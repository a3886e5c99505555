"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level module names; the references import nothing of the port."""

import ast
import glob
import json
import os
import subprocess
import sys

from benchmark import harness

SCRIPT = """
import json, os, sys
sys.path.insert(0, {root!r})
from benchmark import harness, training, calibrate
from benchmark.drivers import predict_closed_loop, train_epochs, train_pool
from benchmark.reference import precision, predict, train, unet3d
import aind_exaspim_neuron_segmentation_tpu_torch.inference
import aind_exaspim_neuron_segmentation_tpu_torch.machine_learning.train
for part in ("metrics", "drivers", "models"):
    for f in sorted(os.listdir(os.path.join(harness.HERE, part))):
        if f.endswith(".py") and f != "__init__.py":
            harness.load_module(part, f)
print(json.dumps(harness.forbidden_loaded()))
"""


def test_fresh_process_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=harness.ROOT)],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=harness.ROOT, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole(monkeypatch):
    for name in ("jaxlike", "aind_exaspim_neuron_segmentation_tpu_torch",
                 "jax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert "jax" in harness.forbidden_loaded()
    assert "jaxlike" not in harness.forbidden_loaded()
    assert "aind_exaspim_neuron_segmentation_tpu_torch" not in \
        harness.forbidden_loaded()


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax():
    files = glob.glob(os.path.join(harness.HERE, "**", "*.py"),
                      recursive=True)
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_references_import_nothing_of_the_port():
    for path in glob.glob(os.path.join(harness.HERE, "reference", "*.py")):
        for name in _imports(path):
            assert not name.startswith(
                "aind_exaspim_neuron_segmentation_tpu"), (path, name)
            if name.startswith("benchmark"):
                assert name.startswith("benchmark.reference"), (path, name)
