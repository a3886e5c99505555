"""A configuration of a second architecture is taken by new files and
``BENCHMARK.json`` additions alone.

The test copies ``benchmark/`` and ``BENCHMARK.json`` into a temporary
checkout and adds a toy architecture that exists only here: a two-conv
plain-torch model, its module under ``models/``, its plain reference under
``reference/``, a configuration, a traffic mix for the predict driver, a
reader, the CPU sizes of its cell, and entries in ``BENCHMARK.json`` (the
cell's name appended to ``affinity_mvox_s``'s ``workloads``). It edits no
file that was there, then runs the copy's own layout, import and check
tests on it, unedited: the layout contract, the cell's metrics, a sound
run on the CPU and its control.
"""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

CELL = "toy_ram_48"

TOY_REFERENCE = '''"""Plain float32 forward of the seam test's two-conv toy."""

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def param_shapes(channels, out_channels):
    """Every parameter by key."""
    return {"conv1.weight": (channels, 1, 3, 3, 3),
            "conv1.bias": (channels,),
            "conv2.weight": (out_channels, channels, 3, 3, 3),
            "conv2.bias": (out_channels,)}


def _fp8(t):
    scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _conv(x, w, b, quant):
    if quant == "fp8":
        x, w = _fp8(x), _fp8(w)
    return F.conv3d(x, w, b, padding=1)


def forward(p, x, quant=None):
    """Logits of a float32 (N, 1, D, H, W) batch."""
    y = F.leaky_relu(_conv(x, p["conv1.weight"], p["conv1.bias"], quant),
                     0.01)
    return _conv(y, p["conv2.weight"], p["conv2.bias"], quant)
'''

TOY_MODEL = '''"""The seam test's two-conv toy behind the architecture seam."""

import torch

from benchmark.reference import toy2conv as ref

PUBLISHED = {"channels": [4]}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

forward = ref.forward


class Toy(torch.nn.Module):
    """Two 3x3x3 convs; ``valid_trim`` drops the output's border."""

    def __init__(self, channels, out_channels):
        super().__init__()
        self.output_channels = out_channels
        self.conv1 = torch.nn.Conv3d(1, channels, 3, padding=1)
        self.conv2 = torch.nn.Conv3d(channels, out_channels, 3, padding=1)

    def forward(self, x, valid_trim=0):
        x = x.to(self.conv1.weight.dtype)
        y = self.conv2(torch.nn.functional.leaky_relu(self.conv1(x), 0.01))
        t = valid_trim
        return y[:, :, t:y.shape[2] - t, t:y.shape[3] - t,
                 t:y.shape[4] - t] if t else y


def weights(cfg, seed, device, block):
    """Uniform in +-0.1 from the seed, by key."""
    m = cfg["model"]
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = ref.param_shapes(m["channels"][0], m["out_channels"])
    return {k: (torch.rand(s, generator=gen, device=device) - 0.5) * 0.2
            for k, s in shapes.items()}


def runner(cfg, params, device):
    """The toy in the port's ``ModelRunner``."""
    from aind_exaspim_neuron_segmentation_tpu_torch import inference

    m = cfg["model"]
    module = Toy(m["channels"][0], m["out_channels"])
    module.load_state_dict(params)
    return inference.ModelRunner(module.to(device, DTYPES[m["dtype"]]))


def conv_layers(cfg, kind):
    """The two convs of one patch."""
    m, s = cfg["model"], cfg[kind]
    v = s["patch"] ** 3
    c = m["channels"][0]
    return [dict(cin=1, cout=c, taps=27, vin=v, vout=v, bn=False),
            dict(cin=c, cout=m["out_channels"], taps=27, vin=v, vout=v,
                 bn=False)]


def forward_flops(cfg, kind):
    """FLOPs of one patch's forward."""
    return sum(2 * l["taps"] * l["cin"] * l["cout"] * l["vout"]
               for l in conv_layers(cfg, kind))
'''

TOY_READER = '''"""Device idle share of the toy's predict cell, %."""

from benchmark import readers


def read(rec):
    """1 - (union of device activity) / window."""
    return readers.idle_pct(rec)
'''

TOY_CONFIG = {
    "name": "toy2conv_infer", "source": "https://example.org/toy2conv",
    "model": {"architecture": "Toy2Conv", "channels": [4],
              "out_channels": 3, "dtype": "float32"},
    "predict": {"patch": 16, "overlap": 8, "trim": 2, "batch_size": 4,
                "blend": "uniform", "clip": 1000, "percentiles": [1, 99.9]},
    "limits": {"aff_mae": 1e-4, "aff_max_abs": 1e-3},
}
TOY_TRAFFIC = {"driver": "predict_closed_loop", "block": 48, "pool": 2,
               "tubes": 3, "radius": 2, "noise": 120, "bright": 350,
               "warm_calls": 1, "sample": 2}
NEW_FILES = {
    "benchmark/reference/toy2conv.py": TOY_REFERENCE,
    "benchmark/models/toy2conv.py": TOY_MODEL,
    "benchmark/metrics/device_idle.toy.py": TOY_READER,
    "benchmark/configs/toy2conv_infer.json": json.dumps(TOY_CONFIG),
    "benchmark/traffic/toy_blocks_48.json": json.dumps(TOY_TRAFFIC),
    f"benchmark/tests/cpu/{CELL}.json": json.dumps({"traffic": {"pool": 2}}),
}


def _files(root):
    out = {}
    for base, dirs, names in os.walk(os.path.join(root, "benchmark")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for n in names:
            path = os.path.join(base, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _with_toy(spec):
    spec = json.loads(json.dumps(spec))
    spec["configs"].append({
        "name": "toy2conv_infer", "source": TOY_CONFIG["source"],
        "file": "benchmark/configs/toy2conv_infer.json", "reduced": [],
        "why": "a two-conv toy that exists only in the seam test"})
    spec["workloads"].append({
        "name": CELL, "config": "toy2conv_infer", "traffic": "toy_blocks_48",
        "chips": 1, "why": "closed loop of predict on two 48^3 blocks"})
    for m in spec["end_to_end"]:
        if m["name"] == "affinity_mvox_s":
            m["workloads"].append(CELL)
    spec["per_layer"].append({
        "name": "device_idle.toy", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "device",
        "moves": "affinity_mvox_s", "workloads": [CELL]})
    return spec


def test_a_second_architecture_needs_new_files_alone(tmp_path):
    before = _files(harness.ROOT)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec()
    grown = _with_toy(spec)
    for path, text in NEW_FILES.items():
        assert path not in before, path
        (tmp_path / path).write_text(text)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(grown, indent=1))

    # no file that was there changed; BENCHMARK.json only grew
    after = _files(tmp_path)
    assert {k: after[k] for k in before} == before
    assert set(grown) == set(spec)
    for key, value in spec.items():
        if not isinstance(value, list) or key in ("command", "paths"):
            assert grown[key] == value, key
            continue
        for old, new in zip(value, grown[key]):
            lists = old.get("workloads", [])
            assert new.get("workloads", [])[:len(lists)] == lists
            assert dict(new, workloads=lists) == dict(old, workloads=lists)

    # the port beside the copy, as in a checkout
    port = "aind_exaspim_neuron_segmentation_tpu_torch"
    os.symlink(os.path.join(harness.ROOT, port), tmp_path / port)
    tests = tmp_path / "benchmark" / "tests"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-rA", "-k",
         f"layout or imports or {CELL}",
         str(tests / "test_bench_layout.py"),
         str(tests / "test_bench_imports.py"),
         str(tests / "test_bench_checks.py")],
        capture_output=True, text=True, timeout=900, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    passed = [line for line in out.stdout.splitlines()
              if line.startswith("PASSED")]
    for name in ("test_sound_run_is_correct", "test_control_fails_a_limit",
                 "test_every_cell_has_cpu_sizes",
                 "test_cell_pieces_are_found_by_name",
                 "test_config_files_hold_what_is_run",
                 "test_architecture_module_is_found_by_name"):
        assert any(name in line and ("toy" in line) for line in passed), (
            name, passed)
