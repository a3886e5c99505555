"""The check that decides ``correct``: a sound run passes; the run with
its timed path broken underneath, and the lower-precision control, fail.

Runs the harness on the CPU past its look for a card, under each cell's
configured limits, at the small sizes of ``cpu/<cell>.json`` (the
settings that replace the cell's, as ``run_cell``'s ``overrides``).
Every cell of ``BENCHMARK.json`` has such a file; its sound run and its
control are tested from it alone.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import train
from aind_exaspim_neuron_segmentation_tpu_torch.ops import stitch
from benchmark import calibrate, harness

SEED = 2**31 + 11
CPU_SIZES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpu")
CELLS = [w["name"] for w in harness.load_spec()["workloads"]]

# a cell the driver, traffic mix and readers are ready for, left out of
# BENCHMARK.json for its spread on the card's host (PERF.md)
PENDING = {"name": "train_sampled_b16", "config": "unet3d_affinity_train",
           "traffic": "sampled_epochs_b16", "chips": 1}


def cpu_sizes(cell):
    """The settings that shrink ``cell`` to a CPU test's size."""
    with open(os.path.join(CPU_SIZES, cell + ".json")) as f:
        return json.load(f)


def _spec():
    spec = harness.load_spec()
    spec["workloads"].append(PENDING)
    return spec


def _run(cell):
    spec = _spec()
    result, lines = harness.run_cell(cell, SEED, 0.5, 0, device="cpu",
                                     overrides=cpu_sizes(cell), quiet=True,
                                     spec=spec)
    assert len(lines) == len(result["checks"])
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_cpu_sizes(cell):
    sizes = cpu_sizes(cell)
    assert set(sizes) <= {"config", "traffic"} and sizes


@pytest.mark.parametrize("cell", CELLS + [PENDING["name"]])
def test_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"] is True, result["checks"]
    # the line holds the cell's end-to-end metrics, and no other
    assert set(result["metrics"]) == {
        m["name"] for m in harness.cell_metrics(_spec(), cell, "end_to_end")}


def _same_state(*args, **kwargs):
    return args[0]


def _half_batch(inner):
    def forward_batch(module, volume, starts, valid, **kw):
        probs = inner(module, volume, starts, valid, **kw)
        probs[len(probs) // 2:] = 0
        return probs
    return forward_batch


def _altered_answer(inner):
    def forward_batch(module, volume, starts, valid, **kw):
        probs = inner(module, volume, starts, valid, **kw)
        probs[0] = 1 - probs[0]
        return probs
    return forward_batch


@pytest.mark.parametrize("fault", ["same_state", "half_batch",
                                   "altered_answer"])
def test_predict_check(monkeypatch, fault):
    if fault == "same_state":
        monkeypatch.setattr(stitch, "scatter_batch", _same_state)
    elif fault == "half_batch":
        monkeypatch.setattr(stitch, "forward_batch",
                            _half_batch(stitch.forward_batch))
    elif fault == "altered_answer":
        monkeypatch.setattr(stitch, "forward_batch",
                            _altered_answer(stitch.forward_batch))
    result = _run("predict_ram_256")
    assert result["correct"] is False, result["checks"]


def _loss_of_half(inner):
    def loss(logits, y, w, n_real):
        half = len(logits) // 2
        return inner(logits[:half], y[:half], w[:half], half)
    return loss


def _flipped_targets(inner):
    def targets(self, y):
        out = inner(self, y)
        out[0] = 1 - out[0]
        return out
    return targets


@pytest.mark.parametrize("fault", ["same_state", "half_batch",
                                   "altered_answer"])
def test_train_check(monkeypatch, fault):
    """The faults, planted in the train step that the training cell and
    the pending one fed by the Trainer's own sampler share, fail."""
    if fault == "same_state":
        monkeypatch.setattr(torch.optim.AdamW, "step",
                            lambda self, closure=None: None)
    elif fault == "half_batch":
        monkeypatch.setattr(train.Trainer, "_loss",
                            staticmethod(_loss_of_half(train.Trainer._loss)))
    elif fault == "altered_answer":
        monkeypatch.setattr(train.Trainer, "_targets_from_labels",
                            _flipped_targets(
                                train.Trainer._targets_from_labels))
    result = _run("train_pool_b16")
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    limits = harness.cell_inputs(harness.load_spec(), cell)[0]["limits"]
    readings = calibrate.control_readings(cell, 5, torch.device("cpu"),
                                          cpu_sizes(cell))
    for kind, numbers in readings.items():
        failed = [k for k, v in numbers if k in limits and v > limits[k]]
        assert failed, (kind, numbers)


def test_a_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"),
         "--workload", "predict_ram_256", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"),
         "--workload", "predict_ram_256", "--seed", str(SEED),
         "--seconds", "2", "--trace", "0"], capture_output=True, text=True,
        timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct": true' in out.stdout.strip().splitlines()[-1]
