"""The check that decides ``correct``: a sound run passes; the run with
its timed path broken underneath, and the lower-precision control, fail.

Runs the harness on the CPU at small sizes (width 0.25, 32^3 patches)
past its look for a card, under each cell's configured limits.
"""

import os
import subprocess
import sys

import pytest
import torch

from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import train
from aind_exaspim_neuron_segmentation_tpu_torch.ops import stitch
from benchmark import calibrate, harness

SEED = 2**31 + 11
PREDICT = {
    "config": {"model": {"width": 0.25, "dtype": "float32"},
               "predict": {"patch": 32, "overlap": 16, "trim": 4,
                           "batch_size": 4}},
    "traffic": {"block": 64, "pool": 2, "tubes": 3, "radius": 2},
}
TRAIN = {
    "config": {"model": {"width": 0.25},
               "train": {"patch": 32, "batch_size": 4},
               "train_data": {"volumes": 4, "size": 64, "tubes": 3,
                              "radius": 3}},
    "traffic": {"pool_batches": 4},
}


# a cell the driver, traffic mix and readers are ready for, left out of
# BENCHMARK.json for its spread on the card's host (PERF.md)
PENDING = {"name": "train_sampled_b16", "config": "unet3d_affinity_train",
           "traffic": "sampled_epochs_b16", "chips": 1}


def _run(cell, overrides):
    spec = harness.load_spec()
    spec["workloads"].append(PENDING)
    result, lines = harness.run_cell(cell, SEED, 0.5, 0, device="cpu",
                                     overrides=overrides, quiet=True,
                                     spec=spec)
    assert len(lines) == len(result["checks"])
    return result


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


@pytest.mark.parametrize("fault", [None, "same_state", "half_batch",
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
    result = _run("predict_ram_256", PREDICT)
    assert result["correct"] is (fault is None), result["checks"]


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


@pytest.mark.parametrize("cell,fault", [
    ("train_sampled_b16", None), ("train_pool_b16", None),
    ("train_pool_b16", "same_state"), ("train_pool_b16", "half_batch"),
    ("train_pool_b16", "altered_answer")])
def test_train_check(monkeypatch, cell, fault):
    """Sound runs of the training cell, and of the pending one fed by the
    Trainer's own sampler, pass; the faults, planted in the train step
    both share, fail."""
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
    result = _run(cell, TRAIN)
    assert result["correct"] is (fault is None), result["checks"]


@pytest.mark.parametrize("cell,overrides", [("predict_ram_256", PREDICT),
                                            ("train_pool_b16", TRAIN)])
def test_control_fails_a_limit(cell, overrides):
    entry = next(w for w in harness.load_spec()["workloads"]
                 if w["name"] == cell)
    limits = harness.load_json("configs", entry["config"] + ".json")[
        "limits"]
    readings = calibrate.control_readings(cell, 5, torch.device("cpu"),
                                          overrides)
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
