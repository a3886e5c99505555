"""Cases of the PyTorch port that need a CUDA card (``gpu`` marker).

This module imports neither JAX nor the JAX package, so it also runs on a
machine with PyTorch and a card alone (``tests/conftest.py`` imports JAX,
hence ``--noconftest`` there)::

    python -m pytest -m gpu --noconftest -p no:cacheprovider \\
        tests/test_torch_gpu.py

Elsewhere every case skips. The K1 cases are shared with
``tests/test_torch_scatter.py``, which holds the plain version against the
JAX package on the CPU, and so is :func:`parity_line`, with which every
parity test prints its figures (``pytest -s``).
"""

import json

import numpy as np
import pytest
import torch

from aind_exaspim_neuron_segmentation_tpu_torch import inference
from aind_exaspim_neuron_segmentation_tpu_torch.ops import predigest, scatter

K1_CASES = ("pallas_overlaps", "pallas_untouched", "random_overlapping")


def k1_case(name):
    """(acc, probs, starts, trim) host arrays for K1, seeded."""
    if name == "pallas_overlaps":  # tests/test_pallas.py, first case
        rng = np.random.default_rng(0)
        return (
            rng.standard_normal((3, 32, 32, 32)).astype(np.float32),
            rng.standard_normal((4, 3, 8, 8, 8)).astype(np.float32),
            np.array([[0, 0, 0], [4, 4, 4], [4, 4, 4], [20, 16, 12]],
                     np.int32),
            2,
        )
    if name == "pallas_untouched":  # tests/test_pallas.py, second case
        return (
            np.random.default_rng(1).standard_normal(
                (1, 16, 16, 16)).astype(np.float32),
            np.ones((1, 1, 4, 4, 4), np.float32),
            np.array([[2, 2, 2]], np.int32),
            0,
        )
    # random overlapping batch with repeated starts and a non-cubic core
    rng = np.random.default_rng(2)
    core, trim, dims = (10, 12, 14), 3, (40, 44, 48)
    starts = np.stack([
        rng.integers(-trim, d - c - trim + 1, 24)
        for c, d in zip(core, dims)
    ], axis=1).astype(np.int32)
    starts[5] = starts[17] = starts[2]
    return (
        rng.standard_normal((3,) + dims).astype(np.float32),
        rng.standard_normal((24, 3) + core).astype(np.float32),
        starts, trim,
    )


def parity_line(what, got=None, want=None, **figures):
    """Print one parity figure as a JSON line: max-abs and MAE of ``got``
    against ``want`` where given, plus ``figures`` (e.g. bytes_equal)."""
    if got is not None:
        d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
        figures = dict(max_abs=float(d.max()), mae=float(d.mean()), **figures)
    print(json.dumps({"parity": what, **figures}))
    return figures


@pytest.fixture
def cuda():
    """The first CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", K1_CASES)
def test_kernel_bit_identical_on_card(cuda, name):
    acc, probs, starts, trim = k1_case(name)
    acc_d = torch.from_numpy(acc).to(cuda)
    probs_d = torch.from_numpy(probs).to(cuda)
    want = scatter.scatter_batch_reference(acc_d.clone(), probs_d, starts,
                                           trim)
    before = scatter.scatter_batch.launches
    got = scatter.scatter_batch(acc_d.clone(), probs_d,
                                torch.from_numpy(starts).to(cuda), trim=trim,
                                host_starts=starts)
    torch.cuda.synchronize()
    assert scatter.scatter_batch.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_predict_on_card_matches_cpu(cuda):
    """float32 predict, TF32 off: card vs CPU within MAE 1e-5 (summation
    order differs); the card's digest equals the CPU digest of its
    floats."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(width_multiplier=0.25, dtype=torch.float32)
    cpu = inference.load_model(device="cpu", **kw)
    gpu = inference.load_model(device=cuda, **kw)
    vol = np.random.default_rng(0).uniform(0, 2000, (72, 56, 40)).astype(
        np.float32)
    pkw = dict(patch_shape=(32,) * 3, overlap=(8,) * 3, trim=4,
               batch_size=4, verbose=False)
    want = inference.predict(vol, cpu, **pkw)
    before = scatter.scatter_batch.launches
    got = inference.predict(vol, gpu, **pkw)
    assert scatter.scatter_batch.launches > before
    fig = parity_line("predict float32, card vs CPU", got, want)
    assert fig["mae"] <= 1e-5
    assert fig["max_abs"] <= 1e-4
    plan, qaff = inference.predict(vol, gpu, predigest=True, **pkw)
    want_plan, want_q = predigest.predigest_slab(torch.from_numpy(got))
    np.testing.assert_array_equal(plan, want_plan.numpy())
    np.testing.assert_array_equal(qaff, want_q.numpy())
