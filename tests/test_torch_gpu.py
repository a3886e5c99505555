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
from aind_exaspim_neuron_segmentation_tpu_torch.core.patches import (
    patch_starts_array,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops import predigest, scatter

K1_CASES = ("pallas_overlaps", "pallas_untouched", "random_overlapping",
            "grid_rows_aligned")


def k1_case(name):
    """(acc, probs, starts, trim) host arrays for K1, seeded."""
    if name == "grid_rows_aligned":
        # the first 16 of the 27 starts of a 36^3 grid (patch 20, overlap
        # 12, trim 4: cores 12^3 at 4, 12, 20): two Z rows, voxels under up
        # to 8 patches, every core x origin a multiple of 4
        rng = np.random.default_rng(3)
        starts = patch_starts_array((36,) * 3, (20,) * 3, (12,) * 3)[:16]
        return (
            rng.standard_normal((3, 36, 36, 36)).astype(np.float32),
            rng.standard_normal((16, 3, 12, 12, 12)).astype(np.float32),
            starts, 4,
        )
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
    assert scatter.scatter_batch.last_vec == scatter.launch_plan(
        acc.shape, probs.shape[2:], starts, trim)[2]
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_strip_bit_identical_on_card(cuda):
    """One (z, y) row of 16 patches along x, as a ~1024-wide volume gives,
    scaled down: cores 16^3 at x = 4 + 12k overlap their neighbours by 4."""
    rng = np.random.default_rng(4)
    starts = np.array([(0, 0, 12 * k) for k in range(16)], np.int32)
    acc = torch.from_numpy(
        rng.standard_normal((3, 24, 24, 204)).astype(np.float32)).to(cuda)
    probs = torch.from_numpy(
        rng.standard_normal((16, 3, 16, 16, 16)).astype(np.float32)).to(cuda)
    want = scatter.scatter_batch_reference(acc.clone(), probs, starts, 4)
    got = scatter.scatter_batch(acc.clone(), probs,
                                torch.from_numpy(starts).to(cuda), trim=4,
                                host_starts=starts)
    torch.cuda.synchronize()
    assert scatter.scatter_batch.last_vec == 4
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_batch_over_launch_batch_on_card(cuda):
    """80 overlapping patches run as two launches (64, then 16), in order."""
    rng = np.random.default_rng(5)
    starts = rng.integers(0, 13, (80, 3)).astype(np.int32) * 4
    acc = torch.from_numpy(
        rng.standard_normal((3, 72, 72, 72)).astype(np.float32)).to(cuda)
    probs = torch.from_numpy(
        rng.standard_normal((80, 3, 16, 16, 16)).astype(np.float32)).to(cuda)
    want = scatter.scatter_batch_reference(acc.clone(), probs, starts, 4)
    before = scatter.scatter_batch.launches
    got = scatter.scatter_batch(acc.clone(), probs,
                                torch.from_numpy(starts).to(cuda), trim=4,
                                host_starts=starts)
    torch.cuda.synchronize()
    assert scatter.scatter_batch.launches == before + 2
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


@pytest.mark.gpu
def test_on_card_digest_segments_like_the_float_path(cuda):
    """Oracle affinities of two blocks and a bar, made and digested on the
    card: the digest pair segments bit-identically to the float path."""
    from aind_exaspim_neuron_segmentation_tpu_torch.core.affinities import (
        affinity_channels,
    )

    lab = np.zeros((40, 36, 32), np.int32)
    lab[2:38, 2:12, 3:29] = 7
    lab[2:38, 20:30, 3:29] = 3
    lab[20, 14:18, 2:30] = 9
    aff = affinity_channels(torch.from_numpy(lab).to(cuda))
    plan, qaff = predigest.predigest_slab(aff)
    assert plan.device.type == qaff.device.type == "cuda"
    pair = inference.affinities_to_segmentation((plan, qaff),
                                                min_segment_size=50)
    want = inference.affinities_to_segmentation(aff, min_segment_size=50)
    assert pair.dtype == np.uint32 and pair.max() == 3
    np.testing.assert_array_equal(pair, want)
