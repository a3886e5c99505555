"""Kernel K1 (overlap-blend scatter-add) of the PyTorch port.

The plain version is held bit for bit against the JAX package's
``stitch.scatter_batch`` on the CPU; the wrapper's checks run here. The
CUDA kernel itself runs only on a card: ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aind_exaspim_neuron_segmentation_tpu.ops.stitch import (
    scatter_batch as jax_scatter_batch,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops import scatter
from tests.test_torch_gpu import K1_CASES, k1_case, parity_line

torch.set_num_threads(1)


@pytest.mark.parametrize("name", K1_CASES)
def test_reference_bit_identical_to_jax(name):
    acc, probs, starts, trim = k1_case(name)
    want = np.asarray(jax_scatter_batch(
        jnp.asarray(acc), jnp.asarray(probs), jnp.asarray(starts), trim=trim,
    ))
    got = scatter.scatter_batch_reference(
        torch.from_numpy(acc.copy()), torch.from_numpy(probs), starts, trim
    )
    np.testing.assert_array_equal(got.numpy(), want)
    parity_line(f"scatter_batch_reference {name}", bytes_equal=True)


def test_untouched_regions_preserved():
    acc, probs, starts, trim = k1_case("pallas_untouched")
    got = scatter.scatter_batch_reference(
        torch.from_numpy(acc.copy()), torch.from_numpy(probs), starts, trim
    ).numpy()
    np.testing.assert_array_equal(got[0, 10:], acc[0, 10:])
    np.testing.assert_array_equal(got[0, 2:6, 2:6, 2:6],
                                  acc[0, 2:6, 2:6, 2:6] + 1.0)


def test_wrapper_on_cpu_runs_reference_in_place_without_counting():
    acc, probs, starts, trim = k1_case("random_overlapping")
    want = scatter.scatter_batch_reference(
        torch.from_numpy(acc.copy()), torch.from_numpy(probs), starts, trim
    )
    before = scatter.scatter_batch.launches
    acc_t = torch.from_numpy(acc.copy())
    out = scatter.scatter_batch(
        acc_t, torch.from_numpy(probs), torch.from_numpy(starts), trim=trim,
        host_starts=starts,
    )
    assert out is acc_t
    assert torch.equal(acc_t, want)
    assert scatter.scatter_batch.launches == before


def _main_path_starts():
    """One batch of the 256^3 main path: a Z row of 4x4 patches of 96^3."""
    grid = range(0, 256 - 96 + 64, 64)
    return np.array([(64, y, x) for y in grid for x in grid], np.int32)


@pytest.mark.parametrize("name,want", [
    ("main_path", ((72, 8, 8), (152, 280, 280), 4)),
    ("random_overlapping", (None, None, 1)),
    ("aligned_w_odd", ((4, 4, 4), (12, 12, 16), 1)),
    ("grid_rows_aligned", ((4, 4, 4), (24, 32, 32), 4)),
])
def test_launch_plan(name, want):
    if name == "main_path":
        args = ((3, 288, 288, 288), (80, 80, 80), _main_path_starts(), 8)
    elif name == "aligned_w_odd":  # core x origins 4 and 8, W = 18
        args = ((1, 16, 16, 18), (8, 8, 8),
                np.array([[0, 0, 0], [0, 0, 4]], np.int32), 4)
    else:
        acc, probs, starts, trim = k1_case(name)
        args = (acc.shape, probs.shape[2:], starts, trim)
    lo, hi, vec = scatter.launch_plan(*args)
    assert vec == want[2]
    if want[0] is not None:
        assert (lo, hi) == want[:2]
    else:  # the box of the cores, from the starts themselves
        core_lo = args[2] + args[3]
        assert lo == tuple(core_lo.min(axis=0))
        assert hi == tuple((core_lo + np.asarray(args[1])).max(axis=0))


@pytest.mark.parametrize("start", [(-3, 0, 0), (0, 0, 20), (0, 21, 0)])
def test_wrapper_rejects_cores_outside_acc(start):
    acc = torch.zeros((1, 16, 16, 16))
    probs = torch.zeros((1, 1, 4, 4, 4))
    starts = np.array([start], np.int32)
    with pytest.raises(ValueError, match="leave acc"):
        scatter.scatter_batch(acc, probs, torch.from_numpy(starts), trim=2,
                              host_starts=starts)


@pytest.mark.parametrize("bad", ["f64", "i64", "strided", "shape", "meta"])
def test_wrapper_rejects_bad_inputs(bad):
    acc = torch.zeros((3, 16, 16, 16))
    probs = torch.zeros((2, 3, 4, 4, 4))
    starts = np.zeros((2, 3), np.int32)
    starts_t = torch.from_numpy(starts)
    err = ValueError
    if bad == "f64":
        probs, err = probs.double(), TypeError
    elif bad == "i64":
        starts_t, err = starts_t.long(), TypeError
    elif bad == "strided":
        acc = torch.zeros((3, 16, 16, 32))[..., ::2]
    elif bad == "shape":
        probs = torch.zeros((2, 2, 4, 4, 4))
    else:
        acc, probs, starts_t = (t.to("meta") for t in (acc, probs, starts_t))
    with pytest.raises(err):
        scatter.scatter_batch(acc, probs, starts_t, trim=0,
                              host_starts=starts)
