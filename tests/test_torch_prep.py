"""``predict``'s device preparation of integer input (``ops.prep``) against
its host preparation, on the CPU: the same float32 bits; and the lazy
route's clip, which takes any dtype."""

import json
import pathlib

import numpy as np
import pytest
import torch

from aind_exaspim_neuron_segmentation_tpu_torch import inference, io
from aind_exaspim_neuron_segmentation_tpu_torch.core.normalize import (
    streaming_percentile,
)
from aind_exaspim_neuron_segmentation_tpu_torch.core.patches import slab_plan
from aind_exaspim_neuron_segmentation_tpu_torch.ops import prep
from benchmark import inputs
from tests.test_torch_gpu import assert_same_bits, device_prep, host_prep

CPU = torch.device("cpu")
# patch 20, overlap 4: the last grid start of 37, 38 and 39 leaves a tail
# of 5, 6 and 7 planes under a pad of 15, 14 and 13 (multi-bounce)
SMALL = dict(patch_shape=(20,) * 3, overlap=(4,) * 3)
MULTI_BOUNCE = (37, 38, 39)


def small_volume(dtype, high, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, high, MULTI_BOUNCE).astype(dtype)


def edge_volume():
    """uint16 with exactly ``k + 1`` zeros, ``k`` the rank below the 1st
    percentile: its upper order statistic is the first value past a bin
    whose cumulative count equals its rank."""
    img = small_volume(np.uint16, 3000) | 1
    k = int(np.floor((img.size - 1) * 0.01))
    img.reshape(-1)[: k + 1] = 0
    return img


def tube_block():
    """The benchmark's first 256^3 block of ``predict_ram_256``."""
    root = pathlib.Path(__file__).resolve().parents[1]
    with open(root / "benchmark/traffic/blocks_256_pool4.json") as f:
        t = json.load(f)
    return inputs.tube_volume(2**31 + 15, 0, t["block"], t["tubes"],
                              t["radius"], t["noise"], t["bright"])[0]


# (volume, clip, grid); the uint8 volume under the default clip 1000 is
# held to the host preparation of its uint16 copy (numpy 2 refuses a
# Python int beyond uint8 in np.minimum)
CASES = {
    "uint16_clip_below_max": (lambda: small_volume(np.uint16, 3000), 1000,
                              SMALL),
    "uint16_clip_above_max": (lambda: small_volume(np.uint16, 3000), 5000,
                              SMALL),
    "uint16_fractional_clip": (lambda: small_volume(np.uint16, 3000),
                               1000.3, SMALL),
    "uint8_clip_below_max": (lambda: small_volume(np.uint8, 256), 100,
                             SMALL),
    "uint8_clip_above_max": (lambda: small_volume(np.uint8, 200), 250,
                             SMALL),
    "uint8_default_clip": (lambda: small_volume(np.uint8, 256), 1000,
                           SMALL),
    "constant": (lambda: np.full(MULTI_BOUNCE, 77, np.uint16), 1000, SMALL),
    "constant_above_fractional_clip": (
        lambda: np.full(MULTI_BOUNCE, 2000, np.uint16), 1000.3, SMALL),
    "rank_on_bin_edge": (edge_volume, 1000, SMALL),
    "tube_block_256": (tube_block, 1000,
                       dict(patch_shape=(96,) * 3, overlap=(32,) * 3)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_device_prep_equals_host_prep(case):
    make, clip, grid = CASES[case]
    img = make()
    assert prep.takes_device_prep(img, clip)
    ref = img.astype(np.uint16) if case == "uint8_default_clip" else img
    want = host_prep(ref, clip, **grid)
    got = device_prep(img, clip, device=CPU, **grid)
    assert_same_bits(got, want)
    if case.startswith("constant"):
        assert not got.any()


def test_clip_histogram_counts_each_voxel_once_over_slabs():
    """Several slabs: the owned Z ranges of predict's slab plan partition
    the volume, so their histogram counts every voxel once."""
    img = small_volume(np.uint16, 3000)
    cap = prep.histogram_cap(img.dtype, 1000)
    z_starts = list(range(0, img.shape[0] - 20 + 16, 16))
    plans = slab_plan(z_starts, 20, 2, img.shape[0], 1)
    assert len(plans) == 3
    hist = prep.clip_histogram(
        (prep.upload(img[slice(*p["own"])], cap, CPU) for p in plans), cap)
    assert int(hist.sum()) == img.size
    np.testing.assert_array_equal(
        hist.numpy(), np.bincount(np.minimum(img, cap).ravel(),
                                  minlength=cap + 1))


@pytest.mark.parametrize("img, clip, takes", [
    (np.zeros((4, 4, 4), np.uint16), 1000, True),
    (np.zeros((4, 4, 4), np.uint8), 1000.5, True),
    (np.zeros((4, 4, 4), np.uint16), np.float32(1000), False),
    (np.zeros((4, 4, 4), np.int16), 1000, False),
    (np.zeros((4, 4, 4), np.uint32), 1000, False),
    (np.zeros((4, 4, 4), np.float32), 1000, False),
], ids=["uint16", "uint8_float_clip", "float32_clip", "int16", "uint32",
        "float32"])
def test_device_prep_is_chosen_by_dtype(img, clip, takes):
    assert prep.takes_device_prep(img, clip) is takes


@pytest.mark.parametrize("clip, cap", [(1000, 1000), (1000.3, 1001),
                                       (-3, 0), (70000, 65535),
                                       (float("inf"), 65535)])
def test_histogram_cap(clip, cap):
    assert prep.histogram_cap(np.uint16, clip) == cap


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int16", "int32",
                                   "float32", "float64"])
@pytest.mark.parametrize("clip", [1000, 1000.3, np.float64(999.7)],
                         ids=["int", "float", "float64"])
def test_clipped_percentiles_keep_the_bits_of_a_clip_in_the_dtype(dtype,
                                                                  clip):
    """The lazy route clips each streamed block in float32: the bits of
    ``np.minimum`` in the block's own dtype, which overflows for uint8
    under 1000 (held to its uint16 copy there)."""
    rng = np.random.default_rng(3)
    low = 0 if dtype.startswith("uint") else -3000
    high = 256 if dtype == "uint8" else 3000
    img = rng.uniform(low, high, (70, 9, 8)).astype(dtype)
    ref = img.astype(np.uint16) if dtype == "uint8" else img
    pcts = (1, 99.9, 50)
    want = streaming_percentile(ref, pcts,
                                transform=lambda b: np.minimum(b, clip))
    got = prep.clipped_percentiles(img, clip, pcts)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_lazy_uint8_store_predicts_as_in_memory(tmp_path):
    """A lazy uint8 store under the default clip of 1000 predicts (its
    blocks are clipped in float32) and gives the in-memory volume's
    result, which is prepared on the device, to the lazy route's
    float32 scale."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (40, 40, 36)).astype(np.uint8)
    path = str(tmp_path / "u8.zarr")
    io.write_zarr(path, img, chunks=(8, 16, 16))
    runner = inference.load_model(device="cpu", width_multiplier=0.25)
    kw = dict(patch_shape=(32,) * 3, overlap=(8,) * 3, trim=4,
              batch_size=4, verbose=False)
    before = inference.predict.device_prep_slabs
    want = inference.predict(img, runner, **kw)
    assert inference.predict.device_prep_slabs == before + 1
    got = inference.predict(io.read(path), runner, max_slab_rows=1, **kw)
    assert inference.predict.device_prep_slabs == before + 1
    np.testing.assert_allclose(got, want, atol=2e-6)
