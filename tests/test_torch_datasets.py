"""The port's training datasets against the JAX package's, on the CPU.

Both packages' samplers draw from Python ``random`` and numpy generators
with the same calls in the same order, so the same seed must give the
same samples and batches: every comparison here is exact, as bytes
(``tobytes``), dtypes and shapes included. Each comparison prints a
``{"parity": ...}`` line (``pytest -s``).
"""

import numpy as np
import pytest

from aind_exaspim_neuron_segmentation_tpu.core import affinities as jaff
from aind_exaspim_neuron_segmentation_tpu.core import patches as jpatches
from aind_exaspim_neuron_segmentation_tpu.machine_learning import (
    data_handling as jdh,
)
from aind_exaspim_neuron_segmentation_tpu_torch import io
from aind_exaspim_neuron_segmentation_tpu_torch.core import affinities
from aind_exaspim_neuron_segmentation_tpu_torch.core import patches
from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import (
    data_handling as dh,
)
from aind_exaspim_neuron_segmentation_tpu_torch.utils import util
from tests.test_torch_gpu import parity_line

PATCH = (16, 16, 16)


def make_volumes(n=2, shape=(40, 40, 40), seed=0):
    """uint16 images with bright boxes and uint32 labels of a few ids."""
    rng = np.random.default_rng(seed)
    imgs, labs = [], []
    for k in range(n):
        lab = np.zeros(shape, np.uint32)
        lab[6:34, 6 + 4 * k: 22 + 4 * k, 6:34] = 7 + k
        lab[20:34, 26:36, 10:30] = 70000 + k
        img = rng.integers(0, 90, shape).astype(np.uint16)
        img[lab > 0] += np.uint16(350)
        imgs.append(img)
        labs.append(lab)
    return imgs, labs


def assert_same(got, want, what=""):
    """Equal as bytes, dtypes and shapes, through tuples."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for g, w in zip(got, want):
            assert_same(g, w, what)
        return
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


# mode -> (TrainDataset kwargs, wire_labels, wire_raw_images)
MODES = {
    "host_transform": (dict(transform=True), False, False),
    "host_foreground": (dict(transform=True, affinity_mode=False), False,
                        False),
    "label_patches": (dict(return_label_patches=True), False, False),
    "label_wire": (dict(transform=True), True, False),
    "raw_u16_wire": (dict(return_label_patches=True), True, True),
}


def train_pair(mode, imgs=None, labs=None, seed=5):
    """(port, JAX) TrainDatasets of ``mode`` on the same volumes."""
    if imgs is None:
        imgs, labs = make_volumes()
    kw, wire, raw = MODES[mode]
    out = []
    for mod in (dh, jdh):
        ds = mod.TrainDataset(imgs, labs, patch_shape=PATCH, seed=seed, **kw)
        ds.wire_labels = wire
        ds.wire_raw_images = raw
        out.append(ds)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_train_dataset_samples_and_batches_equal_jax(mode):
    port, ref = train_pair(mode)
    for k in range(3):
        assert_same(port[k], ref[k], f"{mode} sample {k}")
    got = list(dh.iterate_batches(port, 4))
    want = list(jdh.iterate_batches(ref, 4))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_same(g, w, f"{mode} batch")
    x, y = got[0]
    if mode == "raw_u16_wire":
        assert x[0].dtype == np.uint16 and x[1].shape == (4, 2)
    if mode in ("label_wire", "raw_u16_wire"):
        assert y.dtype == np.uint16
    parity_line(f"TrainDataset {mode}: 3 samples + 2 batches of 4",
                bytes_equal=True)


@pytest.mark.parametrize("wire", [False, True], ids=["f32", "label_wire"])
def test_validate_dataset_equal_jax(wire):
    imgs, labs = make_volumes()
    kw = dict(patch_shape=PATCH, containment_buffer=0, seed=3)
    port = dh.ValidateDataset(imgs, labs, **kw)
    ref = jdh.ValidateDataset(imgs, labs, **kw)
    assert len(port) > 4
    assert port.example_ids == ref.example_ids
    port.wire_labels = ref.wire_labels = wire
    got = list(dh.iterate_batches(port, 4))
    want = list(jdh.iterate_batches(ref, 4))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same(g, w, "validate batch")
    parity_line(f"ValidateDataset example_ids + {len(got)} batches, "
                f"wire {wire}", bytes_equal=True)


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("kind", ["train_raw_wire", "train_host",
                                  "validate"])
def test_prefetch_batches_equal_jax(kind, num_workers):
    """Thread (0) or forked workers (2): the same batches in the same
    order as the JAX package's prefetcher, over two epochs (the worker
    streams are re-keyed per epoch)."""
    if kind == "validate":
        imgs, labs = make_volumes()
        kw = dict(patch_shape=PATCH, containment_buffer=0)
        pair = (dh.ValidateDataset(imgs, labs, **kw),
                jdh.ValidateDataset(imgs, labs, **kw))
        for ds in pair:
            ds.wire_labels = True
    else:
        pair = train_pair("raw_u16_wire" if kind == "train_raw_wire"
                          else "host_transform")
    port, ref = pair
    for _ in range(2):
        got = list(dh.prefetch_batches(port, 3, num_workers=num_workers))
        want = list(jdh.prefetch_batches(ref, 3, num_workers=num_workers))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert_same(g, w, f"{kind} prefetch {num_workers}")
    parity_line(f"prefetch_batches {kind}, num_workers {num_workers}, "
                "2 epochs", bytes_equal=True)


def test_prefetch_thread_equals_serial_and_propagates_errors():
    port, _ = train_pair("label_wire")
    serial = list(dh.iterate_batches(port, 4))
    port2, _ = train_pair("label_wire")
    for g, w in zip(dh.prefetch_batches(port2, 4), serial):
        assert_same(g, w)

    class Bad:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise RuntimeError("boom")

    for workers in (0, 2):
        with pytest.raises(RuntimeError, match="boom"):
            list(dh.prefetch_batches(Bad(), 2, num_workers=workers))


def test_reseed_worker_streams_equal_jax():
    port, ref = train_pair("host_transform")
    for worker, rnd in ((0, 0), (1, 0), (1, 3)):
        port.reseed_worker(worker, rnd)
        ref.reseed_worker(worker, rnd)
        for k in range(2):
            assert_same(port[k], ref[k], f"worker {worker} round {rnd}")


def test_lazy_store_volumes_equal_jax(tmp_path):
    imgs, labs = make_volumes(n=1)
    ip, lp = str(tmp_path / "img.zarr"), str(tmp_path / "lab.zarr")
    io.write_zarr(ip, imgs[0], chunks=(16, 16, 16))
    io.write_zarr(lp, labs[0], chunks=(16, 16, 16))
    port, ref = train_pair("raw_u16_wire", [ip], [lp])
    dense, _ = train_pair("raw_u16_wire", imgs, labs)
    assert not isinstance(port.input_imgs[0], np.ndarray)
    for k in range(3):
        got = port[k]
        assert_same(got, ref[k], f"lazy sample {k}")
        assert_same(got, dense[k], f"lazy vs dense sample {k}")


def test_compact_labels_equal_jax():
    rng = np.random.default_rng(0)
    cases = [rng.integers(0, 2**20, (1, 12, 12, 12)).astype(np.uint32),
             (rng.integers(0, 3, (6, 6, 6)) > 1),
             rng.integers(0, 5, (8, 8, 8)).astype(np.int16)]
    wide = np.zeros((1, 4, 4, 4), np.uint64)
    wide[0, 0], wide[0, 1], wide[0, 2] = 5, 2**32 + 5, 2**32
    cases.append(wide)
    dense = np.resize(np.arange(2**16 + 512, dtype=np.uint32), (41, 41, 41))
    cases.append(dense)
    for lab in cases:
        got, want = dh.compact_labels(lab), jdh.compact_labels(lab)
        assert_same(got, want, str(lab.dtype))
        got = dh.compact_labels(lab, min_dtype=np.uint32)
        assert_same(got, jdh.compact_labels(lab, min_dtype=np.uint32))
    assert dh.compact_labels(cases[0]).dtype == np.uint16
    assert dh.compact_labels(dense).dtype == np.uint32
    for mod in (dh, jdh):
        with pytest.raises(ValueError, match="negative"):
            mod.compact_labels(np.full((2, 2, 2), -3, np.int64))
        with pytest.raises(ValueError, match="integer"):
            mod.compact_labels(np.zeros((2, 2, 2), np.float32))


def test_wire_dtype_promotion_is_sticky_like_jax():
    sparse = np.ones((1, 8, 8, 8), np.uint32)
    dense = np.resize(np.arange(2**16 + 512, dtype=np.uint32),
                      (1, 41, 41, 41))
    port, ref = train_pair("label_wire")
    for ds in (port, ref):
        assert ds._compact_wire(sparse).dtype == np.uint16
        assert ds._compact_wire(dense).dtype == np.uint32
        assert ds._compact_wire(sparse).dtype == np.uint32


def test_reconstruct_normalized_and_raw_patch_equal_jax():
    port, ref = train_pair("raw_u16_wire")
    raw, mn, inv = port.get_raw_input_patch(0, (20, 20, 20))
    want = ref.get_raw_input_patch(0, (20, 20, 20))
    assert_same((raw, np.asarray(mn), np.asarray(inv)),
                (want[0], np.asarray(want[1]), np.asarray(want[2])))
    got = dh.reconstruct_normalized(raw, mn, inv)
    assert got.dtype == np.float32
    assert_same(got, jdh.reconstruct_normalized(raw, mn, inv))
    np.testing.assert_allclose(got, port.get_input_patch(0, (20, 20, 20)),
                               atol=3e-7)


def test_sampler_odd_patch_and_weights_equal_jax():
    rng = np.random.default_rng(11)
    img = rng.uniform(0, 300, (13, 13, 13)).astype(np.float32)
    lab = (rng.uniform(0, 1, (13, 13, 13)) > 0.5).astype(np.uint32)
    port = dh.TrainDataset([img, img], [lab, lab * 0], patch_shape=(13, 11, 9),
                           seed=2)
    ref = jdh.TrainDataset([img, img], [lab, lab * 0],
                           patch_shape=(13, 11, 9), seed=2)
    np.testing.assert_array_equal(port.wgts, ref.wgts)
    assert len(port) == len(ref) == 8
    for _ in range(5):
        np.testing.assert_array_equal(port.sample_center((13, 13, 13)),
                                      ref.sample_center((13, 13, 13)))
        assert_same(port[0], ref[0])


def test_transform_callable_is_used():
    imgs, labs = make_volumes()
    calls = []

    def my_transform(x, y):
        calls.append(1)
        return x, y

    ds = dh.TrainDataset(imgs, labs, patch_shape=PATCH,
                         transform=my_transform, seed=0)
    ds[0]
    assert calls
    with pytest.raises(ValueError, match="counts differ"):
        dh.TrainDataset(imgs, labs[:1], patch_shape=PATCH)


def test_patch_helpers_equal_jax():
    vol = np.arange(10 * 12 * 14).reshape(10, 12, 14)
    for center, shape in (((5, 6, 7), (4, 4, 4)), ((4, 5, 6), (3, 5, 7))):
        assert patches.get_slices(center, shape) == jpatches.get_slices(
            center, shape)
        assert_same(patches.get_patch(vol, center, shape),
                    jpatches.get_patch(vol, center, shape))
        assert_same(patches.get_patch(vol[None, None], center, shape),
                    jpatches.get_patch(vol[None, None], center, shape))
    clipped = vol[:7, :9, :14]
    assert_same(patches.add_padding(clipped, (10, 12, 14)),
                jpatches.add_padding(clipped, (10, 12, 14)))
    assert patches.add_padding(vol, vol.shape) is vol
    for voxel in ((0, 0, 0), (5, 5, 5), (9, 11, 13), (2, 8, 3)):
        for buffer in (0, 2, 4):
            assert patches.is_contained(voxel, vol.shape, buffer) == \
                jpatches.is_contained(voxel, vol.shape, buffer)


def test_host_affinity_channels_equal_jax():
    rng = np.random.default_rng(1)
    lab = (rng.integers(0, 4, (9, 10, 11)) * 977).astype(np.uint32)
    got = affinities.get_affinity_channels(lab)
    want = jaff.get_affinity_channels(lab)
    assert_same(got, want)
    edges = ((-1, 0, 0), (0, 0, 1), (0, -1, 0))
    assert_same(affinities.get_affinity_channels(lab, edges),
                jaff.get_affinity_channels(lab, edges))
    with pytest.raises(ValueError):
        affinities.get_affinity_channels(lab, ((1, 1, 0),))


def test_util_mkdir_rmdir(tmp_path):
    path = tmp_path / "a" / "b"
    util.mkdir(str(path))
    (path / "f").write_text("x")
    util.mkdir(str(path))
    assert (path / "f").exists()
    util.mkdir(str(path), delete=True)
    assert path.is_dir() and not (path / "f").exists()
    util.rmdir(str(tmp_path / "a"))
    util.rmdir(str(tmp_path / "a"))
    assert not (tmp_path / "a").exists()
