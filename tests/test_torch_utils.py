"""The port's single-device helpers against the JAX package's, on the CPU.

``core``'s ``get_patch_slices``, ``blend_weight_map``,
``get_offset_masks`` and ``get_affinity_mask`` equal the JAX package's
bit for bit on seeded inputs; ``utils.img_util``'s colormap equals the
JAX package's and its two plots render under matplotlib's Agg backend;
the GCS listing of ``utils.util`` and ``img_util.list_block_paths`` give
the JAX package's answers on one stub ``client`` (no network).
"""

import numpy as np
import pytest

from aind_exaspim_neuron_segmentation_tpu import core as jcore
from aind_exaspim_neuron_segmentation_tpu.utils import img_util as jimg
from aind_exaspim_neuron_segmentation_tpu.utils import util as jutil
from aind_exaspim_neuron_segmentation_tpu_torch import core
from aind_exaspim_neuron_segmentation_tpu_torch.utils import img_util, util
from tests.test_torch_gpu import parity_line


def _same(what, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("seed", range(4))
def test_patch_slices_and_blend_weights_equal_jax(seed):
    rng = np.random.default_rng(seed)
    img_shape = tuple(int(v) for v in rng.integers(20, 70, 3))
    patch = tuple(int(v) for v in rng.integers(8, 20, 3))
    overlap = tuple(int(rng.integers(0, p // 2 + 1)) for p in patch)
    trim = int(rng.integers(0, min(patch) // 3 + 1))
    for start in core.generate_patch_starts(img_shape, patch, overlap):
        assert core.get_patch_slices(start, patch, img_shape) == \
            jcore.get_patch_slices(start, patch, img_shape)
    _same("blend_weight_map",
          core.blend_weight_map(img_shape, patch, overlap, trim),
          jcore.blend_weight_map(img_shape, patch, overlap, trim))
    parity_line(f"get_patch_slices + blend_weight_map seed {seed}",
                bytes_equal=True)


EDGES = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (-1, 0, 0), (0, -1, 0),
         (0, 0, -1)]


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.int64])
def test_offset_and_affinity_masks_equal_jax(dtype):
    lab = np.random.default_rng(3).integers(0, 4, (9, 11, 13)).astype(dtype)
    for edge in EDGES:
        for got, want in zip(core.get_offset_masks(lab, edge),
                             jcore.get_offset_masks(lab, edge)):
            _same(f"get_offset_masks {edge}", got, want)
        _same(f"get_affinity_mask {edge}",
              core.get_affinity_mask(lab, edge),
              jcore.get_affinity_mask(lab, edge))
        np.testing.assert_array_equal(
            core.get_affinity_mask(lab, edge),
            core.get_affinity_channels(lab, [edge])[0])
    for bad in [(1, 1, 0), (0, 0, 0), (2, 0, 0)]:
        with pytest.raises(ValueError):
            core.get_affinity_mask(lab, bad)
        with pytest.raises(ValueError):
            jcore.get_affinity_mask(lab, bad)
    parity_line(f"get_offset_masks + get_affinity_mask {np.dtype(dtype)}",
                bytes_equal=True)


def test_segmentation_colormap_equals_jax_and_plots_render(tmp_path):
    seg = np.zeros((12, 14, 10), np.uint32)
    seg[2:9, 3:6, 1:8] = 4
    seg[5:11, 8:13, 4:9] = 9
    got = img_util.make_segmentation_colormap(seg, seed=7)
    want = jimg.make_segmentation_colormap(seg, seed=7)
    assert got.N == want.N == 10
    np.testing.assert_array_equal(got.colors, want.colors)
    img = np.random.default_rng(0).uniform(0, 500, (12, 14, 10))
    for name, call in (
        ("mips.png", lambda p: img_util.plot_mips(img, output_path=p)),
        ("mips5d.png",
         lambda p: img_util.plot_mips(img[None, None], output_path=p,
                                      vmax=600)),
        ("seg.png",
         lambda p: img_util.plot_segmentation_mips(seg, output_path=p)),
    ):
        path = tmp_path / name
        call(str(path))
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name
    img_util.plot_mips(img)  # no file, no window: returns quietly


class _Blobs:
    """What ``google.cloud.storage.Client.list_blobs`` returns: an
    iterator of blobs whose ``prefixes`` fill as it is read."""

    def __init__(self, names, prefix, delimiter):
        self._names, self._prefix, self._delim = names, prefix, delimiter
        self.prefixes = set()

    def __iter__(self):
        for name in self._names:
            if not name.startswith(self._prefix):
                continue
            rest = name[len(self._prefix):]
            if self._delim and self._delim in rest:
                self.prefixes.add(
                    self._prefix + rest.split(self._delim)[0] + self._delim)
                continue
            yield type("Blob", (), {"name": name})()


class StubClient:
    """A GCS client over a fixed list of blob names in one bucket."""

    def __init__(self, bucket, names):
        self.bucket, self.names, self.calls = bucket, names, []

    def list_blobs(self, bucket_name, prefix=None, delimiter=None):
        self.calls.append((bucket_name, prefix, delimiter))
        assert bucket_name == self.bucket
        return _Blobs(self.names, prefix or "", delimiter)


NAMES = [
    "exaspim/blocks/", "exaspim/readme.txt",
    "exaspim/blocks/block_000/input.zarr/.zarray",
    "exaspim/blocks/block_000/input.zarr/0.0.0",
    "exaspim/blocks/block_000/Fill_Label_Mask.zarr/.zarray",
    "exaspim/blocks/block_001/input.tif",
    "exaspim/blocks/block_001/Fill_Label_Mask.tif",
    "exaspim/blocks/block_002/notes/",
    "exaspim/blocks/block_002/input.n5/attributes.json",
    "exaspim/blocks/block_002/Fill_Label_Mask.n5/attributes.json",
]


def test_gcs_listing_and_block_paths_equal_jax():
    bucket = img_util.AIND_BUCKET
    assert bucket == jimg.AIND_BUCKET
    ours, theirs = StubClient(bucket, NAMES), StubClient(bucket, NAMES)
    for prefix in ("exaspim", "exaspim/", "exaspim/blocks",
                   "exaspim/blocks/block_001", "missing"):
        assert util.list_gcs_paths(bucket, prefix, client=ours) == \
            jutil.list_gcs_paths(bucket, prefix, client=theirs)
        assert sorted(util.list_gcs_subprefixes(bucket, prefix,
                                                client=ours)) == \
            sorted(jutil.list_gcs_subprefixes(bucket, prefix, client=theirs))
    got = util.find_subprefix_with_keyword(
        bucket, "exaspim/blocks/block_000", "input.", client=ours)
    assert got == jutil.find_subprefix_with_keyword(
        bucket, "exaspim/blocks/block_000", "input.", client=theirs)
    assert got == "exaspim/blocks/block_000/input.zarr/"
    with pytest.raises(LookupError):
        util.find_subprefix_with_keyword(bucket, "exaspim/blocks/block_000",
                                         "labels", client=ours)
    ours.calls, theirs.calls = [], []
    got = img_util.list_block_paths("exaspim/blocks", client=ours)
    want = jimg.list_block_paths("exaspim/blocks", client=theirs)
    assert (sorted(got[0]), sorted(got[1])) == (sorted(want[0]),
                                                sorted(want[1]))
    assert len(got[0]) == 3
    assert ours.calls == theirs.calls
    parity_line("GCS listing + list_block_paths on a stub client",
                equal=True, calls=len(ours.calls))
