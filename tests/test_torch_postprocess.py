"""The port's inference tail against the JAX package, on the CPU.

Watershed, agglomeration, the label remaps, TEASAR, the SWC zip and the
affinity channels: the same inputs, made from seeds with numpy, go
through both packages' C++ engines and Python wrappers, and every result
must be equal -- ``np.array_equal`` on labels, skeleton arrays and
affinity channels, byte equality on SWC text and zip entries; no
tolerance. Both engines are built on this host with the same flags, so
their code is the same; labels are never compared across machines.

Every test that needs the port's engine is in this file, so one worker
builds it. Each comparison prints a ``{"parity": ...}`` line (``-s``).
"""

import ctypes
import os
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aind_exaspim_neuron_segmentation_tpu import inference as jinf
from aind_exaspim_neuron_segmentation_tpu import native as jnative
from aind_exaspim_neuron_segmentation_tpu import postprocess as jpost
from aind_exaspim_neuron_segmentation_tpu.core import affinities as jaff
from aind_exaspim_neuron_segmentation_tpu.postprocess import (
    skeleton as jskel,
)
from aind_exaspim_neuron_segmentation_tpu_torch import (
    inference,
    native,
    postprocess,
)
from aind_exaspim_neuron_segmentation_tpu_torch.core import affinities
from aind_exaspim_neuron_segmentation_tpu_torch.native import build
from aind_exaspim_neuron_segmentation_tpu_torch.ops import predigest
from aind_exaspim_neuron_segmentation_tpu_torch.postprocess import skeleton
from tests.test_e2e import synthetic_volume
from tests.test_predigest import _noisy_affs
from tests.test_torch_gpu import parity_line

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "agglomerate_golden.npz")
SHAPES = {"24x20x16": (24, 20, 16), "40^3": (40, 40, 40)}
THRESHOLDS = {"default": [0.6, 0.8, 0.9], "low": [0.2, 0.5, 0.8]}


def _same(what, got, want):
    """Assert ``got`` equals ``want`` bit for bit (values, shape, dtype)
    and print the parity line."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=what)
    parity_line(what, bytes_equal=True)


def _digest(aff):
    plan, qaff = predigest.predigest_slab(torch.from_numpy(aff))
    return plan.numpy(), qaff.numpy()


# --- the engine ----------------------------------------------------------


def test_engine_loads_from_the_ports_build_dir():
    lib = native._lib()
    jlib = jnative._lib()
    port_build = os.path.join(
        os.path.dirname(os.path.dirname(build.__file__)), "_build")
    assert os.path.dirname(build.loaded_path()) == port_build
    assert os.path.basename(build.loaded_path()).startswith(
        "libexaspim_native_")
    # each handle resolves its own exa_* symbols (RTLD_LOCAL), the
    # codecs' among them
    for name in ("exa_watershed", "exa_blosc_decompress",
                 "exa_streamseg_feed"):
        addr = ctypes.cast(getattr(lib, name), ctypes.c_void_p).value
        jaddr = ctypes.cast(getattr(jlib, name), ctypes.c_void_p).value
        assert addr != jaddr, name


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURE)


@pytest.mark.parametrize("low_high", [None, (0.5, 0.95)],
                         ids=["default", "low0.5_high0.95"])
def test_watershed_equals_golden(golden, low_high):
    args, key = ((), "watershed") if low_high is None else (
        low_high, "watershed_low05_high95")
    got = native.watershed(golden["aff"], *args)
    _same(f"watershed golden {key}", got, golden[key])
    _same(f"watershed vs JAX {key}", got,
          jnative.watershed(golden["aff"], *args))


@pytest.mark.parametrize("q", [50, 85, 95])
def test_agglomerate_all_equals_golden(golden, q):
    th = list(golden["thresholds"])
    got = native.agglomerate_all(golden["aff"], th, quantile_pct=q)
    _same(f"agglomerate_all golden q{q}", got, golden[f"segs_q{q}"])
    plan, qaff = _digest(np.ascontiguousarray(golden["aff"], np.float32))
    _same(f"agglomerate_all_pre golden q{q}",
          native.agglomerate_all_pre(plan, qaff, th, quantile_pct=q),
          golden[f"segs_q{q}"])


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
@pytest.mark.parametrize("th", list(THRESHOLDS), ids=list(THRESHOLDS))
def test_float_and_digest_paths_equal_jax(shape, th):
    aff = _noisy_affs(SHAPES[shape], seed=len(shape) + len(th))
    thresholds = THRESHOLDS[th]
    what = f"{shape} th {th}"
    ws = native.watershed(aff)
    _same(f"watershed {what}", ws, jnative.watershed(aff))
    segs = native.agglomerate_all(aff, thresholds)
    _same(f"agglomerate_all {what}", segs,
          jnative.agglomerate_all(aff, thresholds))

    plan, qaff = _digest(aff)
    ws_plan = native.watershed_plan(plan)
    _same(f"watershed_plan {what}", ws_plan, jnative.watershed_plan(plan))
    _same(f"watershed_plan == watershed {what}", ws_plan, ws)
    segs_pre = native.agglomerate_all_pre(plan, qaff, thresholds)
    _same(f"agglomerate_all_pre {what}", segs_pre,
          jnative.agglomerate_all_pre(plan, qaff, thresholds))
    _same(f"agglomerate_all_pre == agglomerate_all {what}", segs_pre, segs)
    last = native.agglomerate_last_pre(plan, qaff, thresholds)
    _same(f"agglomerate_last_pre {what}", last,
          jnative.agglomerate_last_pre(plan, qaff, thresholds))
    _same(f"agglomerate_last_pre == last of all {what}", last, segs[-1])


def test_agglomerate_generator_equals_jax():
    aff = _noisy_affs(seed=4)
    got = list(postprocess.agglomerate(aff, [0.2, 0.5, 0.8, 0.95]))
    want = list(jpost.agglomerate(aff, [0.2, 0.5, 0.8, 0.95]))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        _same(f"agglomerate generator step {i}", g, w)


@pytest.mark.parametrize("plan_case", ["face_crossing", "undefined_code"])
@pytest.mark.parametrize("fn", ["watershed_plan", "agglomerate_last_pre",
                                "agglomerate_all_pre"])
def test_corrupt_plan_raises(plan_case, fn):
    if plan_case == "face_crossing":
        plan = np.full((2, 4, 4), 8, np.uint8)  # +z out of the last plane
    else:
        plan = np.zeros((2, 4, 4), np.uint8)
        plan[0, 0, 0] = 7 << 3  # direction code 7 is undefined
    qaff = np.zeros((3, 2, 4, 4), np.uint8)
    args = (plan,) if fn == "watershed_plan" else (plan, qaff, [0.5])
    for pkg in (native, jnative):
        with pytest.raises(RuntimeError):
            getattr(pkg, fn)(*args)


@pytest.mark.parametrize("bad", ["descending", "empty", "aff_shape",
                                 "qaff_shape", "plan_ndim"])
def test_argument_checks_raise_like_jax(bad):
    aff = np.zeros((3, 4, 4, 4), np.float32)
    plan = np.zeros((4, 4, 4), np.uint8)
    qaff = np.zeros((3, 4, 4, 4), np.uint8)
    calls = {
        "descending": ("agglomerate_all", (aff, [0.9, 0.6])),
        "empty": ("agglomerate_last_pre", (plan, qaff, [])),
        "aff_shape": ("watershed", (np.zeros((2, 4, 4, 4), np.float32),)),
        "qaff_shape": ("agglomerate_all_pre", (plan, qaff[:2], [0.5])),
        "plan_ndim": ("watershed_plan", (plan[0],)),
    }
    fn, args = calls[bad]
    for pkg in (native, jnative):
        with pytest.raises(ValueError):
            getattr(pkg, fn)(*args)


# --- remaps --------------------------------------------------------------


@pytest.mark.parametrize("case", ["small", "random", "past_2^20"])
def test_unique_equals_jax(case):
    if case == "small":
        lab = np.array([5, 0, 5, 2, 2, 2], np.uint32)
    elif case == "random":
        lab = np.random.default_rng(1).integers(
            0, 5000, (20, 30, 40)).astype(np.uint32)
    else:  # the grow-and-retry path
        lab = np.random.default_rng(2).permutation(
            (1 << 20) + 4097).astype(np.uint32)
    ids, counts = native.unique(lab, return_counts=True)
    want_ids, want_counts = jnative.unique(lab, return_counts=True)
    _same(f"unique ids {case}", ids, want_ids)
    _same(f"unique counts {case}", counts, want_counts)
    _same(f"unique ids only {case}", native.unique(lab), want_ids)
    if case == "past_2^20":
        assert ids.size == lab.size and counts.sum() == lab.size


def test_mask_except_and_renumber_equal_jax():
    rng = np.random.default_rng(3)
    lab = rng.integers(0, 40, (16, 12, 10)).astype(np.uint32)
    keep = rng.choice(40, 12, replace=False)
    masked = native.mask_except(lab, keep)
    _same("mask_except", masked, jnative.mask_except(lab, keep))
    assert not np.shares_memory(masked, lab)
    for preserve_zero in (True, False):
        got, n = native.renumber(masked, preserve_zero=preserve_zero)
        want, n_want = jnative.renumber(masked, preserve_zero=preserve_zero)
        assert n == n_want
        _same(f"renumber preserve_zero={preserve_zero}", got, want)


def test_renumber_copies_a_view_backed_input():
    buf = bytearray(np.array([7, 7, 9, 0, 4, 9], np.uint32).tobytes())
    view = np.frombuffer(buf, np.uint32)
    assert view.base is not None
    out, n = native.renumber(view)
    want, n_want = jnative.renumber(
        np.frombuffer(bytearray(buf), np.uint32))
    assert n == n_want == 3
    _same("renumber view-backed", out, want)
    np.testing.assert_array_equal(np.frombuffer(buf, np.uint32),
                                  [7, 7, 9, 0, 4, 9])


@pytest.mark.parametrize("min_size", [0, 50, 100, 499])
def test_remove_small_segments_equals_jax(min_size):
    lab = np.zeros((10, 10, 10), np.uint32)
    lab[:2, :5, :5] = 9  # 50 voxels
    lab[5:, :, :] = 4  # 500 voxels
    lab[2:4, :, :] = 6  # 200 voxels
    got = postprocess.remove_small_segments(lab, min_size)
    _same(f"remove_small_segments min_size={min_size}", got,
          jpost.remove_small_segments(lab, min_size))


# --- skeletons -----------------------------------------------------------


def _tube(shape=(9, 40, 9), axis=1):
    seg = np.zeros(shape, np.uint32)
    sl = [slice(3, 6)] * 3
    sl[axis] = slice(2, shape[axis] - 2)
    seg[tuple(sl)] = 1
    return seg


def _skeleton_case(name):
    """(segmentation, teasar kwargs) for one skeleton case."""
    if name == "tube":
        return _tube(), dict(const=2, scale=1.0, fix_borders=False)
    if name == "soma_ball":
        seg = np.zeros((24, 24, 24), np.uint32)
        zz, yy, xx = np.meshgrid(*(np.arange(24),) * 3, indexing="ij")
        seg[(zz - 12) ** 2 + (yy - 12) ** 2 + (xx - 12) ** 2 <= 100] = 1
        return seg, dict(soma_detection_threshold=1,
                         soma_acceptance_threshold=1,
                         soma_invalidation_scale=0.5,
                         soma_invalidation_const=0)
    if name == "two_labels":
        seg = _tube()
        seg2 = np.zeros_like(seg)
        seg2[3:6, 2:38, 3:6] = 5
        return (np.concatenate([seg, np.zeros_like(seg), seg2], axis=2),
                dict(const=2, scale=1.0, fix_borders=False))
    if name == "anisotropy_1_1_2":
        return _tube(), dict(anisotropy=(1.0, 1.0, 2.0))
    # one label everywhere: the black-border switch
    return np.ones((10, 8, 8), np.uint32), {}


@pytest.mark.parametrize("name", ["tube", "soma_ball", "two_labels",
                                  "anisotropy_1_1_2", "single_value"])
def test_skeletonize_equals_jax(name):
    seg, kw = _skeleton_case(name)
    got = skeleton.skeletonize(seg, **kw)
    want = jskel.skeletonize(seg, **kw)
    assert list(got) == list(want) and got
    for lab, skel in want.items():
        mine = got[lab]
        _same(f"skeleton {name} {lab} vertices", mine.vertices,
              skel.vertices)
        _same(f"skeleton {name} {lab} radii", mine.radii, skel.radii)
        _same(f"skeleton {name} {lab} edges", mine.edges, skel.edges)
        text = mine.to_swc()
        assert text == skel.to_swc()
        parity_line(f"to_swc {name} {lab}", bytes_equal=True)
        back = skeleton.Skeleton.from_swc(text, id=lab)
        want_back = jskel.Skeleton.from_swc(text, id=lab)
        for field in ("vertices", "radii", "edges"):
            _same(f"from_swc {name} {lab} {field}", getattr(back, field),
                  getattr(want_back, field))
        assert back.to_swc() == text
        assert len(back.radii) == len(mine.radii)
        assert len(back.edges) == len(mine.edges)


def test_skeletonize_takes_a_tensor_and_rejects_a_lazy_handle(tmp_path):
    """A tensor is dense; a lazy label handle of the wrong rank raises
    (lazy 3D handles are ``tests/test_torch_streaming.py``'s)."""
    from aind_exaspim_neuron_segmentation_tpu_torch import io

    seg = _tube()
    got = skeleton.skeletonize(torch.from_numpy(seg.astype(np.int32)))
    want = jskel.skeletonize(seg)
    _same("skeletonize tensor input vertices", got[1].vertices,
          want[1].vertices)
    io.write_zarr(str(tmp_path / "s4.zarr"), seg[None])
    with pytest.raises(ValueError, match="3D label handle"):
        skeleton.skeletonize(io.read(str(tmp_path / "s4.zarr")))
    assert skeleton.skeletonize(np.zeros((5, 5, 5), np.uint32)) == {}


# --- inference tail ------------------------------------------------------


@pytest.fixture(scope="module")
def blobs():
    """Labels of two blocks and a bar, their oracle affinities (float32)
    and the port's digest of them."""
    lab = np.zeros((32, 28, 24), np.int32)
    lab[2:30, 2:10, 2:22] = 1
    lab[2:30, 16:25, 2:22] = 2
    lab[16, 11:14, 1:23] = 3
    aff = jaff.get_affinity_channels(lab).astype(np.float32)
    return lab, aff, _digest(aff)


@pytest.mark.parametrize("form", ["float", "pair", "tensor", "tensor_pair",
                                  "noisy_float", "noisy_pair"])
def test_affinities_to_segmentation_equals_jax(blobs, form):
    _, aff, pair = blobs
    if form.startswith("noisy"):
        aff = _noisy_affs((28, 24, 20), seed=9)
        pair = _digest(aff)
    want_in = pair if form.endswith("pair") else aff
    got_in = {
        "tensor": torch.from_numpy(aff),
        "tensor_pair": tuple(torch.from_numpy(p) for p in pair),
    }.get(form, want_in)
    kw = dict(min_segment_size=20)
    got = inference.affinities_to_segmentation(got_in, **kw)
    want = jinf.affinities_to_segmentation(want_in, **kw)
    _same(f"affinities_to_segmentation {form}", got, want)
    _same(f"affinities_to_segmentation {form} == float path", got,
          jinf.affinities_to_segmentation(aff, **kw))
    if not form.startswith("noisy"):
        assert got.max() == 3


@pytest.mark.parametrize("bad", ["pair_thresholds", "out_path", "lazy",
                                 "lazy_pair"])
def test_affinities_to_segmentation_rejects(blobs, bad, tmp_path):
    """``out_path`` needs a lazy input; a lazy handle of the wrong rank
    and a lazy pair of mismatched shapes raise like the JAX package."""
    from aind_exaspim_neuron_segmentation_tpu_torch import io

    _, aff, pair = blobs
    err, args, kw = ValueError, (aff,), {}
    if bad == "pair_thresholds":
        args, kw = (pair,), dict(aff_threshold_low=0.5)
    elif bad == "out_path":
        kw = dict(out_path="labels.zarr")
    elif bad == "lazy":
        io.write_zarr(str(tmp_path / "a.zarr"), aff[0])
        args = (io.read(str(tmp_path / "a.zarr")),)
    else:
        io.write_zarr(str(tmp_path / "p.zarr"), pair[0][:4])
        io.write_zarr(str(tmp_path / "q.zarr"), pair[1])
        args = ((io.read(str(tmp_path / "p.zarr")),
                 io.read(str(tmp_path / "q.zarr"))),)
    with pytest.raises(err, match="baked|lazy|expected|do not match"):
        inference.affinities_to_segmentation(*args, device="cpu", **kw)


def _zip_entries(path):
    with zipfile.ZipFile(path) as zf:
        return zf.namelist(), {n: zf.read(n) for n in zf.namelist()}


@pytest.mark.parametrize("anisotropy", [(1, 1, 1), (1.0, 1.0, 2.0)],
                         ids=["iso", "aniso_1_1_2"])
def test_zipped_swcs_and_voxelize_equal_jax(blobs, tmp_path, anisotropy):
    _, aff, _ = blobs
    seg = jinf.affinities_to_segmentation(aff, min_segment_size=20)
    skels = inference.segmentation_to_zipped_swcs(
        seg, str(tmp_path / "port.zip"), anisotropy=anisotropy)
    want = jinf.segmentation_to_zipped_swcs(
        seg, str(tmp_path / "jax.zip"), anisotropy=anisotropy)
    names, entries = _zip_entries(tmp_path / "port.zip")
    want_names, want_entries = _zip_entries(tmp_path / "jax.zip")
    assert names == want_names == ["1.swc", "2.swc", "3.swc"]
    assert entries == want_entries
    parity_line(f"zip entries {anisotropy}", bytes_equal=True)
    _same(f"voxelize_skeletons {anisotropy}",
          inference.voxelize_skeletons(skels, seg.shape),
          jinf.voxelize_skeletons(want, seg.shape))
    inference.skeletons_to_zipped_swcs(skels, str(tmp_path / "again.zip"))
    assert _zip_entries(tmp_path / "again.zip")[1] == entries


def test_e2e_predict_segment_zip_equals_jax(tmp_path):
    """Port ``predict`` at width 0.25 with 32^3 patches on the 64^3 volume
    of ``tests/test_e2e.py``; its affinities and the oracle affinities
    segment and skeletonize the same in both packages."""
    img, lab = synthetic_volume()
    model = inference.load_model(affinity_mode=True, device="cpu",
                                 width_multiplier=0.25)
    aff = inference.predict(img, model, patch_shape=(32, 32, 32),
                            overlap=(8, 8, 8), trim=4, batch_size=4,
                            verbose=False)
    assert aff.shape == (3,) + img.shape and aff.dtype == np.float32
    _same("e2e segment of the port's predicted affinities",
          inference.affinities_to_segmentation(aff),
          jinf.affinities_to_segmentation(aff))

    oracle = affinities.affinity_channels(torch.from_numpy(lab)).numpy()
    seg = inference.affinities_to_segmentation(oracle, min_segment_size=50)
    want = jinf.affinities_to_segmentation(oracle, min_segment_size=50)
    _same("e2e segment of the oracle affinities", seg, want)
    assert set(np.unique(seg)) == {0, 1, 2}
    skels = inference.segmentation_to_zipped_swcs(seg,
                                                  str(tmp_path / "p.zip"))
    jinf.segmentation_to_zipped_swcs(want, str(tmp_path / "j.zip"))
    names, entries = _zip_entries(tmp_path / "p.zip")
    assert sorted(names) == ["1.swc", "2.swc"]
    assert entries == _zip_entries(tmp_path / "j.zip")[1]
    parity_line("e2e zip entries", bytes_equal=True)
    vox = inference.voxelize_skeletons(skels, seg.shape)
    assert set(np.unique(vox).tolist()) - {0} == {1, 2}
    for i in (1, 2):
        assert (seg[vox == i] == i).all()


# --- affinity channels ---------------------------------------------------


EDGE_SETS = {
    "default": affinities.DEFAULT_EDGES,
    "negative": ((-1, 0, 0), (0, -1, 0), (0, 0, -1)),
    "xzy": ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
}


@pytest.mark.parametrize("edges", list(EDGE_SETS), ids=list(EDGE_SETS))
def test_affinity_channels_equal_jax(edges):
    lab = np.random.default_rng(6).integers(0, 4, (12, 10, 9)).astype(
        np.int32)
    lab[3:9, 2:8, 1:7] = 5  # a block, so most edges are inside a label
    e = EDGE_SETS[edges]
    host = affinities.affinity_channels(torch.from_numpy(lab), e,
                                        dtype=torch.float64)
    _same(f"affinity_channels float64 == host {edges}", host.numpy(),
          jaff.get_affinity_channels(lab, e))
    dev = affinities.affinity_channels(torch.from_numpy(lab), e)
    assert dev.dtype == torch.float32
    _same(f"affinity_channels {edges}", dev.numpy(),
          np.asarray(jaff.affinity_channels_jax(jnp.asarray(lab), e)))


def test_offset_masks_and_bad_edge_equal_jax():
    """One edge at a time against the JAX host mask (its offset-mask
    compare), in the label dtype; a non-unit edge raises in both."""
    lab = np.random.default_rng(7).integers(0, 3, (6, 5, 4)).astype(np.int32)
    for edge in ((1, 0, 0), (0, -1, 0), (0, 0, 1)):
        got = affinities.affinity_channels(torch.from_numpy(lab), (edge,),
                                           dtype=torch.int32)[0]
        _same(f"affinity_channels one edge {edge}", got.numpy(),
              jaff.get_affinity_mask(lab, edge))
    with pytest.raises(ValueError):
        jaff.get_affinity_mask(lab, (1, 1, 0))
    with pytest.raises(ValueError):
        affinities.affinity_channels(torch.from_numpy(lab), ((1, 1, 0),))
