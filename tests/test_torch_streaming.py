"""The port's beyond-RAM path against the JAX package's, on the CPU.

Lazy (zarr) inputs go through the streaming percentile, the slab digest,
lazy and ``out_path`` ``predict``, the slab-streaming segmentation and
lazy TEASAR of both packages. Host outputs are held bit for bit: the
percentiles, digest bytes, labels, skeleton arrays and zip entries equal
the JAX package's and the port's own dense path. Lazy ``predict`` is
held to its dense call at atol 2e-6 (the slab loads normalize the same
values in another order). Each comparison prints a ``{"parity": ...}``
line (``pytest -s``).
"""

import zipfile

import numpy as np
import pytest
import torch

from aind_exaspim_neuron_segmentation_tpu import io as jio
from aind_exaspim_neuron_segmentation_tpu.core.normalize import (
    streaming_percentile as jstreaming_percentile,
)
from aind_exaspim_neuron_segmentation_tpu.ops import predigest as jpredigest
from aind_exaspim_neuron_segmentation_tpu.postprocess import skeleton as jskel
from aind_exaspim_neuron_segmentation_tpu.postprocess import (
    streaming as jstreaming,
)
from aind_exaspim_neuron_segmentation_tpu_torch import (
    inference,
    io,
    native,
    postprocess,
)
from aind_exaspim_neuron_segmentation_tpu_torch.core.normalize import (
    streaming_percentile,
)
from aind_exaspim_neuron_segmentation_tpu_torch.io.zarr_lite import write_zarr
from aind_exaspim_neuron_segmentation_tpu_torch.ops import predigest
from aind_exaspim_neuron_segmentation_tpu_torch.postprocess import skeleton
from tests.test_predigest import _noisy_affs
from tests.test_streamseg import _blobby_affs
from tests.test_torch_gpu import parity_line

torch.set_num_threads(1)

PKW = dict(patch_shape=(32, 32, 32), overlap=(16, 16, 16), trim=4,
           batch_size=2, verbose=False)


def _same(what, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=what)
    parity_line(what, bytes_equal=True)


def _lazy(tmp_path, arr, name, chunks=None):
    path = str(tmp_path / name)
    write_zarr(path, arr, chunks=chunks or (8,) * arr.ndim)
    return io.read(path), jio.read(path)


# --- streaming percentile and the slab digest -----------------------------


@pytest.mark.parametrize("percentiles", [(1, 99.9), (0, 50, 100), (37.5,)],
                         ids=["default", "0_50_100", "37.5"])
@pytest.mark.parametrize("kind", ["uint16", "float32_ties"])
def test_streaming_percentile_equals_jax(tmp_path, kind, percentiles):
    rng = np.random.default_rng(4)
    if kind == "uint16":
        vol = rng.integers(0, 1600, (21, 18, 16)).astype(np.uint16)
    else:
        vol = rng.normal(0, 2, (21, 18, 16)).astype(np.float32)
        vol[::3] = np.round(vol[::3], 1)  # ties and repeated keys
    handle, jhandle = _lazy(tmp_path, vol, "v.zarr")
    clip = lambda b: np.minimum(b, 1000)  # noqa: E731
    got = streaming_percentile(handle, percentiles, transform=clip,
                               chunk_planes=5)
    want = jstreaming_percentile(jhandle, percentiles, transform=clip,
                                 chunk_planes=5)
    _same(f"streaming_percentile {kind} {percentiles}", got, want)
    np.testing.assert_allclose(
        got, np.percentile(np.minimum(vol, 1000), percentiles),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("slab_planes", [None, 1, 5, 7])
def test_predigest_streaming_equals_jax_and_dense(tmp_path, slab_planes):
    aff = _noisy_affs((19, 14, 12), seed=5)
    handle, jhandle = _lazy(tmp_path, aff, "aff.zarr", chunks=(3, 6, 14, 12))
    got = predigest.predigest_streaming(handle, slab_planes=slab_planes,
                                        device="cpu")
    want = jpredigest.predigest_streaming(jhandle, slab_planes=slab_planes)
    dense = predigest.predigest(aff, device="cpu")
    for name, g, w, d in zip(("plan", "qaff"), got, want, dense):
        _same(f"predigest_streaming {name} slab {slab_planes}", g, w)
        _same(f"predigest_streaming {name} == dense", g, d)


# --- lazy and out_path predict ------------------------------------------


@pytest.fixture(scope="module")
def runner():
    return inference.load_model(device="cpu", width_multiplier=0.25)


@pytest.fixture(scope="module")
def vol():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 300, (40, 36, 32)).astype(np.uint16)
    v[10:30, 12:24, 8:24] += 900
    return v


@pytest.mark.parametrize("case", ["lazy", "lazy_5d", "lazy_slabbed",
                                  "out_path", "out_path_slabbed",
                                  "out_path_mask", "out_path_pair",
                                  "tensor"])
def test_lazy_and_out_path_predict_equal_dense(runner, vol, tmp_path, case):
    """Lazy input and ``out_path`` stores hold the dense call's result;
    a CPU tensor volume is dense and returns numpy."""
    mask = case == "out_path_mask"
    model = (inference.load_model(device="cpu", width_multiplier=0.25,
                                  affinity_mode=False) if mask else runner)
    kw = dict(PKW, affinity_mode=not mask)
    rows = 1 if case.endswith("slabbed") else None
    if case == "out_path_pair":
        want = inference.predict(vol, model, predigest=True, **kw)
        paths = (str(tmp_path / "plan.zarr"), str(tmp_path / "qaff.zarr"))
        got = inference.predict(_lazy(tmp_path, vol, "v.zarr")[0], model,
                                predigest=True, out_path=paths,
                                max_slab_rows=1, **kw)
        for name, g, w in zip(("plan", "qaff"), got, want):
            assert isinstance(g, io.zarr_lite.LazyArray)
            _same(f"predict out_path digest {name} == in RAM", g[:], w)
        return
    want = inference.predict(vol, model, **kw)
    if case == "tensor":
        got = inference.predict(torch.from_numpy(vol.astype(np.int32)),
                                model, **kw)
        assert isinstance(got, np.ndarray)
        _same("predict CPU tensor == numpy", got, want)
        return
    src = vol[None, None] if case == "lazy_5d" else vol
    handle = _lazy(tmp_path, src, "v.zarr")[0]
    out = (str(tmp_path / "out.zarr") if case.startswith("out_path")
           else None)
    got = inference.predict(handle, model, out_path=out, max_slab_rows=rows,
                            **kw)
    if out is not None:
        assert isinstance(got, io.zarr_lite.LazyArray)
        got = got[:]
    assert got.shape == want.shape and got.dtype == np.float32
    fig = parity_line(f"predict {case} vs dense", got, want)
    assert fig["max_abs"] <= 2e-6


@pytest.mark.parametrize("pair", [False, True], ids=["float", "pair"])
def test_predict_empty_grid_out_path_writes_stores(runner, tmp_path, pair):
    vol = np.zeros((40, 6, 32), np.uint16)
    out = ((str(tmp_path / "p.zarr"), str(tmp_path / "q.zarr")) if pair
           else str(tmp_path / "a.zarr"))
    got = inference.predict(vol, runner, predigest=pair, out_path=out, **PKW)
    got = got if pair else (got,)
    shapes = [(40, 6, 32), (3, 40, 6, 32)] if pair else [(3, 40, 6, 32)]
    for g, shape in zip(got, shapes):
        assert isinstance(g, io.zarr_lite.LazyArray) and g.shape == shape
        assert not g[:].any()


def test_predict_digest_needs_two_stores(runner):
    with pytest.raises(ValueError, match="TWO stores"):
        inference.predict(np.zeros((40, 40, 40), np.float32), runner,
                          predigest=True, out_path="single.zarr", **PKW)


# --- the slab-streaming segmentation ------------------------------------


def _u_shape():
    """A fragment down and back up across slab boundaries (slab 4): two
    columns join only through a bar in the third slab."""
    aff = np.full((3, 12, 9, 9), 0.02, np.float32)
    aff[0, 0:10, 2, 2] = 0.95
    aff[0, 0:10, 2, 6] = 0.95
    aff[2, 9, 2, 2:6] = 0.95
    return aff


SEGMENT_CASES = {
    # name: (affinities, slab_planes, segment kwargs)
    "noisy_slab_default": (lambda: _noisy_affs((22, 18, 14), seed=11),
                           None, {}),
    "noisy_slab7": (lambda: _noisy_affs((22, 18, 14), seed=11), 7, {}),
    "noisy_slab1": (lambda: _noisy_affs((22, 18, 14), seed=11), 1, {}),
    "blobby_slab6": (_blobby_affs, 6, {}),
    "u_shape_slab4": (_u_shape, 4, dict(min_segment_size=0)),
    "min_size5_slab5": (lambda: _blobby_affs((30, 20, 20), r=4, seed=9,
                                             step=10), 5,
                        dict(min_segment_size=5)),
    "thresholds_lowhigh_slab4": (
        lambda: _noisy_affs((18, 14, 12), seed=13), 4,
        dict(agglomeration_thresholds=(0.3, 0.7), aff_threshold_low=0.25,
             aff_threshold_high=0.9)),
    "all_background_slab3": (lambda: np.full((3, 10, 8, 8), 0.01,
                                             np.float32), 3, {}),
}


@pytest.mark.parametrize("case,form", [
    (case, form) for case in sorted(SEGMENT_CASES)
    for form in ("float", "pair", "float_out_path", "pair_out_path")
    # a digest pair bakes the default low/high thresholds
    if not (form.startswith("pair") and "lowhigh" in case)
])
def test_segment_streaming_equals_jax_and_dense(tmp_path, case, form):
    make, slab, kw = SEGMENT_CASES[case]
    aff = make()
    dense = inference.affinities_to_segmentation(aff, **kw)
    if form.startswith("pair"):
        plan, qaff = predigest.predigest(aff, device="cpu")
        (p, jp), (q, jq) = (_lazy(tmp_path, plan, "plan.zarr"),
                            _lazy(tmp_path, qaff, "qaff.zarr"))
        handle, jhandle = (p, q), (jp, jq)
    else:
        handle, jhandle = _lazy(tmp_path, aff, "aff.zarr",
                                chunks=(3, 5) + aff.shape[2:])
    out = (str(tmp_path / "seg.zarr") if form.endswith("out_path")
           else None)
    got = postprocess.segment_streaming(handle, slab_planes=slab,
                                        out_path=out, tmp_dir=str(tmp_path),
                                        device="cpu", **kw)
    if out is not None:
        assert isinstance(got, io.zarr_lite.LazyArray)
        got = got[:]
    want = jstreaming.segment_streaming(jhandle, slab_planes=slab, **kw)
    _same(f"segment_streaming {case} {form}", got, want)
    _same(f"segment_streaming {case} {form} == dense", got, dense)
    if case == "u_shape_slab4":
        assert got.max() == 1
    if case.startswith("all_background"):
        assert got.max() == 0


def test_affinities_to_segmentation_streams_lazy_handles(tmp_path, capfd):
    aff = _blobby_affs((24, 16, 16), r=4, seed=21, step=10)
    want = inference.affinities_to_segmentation(aff)
    handle, _ = _lazy(tmp_path, aff, "aff.zarr")
    got = inference.affinities_to_segmentation(
        handle, out_path=str(tmp_path / "seg.zarr"), tmp_dir=str(tmp_path),
        verbose=True, device="cpu")
    assert "merge done" in capfd.readouterr().err
    _same("affinities_to_segmentation lazy float out_path", got[:], want)
    assert want.max() > 1


@pytest.mark.parametrize("bad", ["low_above_high", "pair_thresholds",
                                 "pair_shapes", "handle_rank"])
def test_segment_streaming_rejects_like_jax(tmp_path, bad):
    aff = _noisy_affs((8, 8, 8))
    handle, jhandle = _lazy(tmp_path, aff, "aff.zarr")
    plan, qaff = predigest.predigest(aff, device="cpu")
    args, kw, match = (handle,), {}, "low"
    if bad == "low_above_high":
        kw = dict(aff_threshold_low=0.9, aff_threshold_high=0.2)
    elif bad == "pair_thresholds":
        pair = (_lazy(tmp_path, plan, "p.zarr")[0],
                _lazy(tmp_path, qaff, "q.zarr")[0])
        args, kw, match = (pair,), dict(aff_threshold_low=0.3), "baked"
    elif bad == "pair_shapes":
        pair = (_lazy(tmp_path, plan[:4], "p.zarr")[0],
                _lazy(tmp_path, qaff, "q.zarr")[0])
        args, match = (pair,), "do not match"
    else:
        args, match = (_lazy(tmp_path, aff[0], "a3.zarr")[0],), "expected"
    with pytest.raises(ValueError, match=match):
        inference.affinities_to_segmentation(*args, device="cpu", **kw)


def test_stream_segmenter_call_order_enforced():
    seg = native.StreamSegmenter((4, 4, 4))
    plan = np.zeros((2, 4, 4), np.uint8)
    seg.feed(plan)
    with pytest.raises(RuntimeError):  # rag before fragments_done
        seg.rag_feed(np.zeros((2, 4, 4), np.uint32),
                     np.zeros((2, 3, 4, 4), np.uint8))
    with pytest.raises(RuntimeError):  # incomplete cover
        seg.fragments_done()
    seg.feed(plan)
    with pytest.raises(RuntimeError):  # overfeed
        seg.feed(plan)
    assert seg.fragments_done() == 0
    with pytest.raises(RuntimeError):  # map before merge
        seg.map(np.zeros((2, 4, 4), np.uint32))
    seg.close()
    with pytest.raises(ValueError):
        native.StreamSegmenter((0, 4, 4))


# --- lazy TEASAR ----------------------------------------------------------


@pytest.fixture(scope="module")
def labels():
    """Two tubes, a soma-sized ball touching the volume face and a
    two-component label, uint32 (30, 28, 26)."""
    lab = np.zeros((30, 28, 26), np.uint32)
    lab[3:27, 4:7, 4:7] = 5
    lab[12:15, 2:26, 18:21] = 2
    zz, yy, xx = np.ogrid[:30, :28, :26]
    lab[(zz - 22) ** 2 + (yy - 20) ** 2 + (xx - 0) ** 2 <= 30] = 9
    lab[2:5, 20:25, 10:13] = 7
    lab[25:28, 20:25, 10:13] = 7
    return lab


@pytest.mark.parametrize("slab_planes", [64, 7])
def test_skeletonize_lazy_equals_jax_and_dense(tmp_path, labels,
                                               slab_planes):
    handle, jhandle = _lazy(tmp_path, labels, "seg.zarr")
    got = skeleton.skeletonize_lazy(handle, slab_planes=slab_planes)
    want = jskel.skeletonize_lazy(jhandle, slab_planes=slab_planes)
    dense = skeleton.skeletonize(labels)
    assert sorted(got) == sorted(want) == sorted(dense) == [2, 5, 7, 9]
    for lab in got:
        for field in ("vertices", "radii", "edges"):
            _same(f"skeletonize_lazy slab {slab_planes} {lab} {field}",
                  getattr(got[lab], field), getattr(want[lab], field))
            _same(f"skeletonize_lazy {lab} {field} == dense",
                  getattr(got[lab], field), getattr(dense[lab], field))


def _zip_entries(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def test_lazy_zip_entries_equal_dense(tmp_path, labels):
    """The lazy path writes labels in id order, the dense one in the
    engine's order: the entries, name by name, are the same bytes."""
    handle, _ = _lazy(tmp_path, labels, "seg.zarr")
    inference.segmentation_to_zipped_swcs(handle, tmp_path / "lazy.zip")
    inference.segmentation_to_zipped_swcs(labels, tmp_path / "dense.zip")
    got = _zip_entries(tmp_path / "lazy.zip")
    assert got == _zip_entries(tmp_path / "dense.zip")
    assert sorted(got) == ["2.swc", "5.swc", "7.swc", "9.swc"]
    parity_line("lazy zip entries == dense", entries=len(got),
                bytes_equal=True)
