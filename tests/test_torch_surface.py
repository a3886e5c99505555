"""The port's public surface against the JAX package's, on the CPU.

For every module the two packages share (same relative path), every
public function and class the JAX module defines must exist in the port
with the same parameter names, kinds and defaults, in order. The port may
add one parameter the JAX package has no use for, ``device`` (where the
work runs; ``Trainer(device=)`` among them). Listed below, each with its
reason, are the names the port has by another design (the framework's
own model and weight types); the test also checks that each listed name
is still a JAX name of a shared module, so the list stays exact. Then
the keywords this surface once dropped are held to the
JAX package's meaning: ``skeletonize(parallel=...)`` gives the same
skeletons for any thread count, ``segment_streaming(quantile_pct=...)``
and ``bbox_scan(labels, z_lo, z_hi)`` equal the JAX package's output.
"""

import importlib
import inspect
import os
import zipfile

import numpy as np
import pytest

from aind_exaspim_neuron_segmentation_tpu import io as jio
from aind_exaspim_neuron_segmentation_tpu.postprocess import skeleton as jskel
from aind_exaspim_neuron_segmentation_tpu.postprocess import (
    streaming as jstreaming,
)
from aind_exaspim_neuron_segmentation_tpu_torch import inference, io
from aind_exaspim_neuron_segmentation_tpu_torch.io.zarr_lite import write_zarr
from aind_exaspim_neuron_segmentation_tpu_torch.postprocess import (
    skeleton,
    streaming,
)
from tests.test_streamseg import _noisy_affs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "aind_exaspim_neuron_segmentation_tpu"
PORT = JAX_PKG + "_torch"
PORT_ONLY = ("device",)

# By design: the JAX package's Flax / jnp types and their converters,
# which the port replaces with PyTorch's own (the port's names are given).
BY_DESIGN = {
    # Flax modules are dataclasses (dtype, parent, name fields, input
    # channels inferred); torch modules take their input channels
    "models.UNet3D": "torch nn.Module", "models.unet3d.UNet3D": "same",
    "inference.UNet3D": "same", "machine_learning.train.UNet3D": "same",
    "models.unet3d.DoubleConv": "same", "models.unet3d.Down": "same",
    "models.unet3d.Up": "same", "models.DoubleConv": "same",
    "models.Down": "same", "models.Up": "same",
    "models.BatchNorm3d": "torch.nn.BatchNorm3d",
    "models.unet3d.BatchNorm3d": "torch.nn.BatchNorm3d",
    "models.init_unet3d": "models.unet3d.init_weights",
    "models.unet3d.init_unet3d": "models.unet3d.init_weights",
    # a torch module holds its weights; Flax keeps them apart
    "inference.ModelRunner": "ModelRunner(module)",
    "parallel.sharded_inference.ModelRunner": "ModelRunner(module)",
    "ops.stitch.accumulate_predictions": "(module, volume, ...)",
    "ops.stitch.accumulate_core": "ops.stitch.accumulate_predictions",
    "inference.fold_batchnorm": "fold_batchnorm(state_dict)",
    "models.convert.fold_batchnorm": "fold_batchnorm(state_dict)",
    # Flax <-> torch weight converters: the port reads .pth natively
    "inference.load_pth_variables": "models.convert.load_pth",
    "models.load_pth_variables": "models.convert.load_pth",
    "models.convert.load_pth_variables": "models.convert.load_pth",
    "models.save_pth_checkpoint": "torch.save(module.state_dict())",
    "models.convert.save_pth_checkpoint": "same",
    "machine_learning.train.save_pth_checkpoint": "same",
    "models.torch_state_dict_to_variables": "identity in torch",
    "models.convert.torch_state_dict_to_variables": "identity in torch",
    "models.variables_to_torch_state_dict": "identity in torch",
    "models.convert.variables_to_torch_state_dict": "identity in torch",
    # jnp functions, named for JAX; the port's take torch tensors
    "core.affinity_channels_jax": "core.affinity_channels",
    "core.affinities.affinity_channels_jax": "core.affinity_channels",
    "core.normalize.normalize_jax": "core.normalize.normalize_device",
    "core.normalize.preprocess_jax": "core.normalize.preprocess_device",
    "ops.augment_device.augment_batch": "ops.augment_device.apply_augment",
    # the port has one tracing primitive, annotate(); a profile of its
    # spans is torch.profiler.profile's own (export_chrome_trace)
    "utils.profiling.trace": "torch.profiler.profile",
}
# JAX lazy-import wrappers ``f(x, **kwargs)``: the function they forward
# to is the surface.
FORWARDS = {
    "postprocess.skeletonize": "postprocess.skeleton.skeletonize",
    "postprocess.segment_streaming": "postprocess.streaming.segment_streaming",
    "postprocess.segment_streaming_sharded":
        "postprocess.distributed.segment_streaming_sharded",
    "postprocess.skeletonize_sharded":
        "postprocess.distributed.skeletonize_sharded",
}


def _modules(pkg):
    root = os.path.join(REPO, pkg)
    out = set()
    for path, _, names in os.walk(root):
        for name in names:
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(path, name), root)[:-3]
                rel = rel.replace(os.sep, ".")
                out.add(rel[: -len("__init__")].rstrip(".")
                        if rel.endswith("__init__") else rel)
    return out


def _import(pkg, rel):
    return importlib.import_module(pkg + ("." + rel if rel else ""))


def _public(module):
    """Public functions and classes a JAX module defines or re-exports
    from its own package."""
    for name, obj in sorted(vars(module).items()):
        if name.startswith("_"):
            continue
        if not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue
        if getattr(obj, "__module__", "").split(".")[0] == JAX_PKG:
            yield name, obj


def _params(fn):
    def default(p):
        if p.default is inspect.Parameter.empty:
            return "<none>"
        return "<callable>" if callable(p.default) else p.default

    return [(p.name, p.kind, default(p))
            for p in inspect.signature(fn).parameters.values()]


def _shared():
    """(qualified name, JAX object, port object or None) of every public
    name of the modules both packages have."""
    for rel in sorted(_modules(JAX_PKG) & _modules(PORT)):
        jmod, pmod = _import(JAX_PKG, rel), _import(PORT, rel)
        for name, obj in _public(jmod):
            yield (f"{rel}.{name}" if rel else name), obj, getattr(
                pmod, name, None)


def test_signatures_match_jax():
    mismatched, missing, checked = [], [], 0
    for qual, jobj, pobj in _shared():
        if qual in BY_DESIGN:
            continue
        if pobj is None:
            missing.append(qual)
            continue
        if qual in FORWARDS:
            target, name = FORWARDS[qual].rsplit(".", 1)
            jobj = getattr(_import(JAX_PKG, target), name)
        want = _params(jobj)
        added = set(PORT_ONLY) - {p[0] for p in want}
        got = [p for p in _params(pobj) if p[0] not in added]
        if got != want:
            mismatched.append((qual, want, got))
        checked += 1
    assert not missing, f"JAX names missing in the port: {missing}"
    assert not mismatched, "\n".join(
        f"{q}:\n  JAX  {w}\n  port {g}" for q, w, g in mismatched)
    assert checked > 100


def test_listed_gaps_are_still_gaps():
    shared = {qual: pobj for qual, _, pobj in _shared()}
    for qual in list(BY_DESIGN) + list(FORWARDS):
        assert qual in shared, f"{qual} is no JAX name of a shared module"


def _labels():
    lab = np.zeros((30, 28, 26), np.uint32)
    lab[3:27, 4:7, 4:7] = 5
    lab[12:15, 2:26, 18:21] = 2
    zz, yy, xx = np.ogrid[:30, :28, :26]
    lab[(zz - 22) ** 2 + (yy - 20) ** 2 + (xx - 0) ** 2 <= 30] = 9
    lab[2:5, 20:25, 10:13] = 7
    lab[25:28, 20:25, 10:13] = 7
    lab[14:20, 14:20, 2:24] = 11
    return lab


def _swcs(skels):
    return {k: v.to_swc() for k, v in skels.items()}


@pytest.mark.parametrize("form", ["dense", "lazy"])
def test_skeletonize_parallel_threads_same_output(tmp_path, form):
    lab = _labels()
    path = str(tmp_path / "lab.zarr")
    write_zarr(path, lab, chunks=(8, 28, 26))
    seg, jseg = (lab, lab) if form == "dense" else (io.read(path),
                                                    jio.read(path))
    one = skeleton.skeletonize(seg, parallel=1, slab_planes=7)
    three = skeleton.skeletonize(seg, parallel=3, max_paths=5,
                                 slab_planes=7)
    want = jskel.skeletonize(jseg, parallel=3, slab_planes=7)
    assert sorted(one) == [2, 5, 7, 9, 11]
    assert _swcs(one) == _swcs(three) == _swcs(want)
    zp = tmp_path / "a.zip"
    inference.segmentation_to_zipped_swcs(seg, zp)
    with zipfile.ZipFile(zp) as zf:
        assert sorted(zf.namelist()) == [f"{k}.swc" for k in
                                         sorted(one, key=str)]


def test_segment_streaming_quantile_pct_equals_jax(tmp_path):
    aff = _noisy_affs(shape=(18, 14, 12), seed=13)
    path = str(tmp_path / "aff.zarr")
    write_zarr(path, aff, chunks=(3, 6, 14, 12))
    for q in (50, 85):
        got = streaming.segment_streaming(io.read(path), quantile_pct=q,
                                          slab_planes=5, device="cpu")
        want = jstreaming.segment_streaming(jio.read(path), quantile_pct=q,
                                            slab_planes=5)
        np.testing.assert_array_equal(got, want)


def test_bbox_scan_z_range_equals_jax_and_merges():
    lab = _labels()
    whole = skeleton.bbox_scan(lab, 0, lab.shape[0], 7)
    jwhole = jskel.bbox_scan(lab, 0, lab.shape[0], 7)
    for got, want in zip(whole[:2], jwhole[:2]):
        np.testing.assert_array_equal(got, want)
    assert whole[2:] == jwhole[2:]
    parts = [skeleton.bbox_scan(lab, lo, hi, 4)
             for lo, hi in ((0, 9), (9, 23), (23, 30))]
    for (lo, hi), part in zip(((0, 9), (9, 23), (23, 30)), parts):
        jpart = jskel.bbox_scan(lab, lo, hi, 4)
        np.testing.assert_array_equal(part[0], jpart[0])
        np.testing.assert_array_equal(part[1], jpart[1])
    n = max(len(p[1]) for p in parts)
    counts = sum(np.pad(p[1], (0, n - len(p[1]))) for p in parts)
    np.testing.assert_array_equal(counts[: len(whole[1])], whole[1])
    assert skeleton.bbox_scan(lab, 5, 5)[2:] == (None, None)
