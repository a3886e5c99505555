"""Inference: ``load_model`` -> ``predict`` on the GPU, then the host tail
``affinities_to_segmentation`` -> ``segmentation_to_zipped_swcs``.

The public surface and numbers follow the JAX package's ``inference``
module: ``predict`` returns ``(3, D, H, W)`` float32 affinities, or
``(D, H, W)`` in mask mode, or the u8 ``(plan, qaff)`` digest pair with
``predigest=True``; either affinity form segments on the host through the
port's C++ engine (:mod:`.native`, :mod:`.postprocess`) into labels that
skeletonize into a ZIP of SWC files. The sliding window runs on the device
(:mod:`.ops.stitch`), streaming the volume in Z slabs when it exceeds the
accumulator budget; slab boundaries recompute the overlapping patch rows,
so every output voxel is final without host-side blending.

Everything runs on ``cuda`` unless the caller passes ``device="cpu"``;
a CUDA request without a CUDA device raises, it never falls back.
"""

import sys
import zipfile

import numpy as np
import torch

from aind_exaspim_neuron_segmentation_tpu_torch import native, postprocess
from aind_exaspim_neuron_segmentation_tpu_torch.core.normalize import (
    DEFAULT_PERCENTILES,
    normalize,
)
from aind_exaspim_neuron_segmentation_tpu_torch.core.patches import (
    count_patches,  # noqa: F401  (re-export)
    generate_patch_starts,  # noqa: F401  (re-export)
    patch_grid_ranges,
)
from aind_exaspim_neuron_segmentation_tpu_torch.models.convert import (
    fold_batchnorm,
    load_pth,
)
from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import (
    UNet3D,
    init_weights,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops import stitch
from aind_exaspim_neuron_segmentation_tpu_torch.ops.predigest import (
    predigest_slab,
)


def resolve_device(device=None):
    """``torch.device`` for ``device`` (default ``cuda``); raises if CUDA
    is requested and unavailable."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; pass "
            "device='cpu' to run on the host"
        )
    return device


class ModelRunner:
    """A UNet3D module bound for inference (eval mode, fixed device)."""

    def __init__(self, module):
        self.module = module.eval()

    @property
    def output_channels(self):
        """Number of prediction channels (3 affinity or 1 mask)."""
        return self.module.output_channels

    @property
    def device(self):
        """Device of the module's parameters."""
        return next(self.module.parameters()).device

    def __call__(self, x):
        """Forward float32 logits for a (N, 1, D, H, W) or (N, D, H, W, 1)
        batch, answered in the layout it was given."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        x = x.to(self.device, torch.float32)
        channels_first = x.shape[1] == 1 and x.shape[-1] != 1
        if not channels_first:
            x = x.movedim(-1, 1)
        with torch.inference_mode():
            out = self.module(x)
        return out if channels_first else out.movedim(1, -1)


def load_model(path=None, affinity_mode=True, device=None, dtype=None,
               width_multiplier=1, trilinear=True, fold_bn=None):
    """Build a UNet3D runner, optionally restoring a ``.pth`` checkpoint.

    3 output channels in affinity mode, 1 for foreground/background; eval
    mode. ``device`` defaults to ``cuda`` (raises without one). ``dtype``
    is the activation and weight dtype: bfloat16 on CUDA, float32 on the
    CPU by default. ``path=None`` draws random weights from a
    ``torch.Generator`` seeded 0 (benchmarks and smoke tests).

    ``fold_bn`` folds eval-mode BatchNorm into the conv weights
    (:func:`~.models.convert.fold_batchnorm`); default: on for bfloat16,
    off for float32.
    """
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if fold_bn is None:
        fold_bn = dtype == torch.bfloat16
    kw = dict(
        output_channels=3 if affinity_mode else 1, trilinear=trilinear,
        width_multiplier=width_multiplier,
    )
    module = UNet3D(**kw)
    if path is not None:
        load_pth(path, module)
    else:
        init_weights(module, torch.Generator().manual_seed(0))
    if fold_bn:
        folded = fold_batchnorm(module.state_dict(), trilinear=trilinear)
        module = UNet3D(fused_bn=True, **kw)
        module.load_state_dict(folded, strict=True)
    return ModelRunner(module.to(device=device, dtype=dtype))


def to_tensor(arr, device=None):
    """Expand to (1, 1, D, H, W) float32 on ``device`` (default ``cuda``)."""
    t = torch.as_tensor(np.asarray(arr, dtype=np.float32))
    while t.dim() < 5:
        t = t[None]
    return t.to(resolve_device(device))


def _slab_plan(z_starts, patch_z, trim, dim_z, max_rows, stride=None):
    """Split z-start rows into slabs of <= max_rows owned rows.

    Each slab recomputes the trailing rows of the previous slab whose
    trimmed output reaches into its owned range -- ``back`` rows, where
    back = ceil(core / stride) - 1 and core = patch - 2*trim (one row for
    the default 96/32/8 grid). Only the owned output range ``[own_lo,
    own_hi)`` is kept; the union of owned ranges covers ``[0, dim_z)``.
    """
    plans = []
    n = len(z_starts)
    if stride is None:
        stride = z_starts[1] - z_starts[0] if n > 1 else patch_z
    core = patch_z - 2 * trim
    back = max(-(-core // stride) - 1, 0) if stride > 0 else 0
    for i0 in range(0, n, max_rows):
        i1 = min(i0 + max_rows, n)
        rows = list(range(max(i0 - back, 0), i1))
        own_lo = 0 if i0 == 0 else z_starts[i0] + trim
        own_hi = dim_z if i1 == n else z_starts[i1] + trim
        in_lo = z_starts[rows[0]]
        in_hi = z_starts[rows[-1]] + patch_z
        plans.append(
            dict(rows=rows, own=(own_lo, own_hi), in_range=(in_lo, in_hi))
        )
    return plans


def _to_host_async(tensors):
    """Start copying device tensors to the host; returns (copies, event).

    On CUDA the copies are queued on the current stream into pinned
    memory and ``event`` marks their end; the caller synchronizes on it
    before reading. On the CPU the tensors are returned as they are.
    """
    if tensors[0].device.type != "cuda":
        return tensors, None
    copies = tuple(t.to("cpu", non_blocking=True) for t in tensors)
    event = torch.cuda.Event()
    event.record()
    return copies, event


@torch.inference_mode()
def predict(
    img,
    model,
    affinity_mode=True,
    batch_size=16,
    brightness_clip=1000,
    normalization_percentiles=DEFAULT_PERCENTILES,
    patch_shape=(96, 96, 96),
    overlap=(32, 32, 32),
    trim=8,
    verbose=True,
    max_slab_rows=None,
    blend_mode="uniform",
    blend_sigma=None,
    out_path=None,
    predigest=False,
):
    """Sliding-window affinity / foreground prediction.

    Brightness clip, full-volume percentile normalization (host), the
    overlapping patch grid, sigmoid, ``trim``-voxel border trim, and the
    hit-count blend (zero where never covered), as in the JAX package.

    ``img``: in-memory (D, H, W) or (1, 1, D, H, W) array. ``model``: a
    :class:`ModelRunner` (its device is where the work runs). Returns
    float32 ``(3, D, H, W)`` in affinity mode else ``(D, H, W)``.

    ``max_slab_rows`` caps how many Z patch-rows are resident on the
    device at once (default: from a ~2 GiB per-slab accumulator budget);
    slabs beyond the first recompute their boundary rows.

    ``blend_mode``: 'uniform' averages by hit count; 'gaussian' weights
    each patch by a separable gaussian window (sigma defaults to patch/6).
    Both leave never-covered voxels at exactly 0.

    ``predigest``: affinity mode only -- digest each slab on the device
    (:mod:`.ops.predigest`, default thresholds low=0.1, high=0.9999) and
    return ``(plan uint8 (D, H, W), qaff uint8 (3, D, H, W))``.

    ``out_path`` and lazy (chunked) inputs need the port's ``io/`` and
    streaming percentile, which are not ported yet (ROADMAP.md, slice 4):
    they raise ``NotImplementedError``.
    """
    if out_path is not None:
        raise NotImplementedError(
            "out_path streaming needs the port's io/ (ROADMAP.md, slice 4)"
        )
    if not isinstance(img, (np.ndarray, list, tuple)):
        raise NotImplementedError(
            "lazy (chunked) inputs need the port's io/ and streaming "
            "percentile (ROADMAP.md, slice 4); pass an in-memory array"
        )
    img = np.asarray(img)
    if img.ndim == 5:
        img = img[0, 0]
    if img.ndim != 3:
        raise ValueError(f"expected 3D or 5D input, got shape {img.shape}")

    out_channels = 3 if affinity_mode else 1
    runner = model if isinstance(model, ModelRunner) else ModelRunner(model)
    if runner.output_channels != out_channels:
        raise ValueError(
            f"model has {runner.output_channels} output channels, "
            f"affinity_mode={affinity_mode} needs {out_channels}"
        )
    if predigest and not affinity_mode:
        raise ValueError("predigest requires affinity_mode=True")
    if blend_mode not in ("uniform", "gaussian"):
        raise ValueError(f"unknown blend_mode {blend_mode!r}")

    dim = img.shape
    ranges = patch_grid_ranges(dim, patch_shape, overlap)
    if any(len(r) == 0 for r in ranges):
        # An axis shorter than the overlap yields an empty grid: no patch
        # runs and the result is zeros.
        if predigest:
            return (np.zeros(dim, np.uint8),
                    np.zeros((3,) + dim, np.uint8))
        out = np.zeros((out_channels,) + dim, np.float32)
        return out if affinity_mode else out[0]

    img = np.minimum(img, brightness_clip)
    img = normalize(img, percentiles=normalization_percentiles)
    img = np.ascontiguousarray(img, dtype=np.float32)

    device = runner.device
    host_windows = windows = None
    if blend_mode == "gaussian":
        host_windows = tuple(
            stitch.gaussian_window(p, trim, blend_sigma or p / 6.0)
            for p in patch_shape
        )
        windows = tuple(
            stitch.host_to_device(w, device) for w in host_windows
        )
    wz, wy, wx = (
        stitch.host_to_device(w, device)
        for w in stitch.separable_weights(
            dim, patch_shape, overlap, trim, windows=host_windows
        )
    )

    if max_slab_rows is None:
        # ~2 GiB f32 accumulator per slab (two slabs may be resident in
        # the fetch pipeline): out_channels * (rows*stride + patch) * H *
        # W * 4 <= budget.
        stride_z = patch_shape[0] - overlap[0]
        per_z = out_channels * dim[1] * dim[2] * 4
        max_slab_rows = max(
            (2 * 1024**3 // per_z - patch_shape[0]) // stride_z, 1
        )
    z_starts = list(ranges[0])
    plans = _slab_plan(z_starts, patch_shape[0], trim, dim[0], max_slab_rows)
    if predigest:
        plan_out = np.zeros(dim, np.uint8)
        qaff_out = np.zeros((3,) + dim, np.uint8)
    else:
        out = np.zeros((out_channels,) + dim, dtype=np.float32)

    def fetch(entry):
        own_lo, own_hi, (copies, event) = entry
        if event is not None:
            event.synchronize()
        if predigest:
            plan_out[own_lo:own_hi] = copies[0].numpy()
            qaff_out[:, own_lo:own_hi] = copies[1].numpy()
        else:
            out[:, own_lo:own_hi] = copies[0].numpy()
        if verbose:
            print(f"predict: planes [{own_lo}, {own_hi}) of {dim[0]}",
                  file=sys.stderr)

    # One-slab-deep pipeline: slab i+1's device work is queued before
    # slab i is copied out, so the device stays fed while the host
    # prepares inputs and copies results.
    pending = None
    prev_plane = None  # predigest: previous slab's last z-aff plane
    for plan in plans:
        in_lo, in_hi = plan["in_range"]
        # Pad with the REAL grid so the reflection anchors at the last
        # patch's tail segment.
        slab, _ = stitch.reflect_pad_to_grid(
            img[in_lo:min(in_hi, dim[0])], patch_shape, overlap
        )
        starts = [
            (z_starts[r] - in_lo, y, x)
            for r in plan["rows"]
            for y in ranges[1]
            for x in ranges[2]
        ]
        n_real = len(starts)
        pad_n = (-n_real) % batch_size
        starts += [starts[0]] * pad_n
        valid = np.concatenate(
            [np.ones(n_real, np.float32), np.zeros(pad_n, np.float32)]
        )
        acc = stitch.accumulate_predictions(
            runner.module,
            stitch.host_to_device(slab, device),
            np.asarray(starts, dtype=np.int32),
            valid,
            patch_shape=tuple(patch_shape),
            trim=trim,
            batch_size=batch_size,
            out_channels=out_channels,
            windows=windows,
        )
        own_lo, own_hi = plan["own"]
        blended = stitch.divide_by_weights(
            acc[:, own_lo - in_lo: own_hi - in_lo, : dim[1], : dim[2]],
            wz[own_lo:own_hi], wy, wx,
        )
        del acc
        if predigest:
            payload = predigest_slab(
                blended, prev_plane,
                first_slab=(own_lo == 0), last_slab=(own_hi == dim[0]),
            )
            prev_plane = blended[0, -1]
        else:
            payload = (blended,)
        copy = _to_host_async(payload)
        if pending is not None:
            fetch(pending)
        pending = (own_lo, own_hi, copy)
    fetch(pending)

    if predigest:
        return plan_out, qaff_out
    return out if affinity_mode else out[0]


# --- Segmentation and skeletonization (host C++ engine) ---


def _is_lazy(x):
    return not isinstance(x, (np.ndarray, torch.Tensor, list)) and (
        not hasattr(x, "__array__")
    )


_TORCH_DTYPES = {np.uint8: torch.uint8, np.float32: torch.float32}


def _host_array(x, dtype):
    """``x`` (numpy, list or a tensor on any device) as a C-contiguous
    numpy array of ``dtype``; a tensor is copied to the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", _TORCH_DTYPES[dtype]).numpy()
    return np.ascontiguousarray(x, dtype=dtype)


def affinities_to_segmentation(
    affinities,
    agglomeration_thresholds=(0.6, 0.8, 0.9),
    min_segment_size=100,
    aff_threshold_low=0.1,
    aff_threshold_high=0.9999,
    out_path=None,
):
    """Affinities -> instance segmentation, uint32 (D, H, W) on the host.

    Seeded watershed and hierarchical agglomeration over the requested
    thresholds, keeping only the final threshold's labels, then dropping
    segments of ``<= min_segment_size`` voxels and renumbering the rest
    ``1..n`` by first appearance, as the reference does.

    ``affinities`` may be:

    * float ``(3, D, H, W)`` affinities, as a numpy array or a tensor on
      any device (copied to the host);
    * the ``(plan, qaff)`` uint8 pair of ``predict(..., predigest=True)``
      or :func:`.ops.predigest.predigest_slab`, as numpy arrays or
      tensors: the host replays pure integer work, bit-identical to the
      float path on the volume they were digested from. The low/high
      thresholds are baked into the plan bytes, so non-default
      ``aff_threshold_*`` with a pair raise ``ValueError``.

    Lazy (zarr/N5) handles, for affinities or for the pair, and
    ``out_path`` streaming output need the port's ``io/`` and streaming
    engine (ROADMAP.md, slice 4): a lazy handle raises
    ``NotImplementedError``; ``out_path`` with dense input raises
    ``ValueError``, as in the JAX package.
    """
    predigested = isinstance(affinities, tuple) and len(affinities) == 2
    if _is_lazy(affinities[0] if predigested else affinities):
        raise NotImplementedError(
            "lazy (chunked) affinity handles need the port's io/ and "
            "streaming segmentation (ROADMAP.md, slice 4); pass dense "
            "affinities or the (plan, qaff) pair"
        )
    if out_path is not None:
        raise ValueError(
            "out_path streaming output requires a lazy (zarr/N5) "
            "affinity handle"
        )
    if predigested:
        if (aff_threshold_low, aff_threshold_high) != (0.1, 0.9999):
            raise ValueError(
                "aff thresholds are baked into the plan bytes at digest "
                "time; re-digest with ops.predigest for non-defaults"
            )
        seg = native.agglomerate_last_pre(
            _host_array(affinities[0], np.uint8),
            _host_array(affinities[1], np.uint8),
            list(agglomeration_thresholds),
        )
        return postprocess.remove_small_segments(seg, min_segment_size)

    seg = None
    for seg in postprocess.agglomerate(
        _host_array(affinities, np.float32),
        thresholds=list(agglomeration_thresholds),
        aff_threshold_low=aff_threshold_low,
        aff_threshold_high=aff_threshold_high,
    ):
        pass  # keep only the last threshold (reference deque maxlen=1)
    return postprocess.remove_small_segments(seg, min_segment_size)


def skeletonize(segmentation, anisotropy=(1.0, 1.0, 1.0)):
    """Segmentation -> ``{segment_id: Skeleton}`` via TEASAR, with the
    reference's kimimaro parameters: scale 1.25, const 450, pdrf exponent
    4 and scale 100000, soma detection / acceptance 1000 / 3500, soma
    invalidation 1.0 / 300, fix_borders, fill_holes, one thread."""
    return postprocess.skeletonize(
        segmentation,
        scale=1.25,
        const=450,
        pdrf_exponent=4,
        pdrf_scale=100000,
        soma_detection_threshold=1000,
        soma_acceptance_threshold=3500,
        soma_invalidation_scale=1.0,
        soma_invalidation_const=300,
        anisotropy=anisotropy,
        fix_borders=True,
        fill_holes=True,
    )


def skeletons_to_zipped_swcs(skeletons, zip_path):
    """Write one ``{id}.swc`` entry per skeleton into a ZIP archive."""
    with zipfile.ZipFile(zip_path, "w") as zf:
        for seg_id, skel in skeletons.items():
            zf.writestr(f"{seg_id}.swc", skel.to_swc())


def segmentation_to_zipped_swcs(segmentation, zip_path, anisotropy=(1, 1, 1)):
    """Segmentation -> TEASAR skeletons -> zipped SWC archive; returns the
    skeletons."""
    skeletons = skeletonize(segmentation, anisotropy=anisotropy)
    skeletons_to_zipped_swcs(skeletons, zip_path)
    return skeletons


def voxelize_skeletons(skeletons, shape):
    """Rasterize skeleton vertices (rounded) back into a uint32 label
    volume of ``shape``; the inverse of :func:`skeletonize`, used as a
    round-trip check."""
    out = np.zeros(shape, dtype=np.uint32)
    for seg_id, skel in skeletons.items():
        verts = np.round(np.asarray(skel.vertices)).astype(np.int64)
        keep = np.all((verts >= 0) & (verts < np.asarray(shape)), axis=1)
        v = verts[keep]
        out[v[:, 0], v[:, 1], v[:, 2]] = seg_id
    return out
