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

Lazy chunked inputs (``io.read`` of a zarr / N5 store) stream slab by
slab, and ``out_path`` streams every output into Zarr stores: the volume,
its affinities or digests and its labels are never dense in host RAM
(``predict`` -> ``affinities_to_segmentation`` ->
``segmentation_to_zipped_swcs`` on store handles).

Everything runs on ``cuda`` unless the caller passes ``device="cpu"``;
a CUDA request without a CUDA device raises, it never falls back.
"""

import mmap
import sys
import zipfile

import numpy as np
import torch

from aind_exaspim_neuron_segmentation_tpu_torch import native, postprocess
from aind_exaspim_neuron_segmentation_tpu_torch.core.device import (  # noqa: F401
    resolve_device,  # (re-export)
)
from aind_exaspim_neuron_segmentation_tpu_torch.core.normalize import (
    DEFAULT_PERCENTILES,
    normalize,  # noqa: F401  (re-export)
)
from aind_exaspim_neuron_segmentation_tpu_torch.core.patches import (
    count_patches,  # noqa: F401  (re-export)
    generate_patch_starts,  # noqa: F401  (re-export)
    patch_grid_ranges,
    slab_plan,
)
from aind_exaspim_neuron_segmentation_tpu_torch.io import read
from aind_exaspim_neuron_segmentation_tpu_torch.io.zarr_lite import (
    ZarrAppendWriter,
)
from aind_exaspim_neuron_segmentation_tpu_torch.models import swin_unetr
from aind_exaspim_neuron_segmentation_tpu_torch.models.convert import (
    fold_batchnorm,
)
from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import (
    UNet3D,
    init_weights,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops import prep, stitch
from aind_exaspim_neuron_segmentation_tpu_torch.ops.predigest import (
    predigest_slab,
)
from aind_exaspim_neuron_segmentation_tpu_torch.utils.profiling import (
    annotate,
)


class ModelRunner:
    """A model bound for inference (eval mode, fixed device): a UNet3D or
    a Swin UNETR, either taking ``valid_trim=`` and exposing
    ``output_channels``."""

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
    off for float32. On a CUDA device the UNet3D's conv weights are laid
    out channels-last, so its activations run NDHWC, the layout of
    cuDNN's 3D conv kernels, and no conv transposes its input or output
    (the CPU keeps NCDHW).

    A checkpoint of MONAI's ``SwinUNETR`` (its
    ``swinViT.patch_embed.proj.weight`` key) builds a
    :class:`~.models.swin_unetr.SwinUNETR` instead, every width read from
    the checkpoint's shapes (``trilinear`` and ``fold_bn`` do not apply:
    it has neither upsampling nor BatchNorm); its output channels must be
    the ones ``affinity_mode`` asks for, and ``width_multiplier`` must be
    1.
    """
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    state_dict = None
    if path is not None:
        state_dict = torch.load(path, map_location="cpu", weights_only=True)
        if swin_unetr.is_swin_unetr_state_dict(state_dict):
            return _load_swin_unetr(state_dict, affinity_mode, device,
                                    dtype, width_multiplier)
    if fold_bn is None:
        fold_bn = dtype == torch.bfloat16
    kw = dict(
        output_channels=3 if affinity_mode else 1, trilinear=trilinear,
        width_multiplier=width_multiplier,
    )
    module = UNet3D(**kw)
    if state_dict is not None:
        module.load_state_dict(state_dict, strict=True)
    else:
        init_weights(module, torch.Generator().manual_seed(0))
    if fold_bn:
        folded = fold_batchnorm(module.state_dict(), trilinear=trilinear)
        module = UNet3D(fused_bn=True, **kw)
        module.load_state_dict(folded, strict=True)
    module = module.to(device=device, dtype=dtype)
    if device.type == "cuda":
        module = module.to(memory_format=torch.channels_last_3d)
    return ModelRunner(module)


def _load_swin_unetr(state_dict, affinity_mode, device, dtype,
                     width_multiplier):
    """The Swin UNETR runner of a MONAI-keyed state dict (strict)."""
    if width_multiplier != 1:
        raise ValueError(
            f"width_multiplier={width_multiplier}: a SwinUNETR checkpoint "
            "gives its own widths; pass 1")
    widths = swin_unetr.widths_from_state_dict(state_dict)
    want = 3 if affinity_mode else 1
    if widths["out_channels"] != want:
        raise ValueError(
            f"checkpoint has {widths['out_channels']} output channels, "
            f"affinity_mode={affinity_mode} needs {want}")
    module = swin_unetr.SwinUNETR(**widths)
    module.load_state_dict(state_dict, strict=True)
    return ModelRunner(module.to(device=device, dtype=dtype))


def to_tensor(arr, device=None):
    """Expand to (1, 1, D, H, W) float32 on ``device`` (default ``cuda``)."""
    t = torch.as_tensor(np.asarray(arr, dtype=np.float32))
    while t.dim() < 5:
        t = t[None]
    return t.to(resolve_device(device))


def _chunk_plan(z, batch_size, trim, own):
    """The owned Z planes that each batch of a slab makes final.

    ``z``: the z-starts of the slab's real patches in the order they are
    queued (padding starts add exact zeros and are left out); ``own``:
    the slab's owned ``(lo, hi)``. A patch at ``z`` adds into planes
    ``[z + trim, z + patch - trim)``, so once the batch of starts ``[i,
    i + batch_size)`` is queued every owned plane below ``trim`` plus the
    least z-start still to come is final, and after the last batch all
    are. Returns ``{i: (lo, hi)}``, in Z order, for each batch after
    which planes ``[lo, hi)`` became final.
    """
    own_lo, own_hi = own
    later = np.minimum.accumulate(np.asarray(z)[::-1])[::-1]
    chunks, done = {}, own_lo
    for i in range(0, len(z), batch_size):
        nxt = i + batch_size
        bound = own_hi if nxt >= len(z) else min(later[nxt] + trim, own_hi)
        if bound > done:
            chunks[i] = (done, bound)
            done = bound
    return chunks


def _to_host_async(tensors, stream):
    """Start copying device tensors to the host; returns (copies, event).

    On CUDA the copies are queued into pinned memory on ``stream``, after
    the work queued so far on the current stream, and ``event`` marks
    their end; the caller synchronizes on it before reading. On the CPU
    the tensors are returned as they are.
    """
    if tensors[0].device.type != "cuda":
        return tensors, None
    stream.wait_stream(torch.cuda.current_stream(tensors[0].device))
    for t in tensors:  # not reused by the current stream till copied
        t.record_stream(stream)
    with torch.cuda.stream(stream):
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

    Brightness clip, full-volume percentile normalization, the
    overlapping patch grid, sigmoid, ``trim``-voxel border trim, and the
    hit-count blend (zero where never covered), as in the JAX package.
    :mod:`.ops.prep` clips, normalizes and reflect-pads each slab: on the
    device for an in-memory uint8 or uint16 volume (the raw integers are
    uploaded, the percentiles come from an exact histogram) and on the
    host for any other input; both give the same bits.
    ``predict.device_prep_slabs`` counts the slabs prepared on the
    device.

    The float result streams to the host in Z chunks: the planes each
    batch makes final are divided and copied out while the device runs
    the later batches. ``predict.copy_out_chunks`` counts the chunks (one a
    patch row when a batch holds one row).

    ``img``: (D, H, W) or (1, 1, D, H, W), in memory (numpy, a list, or a
    tensor on any device) or a lazy chunked handle (``io.read`` of a zarr
    / N5 store), which streams one Z slab at a time with the exact
    :func:`~.core.normalize.streaming_percentile`: both give the same
    numbers. ``model``: a :class:`ModelRunner` (its device is where the
    work runs). Returns float32 ``(3, D, H, W)`` in affinity mode else
    ``(D, H, W)``.

    ``max_slab_rows`` caps how many Z patch-rows are resident on the
    device at once (default: from a ~2 GiB per-slab accumulator budget);
    slabs beyond the first recompute their boundary rows.

    ``blend_mode``: 'uniform' averages by hit count; 'gaussian' weights
    each patch by a separable gaussian window (sigma defaults to patch/6).
    Both leave never-covered voxels at exactly 0.

    ``predigest``: affinity mode only -- digest each slab on the device
    (:mod:`.ops.predigest`, default thresholds low=0.1, high=0.9999) and
    return ``(plan uint8 (D, H, W), qaff uint8 (3, D, H, W))``.

    ``out_path``: slab outputs stream into a Zarr store there as they
    finish (at most one slab and one chunk row of the output in host
    RAM) and the opened lazy handle is returned instead of an array.
    With ``predigest`` it is ``(plan_path, qaff_path)``: the two digests
    stream into two stores and the lazy pair is returned, which
    :func:`affinities_to_segmentation` takes as it is.
    """
    img = prep.as_volume(img)
    runner = model if isinstance(model, ModelRunner) else ModelRunner(model)
    out_channels = stitch.check_call(runner, affinity_mode, predigest,
                                     out_path, blend_mode)
    dim = tuple(img.shape)
    ranges = patch_grid_ranges(dim, patch_shape, overlap)
    if any(len(r) == 0 for r in ranges):
        return stitch.empty_grid(dim, out_channels, affinity_mode, predigest,
                                 out_path)

    device = runner.device
    host_windows, windows = stitch.blend_windows(
        blend_mode, blend_sigma, patch_shape, trim, device)
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
    plans = slab_plan(z_starts, patch_shape[0], trim, dim[0], max_slab_rows)
    slabs = prep.SlabPrep(img, brightness_clip, normalization_percentiles,
                          patch_shape, overlap, [p["own"] for p in plans],
                          device)
    writers = out = None
    if out_path is not None and predigest:
        writers = (ZarrAppendWriter(out_path[0], dim, np.uint8),
                   ZarrAppendWriter(out_path[1], (3,) + dim, np.uint8))
    elif out_path is not None:
        writers = (ZarrAppendWriter(
            out_path, (out_channels,) + dim if affinity_mode else dim,
            np.float32,
        ),)
    elif predigest:
        plan_out = np.zeros(dim, np.uint8)
        qaff_out = np.zeros((3,) + dim, np.uint8)
    else:
        out = np.zeros((out_channels,) + dim, dtype=np.float32)

    def fetch(entry, then):
        lo, hi, (copies, event) = entry
        with annotate("predict.copy_out"):
            if event is not None:
                if out is not None and then is not None and \
                        not event.query():
                    # While the device works, fault in the fresh result's
                    # pages that the chunk queued next fills: the call's
                    # last copy, which no device work hides, then faults
                    # no page.
                    plane = dim[1] * dim[2]
                    out.reshape(out_channels, -1)[
                        :, then[0] * plane: then[1] * plane:
                        mmap.PAGESIZE // out.itemsize] = 0
                event.synchronize()
            if writers is not None:
                blocks = [c.numpy() for c in copies]
                if not affinity_mode:
                    blocks = [blocks[0][0]]
                for writer, block in zip(writers, blocks):
                    writer.append(block)
            elif predigest:
                plan_out[lo:hi] = copies[0].numpy()
                qaff_out[:, lo:hi] = copies[1].numpy()
            else:  # torch's copy runs on every host thread
                torch.from_numpy(out)[:, lo:hi].copy_(copies[0])
        if verbose:
            print(f"predict: planes [{lo}, {hi}) of {dim[0]}",
                  file=sys.stderr)

    pending = []  # copies queued and not yet fetched, in Z order

    def fetch_first(n):
        # Fetch the ``n`` oldest queued copies, in order; each fetch that
        # waits faults in the pages of the copy queued after it.
        for j in range(n):
            fetch(pending[j],
                  pending[j + 1][:2] if j + 1 < len(pending) else None)
        del pending[:n]

    # One-slab-deep pipeline: each batch's newly final planes (a digest:
    # the slab's) are divided and queued for the host on a second stream,
    # and a slab's copies are fetched once the next slab's device work
    # is queued behind them, so the device stays fed while the host
    # prepares inputs and copies results; the last slab's are fetched in
    # Z order while its later batches run.
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" \
        else None
    prev_plane = None  # predigest: previous slab's last z-aff plane
    for plan in plans:
        prev_copies = len(pending)  # the previous slab's
        in_lo, in_hi = plan["in_range"]
        slab = slabs.slab(in_lo, min(in_hi, dim[0]))
        predict.device_prep_slabs += slabs.on_device
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
        own_lo, own_hi = plan["own"]
        chunks = _chunk_plan([s[0] + in_lo for s in starts[:n_real]],
                             batch_size, trim, (own_lo, own_hi))
        acc = torch.zeros((out_channels,) + tuple(slab.shape),
                          dtype=torch.float32, device=device)

        def blend(lo, hi):
            return stitch.divide_by_weights(
                acc[:, lo - in_lo: hi - in_lo, : dim[1], : dim[2]],
                wz[lo:hi], wy, wx,
            )

        def stream_chunk(i, _probs):
            if i in chunks:
                lo, hi = chunks[i]
                pending.append((lo, hi, _to_host_async((blend(lo, hi),),
                                                       copy_stream)))
                predict.copy_out_chunks += 1

        stitch.accumulate_predictions(
            runner.module,
            slab,
            np.asarray(starts, dtype=np.int32),
            valid,
            patch_shape=tuple(patch_shape),
            trim=trim,
            batch_size=batch_size,
            out_channels=out_channels,
            windows=windows,
            on_batch=None if predigest else stream_chunk,
            acc=acc,
        )
        if predigest:
            blended = blend(own_lo, own_hi)
            payload = predigest_slab(
                blended, prev_plane,
                first_slab=(own_lo == 0), last_slab=(own_hi == dim[0]),
            )
            prev_plane = blended[0, -1]
            pending.append((own_lo, own_hi,
                            _to_host_async(payload, copy_stream)))
        del acc
        fetch_first(prev_copies)
    fetch_first(len(pending))

    if writers is not None:
        for writer in writers:
            writer.close()
        if predigest:
            return read(out_path[0]), read(out_path[1])
        return read(out_path)
    if predigest:
        return plan_out, qaff_out
    return out if affinity_mode else out[0]


predict.device_prep_slabs = 0
predict.copy_out_chunks = 0


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
    tmp_dir=None,
    verbose=False,
    device=None,
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
      ``aff_threshold_*`` with a pair raise ``ValueError``;
    * a lazy (zarr/N5) handle of float affinities, or a lazy
      ``(plan, qaff)`` pair of store handles (``predict(...,
      predigest=True, out_path=(p1, p2))``): the slab-streaming engine
      (:func:`.postprocess.segment_streaming`) runs three Z-slab passes
      with O(RAG + slab) host RAM, bit-identical to the dense path. Float
      slabs are digested on ``device`` (default ``cuda``); a pair needs
      no device.

    ``out_path`` (lazy input only; ``ValueError`` otherwise): stream the
    labels into a Zarr store there and return the opened lazy handle.
    ``tmp_dir``: where the streaming engine parks its temp spool files.
    ``verbose``: the streaming engine's stage stamps on stderr.
    """
    predigested = isinstance(affinities, tuple) and len(affinities) == 2
    if _is_lazy(affinities[0] if predigested else affinities):
        return postprocess.segment_streaming(
            affinities,
            agglomeration_thresholds=agglomeration_thresholds,
            min_segment_size=min_segment_size,
            aff_threshold_low=aff_threshold_low,
            aff_threshold_high=aff_threshold_high,
            out_path=out_path,
            tmp_dir=tmp_dir,
            verbose=verbose,
            device=device,
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
    invalidation 1.0 / 300, fix_borders, fill_holes, one thread.

    ``segmentation`` is a dense uint32 volume or a lazy (zarr/N5) label
    handle, e.g. from ``affinities_to_segmentation(..., out_path=...)``,
    which streams through per-label bounding-box crops
    (:func:`.postprocess.skeleton.skeletonize_lazy`) with the same
    output, so the zarr -> SWC pipeline never densifies the volume."""
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
    """Segmentation (dense or a lazy label handle, see :func:`skeletonize`)
    -> TEASAR skeletons -> zipped SWC archive; returns the skeletons."""
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
