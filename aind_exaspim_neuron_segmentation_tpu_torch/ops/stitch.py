"""Sliding-window inference with overlap-blend stitching, on the device.

The padded volume slab lives on the device; each batch of patch starts is
gathered by indexing it, run through the UNet with ``valid_trim``, turned
into trimmed float32 probabilities (sigmoid, validity mask, optional
gaussian window) and scatter-added into the accumulator by kernel K1
(:func:`..ops.scatter.scatter_batch`). The blend weight is never
accumulated: it is the separable outer product of per-axis hit counts,
computed on the host and divided out on the device, and voxels of weight
0 stay exactly 0. ``predict`` and ``predict_sharded`` both take their
argument checks, blend windows and empty-grid result from here.
"""

import numpy as np
import torch

from aind_exaspim_neuron_segmentation_tpu_torch.core.patches import (
    patch_grid_ranges,
)
from aind_exaspim_neuron_segmentation_tpu_torch.io import read
from aind_exaspim_neuron_segmentation_tpu_torch.io.zarr_lite import write_zarr
from aind_exaspim_neuron_segmentation_tpu_torch.ops.scatter import (
    scatter_batch,
)


def check_call(runner, affinity_mode, predigest, out_path, blend_mode):
    """Refuse a sliding-window call that cannot run; returns the output
    channel count."""
    out_channels = 3 if affinity_mode else 1
    if runner.output_channels != out_channels:
        raise ValueError(
            f"model has {runner.output_channels} output channels, "
            f"affinity_mode={affinity_mode} needs {out_channels}"
        )
    if predigest and not affinity_mode:
        raise ValueError("predigest=True requires affinity_mode=True")
    if predigest and out_path is not None and (
        not isinstance(out_path, (tuple, list)) or len(out_path) != 2
    ):
        raise ValueError(
            "predigest streams TWO stores; pass "
            "out_path=(plan_path, qaff_path)"
        )
    if blend_mode not in ("uniform", "gaussian"):
        raise ValueError(f"unknown blend_mode {blend_mode!r}")
    return out_channels


def empty_grid(dim, out_channels, affinity_mode, predigest, out_path,
               write=True, sync=None):
    """The zeros of a call whose grid is empty (an axis shorter than the
    overlap); with ``out_path``, written there (where ``write``), then
    ``sync()``, then the stores' lazy handles."""
    if predigest:
        arrays = (np.zeros(dim, np.uint8), np.zeros((3,) + dim, np.uint8))
        paths = out_path
    else:
        out = np.zeros((out_channels,) + dim, np.float32)
        arrays = (out if affinity_mode else out[0],)
        paths = (out_path,)
    if out_path is not None:
        if write:
            for path, arr in zip(paths, arrays):
                write_zarr(path, arr)
        if sync is not None:
            sync()
        arrays = tuple(read(p) for p in paths)
    return arrays if predigest else arrays[0]


def gaussian_window(patch, trim, sigma):
    """Per-axis window over the trimmed core (float32, length p - 2t).

    Centered gaussian bump for the 'gaussian' blend mode: overlapping
    patches fade into each other instead of averaging with uniform
    weight.
    """
    core = patch - 2 * trim
    pos = np.arange(core, dtype=np.float32) + trim
    center = (patch - 1) / 2.0
    return np.exp(-0.5 * ((pos - center) / sigma) ** 2).astype(np.float32)


def blend_windows(blend_mode, blend_sigma, patch_shape, trim, device):
    """``(host, device)`` per-axis windows of ``blend_mode``: each a tuple
    of :func:`gaussian_window` for 'gaussian' (sigma defaults to patch /
    6), None for 'uniform'."""
    if blend_mode != "gaussian":
        return None, None
    host = tuple(gaussian_window(p, trim, blend_sigma or p / 6.0)
                 for p in patch_shape)
    return host, tuple(host_to_device(w, device) for w in host)


def axis_hit_counts(dim, patch, overlap, trim, window=None):
    """1D accumulated blend weight along one axis (host, numpy).

    ``window=None`` gives uniform hit counts; otherwise each patch
    contributes ``window`` over its trimmed core.
    """
    counts = np.zeros(dim, dtype=np.float32)
    stride = patch - overlap
    for s in range(0, dim - patch + stride, stride):
        lo = min(s + trim, dim)
        hi = min(s + patch - trim, dim)
        if window is None:
            counts[lo:hi] += 1
        else:
            counts[lo:hi] += window[: hi - lo]
    return counts


def separable_weights(img_shape, patch_shape, overlap, trim, windows=None):
    """Per-axis weight vectors whose outer product is the weight map."""
    windows = windows or (None, None, None)
    return tuple(
        axis_hit_counts(d, p, o, trim, window=w)
        for d, p, o, w in zip(img_shape, patch_shape, overlap, windows)
    )


def reflect_tail(tail_start, dim, pad):
    """The source planes of ``pad`` planes past ``dim``: the tail segment
    ``[tail_start, dim)`` reflected about its own end (numpy's 'reflect',
    multi-bounce included)."""
    seg = np.arange(tail_start, dim)
    return np.pad(seg, (0, pad), mode="reflect")[dim - tail_start:]


def reflect_pad_plan(shape, patch_shape, overlap):
    """Pad widths and plane fills that grid-pad a volume of ``shape``.

    Only the LAST patch along an axis overhangs, and it starts at the last
    grid start, so the padding is a reflection of the clipped tail segment
    ``img[last_start:]`` about its own end -- including the multi-bounce
    case where the pad exceeds the tail length. Returns ``(pads, fills)``;
    each fill ``(axis, index, dst, src)``, applied in order, copies the
    planes ``index`` along ``axis`` of the box ``src`` (whose ``axis``
    entry is ``slice(None)``) into the box ``dst``. Axis k's reflection
    covers the already-padded extent of axes < k and only the original
    extent of axes > k (sequential per-axis padding).
    """
    ranges = patch_grid_ranges(shape, patch_shape, overlap)
    pads = tuple(
        max(r[-1] + p - d, 0)
        for r, p, d in zip(ranges, patch_shape, shape)
    )
    padded = tuple(d + pad for d, pad in zip(shape, pads))
    fills = []
    for axis, pad in enumerate(pads):
        if pad == 0:
            continue
        d = shape[axis]
        index = reflect_tail(ranges[axis][-1], d, pad)
        box = [slice(0, padded[a] if a < axis else shape[a])
               for a in range(3)]
        dst = list(box)
        dst[axis] = slice(d, padded[axis])
        box[axis] = slice(None)
        fills.append((axis, index, tuple(dst), tuple(box)))
    return pads, fills


def reflect_pad_to_grid(img, patch_shape, overlap):
    """Reflect-pad a 3D host volume so every grid patch is full-size.

    Equivalent to clipping each patch to the volume and reflect-padding it
    at its end (:func:`reflect_pad_plan`). Returns the padded volume and
    the per-axis pad widths.
    """
    pads, fills = reflect_pad_plan(img.shape, patch_shape, overlap)
    if not fills:
        return img, pads
    # One preallocation + per-axis pad-plane fills.
    shape = tuple(d + pad for d, pad in zip(img.shape, pads))
    out = np.empty(shape, img.dtype)
    out[tuple(slice(0, d) for d in img.shape)] = img
    for axis, index, dst, src in fills:
        src = src[:axis] + (index,) + src[axis + 1:]
        out[dst] = out[src]
    return out, pads


def reflect_pad_device(buf, shape, fills):
    """Fill the pad planes of ``buf`` in place, on its device.

    ``buf``: the grid-padded (D', H', W') tensor whose leading ``shape``
    box holds the volume; ``fills``: :func:`reflect_pad_plan`'s for
    ``shape``. Plane copies only, so the result equals
    :func:`reflect_pad_to_grid`'s bit for bit.
    """
    for axis, index, dst, src in fills:
        planes = host_to_device(index, buf.device)
        buf[dst] = buf[src].index_select(axis, planes)
    return buf


def host_to_device(array, device):
    """Copy a host numpy array to ``device`` without blocking the host.

    On CUDA the array goes through pinned memory and an asynchronous copy
    on the current stream, so queued device work keeps running while the
    host prepares the next input.
    """
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def forward_batch(module, volume, starts, valid, *, patch_shape, trim,
                  windows=None):
    """Gather + model forward + sigmoid + trim + validity/window mask.

    ``volume``: (D, H, W) float32 slab on the device. ``starts``: (B, 3)
    int32 patch starts into it; ``valid``: (B,) float32, 0 for padding
    starts. ``windows``: optional per-axis 1-D float32 tensors multiplied
    into each patch's trimmed core (gaussian blend). Returns (B, C, core,
    core, core) float32 weighted probabilities.
    """
    axes = [
        starts[:, a, None] + torch.arange(p, device=volume.device)
        for a, p in enumerate(patch_shape)
    ]
    patches = volume[
        axes[0][:, :, None, None], axes[1][:, None, :, None],
        axes[2][:, None, None, :],
    ]
    logits = module(patches[:, None], valid_trim=trim)
    probs = torch.sigmoid(logits.float())
    probs = probs * valid[:, None, None, None, None]
    if windows is not None:
        wz, wy, wx = windows
        probs = probs * (
            wz[:, None, None] * wy[None, :, None] * wx[None, None, :]
        )
    return probs.contiguous()


def accumulate_predictions(module, volume, starts, valid, *, patch_shape,
                           trim, batch_size, out_channels, windows=None,
                           on_batch=None, acc=None):
    """Blend every patch of ``starts`` into an accumulator.

    ``volume``: (D, H, W) float32 slab on the device, already normalized
    and grid-padded. ``starts``: (N, 3) int32 host array, N a multiple of
    ``batch_size`` (pad with any in-bounds start). ``valid``: (N,) float32
    host array, 0.0 for padding starts. Returns (out_channels, D, H, W)
    float32 accumulated (unweighted) predictions on the device: ``acc``,
    a zeroed tensor of that shape, if given, else a fresh one.
    ``on_batch(i, probs)``, if given, sees each batch's probabilities
    after they are added (``i``: the index of the batch's first start).
    """
    n = starts.shape[0]
    if n % batch_size:
        raise ValueError(f"{n} starts is not a multiple of {batch_size}")
    device = volume.device
    starts_dev = host_to_device(starts.astype(np.int32), device)
    valid_dev = host_to_device(valid.astype(np.float32), device)
    if acc is None:
        acc = torch.zeros(
            (out_channels,) + tuple(volume.shape), dtype=torch.float32,
            device=device,
        )
    for i in range(0, n, batch_size):
        b_starts = starts_dev[i:i + batch_size]
        probs = forward_batch(
            module, volume, b_starts, valid_dev[i:i + batch_size],
            patch_shape=patch_shape, trim=trim, windows=windows,
        )
        scatter_batch(acc, probs, b_starts, trim=trim,
                      host_starts=starts[i:i + batch_size])
        if on_batch is not None:
            on_batch(i, probs)
    return acc


def divide_by_weights(acc, wz, wy, wx):
    """acc / (wz x wy x wx) where the weight is nonzero, else 0."""
    w = wz[:, None, None] * wy[None, :, None] * wx[None, None, :]
    nonzero = w > 0
    return torch.where(nonzero, acc / torch.where(nonzero, w, 1.0), 0.0)
