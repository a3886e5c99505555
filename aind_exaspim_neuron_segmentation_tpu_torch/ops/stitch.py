"""Sliding-window inference with overlap-blend stitching, on the device.

The padded volume slab lives on the device; each batch of patch starts is
gathered by indexing it, run through the UNet with ``valid_trim``, turned
into trimmed float32 probabilities (sigmoid, validity mask, optional
gaussian window) and scatter-added into the accumulator by kernel K1
(:func:`..ops.scatter.scatter_batch`). The blend weight is never
accumulated: it is the separable outer product of per-axis hit counts,
computed on the host and divided out on the device, and voxels of weight
0 stay exactly 0.
"""

import numpy as np
import torch

from aind_exaspim_neuron_segmentation_tpu_torch.core.patches import (
    patch_grid_ranges,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops.scatter import (
    scatter_batch,
)


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


def reflect_pad_to_grid(img, patch_shape, overlap):
    """Reflect-pad a 3D host volume so every grid patch is full-size.

    Equivalent to clipping each patch to the volume and reflect-padding it
    at its end: only the LAST patch along an axis overhangs, and it starts
    at the last grid start, so the padding is a reflection of the clipped
    tail segment ``img[last_start:]`` about its own end -- including the
    multi-bounce case where the pad exceeds the tail length. Returns the
    padded volume and the per-axis pad widths.
    """
    ranges = patch_grid_ranges(img.shape, patch_shape, overlap)
    pads = tuple(
        max(r[-1] + p - d, 0)
        for r, p, d in zip(ranges, patch_shape, img.shape)
    )
    if not any(pads):
        return img, pads
    # One preallocation + per-axis pad-plane fills. Axis k's reflection
    # covers the already-padded extent of axes < k and only the original
    # extent of axes > k (sequential per-axis padding).
    shape = tuple(d + pad for d, pad in zip(img.shape, pads))
    out = np.empty(shape, img.dtype)
    out[tuple(slice(0, d) for d in img.shape)] = img
    for axis in range(3):
        pad = pads[axis]
        if pad == 0:
            continue
        d = img.shape[axis]
        tail_start = ranges[axis][-1]
        # source plane of each pad position: np.pad 'reflect' of the tail
        # segment about its own end (multi-bounce included)
        seg = np.arange(tail_start, d)
        idx = np.pad(seg, (0, pad), mode="reflect")[d - tail_start:]
        dst, src = [], []
        for a in range(3):
            if a < axis:
                dst.append(slice(0, shape[a]))
                src.append(slice(0, shape[a]))
            elif a == axis:
                dst.append(slice(d, shape[a]))
                src.append(idx)
            else:
                dst.append(slice(0, img.shape[a]))
                src.append(slice(0, img.shape[a]))
        out[tuple(dst)] = out[tuple(src)]
    return out, pads


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
                           on_batch=None):
    """Blend every patch of ``starts`` into a fresh accumulator.

    ``volume``: (D, H, W) float32 slab on the device, already normalized
    and grid-padded. ``starts``: (N, 3) int32 host array, N a multiple of
    ``batch_size`` (pad with any in-bounds start). ``valid``: (N,) float32
    host array, 0.0 for padding starts. Returns (out_channels, D, H, W)
    float32 accumulated (unweighted) predictions on the device.
    ``on_batch(i, probs)``, if given, sees each batch's probabilities
    after they are added (``i``: the index of the batch's first start).
    """
    n = starts.shape[0]
    if n % batch_size:
        raise ValueError(f"{n} starts is not a multiple of {batch_size}")
    device = volume.device
    starts_dev = host_to_device(starts.astype(np.int32), device)
    valid_dev = host_to_device(valid.astype(np.float32), device)
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
