"""Brightness clipping and percentile min-max normalization.

    x <- min(x, brightness_clip)
    mn, mx = percentile(x, (1, 99.9))          # linear interpolation
    x <- clip((x - mn) / (mx - mn + 1e-8), 0, 1)

The host path uses ``np.percentile``; ``torch.quantile`` refuses inputs
above 2**24 elements, far below a real volume. A lazy (chunked) volume
gets the same percentiles from :func:`streaming_percentile`, an exact
radix select over Z slabs that never holds the volume. The device path
(:func:`normalize_device`, :func:`preprocess_device`) takes a tensor on
any device and gets its percentiles by the same radix select on that
device (:func:`..parallel.stats.percentile_device`).
"""

import numpy as np
import torch

DEFAULT_PERCENTILES = (1, 99.9)


def clip_brightness(img, brightness_clip):
    """Elementwise ``min(img, brightness_clip)``."""
    return np.minimum(img, brightness_clip)


def normalize(img, apply_clip=True, percentiles=DEFAULT_PERCENTILES):
    """Percentile min-max normalize on the host."""
    mn, mx = np.percentile(img, percentiles)
    img = (img - mn) / (mx - mn + 1e-8)
    if apply_clip:
        return np.clip(img, 0, 1)
    return img


def normalize_device(img, apply_clip=True, percentiles=DEFAULT_PERCENTILES):
    """Percentile min-max normalize a tensor on its own device, in float32
    (the counterpart of the JAX package's ``normalize_jax``)."""
    from aind_exaspim_neuron_segmentation_tpu_torch.parallel.stats import (
        percentile_device,
    )

    img = img.to(torch.float32)
    mn, mx = percentile_device(img, tuple(percentiles))
    img = (img - mn) / (mx - mn + 1e-8)
    if apply_clip:
        img = torch.clamp(img, 0.0, 1.0)
    return img


def preprocess_device(img, brightness_clip, percentiles=DEFAULT_PERCENTILES):
    """Brightness clip + :func:`normalize_device` of a tensor on its device
    (the counterpart of the JAX package's ``preprocess_jax``)."""
    img = torch.clamp(img.to(torch.float32), max=float(brightness_clip))
    return normalize_device(img, apply_clip=True, percentiles=percentiles)


def _float_keys_np(x):
    """Monotone uint32 keys for float32 (order-preserving bit mapping)."""
    u = x.astype(np.float32).view(np.uint32)
    return np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000))


def _key_to_float_np(key):
    key = np.uint32(key)
    u = np.where(key >> 31 == 1, key & np.uint32(0x7FFFFFFF), ~key)
    return np.uint32(u).view(np.float32)


def streaming_percentile(volume, percentiles, transform=None,
                         chunk_planes=64):
    """Exact np.percentile over a lazy volume without densifying it.

    Radix select over the monotone uint32 float mapping: three
    histogram passes (12 + 12 + 8 bits) streaming ``chunk_planes`` Z
    planes at a time, so host memory stays O(one slab). ``transform``
    (e.g. a brightness clip) is applied to each streamed block before
    keying. Matches np.percentile's linear interpolation to float32
    rounding.
    """
    d = volume.shape[0]
    n_total = int(np.prod(volume.shape))
    plan = ((20, 1 << 12), (8, 1 << 12), (0, 1 << 8))

    def order_stat(k):
        prefix = np.uint32(0)
        remaining = int(k)
        for shift, bins in plan:
            fixed_bits = 32 - (shift + (bins.bit_length() - 1))
            hist = np.zeros(bins, np.int64)
            for lo in range(0, d, chunk_planes):
                block = np.asarray(volume[lo: lo + chunk_planes])
                if transform is not None:
                    block = transform(block)
                keys = _float_keys_np(block).ravel()
                if fixed_bits > 0:
                    mask = np.uint32(
                        (0xFFFFFFFF >> (32 - fixed_bits)) << (32 - fixed_bits)
                    )
                    keys = keys[(keys & mask) == (prefix & mask)]
                idx = (keys >> np.uint32(shift)) & np.uint32(bins - 1)
                hist += np.bincount(idx.astype(np.int64), minlength=bins)
            below = np.cumsum(hist) - hist
            b = int(np.argmax((below <= remaining) & (below + hist > remaining)))
            prefix = np.uint32(prefix | (np.uint32(b) << np.uint32(shift)))
            remaining -= int(below[b])
        return float(_key_to_float_np(prefix))

    outs = []
    for q in np.atleast_1d(percentiles):
        rank = (n_total - 1) * (float(q) / 100.0)
        k_lo = int(np.floor(rank))
        frac = rank - k_lo
        v_lo = order_stat(k_lo)
        if frac > 0:
            v_hi = order_stat(k_lo + 1)
            outs.append(v_lo + (v_hi - v_lo) * frac)
        else:
            outs.append(v_lo)
    return np.asarray(outs)
