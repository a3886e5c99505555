"""Predict's input preparation on the device, for integer volumes in RAM.

For an in-memory uint8 or uint16 volume, :func:`..inference.predict` ships
the raw integers (2 B a voxel for uint16, where the float32 it would ship
otherwise takes 4) and does on the device what
``normalize(np.minimum(img, clip))`` and ``stitch.reflect_pad_to_grid``
do on the host, to the same bits:

- the percentiles: clipping commutes with order statistics, so the k-th
  smallest value of ``min(x, clip)`` is ``min(v_k, clip)``, where ``v_k``
  is the k-th smallest of ``min(x, cap)``, ``cap = ceil(clip)`` held to
  the dtype's range. One exact histogram of ``min(x, cap)`` (at most
  65,536 bins) gives every ``v_k``, and
  :func:`..parallel.stats.lerp_plan` interpolates them as
  ``np.percentile`` does;
- the normalize runs in float64, as numpy's does, and rounds once to
  float32;
- the reflect pad copies the planes of the host's index plan
  (:func:`.stitch.reflect_pad_plan`).
"""

import math

import numpy as np
import torch

from aind_exaspim_neuron_segmentation_tpu_torch.ops.stitch import (
    host_to_device,
)


def takes_device_prep(img, brightness_clip):
    """Whether ``predict`` prepares ``img`` on the device: an in-memory
    uint8 or uint16 array, under a clip that leaves numpy's arithmetic
    exact or in float64 (an integer or a float64 clip; numpy would clip in
    float32 under a float32 clip, and numpy 1.x under any float clip)."""
    if not (isinstance(img, np.ndarray)
            and img.dtype in (np.uint8, np.uint16)):
        return False
    clipped = np.result_type(img.dtype, brightness_clip)
    return clipped.kind in "iu" or clipped == np.float64


def histogram_cap(dtype, brightness_clip):
    """The largest bin: ``ceil(brightness_clip)`` within the range of the
    integer ``dtype``."""
    top = np.iinfo(dtype).max
    if brightness_clip >= top:
        return int(top)
    if brightness_clip <= 0:
        return 0
    return math.ceil(brightness_clip)


def upload(block, cap, device):
    """``min(block, cap)`` as int32 on ``device``, from the raw integers.
    uint16 travels as its int16 bit pattern and is widened on the device,
    where torch's unsigned 16-bit support is limited."""
    block = np.ascontiguousarray(block)
    if block.dtype == np.uint16:
        raw = host_to_device(block.view(np.int16), device)
        x = raw.to(torch.int32) & 0xFFFF
    else:
        x = host_to_device(block, device).to(torch.int32)
    return x.clamp_(max=cap)


def clip_histogram(blocks, cap):
    """Counts of each value ``0..cap`` over the device tensors
    ``blocks`` (from :func:`upload`), as one int64 tensor."""
    hist = None
    for block in blocks:
        counts = torch.bincount(block.reshape(-1), minlength=cap + 1)
        hist = counts if hist is None else hist + counts
    return hist


def histogram_percentiles(hist, n_total, percentiles, brightness_clip):
    """``np.percentile(np.minimum(x, brightness_clip), percentiles)`` as
    host floats, from :func:`clip_histogram`'s ``hist`` of the whole
    volume of ``n_total`` voxels: one small device-to-host fetch."""
    # imported here: the parallel package imports inference, which
    # imports this module
    from aind_exaspim_neuron_segmentation_tpu_torch.parallel.stats import (
        lerp_plan,
        rank_plan,
    )

    ks, plan = rank_plan(n_total, percentiles)
    cum = torch.cumsum(hist, 0)
    ranks = torch.tensor(ks, dtype=cum.dtype, device=cum.device)
    # the k-th smallest value is the first whose cumulative count
    # exceeds k
    values = torch.searchsorted(cum, ranks, right=True).cpu().numpy()
    values = np.minimum(values.astype(np.float64), float(brightness_clip))
    return lerp_plan(values, plan, dtype=np.float64)


def normalize_padded(x, mn, mx, brightness_clip, pads):
    """A float32 buffer on ``x``'s device, ``pads`` longer than ``x`` on
    each axis, whose leading box holds ``clip((min(x, brightness_clip) -
    mn) / (mx - mn + 1e-8), 0, 1)``, computed in float64 as the host's
    normalize is; the pad planes are left for
    :func:`.stitch.reflect_pad_device`."""
    scale = float(mx) - float(mn) + 1e-8
    v = x.to(torch.float64).clamp_(max=float(brightness_clip))
    # CUDA divides by a host scalar as a product with its rounded
    # reciprocal, so the divisor is a device tensor: a true division.
    v.sub_(float(mn)).div_(
        torch.full((), scale, dtype=torch.float64, device=v.device))
    v.clamp_(0.0, 1.0)
    out = torch.empty([d + p for d, p in zip(v.shape, pads)],
                      dtype=torch.float32, device=v.device)
    out[tuple(slice(0, d) for d in v.shape)] = v
    return out
