"""Predict's input preparation: a volume into grid-padded float32 slabs on
the runner's device (:class:`SlabPrep`), by one of three routes:

- an in-memory uint8 or uint16 volume under a clip that keeps numpy's
  arithmetic exact: the raw integers are uploaded (2 B a voxel for
  uint16) and the device does what ``normalize(np.minimum(img, clip))``
  and ``stitch.reflect_pad_to_grid`` do on the host, to the same bits.
  Clipping commutes with order statistics: the k-th smallest of ``min(x,
  clip)`` is ``min(v_k, clip)``, ``v_k`` that of ``min(x, cap)``, ``cap =
  ceil(clip)`` held to the dtype's range, so one exact histogram (at most
  65,536 bins) gives every ``v_k``, interpolated as ``np.percentile``
  does (:func:`..core.order_stats.lerp_plan`); the normalize runs in
  float64 and rounds once to float32;
- a lazy handle: :func:`clipped_percentiles`, then each slab read,
  clipped and scaled in float32 on the host;
- any other volume: clipped and normalized whole on the host.

The spans: ``predict.upload``, ``predict.normalize``, ``predict.pad`` on
the device route; normalize, pad, upload on the host routes.
"""

import math

import numpy as np
import torch

from aind_exaspim_neuron_segmentation_tpu_torch.core.normalize import (
    normalize,
    streaming_percentile,
)
from aind_exaspim_neuron_segmentation_tpu_torch.core.order_stats import (
    lerp_plan,
    rank_plan,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops.stitch import (
    host_to_device,
    reflect_pad_device,
    reflect_pad_plan,
    reflect_pad_to_grid,
)
from aind_exaspim_neuron_segmentation_tpu_torch.utils.profiling import (
    annotate,
)


class _Volume5DView:
    """3D view over a lazy (1, 1, D, H, W) handle (AIND zarr layout)."""

    def __init__(self, handle):
        self.handle = handle
        self.shape = tuple(handle.shape[2:])
        self.ndim = 3

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        return self.handle[(0, 0) + key]


def as_volume(img):
    """The input as a 3-D volume: a numpy array (from a list, or a tensor
    on any device, copied to the host) or a lazy chunked handle, a (1, 1,
    D, H, W) one viewed as (D, H, W)."""
    lazy = not isinstance(img, (np.ndarray, torch.Tensor, list, tuple))
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    elif not lazy:
        img = np.asarray(img)
    if getattr(img, "ndim", 0) == 5:
        img = _Volume5DView(img) if lazy else img[0, 0]
    if img.ndim != 3:
        raise ValueError(f"expected 3D or 5D input, got shape {img.shape}")
    return img


class SlabPrep:
    """The preparation of volume ``img`` (from :func:`as_volume`), its
    route chosen once: ``slab(lo, hi)`` is planes ``[lo, hi)`` clipped,
    normalized at ``percentiles`` of the whole volume (computed at the
    first slab) and reflect-padded to the grid, float32 on ``device``.
    ``owned``: the slabs' owned Z ranges, in order (the device route's
    histogram reads them). ``on_device``: the route is the device's."""

    def __init__(self, img, brightness_clip, percentiles, patch_shape,
                 overlap, owned, device):
        self.img, self.clip, self.percentiles = (img, brightness_clip,
                                                 percentiles)
        self.grid = (patch_shape, overlap)
        self.owned, self.device = owned, device
        self.norm = None  # (mn, mx), or the normalized volume in memory
        self.on_device = takes_device_prep(img, brightness_clip)
        if self.on_device:
            self.cap = histogram_cap(img.dtype, brightness_clip)
            self.slab = self._device_slab
        else:
            self._normalized = (self._memory_block
                                if isinstance(img, np.ndarray)
                                else self._lazy_block)
            self.slab = self._host_slab

    def _device_slab(self, lo, hi):
        with annotate("predict.upload"):
            raw = upload(self.img[lo:hi], self.cap, self.device)
        with annotate("predict.normalize"):
            if self.norm is None:
                self.norm = histogram_percentiles(
                    clip_histogram(self._owned_blocks(raw), self.cap),
                    self.img.size, self.percentiles, self.clip)
            pads, fills = reflect_pad_plan(raw.shape, *self.grid)
            slab = normalize_padded(raw, *self.norm, self.clip, pads)
        with annotate("predict.pad"):
            return reflect_pad_device(slab, raw.shape, fills)

    def _owned_blocks(self, raw):
        # The owned Z ranges on the device, each voxel once; the first
        # slab's lies in its upload ``raw``.
        for j, (lo, hi) in enumerate(self.owned):
            if j == 0 and hi <= raw.shape[0]:
                yield raw[lo:hi]
            else:
                yield upload(self.img[lo:hi], self.cap, self.device)

    def _host_slab(self, lo, hi):
        with annotate("predict.normalize"):
            block = self._normalized(lo, hi)
        # Pad with the REAL grid so the reflection anchors at the last
        # patch's tail segment.
        with annotate("predict.pad"):
            block, _ = reflect_pad_to_grid(block, *self.grid)
        with annotate("predict.upload"):
            return host_to_device(block, self.device)

    def _lazy_block(self, lo, hi):
        if self.norm is None:
            self.norm = clipped_percentiles(self.img, self.clip,
                                            self.percentiles)
        mn, mx = self.norm
        block = np.minimum(np.asarray(self.img[lo:hi], np.float32),
                           self.clip)
        block = np.clip((block - mn) / (mx - mn + 1e-8), 0.0, 1.0)
        return block.astype(np.float32)

    def _memory_block(self, lo, hi):
        if self.norm is None:
            vol = normalize(np.minimum(self.img, self.clip),
                            percentiles=self.percentiles)
            self.norm = np.ascontiguousarray(vol, dtype=np.float32)
        return self.norm[lo:hi]


def clipped_percentiles(img, brightness_clip, percentiles):
    """``np.percentile(np.minimum(img, brightness_clip), percentiles)``
    of a volume streamed in Z blocks (:func:`streaming_percentile`). Each
    block is clipped in float32, where its keys are taken anyway: the
    same bits as a clip in the block's own dtype, and a clip beyond a
    narrow dtype's range (1000 over uint8) cannot overflow."""
    return streaming_percentile(
        img, percentiles,
        transform=lambda b: np.minimum(np.asarray(b, np.float32),
                                       brightness_clip))


def takes_device_prep(img, brightness_clip):
    """Whether ``img`` is prepared on the device: an in-memory uint8 or
    uint16 array, under a clip that leaves numpy's arithmetic exact or in
    float64 (an integer or a float64 clip; numpy would clip in float32
    under a float32 clip, and numpy 1.x under any float clip)."""
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
