"""On-device affinity pre-digest for the native postprocess engines.

Reduces one Z slab of final (blended) float32 affinities to the two u8
digests the host watershed and agglomeration consume:

* ``plan`` uint8 (d, H, W): bits 0-2 flag outgoing ``aff >= high`` edges
  along z/y/x; bits 3-5 encode the steepest ``>= low`` incident neighbor
  (0 = background, 1..6 = +z,+y,+x,-z,-y,-x), enumerated in the order
  out-z, in-z, out-y, in-y, out-x, in-x with strict ``>``, every compare
  in float32;
* ``qaff`` uint8 (3, d, H, W): ``clip(aff * 256, 0, 255)`` truncated.

The bytes equal the JAX package's ``ops/predigest.py::predigest_slab`` on
the same float input. A voxel in the first plane of a slab needs the
previous slab's last z-affinity plane for its incoming -z candidate;
callers thread it through ``prev_plane``. :func:`predigest` digests a
whole in-memory volume and :func:`predigest_streaming` a lazy (zarr/N5)
handle slab by slab (:func:`predigest_slabs`), all on ``device``
(default ``cuda``); :func:`predigest_shard` digests one rank's region
of a sharded volume.
"""

import numpy as np
import torch

from aind_exaspim_neuron_segmentation_tpu_torch.core.device import (
    resolve_device,
)


def _digest_core(aff, in_z, in_y, in_x, valids, low, high):
    """(plan, qaff) of float32 affinities ``aff`` (3, d, h, w) given the
    incoming-edge volumes and the six candidates' validity masks
    (out-z, in-z, out-y, in-y, out-x, in-x; broadcastable booleans)."""
    dev = aff.device
    az, ay, ax = aff[0], aff[1], aff[2]
    out_z_v, in_z_v, out_y_v, in_y_v, out_x_v, in_x_v = valids
    candidates = (
        (az, out_z_v, 1), (in_z, in_z_v, 4),
        (ay, out_y_v, 2), (in_y, in_y_v, 5),
        (ax, out_x_v, 3), (in_x, in_x_v, 6),
    )
    low = torch.tensor(low, dtype=torch.float32, device=dev)
    high = torch.tensor(high, dtype=torch.float32, device=dev)
    best = torch.full(az.shape, -1.0, dtype=torch.float32, device=dev)
    dirs = torch.zeros(az.shape, dtype=torch.uint8, device=dev)
    for a, valid, code in candidates:
        upd = valid & (a >= low) & (a > best)
        best = torch.where(upd, a, best)
        dirs = dirs.masked_fill(upd, code)

    flags = (
        (out_z_v & (az >= high)).to(torch.uint8)
        | ((out_y_v & (ay >= high)).to(torch.uint8) << 1)
        | ((out_x_v & (ax >= high)).to(torch.uint8) << 2)
    )
    plan = flags | (dirs << 3)
    qaff = torch.clamp(aff * 256.0, 0.0, 255.0).to(torch.uint8)
    return plan, qaff


def predigest_slab(aff, prev_plane=None, *, first_slab=True,
                   last_slab=True, low=0.1, high=0.9999):
    """Digest one Z slab of affinities into (plan, qaff) uint8 tensors.

    ``aff``: float32 (3, d, H, W), the slab's final affinities.
    ``prev_plane``: float32 (H, W), the z-affinity plane at the slab's
    preceding global z (ignored when ``first_slab``). ``first_slab`` /
    ``last_slab``: whether the slab starts at global z=0 / ends at the
    last plane (controls edge validity at the slab's z faces).
    """
    aff = aff.float()
    _, d, h, w = aff.shape
    dev = aff.device
    az, ay, ax = aff[0], aff[1], aff[2]
    if prev_plane is None:
        prev_plane = torch.zeros((h, w), dtype=torch.float32, device=dev)

    # Outgoing edge along an axis is stored AT the voxel; incoming is the
    # neighbor's stored value shifted forward.
    in_z = torch.cat([prev_plane.float()[None], az[:-1]], dim=0)
    in_y = torch.cat([torch.zeros((d, 1, w), device=dev), ay[:, :-1]], dim=1)
    in_x = torch.cat(
        [torch.zeros((d, h, 1), device=dev), ax[:, :, :-1]], dim=2
    )
    iota_z = torch.arange(d, device=dev)[:, None, None]
    iota_y = torch.arange(h, device=dev)[None, :, None]
    iota_x = torch.arange(w, device=dev)[None, None, :]
    every = torch.ones((1, 1, 1), dtype=torch.bool, device=dev)
    valids = (
        iota_z + 1 < d if last_slab else every,
        iota_z > 0 if first_slab else every,
        iota_y + 1 < h, iota_y > 0,
        iota_x + 1 < w, iota_x > 0,
    )
    return _digest_core(aff, in_z, in_y, in_x, valids, low, high)


def predigest_shard(aff, prev_z, prev_y, z_off, y_off, dims, low=0.1,
                    high=0.9999):
    """Digest one rank's final blended region of a sharded volume.

    The multi-rank form of :func:`predigest_slab` for
    ``parallel.predict_sharded(predigest=True)``: each rank digests its
    own (Z x Y)-sharded region, so 4 bytes/voxel of u8 digests leave the
    device instead of 12 of float32. Edge validity is masked by GLOBAL
    coordinates, and the two incoming-edge halos come from the
    predecessor ranks:

    ``aff``: float32 (3, kz, ky, wp), the region's final blended values
    (owned + kept spill extents). ``prev_z``: float32 (ky, wp), the Z
    predecessor's z-affinity plane at global ``z_off - 1`` (zeros for the
    first shard, which equals the volume's zero trim margin).
    ``prev_y``: float32 (kz, wp), the same for the Y predecessor's
    y-affinity column at global ``y_off - 1``. ``z_off`` / ``y_off``:
    global offsets of the region's first plane / row. ``dims``: global
    (D, H, W).

    The candidates, float32 compares and u8 quantization are
    :func:`predigest_slab`'s, so digesting the assembled float output
    gives the same bytes.
    """
    aff = aff.float()
    _, kz, ky, wp = aff.shape
    dev = aff.device
    d_g, h_g, w_g = dims
    az, ay, ax = aff[0], aff[1], aff[2]
    z_g = z_off + torch.arange(kz, device=dev)[:, None, None]
    y_g = y_off + torch.arange(ky, device=dev)[None, :, None]
    x_g = torch.arange(wp, device=dev)[None, None, :]
    in_z = torch.cat([prev_z.float()[None], az[:-1]], dim=0)
    in_y = torch.cat([prev_y.float()[:, None], ay[:, :-1]], dim=1)
    in_x = torch.cat(
        [torch.zeros((kz, ky, 1), device=dev), ax[:, :, :-1]], dim=2
    )
    valids = (
        z_g + 1 < d_g, z_g > 0,
        y_g + 1 < h_g, y_g > 0,
        x_g + 1 < w_g, x_g > 0,
    )
    return _digest_core(aff, in_z, in_y, in_x, valids, low, high)


def predigest(aff, low=0.1, high=0.9999, device=None):
    """Digest a whole in-memory affinity volume; returns numpy arrays.

    ``aff``: float32 (3, D, H, W), numpy or a tensor on any device; it is
    digested on ``device`` (default ``cuda``) as one slab (first and
    last) of :func:`predigest_slab`.
    """
    dev = resolve_device(device)
    if not isinstance(aff, torch.Tensor):
        aff = torch.from_numpy(np.ascontiguousarray(aff, np.float32))
    plan, qaff = predigest_slab(
        aff.to(dev, torch.float32), first_slab=True, last_slab=True,
        low=low, high=high,
    )
    return plan.cpu().numpy(), qaff.cpu().numpy()


def default_slab_planes(h, w):
    """Z planes per digest slab: ~512 MB of f32 (3, nz, h, w) on device."""
    return max(int(512 * 1024**2 // (3 * h * w * 4)), 1)


def predigest_slabs(aff, low=0.1, high=0.9999, slab_planes=None,
                    device=None, z_lo=0, z_hi=None):
    """Iterator of ``(lo, hi, plan, qaff)`` over Z slabs of a lazy handle.

    ``aff``: any chunked reader of shape (3, D, H, W). Each slab
    ``[lo, hi)`` of the global planes ``[z_lo, z_hi)`` (default: all) is
    read as float32, digested on ``device`` (default ``cuda``) and
    yielded as device tensors; the previous slab's last z-affinity plane
    is threaded through for the -z steepest candidate (for the first slab
    of a range that starts past 0, the plane at ``z_lo - 1``), so the
    slabs together equal :func:`predigest` of the dense volume byte for
    byte. ``slab_planes``: Z planes per slab (default
    :func:`default_slab_planes`). The shape and the device are checked
    at the call, before the first slab is read.
    """
    if aff.ndim != 4 or aff.shape[0] != 3:
        raise ValueError(f"expected (3, D, H, W) handle, got {aff.shape}")
    dev = resolve_device(device)
    _, d, h, w = aff.shape
    z_hi = d if z_hi is None else z_hi
    if slab_planes is None:
        slab_planes = default_slab_planes(h, w)

    def slabs():
        prev = None
        if z_lo > 0:
            prev = torch.from_numpy(np.ascontiguousarray(
                aff[0, z_lo - 1], dtype=np.float32)).to(dev)
        for lo in range(z_lo, z_hi, slab_planes):
            hi = min(lo + slab_planes, z_hi)
            block = torch.from_numpy(
                np.ascontiguousarray(aff[:, lo:hi], dtype=np.float32)
            ).to(dev)
            plan, qaff = predigest_slab(
                block, prev, first_slab=(lo == 0), last_slab=(hi == d),
                low=low, high=high,
            )
            prev = block[0, -1]
            yield lo, hi, plan, qaff

    return slabs()


def predigest_streaming(aff, low=0.1, high=0.9999, slab_planes=None,
                        device=None):
    """Digest a lazy (zarr/N5) affinity handle in Z slabs on ``device``.

    The float volume is never dense on the host or the device: one f32
    slab on the device plus the 4-bytes/voxel numpy digest outputs bound
    the memory. Equals :func:`predigest` of the dense volume byte for
    byte (:func:`predigest_slabs`).
    """
    slabs = predigest_slabs(aff, low, high, slab_planes, device)
    _, d, h, w = aff.shape
    plan = np.empty((d, h, w), np.uint8)
    qaff = np.empty((3, d, h, w), np.uint8)
    for lo, hi, p, q in slabs:
        plan[lo:hi] = p.cpu().numpy()
        qaff[:, lo:hi] = q.cpu().numpy()
    return plan, qaff
