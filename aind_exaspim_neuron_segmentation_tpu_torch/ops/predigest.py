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
callers thread it through ``prev_plane``.
"""

import torch


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
    out_z_v = iota_z + 1 < d if last_slab else every
    out_y_v = iota_y + 1 < h
    out_x_v = iota_x + 1 < w
    candidates = (
        (az, out_z_v, 1), (in_z, iota_z > 0 if first_slab else every, 4),
        (ay, out_y_v, 2), (in_y, iota_y > 0, 5),
        (ax, out_x_v, 3), (in_x, iota_x > 0, 6),
    )
    low = torch.tensor(low, dtype=torch.float32, device=dev)
    high = torch.tensor(high, dtype=torch.float32, device=dev)
    best = torch.full((d, h, w), -1.0, dtype=torch.float32, device=dev)
    dirs = torch.zeros((d, h, w), dtype=torch.uint8, device=dev)
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
