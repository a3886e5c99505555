"""Affinity channels from instance label masks.

For edge direction ``e`` (a unit offset), the affinity at voxel ``v`` is
1 iff ``label[v] == label[v + e] != 0``; each channel is zero-padded at
the end of the edge's axis so it keeps the label shape. The result is a
``(3, Z, Y, X)`` tensor on the label tensor's device; a CPU tensor in
float64 gives the reference's host array.
"""

import torch
import torch.nn.functional as F

DEFAULT_EDGES = ((1, 0, 0), (0, 1, 0), (0, 0, 1))


def _unit_axis(edge):
    edge = tuple(int(e) for e in edge)
    if sorted(abs(e) for e in edge) != [0, 0, 1]:
        raise ValueError(f"expected a unit edge direction, got {edge}")
    return next(i for i, e in enumerate(edge) if e != 0)


def affinity_channels(label_mask, edges=DEFAULT_EDGES, dtype=torch.float32):
    """(3, Z, Y, X) affinity channels of a label tensor, on its device.

    The channel of ``+e`` and ``-e`` is the same: the compare is
    symmetric and both pad the end of the axis.
    """
    channels = []
    for edge in edges:
        axis = _unit_axis(edge)
        n = label_mask.shape[axis]
        o1 = label_mask.narrow(axis, 1, n - 1)
        o2 = label_mask.narrow(axis, 0, n - 1)
        aff = ((o1 == o2) & (o1 != 0)).to(dtype)
        pad = [0, 0] * 3  # F.pad lists the last axis first
        pad[2 * (2 - axis) + 1] = 1
        channels.append(F.pad(aff, pad))
    return torch.stack(channels)
