"""Affinity channels from instance label masks.

For edge direction ``e`` (a unit offset), the affinity at voxel ``v`` is
1 iff ``label[v] == label[v + e] != 0``; each channel is zero-padded at
the end of the edge's axis so it keeps the label shape.
:func:`affinity_channels` computes them with torch on the label tensor's
device (the train step's targets, the tail's known answers);
:func:`get_affinity_channels` is the numpy host version the training
datasets use, whose sampler workers never touch torch.
"""

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_EDGES = ((1, 0, 0), (0, 1, 0), (0, 0, 1))


def _unit_axis(edge):
    edge = tuple(int(e) for e in edge)
    if sorted(abs(e) for e in edge) != [0, 0, 1]:
        raise ValueError(f"expected a unit edge direction, got {edge}")
    return next(i for i, e in enumerate(edge) if e != 0)


def affinity_channels(label_mask, edges=DEFAULT_EDGES, dtype=torch.float32):
    """Affinity channels of a label tensor over its last three axes.

    A ``(Z, Y, X)`` tensor gives ``(3, Z, Y, X)``; leading batch axes are
    kept, so ``(B, Z, Y, X)`` gives ``(B, 3, Z, Y, X)``. On the tensor's
    device; a CPU tensor in float64 gives the host array. The channel of
    ``+e`` and ``-e`` is the same: the compare is symmetric and both pad
    the end of the axis.
    """
    lead = label_mask.dim() - 3
    channels = []
    for edge in edges:
        axis = _unit_axis(edge)
        n = label_mask.shape[lead + axis]
        o1 = label_mask.narrow(lead + axis, 1, n - 1)
        o2 = label_mask.narrow(lead + axis, 0, n - 1)
        aff = ((o1 == o2) & (o1 != 0)).to(dtype)
        pad = [0, 0] * 3  # F.pad lists the last axis first
        pad[2 * (2 - axis) + 1] = 1
        channels.append(F.pad(aff, pad))
    return torch.stack(channels, dim=lead)


def get_affinity_channels(label_mask, edges=DEFAULT_EDGES):
    """(3, Z, Y, X) float64 affinity channels of a numpy label volume."""
    out = np.zeros((len(edges),) + label_mask.shape)
    for i, edge in enumerate(edges):
        axis = _unit_axis(edge)
        ahead = [slice(None)] * 3
        behind = [slice(None)] * 3
        ahead[axis] = slice(1, None)
        behind[axis] = slice(None, -1)
        o1 = label_mask[tuple(ahead)]
        out[i][tuple(behind)] = (o1 == label_mask[tuple(behind)]) & (o1 != 0)
    return out
