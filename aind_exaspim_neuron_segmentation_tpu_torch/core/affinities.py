"""Affinity channels from instance label masks.

For edge direction ``e`` (a unit offset), the affinity at voxel ``v`` is
1 iff ``label[v] == label[v + e] != 0``; each channel is zero-padded at
the end of the edge's axis so it keeps the label shape.
:func:`affinity_channels` computes them with torch on the label tensor's
device (the train step's targets, the tail's known answers);
:func:`get_affinity_channels` is the numpy host version the training
datasets use, whose sampler workers never touch torch;
:func:`get_affinity_mask` and :func:`get_offset_masks` are its one-edge
parts, with the reference's names.
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


def get_offset_masks(label_mask, edge):
    """The two views of ``label_mask`` :func:`get_affinity_mask` compares:
    ``o1`` offset by ``+edge``, ``o2`` by ``-edge``."""
    shape = label_mask.shape
    edge = np.asarray(edge)
    off1 = np.maximum(edge, 0)
    off2 = np.maximum(-edge, 0)
    o1 = label_mask[tuple(
        slice(a, s - b) for a, b, s in zip(off1, off2, shape)
    )]
    o2 = label_mask[tuple(
        slice(b, s - a) for a, b, s in zip(off1, off2, shape)
    )]
    return o1, o2


def get_affinity_mask(label_mask, edge):
    """Binary affinity mask of one unit edge direction, in the label
    mask's dtype, zero-padded at the end of the edge's axis."""
    if sorted(np.abs(edge)) != [0, 0, 1]:
        raise ValueError(f"expected a unit edge direction, got {edge}")
    o1, o2 = get_offset_masks(label_mask, edge)
    aff = ((o1 == o2) & (o1 != 0)).astype(label_mask.dtype)
    axis = int(np.argmax(np.asarray(edge) != 0))
    pad = [(0, 0)] * 3
    pad[axis] = (0, 1)
    return np.pad(aff, pad, mode="constant", constant_values=0)


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
