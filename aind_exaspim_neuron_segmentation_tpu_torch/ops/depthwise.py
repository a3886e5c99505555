"""Depthwise 3D convolutions of MedNeXt's blocks, in plain torch.

A depthwise ``k^3`` conv (``groups`` = channels, one weight set a
channel) reaches two slow routes on an H100 (PyTorch 2.11, cuDNN 9.22):
``F.conv3d`` on NCDHW maps runs ATen's ``conv_depthwise3d`` kernel (NDHWC
maps go to cuDNN, slower still), and ``F.conv_transpose3d`` runs cuDNN's
grouped direct dgrad kernel, 4.4x slower at 64 channels of 64^3 than the
same arithmetic split into stride-1 phases.
The two functions here compute the same sums by other torch ops, on the
CPU as on the card:

* :func:`depthwise_conv3d` (stride 1, padding ``k // 2``): on maps at
  least :data:`BANDED_MIN_DEPTH` deep, the depth axis is cut into tiles
  of :data:`TILE` planes with a ``k // 2`` halo, each tile's planes are
  folded into the channels, and one grouped 2D conv (a group a channel)
  applies a banded weight: output plane ``t`` of a channel takes input
  plane ``t + kd`` of its tile with the depth tap ``kd``, and every
  other weight of the band is an exact zero. Shallower maps keep
  ``F.conv3d``.
* :func:`depthwise_conv_transpose3d` (stride 2, padding ``k // 2``, odd
  ``k``): the ``2n - 1`` outputs of each axis split into even and odd
  phases; each of the 8 phase combinations is a stride-1 depthwise conv
  of the input with the taps of that phase (``(k + 1) / 2`` or
  ``(k - 1) / 2`` an axis), written into its strided slice of the
  output.
"""

import torch
import torch.nn.functional as F

TILE = 16
BANDED_MIN_DEPTH = 32


def banded_weight(weight, tile):
    """(C * tile, tile + k - 1, k, k) grouped 2D weight of a depthwise
    (C, 1, k, k, k) weight: row ``c * tile + t`` holds the depth taps of
    channel ``c`` at input planes ``t .. t + k - 1``, zeros elsewhere."""
    c, _, k = weight.shape[:3]
    band = weight.new_zeros(c, tile, tile + k - 1, k, k)
    t = torch.arange(tile, device=weight.device)
    for kd in range(k):
        band[:, t, t + kd] = weight[:, 0, kd, None]
    return band.view(c * tile, tile + k - 1, k, k)


def depthwise_conv3d(x, weight, bias):
    """``F.conv3d(x, weight, bias, padding=k // 2, groups=C)`` of an
    NCDHW ``x``; NCDHW out."""
    n, c, d, h, w = x.shape
    k = weight.shape[-1]
    p = k // 2
    if d < BANDED_MIN_DEPTH or d % TILE:
        return F.conv3d(x, weight, bias, padding=p, groups=c)
    tiles = F.pad(x, (0, 0, 0, 0, p, p)).unfold(2, TILE + 2 * p, TILE)
    # (n, c, d / TILE, h, w, planes) -> (n * d / TILE, c * planes, h, w)
    tiles = tiles.permute(0, 2, 1, 5, 3, 4).reshape(
        n * (d // TILE), c * (TILE + 2 * p), h, w)
    y = F.conv2d(tiles.contiguous(memory_format=torch.channels_last),
                 banded_weight(weight, TILE).contiguous(
                     memory_format=torch.channels_last),
                 bias.repeat_interleave(TILE), padding=p, groups=c)
    y = y.view(n, d // TILE, c, TILE, h, w).permute(0, 2, 1, 3, 4, 5)
    return y.reshape(n, c, d, h, w)


def _phase_taps(k, phase):
    """The kernel taps of output phase ``phase`` (0 even, 1 odd) of a
    stride-2 transposed conv with padding ``k // 2``, in correlation
    order, and the input's (before, after) padding."""
    p = k // 2
    # output 2j + phase takes input i through tap t = 2j + phase + p - 2i
    taps = [t for t in reversed(range(k)) if (t - phase - p) % 2 == 0]
    before = (len(taps) - 1) - (phase + p - taps[-1]) // 2
    return taps, (before, len(taps) - 1 - before)


def depthwise_conv_transpose3d(x, weight, bias):
    """``F.conv_transpose3d(x, weight, bias, stride=2, padding=k // 2,
    groups=C)`` of an NCDHW ``x`` (odd ``k``): (n, c, 2m - 1, ...) out,
    NCDHW."""
    n, c = x.shape[:2]
    k = weight.shape[-1]
    sizes = [2 * m - 1 for m in x.shape[2:]]
    y = x.new_empty((n, c, *sizes))
    phases = [_phase_taps(k, ph) for ph in (0, 1)]
    for pz in (0, 1):
        for py in (0, 1):
            for px in (0, 1):
                (tz, az), (ty, ay), (tx, ax) = (phases[pz], phases[py],
                                                phases[px])
                w = weight[:, :, tz][:, :, :, ty][:, :, :, :, tx]
                part = F.conv3d(F.pad(x, ax + ay + az), w, bias, groups=c)
                out = y[:, :, pz::2, py::2, px::2]
                out.copy_(part[:, :, :out.shape[2], :out.shape[3],
                               :out.shape[4]])
    return y
