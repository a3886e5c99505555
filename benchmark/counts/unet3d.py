"""Analytic operation and byte counts of the UNet3D, from its shapes alone.

The yardstick of the benchmark's rooflines and MFU figures. Every count
follows from the published architecture (channels 32/64/128/256/512 times
the width, trilinear x2 decoder, 3x3x3 convs, a 1x1x1 output conv) and
the patch geometry; none depends on how the program computes it.

* :func:`conv_layers` lists every convolution of one patch's forward:
  input and output channels, kernel taps, input and output voxels. With
  ``trim >= 2`` it follows the valid-region decoder (up3 and up4 run
  their convs unpadded over only what the trimmed output needs, outc runs
  over the trimmed output), as ``bench.py::analytic_macs_per_patch`` did
  for the JAX package.
* FLOPs are 2 x multiply-adds; bias adds are not counted.
* Minimal bytes count each input read once and each output written once,
  in the activation dtype's width.
"""

import numpy as np
import torch

CHANNELS = (32, 64, 128, 256, 512)


def _upsample_weights(n_in, n_out):
    """(i0, i1, l0, l1) per output row of a linear ``align_corners=True``
    resize, in float32 as PyTorch computes them."""
    if n_out > 1:
        ratio = torch.tensor(float(n_in - 1)) / float(n_out - 1)
    else:
        ratio = torch.tensor(0.0)
    real = ratio * torch.arange(n_out, dtype=torch.float32)
    i0 = torch.clamp(real.floor().long(), max=n_in - 1)
    i1 = torch.where(i0 < n_in - 1, i0 + 1, i0)
    l1 = torch.clamp(real - i0.float(), 0.0, 1.0)
    return i0, i1, 1.0 - l1, l1


def x2_support_trim(n_in, out_lo, out_hi):
    """Largest symmetric input trim whose dropped rows have zero weight in
    output rows ``[out_lo, out_hi)`` of the x2 upsample of ``n_in`` rows."""
    i0, i1, l0, l1 = (w[out_lo:out_hi]
                      for w in _upsample_weights(n_in, 2 * n_in))
    rows = sorted(set(torch.cat([i0[l0 != 0], i1[l1 != 0]]).tolist()))
    if not rows:
        return 0
    return int(min(rows[0], n_in - (rows[-1] + 1)))


def conv_layers(patch=96, trim=0, width=1.0, out_channels=3):
    """Every conv of one ``patch**3`` forward, in order, as dicts with
    ``cin``, ``cout``, ``taps`` (27 or 1), ``vin`` and ``vout`` (input and
    output voxels of one patch) and ``bn`` (a BatchNorm follows it)."""
    ch = [int(c * width) for c in CHANNELS]
    dims = [patch // 2 ** k for k in range(5)]
    layers = []

    def double(cin, mid, cout, n_out, pad=True):
        n_mid_in = n_out if pad else n_out + 4
        n_mid = n_out if pad else n_out + 2
        layers.append(dict(cin=cin, cout=mid, taps=27, vin=n_mid_in ** 3,
                           vout=n_mid ** 3, bn=True))
        layers.append(dict(cin=mid, cout=cout, taps=27, vin=n_mid ** 3,
                           vout=n_out ** 3, bn=True))

    double(1, ch[0], ch[0], dims[0])
    for k in range(1, 4):
        double(ch[k - 1], ch[k], ch[k], dims[k])
    double(ch[3], ch[4] // 2, ch[4] // 2, dims[4])
    # decoder: the concat of the skip and the upsampled input, mid = half
    double(2 * ch[3], ch[3], ch[3] // 2, dims[3])
    double(2 * ch[2], ch[2], ch[2] // 2, dims[2])
    s = 0
    if trim >= 2:
        a = dims[1]
        s = x2_support_trim(a, trim - 2, 2 * a - (trim - 2))
        if s < 2 or a - 2 * s <= 0:
            s = 0
    if s:
        double(2 * ch[1], ch[1], ch[1] // 2, dims[1] - 2 * s, pad=False)
    else:
        double(2 * ch[1], ch[1], ch[1] // 2, dims[1])
    if trim >= 2 and dims[0] - 2 * trim > 0:
        out = dims[0] - 2 * trim
        double(2 * ch[0], ch[0], ch[0], out, pad=False)
    else:
        double(2 * ch[0], ch[0], ch[0], dims[0])
        out = dims[0] - 2 * trim if trim > 0 else dims[0]
    layers.append(dict(cin=ch[0], cout=out_channels, taps=1, vin=out ** 3,
                       vout=out ** 3, bn=False))
    return layers


def forward_flops(layers):
    """FLOPs (2 x multiply-adds) of one patch's forward convs."""
    return sum(2 * l["taps"] * l["cin"] * l["cout"] * l["vout"]
               for l in layers)


def conv_train_flops(layers):
    """FLOPs of one patch through every conv's forward, data gradient and
    weight gradient; the first conv reads the input image, which needs no
    gradient."""
    total = 0
    for i, l in enumerate(layers):
        one = 2 * l["taps"] * l["cin"] * l["cout"] * l["vout"]
        total += one * (2 if i == 0 else 3)
    return total


def conv_bytes(layers, batch, itemsize=2, train=False):
    """Minimal bytes of a batch through every conv: forward reads the
    input and the weights and writes the output; with ``train``, the data
    gradient reads the output gradient and the weights and writes the
    input gradient (not for the first conv), and the weight gradient reads
    the output gradient and the input and writes the weight gradient."""
    total = 0
    for i, l in enumerate(layers):
        x = batch * l["cin"] * l["vin"] * itemsize
        y = batch * l["cout"] * l["vout"] * itemsize
        w = (l["cin"] * l["taps"] + 1) * l["cout"] * itemsize
        total += x + w + y
        if train:
            if i:
                total += y + w + x
            total += y + x + w
    return total


def batchnorm_bytes(layers, batch, itemsize=2):
    """Minimal bytes of a train step's BatchNorms: forward reads x and
    writes y, backward reads dy and x and writes dx."""
    numel = sum(batch * l["cout"] * l["vout"] for l in layers if l["bn"])
    return 5 * numel * itemsize


def k1_launch_bytes(acc_shape, core, starts, trim):
    """Minimal bytes of one blend launch: the probabilities read once, the
    union of the patch cores in the accumulator read once and written
    once (float32)."""
    covered = np.zeros(acc_shape[1:], bool)
    for s in np.asarray(starts).reshape(-1, 3):
        lo = s + trim
        covered[tuple(slice(a, a + c) for a, c in zip(lo, core))] = True
    probs = len(np.asarray(starts).reshape(-1, 3)) * acc_shape[0] * int(
        np.prod(core)) * 4
    return probs + 2 * int(covered.sum()) * acc_shape[0] * 4
