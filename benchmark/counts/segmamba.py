"""Analytic operation and byte counts of SegMamba, from its shapes alone.

The yardstick of the SegMamba cell's rooflines and MFU. Every count
follows from the published architecture (SegMamba: a 7^3 stride-2 stem,
four encoder stages of downsample, GSC convs, Mamba layers and a channel
MLP, MONAI's UNETR decoder, a 1^3 output conv) and the patch geometry;
none depends on how the program computes it.

* :func:`stages` gives each encoder stage's map side, channels, tokens,
  inner width, ``delta`` rank and Mamba layers.
* :func:`conv_layers` lists every conv, transposed conv and the Mamba
  layers' causal ``conv1d`` of one patch's forward, in the order it runs,
  each tagged with its ``role``; :func:`linear_layers` every linear
  (``in_proj``, each direction's ``x_proj`` and ``dt_proj``,
  ``out_proj``).
* FLOPs are 2 x multiply-adds; bias adds, norms, activations and the
  scan's own arithmetic are not counted (``torch.utils.flop_counter``
  counts the same). A transposed conv's multiply-adds are its weight
  times its input voxels; a conv's, its weight times its output voxels.
* :func:`scan_work` gives the work of each Mamba layer's three
  directions, from ``xz`` to the gated sum (the span ``segmamba.scan``):
  the FLOPs of its convs and linears and six a state update (``delta A``,
  the decay times the state, ``delta B u`` added, ``C h``), and its
  minimal bytes: ``xz`` read once, the directions' weights read, the
  summed ``y`` written once.
"""

import math

STAGES = 4
DIRECTIONS = 3
PUBLISHED = dict(depths=(2, 2, 2, 2), feat_size=(48, 96, 192, 384),
                 hidden_size=768, d_state=16, d_conv=4, expand=2)


def stages(patch=128, depths=PUBLISHED["depths"],
           feat_size=PUBLISHED["feat_size"], expand=2, **_):
    """One dict an encoder stage: ``side`` (the map's edge), ``channels``,
    ``tokens``, ``inner`` (d), ``rank`` (R) and ``layers``."""
    return [dict(side=patch // 2 ** (i + 1), channels=c,
                 tokens=(patch // 2 ** (i + 1)) ** 3, inner=expand * c,
                 rank=math.ceil(c / 16), layers=n)
            for i, (c, n) in enumerate(zip(feat_size, depths))]


def conv_layers(patch=128, in_channels=1, out_channels=3, hidden_size=768,
                d_conv=4, **widths):
    """Every conv of one ``patch**3`` forward, in the order it runs, as
    dicts with ``role`` (``stem``, ``down``, ``gsc``, ``conv1d``, ``mlp``,
    ``unetr``, ``out``), ``cin``, ``cout``, ``taps``, ``vin``, ``vout``
    (input and output voxels or tokens of one patch), ``groups``,
    ``transposed`` and ``bias``."""
    layers = []

    def conv(role, cin, cout, taps, vin, vout, groups=1, transposed=False,
             bias=True):
        layers.append(dict(role=role, cin=cin, cout=cout, taps=taps,
                           vin=vin, vout=vout, groups=groups,
                           transposed=transposed, bias=bias))

    st = stages(patch, **widths)
    prev, side = in_channels, patch
    for i, s in enumerate(st):
        c, v = s["channels"], s["tokens"]
        if i == 0:
            conv("stem", prev, c, 7 ** 3, side ** 3, v)
        else:
            conv("down", prev, c, 8, side ** 3, v)
        for taps in (27, 27, 1, 1):
            conv("gsc", c, c, taps, v, v)
        for _ in range(s["layers"] * DIRECTIONS):
            conv("conv1d", s["inner"], s["inner"], d_conv, v, v,
                 groups=s["inner"])
        conv("mlp", c, 2 * c, 1, v, v)
        conv("mlp", 2 * c, c, 1, v, v)
        prev, side = c, s["side"]

    def res(cin, cout, n):
        conv("unetr", cin, cout, 27, n ** 3, n ** 3, bias=False)
        conv("unetr", cout, cout, 27, n ** 3, n ** 3, bias=False)
        if cin != cout:
            conv("unetr", cin, cout, 1, n ** 3, n ** 3, bias=False)

    sides = [patch] + [s["side"] for s in st]
    ladder = [in_channels] + [s["channels"] for s in st] + [hidden_size]
    for i in range(STAGES + 1):
        res(ladder[i], ladder[i + 1], sides[i])
    for i in range(STAGES, 0, -1):
        cin, cout, n = ladder[i + 1], ladder[i], sides[i - 1]
        conv("unetr", cin, cout, 8, sides[i] ** 3, n ** 3, transposed=True,
             bias=False)
        res(2 * cout, cout, n)
    res(ladder[1], ladder[1], patch)
    conv("out", ladder[1], out_channels, 1, patch ** 3, patch ** 3)
    return layers


def linear_layers(patch=128, d_state=16, **widths):
    """Every linear of one patch's forward, as dicts with ``stage``,
    ``tokens``, ``fin``, ``fout`` and ``bias``."""
    out = []
    for i, s in enumerate(stages(patch, **widths)):
        c, d, r, t = s["channels"], s["inner"], s["rank"], s["tokens"]
        for _ in range(s["layers"]):
            out.append(dict(stage=i, tokens=t, fin=c, fout=2 * d,
                            bias=False))
            for _ in range(DIRECTIONS):
                out += [dict(stage=i, tokens=t, fin=d, fout=r + 2 * d_state,
                             bias=False),
                        dict(stage=i, tokens=t, fin=r, fout=d, bias=True)]
            out.append(dict(stage=i, tokens=t, fin=d, fout=c, bias=False))
    return out


def layer_flops(l):
    """FLOPs (2 x multiply-adds) of one conv of one patch."""
    voxels = l["vin"] if l["transposed"] else l["vout"]
    return 2 * l["taps"] * l["cin"] // l["groups"] * l["cout"] * voxels


def conv_flops(layers):
    """FLOPs of the convs of one patch."""
    return sum(layer_flops(l) for l in layers)


def linear_flops(layers):
    """FLOPs of the linears of one patch."""
    return sum(2 * l["tokens"] * l["fin"] * l["fout"] for l in layers)


def forward_flops(patch=128, **widths):
    """FLOPs of one patch's forward: its convs and linears."""
    return (conv_flops(conv_layers(patch, **widths))
            + linear_flops(linear_layers(patch, **widths)))


def scan_tokens(patch=128, batch=1, **widths):
    """(token, direction) pairs one forward of ``batch`` patches scans:
    the program's ``SegMamba.scan_tokens`` counter."""
    return batch * DIRECTIONS * sum(s["layers"] * s["tokens"]
                                    for s in stages(patch, **widths))


def scan_work(patch=128, batch=1, itemsize=2, d_state=16, d_conv=4,
              **widths):
    """``[(flops, bytes), ...]`` of every Mamba layer's three directions
    (``xz`` to the gated sum) of one forward of ``batch`` patches."""
    out = []
    for s in stages(patch, **widths):
        d, r, t = s["inner"], s["rank"], s["tokens"]
        macs = t * d * (d_conv + (r + 2 * d_state) + r)
        flops = batch * DIRECTIONS * (2 * macs + 6 * t * d * d_state)
        weights = DIRECTIONS * d * (d_conv + 1 + (r + 2 * d_state) + r + 1
                                    + d_state + 1)
        nbytes = (batch * t * (2 * d + d) + weights) * itemsize
        out += [(flops, nbytes)] * s["layers"]
    return out
