"""Analytic operation and byte counts of the Swin UNETR, from its shapes
alone.

The yardstick of the Swin cell's rooflines and MFU. Every count follows
from the published architecture (MONAI's v1 ``SwinUNETR``: a
patch-embedding conv, four stages of windowed attention blocks and patch
merging, the UNETR decoder of residual conv blocks and transposed convs,
a 1x1x1 output conv) and the patch geometry; none depends on how the
program computes it.

* :func:`stages` gives each stage's map, its window and shift (clipped
  where the map is no larger than the window), the padded map the
  windows tile, and the windows.
* :func:`conv_layers` lists every conv and transposed conv of one patch's
  forward in the order it runs; :func:`linear_layers` every linear
  (``qkv`` and ``proj`` run over the padded windows, the MLP over the
  map, the merge's reduction over the merged map).
* FLOPs are 2 x multiply-adds; bias adds, norms, softmax and GELU are
  not counted. A transposed conv's multiply-adds are its weight times
  its input voxels; a conv's, its weight times its output voxels.
* The attention core's FLOPs are ``q @ k^T`` and ``attn @ v`` over the
  padded windows: ``4 * tokens * n * C`` a block.
* Minimal bytes count each input read once and each output written once,
  in the activation dtype's width.
"""


def _ceil_to(a, b):
    return -(-a // b) * b


def stages(patch=96, feature_size=48, depths=(2, 2, 2, 2),
           num_heads=(3, 6, 12, 24), window=7, patch_size=2, **_):
    """One dict a stage: ``side`` (the map's edge), ``channels``,
    ``heads``, ``depth``, ``window`` and ``shift`` (as MONAI clips them),
    ``padded`` (the edge the windows tile), ``tokens`` (n, a window's),
    ``windows`` (of one patch), ``merged`` (the edge after merging) and
    ``rows`` (of the bias table, which keeps the full window's)."""
    side = patch // patch_size
    out = []
    for i, (depth, heads) in enumerate(zip(depths, num_heads)):
        w = side if side <= window else window
        shift = 0 if side <= window else window // 2
        padded = _ceil_to(side, w)
        out.append(dict(side=side, channels=feature_size * 2 ** i,
                        heads=heads, depth=depth, window=w, shift=shift,
                        padded=padded, tokens=w ** 3,
                        windows=(padded // w) ** 3,
                        merged=-(-side // 2), rows=(2 * window - 1) ** 3))
        side = -(-side // 2)
    return out


def conv_layers(patch=96, feature_size=48, out_channels=3, in_channels=1,
                patch_size=2, **_):
    """Every conv of one ``patch**3`` forward, in the order it runs, as
    dicts with ``cin``, ``cout``, ``taps``, ``vin``, ``vout`` (input and
    output voxels of one patch), ``transposed`` and ``bias``."""
    fs = feature_size
    sides = [patch // patch_size // 2 ** k for k in range(5)]
    layers = []

    def conv(cin, cout, k, n_in, n_out, transposed=False, bias=False):
        layers.append(dict(cin=cin, cout=cout, taps=k ** 3, vin=n_in ** 3,
                           vout=n_out ** 3, transposed=transposed,
                           bias=bias))

    def res(cin, cout, n):
        conv(cin, cout, 3, n, n)
        conv(cout, cout, 3, n, n)
        if cin != cout:
            conv(cin, cout, 1, n, n)

    conv(in_channels, fs, patch_size, patch, sides[0], bias=True)
    res(in_channels, fs, patch)
    res(fs, fs, sides[0])
    res(2 * fs, 2 * fs, sides[1])
    res(4 * fs, 4 * fs, sides[2])
    res(16 * fs, 16 * fs, sides[4])
    for k, (cin, cout) in zip((3, 2, 1, 0), ((16, 8), (8, 4), (4, 2),
                                             (2, 1))):
        conv(cin * fs, cout * fs, 2, sides[k + 1], sides[k],
             transposed=True)
        res(2 * cout * fs, cout * fs, sides[k])
    conv(fs, fs, 2, sides[0], patch, transposed=True)
    res(2 * fs, fs, patch)
    conv(fs, out_channels, 1, patch, patch, bias=True)
    return layers


def linear_layers(patch=96, mlp_ratio=4, **widths):
    """Every linear of one patch's forward, as dicts with ``tokens``,
    ``fin``, ``fout`` and ``bias``."""
    out = []
    for s in stages(patch, **widths):
        c, tp = s["channels"], s["padded"] ** 3
        for _ in range(s["depth"]):
            out += [dict(tokens=tp, fin=c, fout=3 * c, bias=True),
                    dict(tokens=tp, fin=c, fout=c, bias=True),
                    dict(tokens=s["side"] ** 3, fin=c,
                         fout=int(mlp_ratio * c), bias=True),
                    dict(tokens=s["side"] ** 3, fin=int(mlp_ratio * c),
                         fout=c, bias=True)]
        out.append(dict(tokens=s["merged"] ** 3, fin=8 * c, fout=2 * c,
                        bias=False))
    return out


def conv_flops(layers):
    """FLOPs (2 x multiply-adds) of the convs of one patch."""
    return sum(2 * l["taps"] * l["cin"] * l["cout"]
               * (l["vin"] if l["transposed"] else l["vout"])
               for l in layers)


def linear_flops(layers):
    """FLOPs of the linears of one patch."""
    return sum(2 * l["tokens"] * l["fin"] * l["fout"] for l in layers)


def attention_flops(patch=96, **widths):
    """FLOPs of ``q @ k^T`` and ``attn @ v`` of one patch, over the
    padded windows the model computes."""
    return sum(4 * s["depth"] * s["padded"] ** 3 * s["tokens"]
               * s["channels"] for s in stages(patch, **widths))


def attention_windows(patch=96, batch=1, **widths):
    """(window, head, patch) triples one forward of ``batch`` patches
    attends."""
    return batch * sum(s["depth"] * s["windows"] * s["heads"]
                       for s in stages(patch, **widths))


def attention_bytes(patch=96, batch=1, itemsize=2, **widths):
    """Minimal bytes of the attention cores of one forward of ``batch``
    patches: q, k and v read and the output written over the padded
    windows, each block's bias table read, and, in a shifted block, one
    int32 region id a padded token of one patch (the same in every
    patch)."""
    total = 0
    for s in stages(patch, **widths):
        tp, c = s["padded"] ** 3, s["channels"]
        for b in range(s["depth"]):
            total += 4 * batch * tp * c * itemsize
            total += s["rows"] * s["heads"] * itemsize
            if b % 2 and s["shift"]:
                total += tp * 4
    return total


def conv_bytes(layers, batch, itemsize=2):
    """Minimal bytes of a batch through every conv: the input, the
    weights (and bias) read, the output written."""
    total = 0
    for l in layers:
        x = batch * l["cin"] * l["vin"] * itemsize
        y = batch * l["cout"] * l["vout"] * itemsize
        w = (l["cin"] * l["taps"] * l["cout"]
             + (l["cout"] if l["bias"] else 0)) * itemsize
        total += x + w + y
    return total


def forward_flops(patch=96, **widths):
    """FLOPs of one patch's forward: convs, linears and the attention
    matmuls."""
    return (conv_flops(conv_layers(patch, **widths))
            + linear_flops(linear_layers(patch, **widths))
            + attention_flops(patch, **widths))
