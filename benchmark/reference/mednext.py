"""Plain MedNeXt forward in float32, written from the published model.

Roy et al., arXiv:2303.09975, as MIC-DKFZ/MedNeXt's ``MedNeXt`` builds it
with ``do_res`` and ``do_res_up_down`` on, group norm and no GRN: a
``1^3`` stem; four encoder stages of blocks (``x + conv3(GELU(conv2(
GN(dw(x)))))``, ``dw`` a depthwise ``k^3`` conv, GN per channel), each
followed by a down block (a stride-2 depthwise conv in the chain and a
stride-2 ``1^3`` ``res_conv`` added); the bottleneck stage; four up
blocks (a depthwise stride-2 transposed conv in the chain and a stride-2
``1^3`` transposed ``res_conv``, each padded one voxel at the low end of
each axis, then added), each added to its encoder stage's output and
followed by a decoder stage; a ``1^3`` transposed output conv. The
parameters are a dict under MedNeXt's state-dict keys; the widths are read
from their shapes. GroupNorm is written out (mean and biased variance
over D, H, W per channel), GELU is exact (erf). No kernel of the program.

``quant="fp8"`` rounds the input and the weight of every conv and
transposed conv to float8 e4m3 with a per-tensor scale (amax / 448)
first: the lower-precision control that the benchmark's limits are set
against.
"""

import torch
import torch.nn.functional as F

from benchmark.reference.precision import restore_tf32, tf32_off

E4M3_MAX = 448.0
GN_EPS = 1e-5
STAGES = 4
PUBLISHED_L = (3, 4, 8, 8, 8, 8, 8, 4, 3)


def stage_names():
    """The nine stages of blocks, in the order they run."""
    return ([f"enc_block_{i}" for i in range(STAGES)] + ["bottleneck"]
            + [f"dec_block_{i}" for i in reversed(range(STAGES))])


def widths(p):
    """``(n_channels, exp_r, block_counts, kernel_size)`` from the
    parameters."""
    counts = [sum(1 for k in p if k.startswith(name + ".")
                  and k.endswith(".conv1.weight")) for name in stage_names()]

    def ratio(name):
        w = p[name + ".conv2.weight"]
        return w.shape[0] // w.shape[1]

    exp_r = ([ratio("enc_block_0.0")]
             + [ratio(f"down_{i}") for i in range(STAGES)]
             + [ratio(f"up_{i}") for i in reversed(range(STAGES))])
    return (p["stem.weight"].shape[0], exp_r, counts,
            p["down_0.conv1.weight"].shape[-1])


def _block_shapes(pre, cin, cout, r, k, mode):
    s = {pre + "conv1.weight": (cin, 1) + (k,) * 3,
         pre + "conv1.bias": (cin,),
         pre + "norm.weight": (cin,), pre + "norm.bias": (cin,),
         pre + "conv2.weight": (r * cin, cin, 1, 1, 1),
         pre + "conv2.bias": (r * cin,),
         pre + "conv3.weight": (cout, r * cin, 1, 1, 1),
         pre + "conv3.bias": (cout,)}
    if mode == "down":
        s[pre + "res_conv.weight"] = (cout, cin, 1, 1, 1)
    elif mode == "up":
        s[pre + "res_conv.weight"] = (cin, cout, 1, 1, 1)
    if mode != "same":
        s[pre + "res_conv.bias"] = (cout,)
    return s


def param_shapes(n_channels=32, exp_r=PUBLISHED_L, block_counts=PUBLISHED_L,
                 kernel_size=5, in_channels=1, out_channels=3):
    """Every parameter of the model, by MedNeXt's key (no deep-supervision
    head and no ``dummy_tensor``)."""
    c = [n_channels * 2 ** i for i in range(STAGES + 1)]
    k = kernel_size
    s = {"stem.weight": (c[0], in_channels, 1, 1, 1), "stem.bias": (c[0],)}

    def stage(name, ch, r, count):
        for j in range(count):
            s.update(_block_shapes(f"{name}.{j}.", ch, ch, r, k, "same"))

    for i in range(STAGES):
        stage(f"enc_block_{i}", c[i], exp_r[i], block_counts[i])
        s.update(_block_shapes(f"down_{i}.", c[i], c[i + 1], exp_r[i + 1], k,
                               "down"))
    stage("bottleneck", c[4], exp_r[4], block_counts[4])
    for j in range(STAGES):
        i = STAGES - 1 - j
        s.update(_block_shapes(f"up_{i}.", c[i + 1], c[i], exp_r[5 + j], k,
                               "up"))
        stage(f"dec_block_{i}", c[i], exp_r[5 + j], block_counts[5 + j])
    s["out_0.conv_out.weight"] = (c[0], out_channels, 1, 1, 1)
    s["out_0.conv_out.bias"] = (out_channels,)
    return s


def _fp8(t):
    scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _q(x, w, quant):
    if quant == "fp8":
        return _fp8(x), _fp8(w)
    if quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return x, w


def _conv(x, w, b, quant, **kw):
    x, w = _q(x, w, quant)
    return F.conv3d(x, w, b, **kw)


def _conv_t(x, w, b, quant, **kw):
    x, w = _q(x, w, quant)
    return F.conv_transpose3d(x, w, b, **kw)


def group_norm(x, weight, bias, eps=GN_EPS):
    """``GroupNorm(C, C)``: each channel of each sample normalized by its
    own mean and biased variance over D, H, W, then scaled and shifted."""
    mean = x.mean(dim=(2, 3, 4), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    return y * weight.view(1, -1, 1, 1, 1) + bias.view(1, -1, 1, 1, 1)


def _low_pad(x):
    """One voxel of zeros before the start of each spatial axis."""
    return F.pad(x, (1, 0, 1, 0, 1, 0))


def block(p, pre, x, mode="same", quant=None):
    """One block under the key prefix ``pre`` (ending in "."): ``mode``
    "same", "down" or "up"."""
    c = x.shape[1]
    w1, b1 = p[pre + "conv1.weight"], p[pre + "conv1.bias"]
    pad = w1.shape[-1] // 2
    if mode == "up":
        y = _conv_t(x, w1, b1, quant, stride=2, padding=pad, groups=c)
    else:
        y = _conv(x, w1, b1, quant, stride=2 if mode == "down" else 1,
                  padding=pad, groups=c)
    y = group_norm(y, p[pre + "norm.weight"], p[pre + "norm.bias"])
    y = F.gelu(_conv(y, p[pre + "conv2.weight"], p[pre + "conv2.bias"],
                     quant))
    y = _conv(y, p[pre + "conv3.weight"], p[pre + "conv3.bias"], quant)
    if mode == "same":
        return x + y
    wr, br = p[pre + "res_conv.weight"], p[pre + "res_conv.bias"]
    if mode == "down":
        return y + _conv(x, wr, br, quant, stride=2)
    return _low_pad(y) + _low_pad(_conv_t(x, wr, br, quant, stride=2))


def forward(p, x, quant=None):
    """Logits (N, out, D, H, W) of a float32 (N, in, D, H, W) batch, with
    TF32 off."""
    _, _, counts, _ = widths(p)
    names = stage_names()
    saved = tf32_off()
    try:
        h = _conv(x, p["stem.weight"], p["stem.bias"], quant)
        skips = []
        for i in range(STAGES):
            for j in range(counts[i]):
                h = block(p, f"{names[i]}.{j}.", h, quant=quant)
            skips.append(h)
            h = block(p, f"down_{i}.", h, "down", quant)
        for j in range(counts[4]):
            h = block(p, f"bottleneck.{j}.", h, quant=quant)
        for n, i in enumerate(reversed(range(STAGES))):
            h = block(p, f"up_{i}.", h, "up", quant) + skips[i]
            for j in range(counts[5 + n]):
                h = block(p, f"{names[5 + n]}.{j}.", h, quant=quant)
        return _conv_t(h, p["out_0.conv_out.weight"],
                       p["out_0.conv_out.bias"], quant)
    finally:
        restore_tf32(saved)
