"""Plain UNet3D forward in float32, written from the published model.

AllenNeuralDynamics aind-exaspim-neuron-segmentation,
``machine_learning/unet3d.py``: channels 32/64/128/256/512 times the
width, DoubleConv = [Conv3d(3, padding 1) -> BatchNorm3d(eps 1e-5) ->
LeakyReLU(0.01)] x 2, four MaxPool3d(2) levels, trilinear x2 upsampling
with ``align_corners=True``, the decoder concatenating ``[skip,
upsampled]`` with the mid width half the concat, a 1x1x1 output conv,
raw logits out. The parameters are a dict under the published checkpoint
keys (``inc.double_conv.0.weight``, ...), unfolded: BatchNorm is applied
as BatchNorm. No kernel of the program and no layout trick: the full
forward over the whole patch, which callers trim.

``quant="fp8"`` rounds every conv's input and weight to float8 e4m3 with a
per-tensor scale (amax / 448) before the conv, the gradient passing
straight through: the lower-precision control that the benchmark's
limits are set against.
"""

import torch
import torch.nn.functional as F

CHANNELS = (32, 64, 128, 256, 512)
E4M3_MAX = 448.0


def block_names():
    """``(module prefix, input channels, mid channels, output channels,
    level)`` of every DoubleConv, encoder then decoder, for width 1."""
    ch = CHANNELS
    rows = [("inc.double_conv", 1, ch[0], ch[0], 0)]
    for k in range(1, 5):
        cout = ch[k] if k < 4 else ch[4] // 2
        rows.append((f"down{k}.maxpool_conv.1.double_conv", ch[k - 1],
                     cout, cout, k))
    for k, level in zip(range(1, 5), (3, 2, 1, 0)):
        skip = ch[level]
        cout = skip // 2 if level else skip
        rows.append((f"up{k}.conv.double_conv", 2 * skip, skip, cout, level))
    return rows


def param_shapes(width=1.0, out_channels=3):
    """Every parameter and BatchNorm statistic of the model, by key."""
    shapes = {}
    for prefix, cin, mid, cout, _ in block_names():
        cin = 1 if cin == 1 else int(cin * width)
        mid, cout = int(mid * width), int(cout * width)
        for idx, (a, b) in (("0", (cin, mid)), ("3", (mid, cout))):
            shapes[f"{prefix}.{idx}.weight"] = (b, a, 3, 3, 3)
            shapes[f"{prefix}.{idx}.bias"] = (b,)
        for idx, c in (("1", mid), ("4", cout)):
            for name in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"{prefix}.{idx}.{name}"] = (c,)
    c0 = int(CHANNELS[0] * width)
    shapes["outc.conv.weight"] = (out_channels, c0, 1, 1, 1)
    shapes["outc.conv.bias"] = (out_channels,)
    return shapes


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 with a per-tensor scale; straight-through
    gradient."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, grad):
        return grad


def _conv(x, w, b, padding, quant):
    if quant == "fp8":
        x, w = _Fp8.apply(x), _Fp8.apply(w)
    elif quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return F.conv3d(x, w, b, padding=padding)


def _double(p, prefix, x, mode, quant):
    for conv, bn in (("0", "1"), ("3", "4")):
        x = _conv(x, p[f"{prefix}.{conv}.weight"], p[f"{prefix}.{conv}.bias"],
                  1, quant)
        stats = mode != "train"
        x = F.batch_norm(
            x,
            p[f"{prefix}.{bn}.running_mean"] if stats else None,
            p[f"{prefix}.{bn}.running_var"] if stats else None,
            p[f"{prefix}.{bn}.weight"], p[f"{prefix}.{bn}.bias"],
            training=mode != "eval", momentum=1.0, eps=1e-5,
        )
        x = F.leaky_relu(x, 0.01, inplace=True)
    return x


def forward(p, x, train=False, quant=None, calibrate=False):
    """Logits (N, C, D, H, W) of a float32 (N, 1, D, H, W) batch.

    ``train``: BatchNorm normalizes by the batch's statistics (and
    touches no running statistics), else by ``p``'s running ones.
    ``calibrate``: normalizes by the batch's statistics and writes them,
    mean and unbiased variance, into ``p``'s running statistics.
    """
    mode = "calibrate" if calibrate else "train" if train else "eval"
    names = [r[0] for r in block_names()]
    skips = [_double(p, names[0], x, mode, quant)]
    for name in names[1:5]:
        skips.append(_double(p, name, F.max_pool3d(skips[-1], 2), mode,
                             quant))
    y = skips.pop()
    for name in names[5:]:
        skip = skips.pop()
        up = F.interpolate(y, scale_factor=2, mode="trilinear",
                           align_corners=True)
        d_y = skip.size(2) - up.size(2)
        d_x = skip.size(3) - up.size(3)
        if d_y or d_x:  # the published model pads H by the D mismatch
            up = F.pad(up, [d_x // 2, d_x - d_x // 2, d_y // 2,
                            d_y - d_y // 2])
        y = _double(p, name, torch.cat([skip, up], dim=1), mode, quant)
    return _conv(y, p["outc.conv.weight"], p["outc.conv.bias"], 0, quant)

