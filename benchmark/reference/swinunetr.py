"""Plain Swin UNETR forward in float32, written from the published model.

Hatamizadeh et al., arXiv:2201.01266, as MONAI's
``monai/networks/nets/swin_unetr.py`` builds ``SwinUNETR(use_v2=False,
norm_name="instance", normalize=True, downsample="merging")`` with every
dropout 0: a ``Conv3d(k=p, s=p)`` patch embedding; four stages of Swin
blocks (``x + Attn(LN1(x))``, ``x + MLP(LN2(x))``, the odd block's
windows rolled by ``-w // 2`` under a -100 region mask, windows padded
with zeros after LN1, the relative-position bias ``table[index[:n,
:n]]`` of the full window's index), each ending in MONAI's legacy patch
merging; every stage output layer-normalized without affine terms; the
UNETR decoder of residual conv blocks (InstanceNorm without affine terms,
LeakyReLU 0.01) and transposed-conv up blocks; a 1x1x1 output conv. The
parameters are a dict under MONAI's state-dict keys; the widths are read
from their shapes. Attention is written out: ``q @ k^T``, the bias and
mask added, softmax, ``@ v``. No kernel of the program.

A one-voxel map (the bottom of a 32^3 patch) is instance-normalized to 0,
where ``torch.nn.InstanceNorm3d`` would refuse it.

``quant="fp8"`` rounds the input and the weight of every conv, transposed
conv and linear to float8 e4m3 with a per-tensor scale (amax / 448)
first: the lower-precision control that the benchmark's limits are set
against.
"""

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
STAGES = 4
# MONAI's PatchMerging (v0.9.0's): x0 ... x7, two of them repeated
MERGE = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
         (1, 0, 1), (0, 1, 0), (0, 0, 1), (1, 1, 1))


def widths(p):
    """``(feature size, depths, heads, window)`` from the parameters."""
    fs = p["swinViT.patch_embed.proj.weight"].shape[0]
    depths, heads = [], []
    for i in range(1, STAGES + 1):
        pre = f"swinViT.layers{i}.0.blocks."
        depths.append(sum(1 for k in p if k.startswith(pre)
                          and k.endswith(".norm1.weight")))
        heads.append(p[pre + "0.attn.relative_position_bias_table"].shape[1])
    rows = p["swinViT.layers1.0.blocks.0.attn.relative_position_bias_table"
             ].shape[0]
    window = (round(rows ** (1 / 3)) + 1) // 2
    return fs, depths, heads, window


def param_shapes(feature_size=48, depths=(2, 2, 2, 2),
                 num_heads=(3, 6, 12, 24), window=7, patch_size=2,
                 mlp_ratio=4, in_channels=1, out_channels=3):
    """Every parameter of the model, by MONAI's key (the relative
    position indices, buffers, are left out: :func:`position_index`)."""
    fs = feature_size
    s = {"swinViT.patch_embed.proj.weight": (fs, in_channels) +
         (patch_size,) * 3,
         "swinViT.patch_embed.proj.bias": (fs,)}
    for i, (depth, heads) in enumerate(zip(depths, num_heads)):
        c = fs * 2 ** i
        pre = f"swinViT.layers{i + 1}.0."
        for b in range(depth):
            blk = f"{pre}blocks.{b}."
            s.update({
                blk + "norm1.weight": (c,), blk + "norm1.bias": (c,),
                blk + "attn.relative_position_bias_table":
                    ((2 * window - 1) ** 3, heads),
                blk + "attn.qkv.weight": (3 * c, c),
                blk + "attn.qkv.bias": (3 * c,),
                blk + "attn.proj.weight": (c, c),
                blk + "attn.proj.bias": (c,),
                blk + "norm2.weight": (c,), blk + "norm2.bias": (c,),
                blk + "mlp.linear1.weight": (mlp_ratio * c, c),
                blk + "mlp.linear1.bias": (mlp_ratio * c,),
                blk + "mlp.linear2.weight": (c, mlp_ratio * c),
                blk + "mlp.linear2.bias": (c,),
            })
        s.update({pre + "downsample.norm.weight": (8 * c,),
                  pre + "downsample.norm.bias": (8 * c,),
                  pre + "downsample.reduction.weight": (2 * c, 8 * c)})

    def res(name, cin, cout):
        s[f"{name}.conv1.conv.weight"] = (cout, cin, 3, 3, 3)
        s[f"{name}.conv2.conv.weight"] = (cout, cout, 3, 3, 3)
        if cin != cout:
            s[f"{name}.conv3.conv.weight"] = (cout, cin, 1, 1, 1)

    for name, cin, cout in (("encoder1", in_channels, fs),
                            ("encoder2", fs, fs),
                            ("encoder3", 2 * fs, 2 * fs),
                            ("encoder4", 4 * fs, 4 * fs),
                            ("encoder10", 16 * fs, 16 * fs)):
        res(name + ".layer", cin, cout)
    for name, cin, cout in (("decoder5", 16 * fs, 8 * fs),
                            ("decoder4", 8 * fs, 4 * fs),
                            ("decoder3", 4 * fs, 2 * fs),
                            ("decoder2", 2 * fs, fs),
                            ("decoder1", fs, fs)):
        s[f"{name}.transp_conv.conv.weight"] = (cin, cout, 2, 2, 2)
        res(name + ".conv_block", 2 * cout, cout)
    s["out.conv.conv.weight"] = (out_channels, fs, 1, 1, 1)
    s["out.conv.conv.bias"] = (out_channels,)
    return s


def position_index(window):
    """MONAI's ``relative_position_index`` of a cubic ``window``: for each
    pair of a window's tokens, its row of the bias table."""
    w, m = window, 2 * window - 1
    r = torch.arange(w)
    a, b, c = (t.reshape(-1) for t in torch.meshgrid(r, r, r, indexing="ij"))
    return ((a[:, None] - a[None, :] + w - 1) * m * m
            + (b[:, None] - b[None, :] + w - 1) * m
            + (c[:, None] - c[None, :] + w - 1))


def _fp8(t):
    scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _q(x, w, quant):
    if quant == "fp8":
        return _fp8(x), _fp8(w)
    if quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return x, w


def _linear(x, w, b, quant):
    x, w = _q(x, w, quant)
    return F.linear(x, w, b)


def _conv(x, w, b, quant, **kw):
    x, w = _q(x, w, quant)
    return F.conv3d(x, w, b, **kw)


def _instance_norm(x, eps=1e-5):
    mean = x.mean(dim=(2, 3, 4), keepdim=True)
    var = x.var(dim=(2, 3, 4), unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def _res_block(p, name, x, quant):
    y = _conv(x, p[f"{name}.conv1.conv.weight"], None, quant, padding=1)
    y = F.leaky_relu(_instance_norm(y), 0.01)
    y = _instance_norm(_conv(y, p[f"{name}.conv2.conv.weight"], None, quant,
                             padding=1))
    if f"{name}.conv3.conv.weight" in p:
        x = _instance_norm(_conv(x, p[f"{name}.conv3.conv.weight"], None,
                                 quant))
    return F.leaky_relu(y + x, 0.01)


def _up_block(p, name, x, skip, quant):
    xq, w = _q(x, p[f"{name}.transp_conv.conv.weight"], quant)
    up = F.conv_transpose3d(xq, w, None, stride=2)
    return _res_block(p, name + ".conv_block", torch.cat([up, skip], 1),
                      quant)


def _windows(x, w):
    """(B, D, H, W, C) -> (B * nW, w^3, C), windows in raster order."""
    b, d, h, ww, c = x.shape
    x = x.reshape(b, d // w[0], w[0], h // w[1], w[1], ww // w[2], w[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        -1, w[0] * w[1] * w[2], c)


def _unwindows(t, w, b, d, h, ww):
    x = t.reshape(b, d // w[0], h // w[1], ww // w[2], w[0], w[1], w[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, ww, -1)


def region_mask(dims, w, s):
    """MONAI's ``compute_mask``: (nW, n, n), -100 between regions."""
    img = torch.zeros((1,) + tuple(dims) + (1,))
    cnt = 0
    for a in (slice(-w[0]), slice(-w[0], -s[0]), slice(-s[0], None)):
        for b in (slice(-w[1]), slice(-w[1], -s[1]), slice(-s[1], None)):
            for c in (slice(-w[2]), slice(-w[2], -s[2]),
                      slice(-s[2], None)):
                img[:, a, b, c, :] = cnt
                cnt += 1
    ids = _windows(img, w).squeeze(-1)
    diff = ids[:, None, :] - ids[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def _window_attention(p, blk, x, heads, index, mask, quant):
    bw, n, c = x.shape
    qkv = _linear(x, p[blk + "attn.qkv.weight"], p[blk + "attn.qkv.bias"],
                  quant)
    qkv = qkv.reshape(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (c // heads) ** -0.5
    attn = q @ k.transpose(-2, -1)
    table = p[blk + "attn.relative_position_bias_table"]
    bias = table[index[:n, :n].reshape(-1)].reshape(n, n, -1)
    attn = attn + bias.permute(2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(bw // nw, nw, heads, n, n) + mask[None, :, None]
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(bw, n, c)
    return _linear(out, p[blk + "attn.proj.weight"],
                   p[blk + "attn.proj.bias"], quant)


def swin_block(p, blk, x, heads, window, shift, index, mask, quant=None):
    """One Swin block (key prefix ``blk``) on a channels-last map;
    ``mask`` (:func:`region_mask`) applies where ``shift`` is not 0."""
    b, d, h, w, c = x.shape
    y = F.layer_norm(x, (c,), p[blk + "norm1.weight"], p[blk + "norm1.bias"])
    pads = [(window[i] - s % window[i]) % window[i]
            for i, s in enumerate((d, h, w))]
    y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    _, dp, hp, wp, _ = y.shape
    shifted = any(s > 0 for s in shift)
    if shifted:
        y = torch.roll(y, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
    out = _window_attention(p, blk, _windows(y, window), heads, index,
                            mask if shifted else None, quant)
    y = _unwindows(out, window, b, dp, hp, wp)
    if shifted:
        y = torch.roll(y, shifts=tuple(shift), dims=(1, 2, 3))
    x = x + y[:, :d, :h, :w]
    y = F.layer_norm(x, (c,), p[blk + "norm2.weight"], p[blk + "norm2.bias"])
    y = F.gelu(_linear(y, p[blk + "mlp.linear1.weight"],
                       p[blk + "mlp.linear1.bias"], quant))
    return x + _linear(y, p[blk + "mlp.linear2.weight"],
                       p[blk + "mlp.linear2.bias"], quant)


def merge(p, pre, x, quant=None):
    """MONAI's legacy patch merging of stage ``pre`` on a channels-last
    map."""
    d, h, w = x.shape[1:4]
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
    x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in MERGE], -1)
    x = F.layer_norm(x, (x.shape[-1],), p[pre + "downsample.norm.weight"],
                     p[pre + "downsample.norm.bias"])
    return _linear(x, p[pre + "downsample.reduction.weight"], None, quant)


def geometry(dims, window_size):
    """``(window, shift, padded dims)`` of a stage's map: MONAI's
    ``get_window_size`` (the map's size, and no shift, on an axis no
    larger than the window) and the size the windows tile."""
    window = [d if d <= window_size else window_size for d in dims]
    shift = [0 if d <= window_size else window_size // 2 for d in dims]
    padded = [-(-d // w) * w for d, w in zip(dims, window)]
    return window, shift, padded


def _stage(p, i, x, depth, heads, window_size, quant):
    """Stage ``i`` (1-based) on a channels-last map."""
    window, shift, padded = geometry(x.shape[1:4], window_size)
    mask = region_mask(padded, window, shift).to(x.device) \
        if any(shift) else None
    index = position_index(window_size).to(x.device)
    pre = f"swinViT.layers{i}.0."
    for b in range(depth):
        x = swin_block(p, f"{pre}blocks.{b}.", x, heads, window,
                       shift if b % 2 else (0, 0, 0), index, mask, quant)
    return merge(p, pre, x, quant)


def _proj_out(x):
    """Channels-last map -> NCDHW, layer-normalized without affine."""
    return F.layer_norm(x, (x.shape[-1],)).permute(0, 4, 1, 2, 3)


def forward(p, x, quant=None):
    """Logits (N, C, D, H, W) of a float32 (N, 1, D, H, W) batch."""
    _, depths, heads, window = widths(p)
    h = _conv(x, p["swinViT.patch_embed.proj.weight"],
              p["swinViT.patch_embed.proj.bias"], quant,
              stride=p["swinViT.patch_embed.proj.weight"].shape[2])
    h = h.permute(0, 2, 3, 4, 1)
    hidden = [_proj_out(h)]
    for i in range(STAGES):
        h = _stage(p, i + 1, h, depths[i], heads[i], window, quant)
        hidden.append(_proj_out(h))
    enc0 = _res_block(p, "encoder1.layer", x, quant)
    enc1 = _res_block(p, "encoder2.layer", hidden[0], quant)
    enc2 = _res_block(p, "encoder3.layer", hidden[1], quant)
    enc3 = _res_block(p, "encoder4.layer", hidden[2], quant)
    y = _res_block(p, "encoder10.layer", hidden[4], quant)
    y = _up_block(p, "decoder5", y, hidden[3], quant)
    y = _up_block(p, "decoder4", y, enc3, quant)
    y = _up_block(p, "decoder3", y, enc2, quant)
    y = _up_block(p, "decoder2", y, enc1, quant)
    y = _up_block(p, "decoder1", y, enc0, quant)
    return _conv(y, p["out.conv.conv.weight"], p["out.conv.conv.bias"],
                 quant)
