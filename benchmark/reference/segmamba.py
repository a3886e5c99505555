"""Plain SegMamba forward in float32, written from the published model.

Xing et al., arXiv:2401.13560, as ge-xing/SegMamba's ``SegMamba`` builds
it (``norm_name="instance"``, ``res_block=True``): the encoder ``vit`` of
four stages, each a downsample (a 7^3 stride-2 stem conv, then IN and a
2^3 stride-2 conv), a GSC block (``x + ReLU(IN(proj4(a + b)))``, ``a =
ReLU(IN(proj2(ReLU(IN(proj(x))))))``, ``b = ReLU(IN(proj3(x)))``), two
Mamba layers and an output ``fc2(GELU(fc1(IN(x))))``; the UNETR decoder of
residual conv blocks and transposed-conv up blocks (as the Swin UNETR
reference writes them); a 1^3 output conv. IN is InstanceNorm without
affine terms (eps 1e-5). The parameters are a dict under SegMamba's
state-dict keys; the widths are read from their shapes.

A Mamba layer (``mamba_ssm``'s ``Mamba``, bimamba "v3", as SegMamba forks
it): the map's tokens (W fastest) layer-normalized, ``in_proj`` to ``x``
and ``z``; then for each of three directions, each with its own weights
(suffixes none, ``_b``, ``_s``), ``x`` and ``z`` put in the direction's
order (as they are; flipped; ``chunk(nslices)`` along the sequence,
stacked on a new last axis and flattened, ``nslices`` the map's depth),
``u = SiLU(conv1d(x))`` (depthwise, 4 taps, left-padded 3), ``[delta_r,
B, C] = x_proj(u)``, ``delta = softplus(dt_proj(delta_r))``, ``A =
-exp(A_log)``, the selective scan ``h_t = exp(delta_t A) h_{t-1} +
delta_t B_t u_t``, ``y_t = C_t . h_t + D u_t``, gated ``y * SiLU(z)``, and
put back in token order; the three summed, ``out_proj``, the layer's
input added. No kernel of the program.

The scan is computed in chunks of at most :data:`CHUNK` steps, its one
departure from a step-by-step loop: the recurrence of every chunk is
stepped from a zero state, all chunks at once; the state entering each
chunk is carried across the chunks through their decays ``exp(A *
sum(delta))``; and each chunk's outputs get the carried state's share in
closed form, ``C_t . (exp(A S_t) h_in)`` with ``S_t`` the chunk's running
sum of delta. That keeps it within memory and within seconds at 262,144
steps.

``quant="fp8"`` rounds the input and the weight of every conv, transposed
conv and linear to float8 e4m3 with a per-tensor scale (amax / 448)
first: the lower-precision control that the benchmark's limits are set
against.
"""

import math

import torch
import torch.nn.functional as F

from benchmark.reference.precision import restore_tf32, tf32_off
from benchmark.reference.swinunetr import (
    _conv,
    _instance_norm,
    _linear,
    _q,
    _res_block,
    _up_block,
)

STAGES = 4
CHUNK = 64
SUFFIXES = ("", "_b", "_s")
LN_EPS = 1e-5


def widths(p):
    """``(feat_size, depths, hidden_size)`` from the parameters."""
    feat = [p["vit.downsample_layers.0.0.weight"].shape[0]] + [
        p[f"vit.downsample_layers.{i}.1.weight"].shape[0]
        for i in range(1, STAGES)]
    depths = [sum(1 for k in p if k.startswith(f"vit.stages.{i}.")
                  and k.endswith(".norm.weight")) for i in range(STAGES)]
    return feat, depths, p["encoder5.layer.conv1.conv.weight"].shape[0]


def _mamba_shapes(pre, c, d_state, d_conv, expand):
    d, r = expand * c, math.ceil(c / 16)
    s = {pre + "norm.weight": (c,), pre + "norm.bias": (c,),
         pre + "mamba.in_proj.weight": (2 * d, c),
         pre + "mamba.out_proj.weight": (c, d)}
    for sfx in SUFFIXES:
        m = pre + "mamba."
        s.update({m + f"conv1d{sfx}.weight": (d, 1, d_conv),
                  m + f"conv1d{sfx}.bias": (d,),
                  m + f"x_proj{sfx}.weight": (r + 2 * d_state, d),
                  m + f"dt_proj{sfx}.weight": (d, r),
                  m + f"dt_proj{sfx}.bias": (d,),
                  m + f"A{sfx}_log": (d, d_state),
                  m + f"D{sfx}": (d,)})
    return s


def param_shapes(in_channels=1, out_channels=3, depths=(2, 2, 2, 2),
                 feat_size=(48, 96, 192, 384), hidden_size=768, d_state=16,
                 d_conv=4, expand=2):
    """Every parameter of the model, by SegMamba's key."""
    fs = feat_size
    s = {"vit.downsample_layers.0.0.weight": (fs[0], in_channels, 7, 7, 7),
         "vit.downsample_layers.0.0.bias": (fs[0],)}
    for i in range(1, STAGES):
        s[f"vit.downsample_layers.{i}.1.weight"] = (fs[i], fs[i - 1], 2, 2,
                                                    2)
        s[f"vit.downsample_layers.{i}.1.bias"] = (fs[i],)
    for i, c in enumerate(fs):
        for name, k in (("proj", 3), ("proj2", 3), ("proj3", 1),
                        ("proj4", 1)):
            s[f"vit.gscs.{i}.{name}.weight"] = (c, c, k, k, k)
            s[f"vit.gscs.{i}.{name}.bias"] = (c,)
        for j in range(depths[i]):
            s.update(_mamba_shapes(f"vit.stages.{i}.{j}.", c, d_state,
                                   d_conv, expand))
        s[f"vit.mlps.{i}.fc1.weight"] = (2 * c, c, 1, 1, 1)
        s[f"vit.mlps.{i}.fc1.bias"] = (2 * c,)
        s[f"vit.mlps.{i}.fc2.weight"] = (c, 2 * c, 1, 1, 1)
        s[f"vit.mlps.{i}.fc2.bias"] = (c,)

    def res(name, cin, cout):
        s[f"{name}.conv1.conv.weight"] = (cout, cin, 3, 3, 3)
        s[f"{name}.conv2.conv.weight"] = (cout, cout, 3, 3, 3)
        if cin != cout:
            s[f"{name}.conv3.conv.weight"] = (cout, cin, 1, 1, 1)

    ladder = [in_channels] + list(fs) + [hidden_size]
    for i in range(STAGES + 1):
        res(f"encoder{i + 1}.layer", ladder[i], ladder[i + 1])
    for i in range(STAGES, 0, -1):
        cin, cout = ladder[i + 1], ladder[i]
        s[f"decoder{i + 1}.transp_conv.conv.weight"] = (cin, cout, 2, 2, 2)
        res(f"decoder{i + 1}.conv_block", 2 * cout, cout)
    res("decoder1.layer", fs[0], fs[0])
    s["out.conv.conv.weight"] = (out_channels, fs[0], 1, 1, 1)
    s["out.conv.conv.bias"] = (out_channels,)
    return s


def scan(u, delta, A, Bm, Cm, D, chunk=CHUNK):
    """The selective scan of (Bt, L, d) sequences in order: ``u``,
    ``delta`` (Bt, L, d), ``A`` (d, N), ``Bm``, ``Cm`` (Bt, L, N), ``D``
    (d); ``y`` (Bt, L, d)."""
    bt, length, d = u.shape
    nc = -(-length // chunk)
    pad = nc * chunk - length

    def split(t):  # zero delta in the pad: no decay, no input
        return F.pad(t, (0, 0, 0, pad)).view(bt, nc, chunk, t.shape[-1])

    u_, dl, bm, cm = (split(t) for t in (u, delta, Bm, Cm))
    h = u.new_zeros((bt, nc, d, A.shape[1]))
    y = u.new_empty((bt, nc, chunk, d))
    for t in range(chunk):  # every chunk from a zero state
        h = (torch.exp(dl[:, :, t, :, None] * A) * h
             + (dl[:, :, t] * u_[:, :, t])[..., None] * bm[:, :, t, None, :])
        y[:, :, t] = (h * cm[:, :, t, None, :]).sum(-1)
    run = dl.cumsum(2)
    carry, entering = h.new_zeros((bt, d, A.shape[1])), []
    for k in range(nc):
        entering.append(carry)
        carry = torch.exp(run[:, k, -1, :, None] * A) * carry + h[:, k]
    h_in = torch.stack(entering, 1)
    for t in range(chunk):  # the carried state's share
        y[:, :, t] += (torch.exp(run[:, :, t, :, None] * A) * h_in
                       * cm[:, :, t, None, :]).sum(-1)
    return y.reshape(bt, nc * chunk, d)[:, :length] + D * u


def _orders(nslices, length):
    """``(suffix, into order, back to token order)`` of each direction."""
    hw = length // nslices

    def slices(t):  # SegMamba: chunk(nslices), stack on a last axis, flatten
        return torch.stack(t.chunk(nslices, dim=1), dim=2).flatten(1, 2)

    def unslice(t):
        return t.reshape(t.shape[0], hw, nslices, -1).transpose(1, 2) \
            .reshape(t.shape[0], length, -1)

    def same(t):
        return t

    def flip(t):
        return t.flip(1)

    return (("", same, same), ("_b", flip, flip), ("_s", slices, unslice))


def mamba_layer(p, pre, x, quant=None):
    """One Mamba layer (key prefix ``pre``) of an NCDHW map: the layer's
    output map, the input added."""
    b, c = x.shape[:2]
    t = x.reshape(b, c, -1).transpose(1, 2)
    length = t.shape[1]
    t = F.layer_norm(t, (c,), p[pre + "norm.weight"], p[pre + "norm.bias"],
                     LN_EPS)
    m = pre + "mamba."
    xz = _linear(t, p[m + "in_proj.weight"], None, quant)
    d = xz.shape[-1] // 2
    total = 0
    for sfx, into, back in _orders(x.shape[2], length):
        xs, zs = into(xz[..., :d]), into(xz[..., d:])
        xq, wq = _q(xs.transpose(1, 2), p[m + f"conv1d{sfx}.weight"], quant)
        xq = F.pad(xq, (wq.shape[-1] - 1, 0))  # causal: left-padded
        u = F.silu(F.conv1d(xq, wq, p[m + f"conv1d{sfx}.bias"], groups=d)
                   ).transpose(1, 2)
        dbl = _linear(u, p[m + f"x_proj{sfx}.weight"], None, quant)
        dt_w = p[m + f"dt_proj{sfx}.weight"]
        r, n = dt_w.shape[1], p[m + f"A{sfx}_log"].shape[1]
        delta = F.softplus(_linear(dbl[..., :r], dt_w,
                                   p[m + f"dt_proj{sfx}.bias"], quant))
        y = scan(u, delta, -torch.exp(p[m + f"A{sfx}_log"]),
                 dbl[..., r:r + n], dbl[..., r + n:], p[m + f"D{sfx}"])
        total = total + back(y * F.silu(zs))
    y = _linear(total, p[m + "out_proj.weight"], None, quant)
    return x + y.transpose(1, 2).reshape(x.shape)


def _gsc(p, pre, x, quant):
    def conv(name, h, pad):
        return _conv(h, p[f"{pre}{name}.weight"], p[f"{pre}{name}.bias"],
                     quant, padding=pad)

    a = F.relu(_instance_norm(conv("proj", x, 1)))
    a = F.relu(_instance_norm(conv("proj2", a, 1)))
    b = F.relu(_instance_norm(conv("proj3", x, 0)))
    return x + F.relu(_instance_norm(conv("proj4", a + b, 0)))


def encoder(p, x, quant=None):
    """The four stage outputs of ``vit``."""
    _, depths, _ = widths(p)
    outs = []
    for i in range(STAGES):
        pre = f"vit.downsample_layers.{i}."
        if i == 0:
            x = _conv(x, p[pre + "0.weight"], p[pre + "0.bias"], quant,
                      stride=2, padding=3)
        else:
            x = _conv(_instance_norm(x), p[pre + "1.weight"],
                      p[pre + "1.bias"], quant, stride=2)
        x = _gsc(p, f"vit.gscs.{i}.", x, quant)
        for j in range(depths[i]):
            x = mamba_layer(p, f"vit.stages.{i}.{j}.", x, quant)
        h = F.gelu(_conv(_instance_norm(x), p[f"vit.mlps.{i}.fc1.weight"],
                         p[f"vit.mlps.{i}.fc1.bias"], quant))
        outs.append(_conv(h, p[f"vit.mlps.{i}.fc2.weight"],
                          p[f"vit.mlps.{i}.fc2.bias"], quant))
    return outs


def forward(p, x, quant=None):
    """Logits (N, out, D, H, W) of a float32 (N, in, D, H, W) batch, with
    TF32 off."""
    saved = tf32_off()
    try:
        outs = encoder(p, x, quant)
        skips = [_res_block(p, "encoder1.layer", x, quant)] + [
            _res_block(p, f"encoder{i + 2}.layer", outs[i], quant)
            for i in range(STAGES - 1)]
        y = _res_block(p, "encoder5.layer", outs[3], quant)
        for i in range(STAGES, 0, -1):
            y = _up_block(p, f"decoder{i + 1}", y, skips[i - 1], quant)
        y = _res_block(p, "decoder1.layer", y, quant)
        return _conv(y, p["out.conv.conv.weight"], p["out.conv.conv.bias"],
                     quant)
    finally:
        restore_tf32(saved)
