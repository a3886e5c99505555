"""PyTorch SegMamba (3D), with the published SegMamba semantics.

Xing et al., "SegMamba: Long-range Sequential Modeling Mamba For 3D
Medical Image Segmentation" (MICCAI 2024, arXiv:2401.13560), as
ge-xing/SegMamba's ``model_segmamba/segmamba.py`` builds ``SegMamba(
in_chans, out_chans, depths=[2, 2, 2, 2], feat_size=[48, 96, 192, 384],
hidden_size=768, norm_name="instance", res_block=True)``: 67,362,723
parameters with 1 channel in and 3 out.

Architecture contract ("IN" is InstanceNorm without affine terms, eps
1e-5; maps are (N, C, D, H, W)):

* encoder (``vit``), stage ``i`` of 4: the downsample (``i = 0``:
  ``Conv3d(in, C0, 7, stride 2, padding 3)``; else IN, then
  ``Conv3d(C_{i-1}, C_i, 2, stride 2)``), the GSC (``x + ReLU(IN(proj4(a
  + b)))`` with ``a = ReLU(IN(proj2(ReLU(IN(proj(x))))))``, ``b =
  ReLU(IN(proj3(x)))``, ``proj``/``proj2`` 3^3 convs, ``proj3``/
  ``proj4`` 1^3, all with bias), ``depths[i]`` Mamba layers, and the
  stage's output ``mlps.i(IN(x))`` (``Conv3d(C, 2C, 1)``, exact GELU,
  ``Conv3d(2C, C, 1)``);
* Mamba layer (``C`` channels, ``d = expand * C`` inner, ``R =
  ceil(C / 16)``, 16 states): the map's tokens (W fastest), ``xz =
  in_proj(LN(tokens))`` (a Linear to ``2d`` without bias, LN with affine
  terms, eps 1e-5), the three directions of ``mamba_ssm``'s bimamba
  "v3" (forward, backward and depth slices, each with its own
  ``conv1d``, ``x_proj``, ``dt_proj``, ``A_log`` and ``D``: see
  :mod:`..ops.selective_scan`), their gated outputs summed, ``out_proj``
  (a Linear to ``C`` without bias), and the layer's input added; the
  slice order cuts the map into its depth's worth of slices (``nslices``
  = D: SegMamba's ``[64, 32, 16, 8]`` at a 128^3 patch);
* decoder: MONAI's UNETR blocks (:mod:`.unetr_blocks`): ``encoder1`` on
  the input, ``encoder2..4`` on the first three stage outputs (widths
  ``C_i -> C_{i+1}``), ``encoder5`` (``C_3 -> hidden_size``) on the
  last, ``decoder5..2`` up blocks back to ``C_0`` with the encoders'
  maps as skips, ``decoder1`` a basic block, ``out`` a 1^3 conv with
  bias; raw logits out.

``state_dict`` keys are SegMamba's (``vit.downsample_layers.0.0.weight``,
``vit.gscs.1.proj2.bias``, ``vit.stages.2.1.norm.weight``,
``vit.stages.0.0.mamba.A_b_log``, ``vit.stages.3.1.mamba.dt_proj_s.bias``,
``vit.mlps.0.fc1.weight``, ``encoder5.layer.conv1.conv.weight``,
``decoder2.transp_conv.conv.weight``, ``out.conv.conv.bias``, ...), so
such a checkpoint loads with a strict ``load_state_dict``.

Each direction's causal conv and scan run through
:mod:`..ops.selective_scan`: the hand-written kernels on a card, the
plain version on the CPU; ``x_proj``, ``in_proj`` and ``out_proj`` are
GEMMs.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from aind_exaspim_neuron_segmentation_tpu_torch.models.unetr_blocks import (
    UnetOutBlock,
    UnetrBasicBlock,
    UnetrUpBlock,
    _norm,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops.selective_scan import (
    ORDERS,
    scan_conv,
    selective_scan,
)
from aind_exaspim_neuron_segmentation_tpu_torch.utils.profiling import (
    annotate,
)

STAGES = 4
# the parameter names' suffix of each direction, in ORDERS' order
SUFFIXES = ("", "_b", "_s")


class InstanceNorm(nn.Module):
    """InstanceNorm without affine terms (no parameters, no keys)."""

    def forward(self, x):
        """The normalized map."""
        return _norm(x)


class GSC(nn.Module):
    """SegMamba's gated spatial convolution block, ``C -> C``."""

    def __init__(self, c):
        super().__init__()
        self.proj = nn.Conv3d(c, c, 3, padding=1)
        self.proj2 = nn.Conv3d(c, c, 3, padding=1)
        self.proj3 = nn.Conv3d(c, c, 1)
        self.proj4 = nn.Conv3d(c, c, 1)

    def forward(self, x):
        """``x + ReLU(IN(proj4(a + b)))``."""
        a = F.relu(_norm(self.proj2(F.relu(_norm(self.proj(x))))))
        b = F.relu(_norm(self.proj3(x)))
        return x + F.relu(_norm(self.proj4(a + b)))


class MlpChannel(nn.Module):
    """``Conv3d(C, 2C, 1)``, exact GELU, ``Conv3d(2C, C, 1)``."""

    def __init__(self, c, hidden):
        super().__init__()
        self.fc1 = nn.Conv3d(c, hidden, 1)
        self.fc2 = nn.Conv3d(hidden, c, 1)

    def forward(self, x):
        """The channel MLP."""
        return self.fc2(F.gelu(self.fc1(x)))


class Mamba(nn.Module):
    """``mamba_ssm``'s ``Mamba`` with bimamba "v3": three directions of
    selective scan over one token sequence."""

    def __init__(self, d_model, d_state=16, d_conv=4, expand=2):
        super().__init__()
        d = expand * d_model
        rank = math.ceil(d_model / 16)
        self.in_proj = nn.Linear(d_model, 2 * d, bias=False)
        for sfx in SUFFIXES:
            setattr(self, "conv1d" + sfx, nn.Conv1d(
                d, d, d_conv, groups=d, padding=d_conv - 1))
            setattr(self, "x_proj" + sfx,
                    nn.Linear(d, rank + 2 * d_state, bias=False))
            setattr(self, "dt_proj" + sfx, nn.Linear(rank, d))
            a = torch.arange(1, d_state + 1, dtype=torch.float32)
            setattr(self, _a_log(sfx),
                    nn.Parameter(torch.log(a).repeat(d, 1)))
            setattr(self, "D" + sfx, nn.Parameter(torch.ones(d)))
        self.out_proj = nn.Linear(d, d_model, bias=False)

    def forward(self, t, nslices):
        """(B, L, C) normalized tokens -> (B, L, C); the slice order cuts
        the L tokens into ``nslices`` slices."""
        xz = self.in_proj(t)
        y = None
        with annotate("segmamba.scan"):
            for i, (order, sfx) in enumerate(zip(ORDERS, SUFFIXES)):
                conv = getattr(self, "conv1d" + sfx)
                dt = getattr(self, "dt_proj" + sfx)
                u = scan_conv(xz, conv.weight, conv.bias, order, nslices)
                dbl = F.linear(u, getattr(self, "x_proj" + sfx).weight)
                y = selective_scan(
                    u, dbl, dt.weight, dt.bias, getattr(self, _a_log(sfx)),
                    getattr(self, "D" + sfx), order, nslices, acc=y,
                    xz=xz if i == len(ORDERS) - 1 else None)
        return self.out_proj(y)


def _a_log(sfx):
    return "A" + sfx + "_log"


class MambaLayer(nn.Module):
    """LayerNorm over channels, the three-direction Mamba, the residual
    add."""

    def __init__(self, dim, d_state=16, d_conv=4, expand=2):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.mamba = Mamba(dim, d_state, d_conv, expand)

    def forward(self, x):
        """The layer's output map; its scans cut the map into as many
        slices as it is deep."""
        with annotate("segmamba.mamba"):
            t = x.flatten(2).transpose(1, 2)
            y = self.mamba(self.norm(t), nslices=x.shape[2])
            SegMamba.scan_tokens += len(ORDERS) * t.shape[0] * t.shape[1]
            return x + y.transpose(1, 2).reshape(x.shape)


class MambaEncoder(nn.Module):
    """SegMamba's ``vit``: four stages of downsample, GSC, Mamba layers;
    each stage's output through IN and its channel MLP."""

    def __init__(self, in_channels, depths, dims, d_state, d_conv, expand):
        super().__init__()
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            nn.Conv3d(in_channels, dims[0], 7, stride=2, padding=3))])
        for i in range(1, STAGES):
            self.downsample_layers.append(nn.Sequential(
                InstanceNorm(), nn.Conv3d(dims[i - 1], dims[i], 2, stride=2)))
        self.gscs = nn.ModuleList([GSC(c) for c in dims])
        self.stages = nn.ModuleList([nn.Sequential(*[
            MambaLayer(c, d_state, d_conv, expand) for _ in range(n)])
            for c, n in zip(dims, depths)])
        self.mlps = nn.ModuleList([MlpChannel(c, 2 * c) for c in dims])

    def forward(self, x):
        """(B, in, D, H, W) -> the four stage outputs."""
        outs = []
        for i in range(STAGES):
            x = self.downsample_layers[i](x)
            x = self.stages[i](self.gscs[i](x))
            outs.append(self.mlps[i](_norm(x)))
        return outs


class SegMamba(nn.Module):
    """SegMamba over (N, in, D, H, W) volumes, logits out.

    Activations run NCDHW on every device (on a card a batch-9 128^3
    bf16 forward took 351 ms NCDHW and 553 ms NDHWC, where every
    InstanceNorm copies its map to NCDHW and back), in the dtype of the
    parameters (bfloat16 on the GPU in production, float32 for parity);
    the logits come back in the dtype of the input. A Mamba layer's
    tokens are the map's transpose, (B, L, C). ``SegMamba.scan_tokens``
    counts the (token, direction) pairs every forward scanned: 1,797,120
    a 128^3 patch at the published depths.
    """

    scan_tokens = 0

    def __init__(self, in_channels=1, out_channels=3, depths=(2, 2, 2, 2),
                 feat_size=(48, 96, 192, 384), hidden_size=768, d_state=16,
                 d_conv=4, expand=2):
        super().__init__()
        fs = feat_size
        self.output_channels = out_channels
        self.vit = MambaEncoder(in_channels, depths, fs, d_state, d_conv,
                                expand)
        self.encoder1 = UnetrBasicBlock(in_channels, fs[0])
        for i in range(1, STAGES):
            setattr(self, f"encoder{i + 1}", UnetrBasicBlock(fs[i - 1],
                                                             fs[i]))
        self.encoder5 = UnetrBasicBlock(fs[3], hidden_size)
        self.decoder5 = UnetrUpBlock(hidden_size, fs[3])
        for i in range(STAGES - 1, 0, -1):
            setattr(self, f"decoder{i + 1}", UnetrUpBlock(fs[i], fs[i - 1]))
        self.decoder1 = UnetrBasicBlock(fs[0], fs[0])
        self.out = UnetOutBlock(fs[0], out_channels)

    def forward(self, x, valid_trim=0):
        """Forward logits (N, C, D, H, W) of the whole patch; with
        ``valid_trim=t`` only its central ``dim - 2t`` region is returned
        (the scans need the whole map, so all of it is computed)."""
        if any(d % 2 ** STAGES for d in x.shape[2:]):
            raise ValueError(
                f"spatial size {tuple(x.shape[2:])}: each axis must be a "
                f"multiple of {2 ** STAGES} (the model halves it "
                f"{STAGES} times)")
        in_dtype = x.dtype
        x = x.to(self.out.conv.conv.weight.dtype)
        with annotate("segmamba.encoder"):
            outs = self.vit(x)
        with annotate("segmamba.decoder"):
            skips = [self.encoder1(x)] + [
                getattr(self, f"encoder{i + 2}")(outs[i])
                for i in range(STAGES - 1)]
            y = self.encoder5(outs[3])
            for i in range(STAGES, 0, -1):
                y = getattr(self, f"decoder{i + 1}")(y, skips[i - 1])
            y = self.out(self.decoder1(y))
        t = int(valid_trim)
        if t:
            y = y[:, :, t:-t, t:-t, t:-t]
        return y.to(in_dtype)


def widths_from_state_dict(state_dict):
    """The constructor's arguments of a SegMamba-keyed state dict, read
    from its shapes and keys: the input channels and ``feat_size`` from
    the downsample convs, ``depths`` from the Mamba layers' keys,
    ``hidden_size`` from ``encoder5``, ``d_state`` from ``A_log``,
    ``d_conv`` from ``conv1d``, ``expand`` from ``in_proj`` and the output
    channels from ``out``."""
    stem = state_dict["vit.downsample_layers.0.0.weight"]
    feat = [stem.shape[0]] + [
        state_dict[f"vit.downsample_layers.{i}.1.weight"].shape[0]
        for i in range(1, STAGES)]
    depths = []
    for i in range(STAGES):
        n = 0
        while f"vit.stages.{i}.{n}.norm.weight" in state_dict:
            n += 1
        depths.append(n)
    mamba = "vit.stages.0.0.mamba."
    return dict(
        in_channels=stem.shape[1],
        out_channels=state_dict["out.conv.conv.weight"].shape[0],
        depths=tuple(depths), feat_size=tuple(feat),
        hidden_size=state_dict["encoder5.layer.conv1.conv.weight"].shape[0],
        d_state=state_dict[mamba + "A_log"].shape[1],
        d_conv=state_dict[mamba + "conv1d.weight"].shape[-1],
        expand=state_dict[mamba + "in_proj.weight"].shape[0] // (2 * feat[0]))


def is_segmamba_state_dict(state_dict):
    """Whether ``state_dict`` holds SegMamba keys."""
    return "vit.downsample_layers.0.0.weight" in state_dict and \
        "encoder5.layer.conv1.conv.weight" in state_dict
