"""PyTorch Swin UNETR (3D), NCDHW, with MONAI's v1 ``SwinUNETR`` semantics.

Hatamizadeh et al., "Swin UNETR: Swin Transformers for Semantic
Segmentation of Brain Tumors in MRI Images" (arXiv:2201.01266), as MONAI's
``monai.networks.nets.SwinUNETR`` builds it with ``use_v2=False``,
``norm_name="instance"``, ``normalize=True``, ``downsample="merging"``
and every dropout 0 (the BTCV defaults: feature size 48, depths
(2, 2, 2, 2), heads (3, 6, 12, 24), window 7, patch size 2, MLP ratio 4).

Architecture contract:

* patch embedding: ``Conv3d(in, F, k=p, s=p)`` with bias, no norm;
* four ``BasicLayer`` stages of Swin blocks, each ending in patch
  merging (``F -> 2F`` at half the size); block ``i`` of a stage shifts
  its windows by ``window // 2`` when ``i`` is odd;
* Swin block: ``x + Attn(LN1(x))``, then ``x + MLP(LN2(x))`` with
  ``Linear(C, rC)``, exact GELU, ``Linear(rC, C)``;
* ``Attn``: zero-pad each axis up to a multiple of the window (after
  LN1; padded tokens are keys like any other), roll by ``-window // 2``
  in a shifted block and add the region mask (-100 between regions,
  computed on the padded size), partition into windows, ``Linear(C, 3C)``
  with bias, ``q`` scaled by ``head_dim ** -0.5``, the relative-position
  bias ``table[index[:n, :n]]`` (the table has ``(2w - 1) ** 3`` rows,
  ``index`` is the full window's), softmax, ``@ v``, ``Linear(C, C)``,
  then the partition reversed, the roll undone and the padding cropped.
  Where a map is no larger than the window on an axis, the window there
  is the map and the shift 0 (MONAI's ``get_window_size``);
* patch merging (MONAI's legacy ``PatchMerging``): the 8 strided slices
  concatenated in MONAI's order (two of them repeat), ``LayerNorm(8C)``,
  ``Linear(8C, 2C)`` without bias;
* each stage's output (and the embedding's) normalized over channels by
  ``F.layer_norm`` without affine terms;
* the UNETR decoder (:mod:`.unetr_blocks`, shared with SegMamba):
  ``UnetResBlock`` (conv3 -> InstanceNorm ->
  LeakyReLU(0.01) -> conv3 -> InstanceNorm, plus the input or its
  ``conv1`` + InstanceNorm where the widths differ, -> LeakyReLU), convs
  without bias, InstanceNorm without affine terms (eps 1e-5);
  ``UnetrUpBlock`` = ``ConvTranspose3d(k=2, s=2)`` without bias, the
  concat ``[up, skip]`` and a ``UnetResBlock``; ``UnetOutBlock`` a
  ``Conv3d(F, out, k=1)`` with bias; raw logits out.

``state_dict`` keys are MONAI's (``swinViT.patch_embed.proj.weight``,
``swinViT.layers1.0.blocks.1.attn.relative_position_bias_table``,
``encoder10.layer.conv1.conv.weight``, ``decoder5.transp_conv.conv.weight``,
``out.conv.conv.bias``, ...), so a MONAI checkpoint of the same widths
loads with a strict ``load_state_dict``.

On the device the attention core runs through
``F.scaled_dot_product_attention``, the bias and the region mask given as
one additive mask of the model's dtype.
"""

import itertools
import math

import torch
import torch.nn.functional as F
from torch import nn

from aind_exaspim_neuron_segmentation_tpu_torch.models.unetr_blocks import (  # noqa: F401,E501
    ConvUnit,
    UnetOutBlock,
    UnetResBlock,
    UnetrBasicBlock,
    UnetrUpBlock,
    _norm,
)
from aind_exaspim_neuron_segmentation_tpu_torch.utils.profiling import (
    annotate,
)

# MONAI's legacy merge order: two of the slices repeat
MERGE_ORDER = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
               (1, 0, 1), (0, 1, 0), (0, 0, 1), (1, 1, 1))
MASK_FILL = -100.0
# the row stride of the additive mask, a multiple of the fused
# attention kernels' alignment, so that they read it in place
MASK_ALIGN = 16


def window_and_shift(dims, window, shift):
    """MONAI's ``get_window_size``: on an axis no longer than the window,
    the window is the axis and the shift 0."""
    ws = [d if d <= w else w for d, w in zip(dims, window)]
    ss = [0 if d <= w else s for d, w, s in zip(dims, window, shift)]
    return tuple(ws), tuple(ss)


def window_partition(x, window):
    """(B, D, H, W, C) -> (B * windows, tokens a window, C), windows in
    (D, H, W) order inside each batch element."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window
    x = x.view(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, c)


def window_reverse(windows, window, dims):
    """Inverse of :func:`window_partition` onto ``dims = (B, D, H, W)``."""
    b, d, h, w = dims
    wd, wh, ww = window
    x = windows.view(b, d // wd, h // wh, w // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def region_ids(dims, window, shift, device):
    """(windows, tokens) region number of every token of the rolled,
    padded map (MONAI's ``compute_mask`` before the comparison)."""
    img = torch.zeros((1,) + tuple(dims) + (1,), device=device)
    cuts = [(slice(-w), slice(-w, -s), slice(-s, None))
            for w, s in zip(window, shift)]
    for cnt, (a, b, c) in enumerate(itertools.product(*cuts)):
        img[:, a, b, c, :] = cnt
    return window_partition(img, window).squeeze(-1)


def relative_position_index(window):
    """(n, n) row of the bias table of every token pair of a window."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(w) for w in window], indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + torch.tensor([w - 1 for w in window])
    scale = torch.tensor([(2 * window[1] - 1) * (2 * window[2] - 1),
                          2 * window[2] - 1, 1])
    return (rel * scale).sum(-1)


def attention_mask(table, index, ids, heads, n, dtype):
    """The additive mask of one window attention: the relative-position
    bias ``table[index[:n, :n]]`` as (1, heads, n, n), or, with the
    region ids of a shifted block, bias plus region mask as (1, windows *
    heads, n, n). Rows are padded to ``MASK_ALIGN`` and the padding
    sliced off, so the fused kernels read the mask where it lies."""
    bias = table[index[:n, :n].reshape(-1)].view(n, n, heads)
    bias = bias.permute(2, 0, 1).to(dtype)
    groups = 1 if ids is None else ids.shape[0]
    pad = -(-n // MASK_ALIGN) * MASK_ALIGN
    buf = torch.empty((1, groups, heads, n, pad), dtype=dtype,
                      device=table.device)
    mask = buf[..., :n]
    mask.copy_(bias.expand_as(mask))
    if ids is not None:
        apart = ids[:, :, None] != ids[:, None, :]
        mask.add_(apart[None, :, None].to(dtype) * MASK_FILL)
    return mask.view(1, groups * heads, n, n)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside each window, with MONAI's
    relative-position bias (keys ``qkv``, ``proj``,
    ``relative_position_bias_table``, ``relative_position_index``)."""

    def __init__(self, dim, num_heads, window):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        rows = math.prod(2 * w - 1 for w in window)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(rows, num_heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window))
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, ids=None):
        """(B * windows, n, C) windows -> the same; ``ids``: the region
        ids (windows, n) of a shifted block, else None."""
        bw, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x)
        with annotate("swin.attention"):
            q, k, v = qkv.view(bw, n, 3, h, c // h).permute(
                2, 0, 3, 1, 4).contiguous()
            mask = attention_mask(self.relative_position_bias_table,
                                  self.relative_position_index, ids, h, n,
                                  q.dtype)
            if ids is not None:
                # windows folded into the heads: the mask then differs
                # per (window, head) and is shared across the batch
                groups = ids.shape[0] * h
                q, k, v = (t.view(bw // ids.shape[0], groups, n, c // h)
                           for t in (q, k, v))
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                 scale=self.scale)
            out = out.view(bw, h, n, c // h).transpose(1, 2).reshape(
                bw, n, c)
        SwinUNETR.swin_windows += bw * h
        return self.proj(out)


class MLPBlock(nn.Module):
    """``Linear(C, rC)``, exact GELU, ``Linear(rC, C)`` (MONAI's keys
    ``linear1``, ``linear2``)."""

    def __init__(self, dim, hidden):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)

    def forward(self, x):
        """Channels-last tokens in and out."""
        return self.linear2(F.gelu(self.linear1(x)))


class SwinTransformerBlock(nn.Module):
    """``x + Attn(LN1(x))``, then ``x + MLP(LN2(x))``, on (B, D, H, W, C)."""

    def __init__(self, dim, num_heads, window, shift, mlp_ratio):
        super().__init__()
        self.window, self.shift = tuple(window), tuple(shift)
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def _attend(self, x, ids):
        b, d, h, w, c = x.shape
        window, shift = window_and_shift((d, h, w), self.window, self.shift)
        with annotate("swin.window"):
            pads = [(-s) % ws for s, ws in zip((d, h, w), window)]
            if any(pads):
                x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
            dims = tuple(x.shape[:4])
            if any(shift):
                x = torch.roll(x, tuple(-s for s in shift), (1, 2, 3))
            windows = window_partition(x, window)
        out = self.attn(windows, ids if any(shift) else None)
        with annotate("swin.window"):
            x = window_reverse(out, window, dims)
            if any(shift):
                x = torch.roll(x, shift, (1, 2, 3))
        return x[:, :d, :h, :w]

    def forward(self, x, ids):
        """``ids``: the stage's region ids (used if this block shifts)."""
        x = x + self._attend(self.norm1(x), ids)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """MONAI's legacy merge: (B, D, H, W, C) -> (B, D/2, H/2, W/2, 2C)."""

    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x):
        """Odd sizes are zero-padded by one first, as MONAI does."""
        d, h, w = x.shape[1:4]
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in MERGE_ORDER],
                      -1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """One stage: Swin blocks (odd ones shifted), then patch merging."""

    def __init__(self, dim, depth, num_heads, window, mlp_ratio):
        super().__init__()
        self.window = tuple(window)
        self.shift = tuple(w // 2 for w in window)
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, window,
                                 self.shift if i % 2 else (0, 0, 0),
                                 mlp_ratio)
            for i in range(depth)])
        self.downsample = PatchMerging(dim)

    def forward(self, x):
        """Channels-last (B, D, H, W, C) in and out."""
        dims = x.shape[1:4]
        window, shift = window_and_shift(dims, self.window, self.shift)
        ids = None
        if any(shift):
            with annotate("swin.window"):
                padded = [-(-s // w) * w for s, w in zip(dims, window)]
                ids = region_ids(padded, window, shift, x.device)
        for blk in self.blocks:
            x = blk(x, ids)
        return self.downsample(x)


class SwinTransformer(nn.Module):
    """MONAI's ``SwinTransformer``: the embedding and the four stages;
    returns the five channel-normalized maps, NCDHW."""

    def __init__(self, in_channels, feature_size, depths, num_heads, window,
                 patch_size, mlp_ratio):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv3d(in_channels, feature_size,
                                          patch_size, stride=patch_size)
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            setattr(self, f"layers{i + 1}", nn.ModuleList([BasicLayer(
                feature_size * 2 ** i, depth, heads, (window,) * 3,
                mlp_ratio)]))
        self.num_layers = len(depths)

    @staticmethod
    def _out(x):
        """Channels-last map -> its channel-normalized NCDHW copy."""
        x = F.layer_norm(x, x.shape[-1:])
        return x.permute(0, 4, 1, 2, 3).contiguous()

    def forward(self, x):
        """(B, in, D, H, W) -> [x0, ..., x4], each NCDHW."""
        x = self.patch_embed.proj(x).permute(0, 2, 3, 4, 1)
        outs = [self._out(x)]
        for i in range(self.num_layers):
            x = getattr(self, f"layers{i + 1}")[0](x.contiguous())
            outs.append(self._out(x))
        return outs


class SwinUNETR(nn.Module):
    """Swin UNETR over (N, in, D, H, W) volumes, logits out.

    Activations run in the dtype of the parameters (bfloat16 on the GPU
    in production, float32 for parity); the logits come back in the
    dtype of the input. ``SwinUNETR.swin_windows`` counts the (window,
    head, patch) triples every forward attended.
    """

    swin_windows = 0

    def __init__(self, in_channels=1, out_channels=3, feature_size=48,
                 depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24), window=7,
                 patch_size=2, mlp_ratio=4.0):
        super().__init__()
        fs = feature_size
        self.output_channels = out_channels
        self.swinViT = SwinTransformer(in_channels, fs, depths, num_heads,
                                       window, patch_size, mlp_ratio)
        self.encoder1 = UnetrBasicBlock(in_channels, fs)
        self.encoder2 = UnetrBasicBlock(fs, fs)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(2 * fs, fs)
        self.decoder1 = UnetrUpBlock(fs, fs)
        self.out = UnetOutBlock(fs, out_channels)

    def forward(self, x, valid_trim=0):
        """Forward logits (N, C, D, H, W) of the whole patch; with
        ``valid_trim=t`` only its central ``dim - 2t`` region is returned
        (the attention needs the whole map, so all of it is computed)."""
        if any(d % 32 for d in x.shape[2:]):
            raise ValueError(
                f"spatial size {tuple(x.shape[2:])}: each axis must be a "
                "multiple of 32 (the model halves it five times)")
        in_dtype = x.dtype
        x = x.to(self.out.conv.conv.weight.dtype)
        with annotate("swin.encoder"):
            hidden = self.swinViT(x)
        with annotate("swin.decoder"):
            enc0 = self.encoder1(x)
            enc1 = self.encoder2(hidden[0])
            enc2 = self.encoder3(hidden[1])
            enc3 = self.encoder4(hidden[2])
            y = self.encoder10(hidden[4])
            y = self.decoder5(y, hidden[3])
            y = self.decoder4(y, enc3)
            y = self.decoder3(y, enc2)
            y = self.decoder2(y, enc1)
            y = self.out(self.decoder1(y, enc0))
        t = int(valid_trim)
        if t:
            y = y[:, :, t:-t, t:-t, t:-t]
        return y.to(in_dtype)


def widths_from_state_dict(state_dict):
    """The constructor's arguments of a MONAI-keyed SwinUNETR state dict,
    read from its shapes: feature size and input channels from the
    embedding, depths from the block keys, heads from the bias tables'
    widths, the window from their rows, the MLP ratio from ``linear1``
    and the output channels from ``out.conv.conv.weight``."""
    embed = state_dict["swinViT.patch_embed.proj.weight"]
    fs = embed.shape[0]
    depths, heads, stage = [], [], 1
    while f"swinViT.layers{stage}.0.blocks.0.norm1.weight" in state_dict:
        pre = f"swinViT.layers{stage}.0.blocks."
        depth = 0
        while f"{pre}{depth}.norm1.weight" in state_dict:
            depth += 1
        depths.append(depth)
        table = state_dict[f"{pre}0.attn.relative_position_bias_table"]
        heads.append(table.shape[1])
        stage += 1
    rows = table.shape[0]
    side = round(rows ** (1 / 3))
    if side ** 3 != rows or side % 2 == 0:
        raise ValueError(f"bias table of {rows} rows is no (2w-1)^3 table")
    hidden = state_dict["swinViT.layers1.0.blocks.0.mlp.linear1.weight"]
    return dict(in_channels=embed.shape[1],
                out_channels=state_dict["out.conv.conv.weight"].shape[0],
                feature_size=fs, depths=tuple(depths),
                num_heads=tuple(heads), window=(side + 1) // 2,
                patch_size=embed.shape[2], mlp_ratio=hidden.shape[0] / fs)


def is_swin_unetr_state_dict(state_dict):
    """Whether ``state_dict`` holds MONAI SwinUNETR keys."""
    return "swinViT.patch_embed.proj.weight" in state_dict
