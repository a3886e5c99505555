"""PyTorch MedNeXt (3D), NCDHW, with the published MedNeXt v1 semantics.

Roy et al., "MedNeXt: Transformer-driven Scaling of ConvNets for Medical
Image Segmentation" (MICCAI 2023, arXiv:2303.09975), as MIC-DKFZ/MedNeXt's
``MedNeXt`` builds it with ``do_res`` and ``do_res_up_down`` on,
``norm_type="group"`` and no GRN. ``create_mednext_v1(1, 3, "L",
kernel_size=5)`` is ``n_channels=32``, ``exp_r = block_counts = (3, 4, 8,
8, 8, 8, 8, 4, 3)``, ``kernel_size=5``: 62.99 M parameters.

Architecture contract (every conv has a bias):

* block (``C -> C``, ratio ``r``): ``x + conv3(GELU(conv2(GN(conv1(x)))))``
  with ``conv1`` a depthwise ``k^3`` conv (``groups=C``, padding
  ``k // 2``), ``GN`` = ``GroupNorm(C, C)`` (per-channel statistics over
  D, H, W, eps 1e-5, affine), ``conv2`` a ``1^3`` conv to ``rC``, exact
  (erf) GELU, ``conv3`` a ``1^3`` conv back;
* down block (``C -> 2C``): the same chain with ``conv1`` of stride 2 and
  ``conv3`` to ``2C``, plus ``res_conv``, a ``1^3`` conv of stride 2;
* up block (``2C -> C``): ``conv1`` a depthwise ``ConvTranspose3d(k,
  stride 2, padding k // 2)`` (``2n - 1`` voxels an axis), ``conv3`` to
  ``C``, plus ``res_conv``, a ``ConvTranspose3d(2C, C, 1, stride 2)``; the
  sum is padded by one voxel at the low end of each axis (:data:`LOW_PAD`);
* network: ``stem`` (``Conv3d(in, C, 1)``), four encoder stages of blocks
  each followed by a down block, the ``bottleneck`` stage, four up blocks
  each followed by a decoder stage, the up block's output added to the
  encoder stage's (no concat), and ``out_0.conv_out``
  (``ConvTranspose3d(C, out, 1)``); raw logits out. Stage ``i``'s blocks
  take ``exp_r[i]``, ``down_i`` ``exp_r[i + 1]``, ``up_{3-j}`` and
  ``dec_block_{3-j}`` ``exp_r[5 + j]``.

``state_dict`` keys are MedNeXt's (``stem.weight``,
``enc_block_0.0.conv1.weight``, ``down_0.res_conv.bias``,
``bottleneck.7.norm.weight``, ``up_3.conv2.weight``,
``dec_block_0.2.conv3.bias``, ``out_0.conv_out.weight``, ...), so such a
checkpoint loads with a strict ``load_state_dict``; a training
checkpoint's deep-supervision heads ``out_1`` .. ``out_4`` load too
(``deep_supervision=True``) and never run.

Each block's depthwise conv (stride 1, stride 2 or transposed) runs
through :mod:`..ops.depthwise` with ``conv1``'s weight and bias: the
hand-written kernel on a card, the plain version on the CPU.
"""

import torch
import torch.nn.functional as F
from torch import nn

# depthwise_conv3d and depthwise_conv_transpose3d are not called here; the
# benchmark's walk of the model on ``meta`` still patches them by name
from aind_exaspim_neuron_segmentation_tpu_torch.ops.depthwise import (
    depthwise3d,
    depthwise_conv3d,
    depthwise_conv_transpose3d,
)
from aind_exaspim_neuron_segmentation_tpu_torch.utils.profiling import (
    annotate,
)

# the up block's one-voxel pad, at the low end of each axis (F.pad order)
LOW_PAD = (1, 0, 1, 0, 1, 0)
STAGES = 4


class MedNeXtBlock(nn.Module):
    """One MedNeXt block: ``mode`` "same" (``cin == cout``, the input
    added), "down" (stride 2, ``res_conv`` added) or "up" (transposed,
    stride 2, ``res_conv`` added, the sum padded at the low end)."""

    def __init__(self, cin, cout, exp_r, kernel_size, mode="same"):
        super().__init__()
        k = kernel_size
        if mode == "up":
            self.conv1 = nn.ConvTranspose3d(cin, cin, k, stride=2,
                                            padding=k // 2, groups=cin)
        else:
            self.conv1 = nn.Conv3d(cin, cin, k, stride=2 if mode == "down"
                                   else 1, padding=k // 2, groups=cin)
        self.norm = nn.GroupNorm(cin, cin)
        self.conv2 = nn.Conv3d(cin, exp_r * cin, 1)
        self.conv3 = nn.Conv3d(exp_r * cin, cout, 1)
        if mode == "down":
            self.res_conv = nn.Conv3d(cin, cout, 1, stride=2)
        elif mode == "up":
            self.res_conv = nn.ConvTranspose3d(cin, cout, 1, stride=2)
        self.mode = mode

    def forward(self, x):
        """The block's output."""
        with annotate("mednext.dwconv"):
            y = depthwise3d(x, self.conv1.weight, self.conv1.bias, self.mode)
        with annotate("mednext.norm"):
            y = self.norm(y)
        with annotate("mednext.mlp"):
            y = self.conv3(F.gelu(self.conv2(y)))
        if self.mode == "same":
            return x + y
        y = y + self.res_conv(x)
        # pad(y) + pad(res) is pad(y + res): the pad is zeros
        return F.pad(y, LOW_PAD) if self.mode == "up" else y


class OutBlock(nn.Module):
    """``conv_out``, a ``1^3`` transposed conv to the output channels."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv_out = nn.ConvTranspose3d(cin, cout, 1)

    def forward(self, x):
        """The logits."""
        return self.conv_out(x)


def _stage(c, exp_r, count, k):
    return nn.Sequential(*[MedNeXtBlock(c, c, exp_r, k)
                           for _ in range(count)])


class MedNeXt(nn.Module):
    """MedNeXt over (N, in, D, H, W) volumes, logits out.

    Activations run NCDHW on every device (the depthwise kernel takes
    NCDHW maps; on a card PyTorch's GroupNorm is 5x slower NDHWC) in the
    dtype of the parameters (bfloat16 on the GPU in
    production, float32 for parity); the logits come back in the dtype
    of the input. ``MedNeXt.block_patches`` counts (blocks run) x
    (patches in the batch) of every forward: 62 a patch at MedNeXt-L's
    block counts (54 blocks, 4 down, 4 up).
    """

    block_patches = 0

    def __init__(self, in_channels=1, out_channels=3, n_channels=32,
                 exp_r=(3, 4, 8, 8, 8, 8, 8, 4, 3),
                 block_counts=(3, 4, 8, 8, 8, 8, 8, 4, 3), kernel_size=5,
                 deep_supervision=False):
        super().__init__()
        c = [n_channels * 2 ** i for i in range(STAGES + 1)]
        k = kernel_size
        self.output_channels = out_channels
        self.blocks = sum(block_counts) + 2 * STAGES
        self.stem = nn.Conv3d(in_channels, c[0], 1)
        for i in range(STAGES):
            setattr(self, f"enc_block_{i}",
                    _stage(c[i], exp_r[i], block_counts[i], k))
            setattr(self, f"down_{i}",
                    MedNeXtBlock(c[i], c[i + 1], exp_r[i + 1], k, "down"))
        self.bottleneck = _stage(c[4], exp_r[4], block_counts[4], k)
        for j in range(STAGES):
            i = STAGES - 1 - j
            setattr(self, f"up_{i}",
                    MedNeXtBlock(c[i + 1], c[i], exp_r[5 + j], k, "up"))
            setattr(self, f"dec_block_{i}",
                    _stage(c[i], exp_r[5 + j], block_counts[5 + j], k))
        self.out_0 = OutBlock(c[0], out_channels)
        if deep_supervision:
            for i in range(1, STAGES + 1):
                setattr(self, f"out_{i}", OutBlock(c[i], out_channels))

    def forward(self, x, valid_trim=0):
        """Forward logits (N, C, D, H, W) of the whole patch; with
        ``valid_trim=t`` only its central ``dim - 2t`` region is returned
        (all of it is computed)."""
        if any(d % 2 ** STAGES for d in x.shape[2:]):
            raise ValueError(
                f"spatial size {tuple(x.shape[2:])}: each axis must be a "
                f"multiple of {2 ** STAGES} (the model halves it "
                f"{STAGES} times)")
        in_dtype = x.dtype
        x = x.to(self.stem.weight.dtype)
        skips = []
        with annotate("mednext.encoder"):
            x = self.stem(x)
            for i in range(STAGES):
                x = getattr(self, f"enc_block_{i}")(x)
                skips.append(x)
                x = getattr(self, f"down_{i}")(x)
            x = self.bottleneck(x)
        with annotate("mednext.decoder"):
            for i in reversed(range(STAGES)):
                x = getattr(self, f"up_{i}")(x) + skips.pop()
                x = getattr(self, f"dec_block_{i}")(x)
            y = self.out_0(x)
        MedNeXt.block_patches += self.blocks * y.shape[0]
        t = int(valid_trim)
        if t:
            y = y[:, :, t:-t, t:-t, t:-t]
        return y.to(in_dtype)


def _ratio(state_dict, name):
    w = state_dict[f"{name}.conv2.weight"]
    return w.shape[0] // w.shape[1]


def widths_from_state_dict(state_dict):
    """The constructor's arguments of a MedNeXt-keyed state dict, read
    from its shapes and keys: ``n_channels`` and the input channels from
    ``stem``, each stage's block count from its keys, ``exp_r`` from the
    ``conv2`` of ``enc_block_0.0``, ``down_0..3`` and ``up_3..0``, the
    kernel size from ``down_0.conv1``, the output channels from
    ``out_0.conv_out`` and ``deep_supervision`` from ``out_1``."""
    stem = state_dict["stem.weight"]
    names = ([f"enc_block_{i}" for i in range(STAGES)] + ["bottleneck"]
             + [f"dec_block_{i}" for i in reversed(range(STAGES))])
    counts = []
    for name in names:
        n = 0
        while f"{name}.{n}.conv1.weight" in state_dict:
            n += 1
        counts.append(n)
    exp_r = ([_ratio(state_dict, "enc_block_0.0")]
             + [_ratio(state_dict, f"down_{i}") for i in range(STAGES)]
             + [_ratio(state_dict, f"up_{i}")
                for i in reversed(range(STAGES))])
    return dict(in_channels=stem.shape[1],
                out_channels=state_dict["out_0.conv_out.weight"].shape[1],
                n_channels=stem.shape[0], exp_r=tuple(exp_r),
                block_counts=tuple(counts),
                kernel_size=state_dict["down_0.conv1.weight"].shape[-1],
                deep_supervision="out_1.conv_out.weight" in state_dict)


def is_mednext_state_dict(state_dict):
    """Whether ``state_dict`` holds MedNeXt keys."""
    return "stem.weight" in state_dict and \
        "out_0.conv_out.weight" in state_dict
