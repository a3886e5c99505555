"""PyTorch 3D U-Net, NCDHW, with the reference model's semantics.

Architecture contract (the same as the JAX package's ``models/unet3d.py``):

* channel ladder ``(32, 64, 128, 256, 512) * width_multiplier``, each
  truncated with ``int()``;
* encoder = DoubleConv stem + 4 x (MaxPool3d(2) + DoubleConv);
* ``trilinear=True`` (default): bottleneck and decoder DoubleConv output
  channels are halved (``factor = 2``) and upsampling is trilinear with
  ``align_corners=True``; otherwise ConvTranspose3d(k=2, s=2);
* DoubleConv = [Conv3d(k=3, p=1) -> BatchNorm3d -> LeakyReLU(0.01)] x 2,
  BatchNorm eps 1e-5 and momentum 0.1;
* decoder Up pads ``x1`` before the channel concat ``[skip, x1]`` with the
  reference's quirk: the D mismatch pads H and the H mismatch pads W;
* returns raw logits -- callers apply the sigmoid.

``valid_trim=t`` returns only the central ``dim - 2t`` region of every
spatial axis. In eval mode, where the geometry allows, the last two
decoder stages compute only what that region needs (the valid-region
decoder, see :class:`Up`).

``state_dict`` keys are those of the reference checkpoints
(``inc.double_conv.0.weight``, ``down1.maxpool_conv.1.double_conv.1.
running_mean``, ``up1.up.weight``, ``outc.conv.bias``, ...), so a
reference ``.pth`` loads with a strict ``load_state_dict``. The
``fused_bn=True`` variant has no BatchNorm modules (their slots hold
``nn.Identity``): it takes the conv-only state_dict that
:func:`..models.convert.fold_batchnorm` produces.
"""

import torch
import torch.nn.functional as F
from torch import nn

from aind_exaspim_neuron_segmentation_tpu_torch.ops.upsample import (  # noqa: F401,E501
    trilinear_upsample_x2,
    x2_support_trim,
)

DEFAULT_CHANNELS = (32, 64, 128, 256, 512)


class DoubleConv(nn.Module):
    """Two (Conv3d k=3 p=1 -> BatchNorm3d -> LeakyReLU 0.01) blocks.

    With ``fused_bn=True`` each BatchNorm is an ``nn.Identity``: eval-mode
    BatchNorm has been folded into the conv weight and bias.
    """

    def __init__(self, in_channels, out_channels, mid_channels=None,
                 fused_bn=False):
        super().__init__()
        mid = mid_channels or out_channels

        def norm(c):
            if fused_bn:
                return nn.Identity()
            return nn.BatchNorm3d(c, eps=1e-5, momentum=0.1)

        self.double_conv = nn.Sequential(
            nn.Conv3d(in_channels, mid, kernel_size=3, padding=1),
            norm(mid),
            nn.LeakyReLU(0.01, inplace=True),
            nn.Conv3d(mid, out_channels, kernel_size=3, padding=1),
            norm(out_channels),
            nn.LeakyReLU(0.01, inplace=True),
        )

    def forward(self, x, padding=1):
        """Apply both conv blocks; ``padding=0`` runs both convs unpadded
        (each spatial side shrinks by 2) with the same weights."""
        if padding == 1:
            return self.double_conv(x)
        for m in self.double_conv:
            x = (F.conv3d(x, m.weight, m.bias, padding=padding)
                 if isinstance(m, nn.Conv3d) else m(x))
        return x


class Down(nn.Module):
    """MaxPool3d(2) then DoubleConv."""

    def __init__(self, in_channels, out_channels, fused_bn=False):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool3d(2),
            DoubleConv(in_channels, out_channels, fused_bn=fused_bn),
        )

    def forward(self, x):
        """Halve every spatial axis, then convolve."""
        return self.maxpool_conv(x)


def pad_to_skip(x1, x2):
    """Pad the upsampled ``x1`` towards the skip ``x2``, reference quirk.

    ``F.pad`` pads the last two axes (H, W) while the amounts are read
    from the D and H mismatches: the D mismatch pads H and the H mismatch
    pads W; D is never padded. A mismatch leaves the spatial shapes
    unequal, so the concat that follows rejects any input whose sides are
    not multiples of 16 -- in this model and in the reference alike.
    """
    d_y = x2.size(2) - x1.size(2)
    d_x = x2.size(3) - x1.size(3)
    if d_y or d_x:
        x1 = F.pad(x1, [d_x // 2, d_x - d_x // 2, d_y // 2, d_y - d_y // 2])
    return x1


class Up(nn.Module):
    """Upsample ``x1``, pad it to the skip, concat ``[skip, x1]``, DoubleConv.

    ``x1_channels`` and ``skip_channels`` are the channel counts of the
    two inputs.

    ``valid_trim=t`` returns only the central ``dim - 2t`` region of the
    output on every spatial axis. With ``t >= 2``, trilinear upsampling,
    eval mode and an exact x2 match of the skip, the block computes only
    that region: the upsample keeps only the rows the region needs
    (:func:`trilinear_upsample_x2` with ``out_ranges``), the skip is cut
    to the same ``dim - 2t + 4`` rows, and both 3^3 convs run unpadded
    (``dim-2t+4 -> dim-2t+2 -> dim-2t``), each output window seeing the
    operands of the padded full forward. Otherwise it runs the full
    forward and slices.

    ``x1_trim=s`` declares that ``x1`` holds only the central ``[s, a -
    s)`` rows of its nominal ``a``-row grid on every spatial axis: the
    previous stage decoded only the rows this block's upsample reads.
    It needs the valid-region path (a ``ValueError`` otherwise).
    """

    def __init__(self, x1_channels, skip_channels, out_channels,
                 trilinear=True, fused_bn=False):
        super().__init__()
        self.trilinear = trilinear
        if trilinear:
            self.up = nn.Upsample(
                scale_factor=2, mode="trilinear", align_corners=True
            )
            cat = x1_channels + skip_channels
            self.conv = DoubleConv(cat, out_channels, cat // 2,
                                   fused_bn=fused_bn)
        else:
            self.up = nn.ConvTranspose3d(
                x1_channels, x1_channels // 2, kernel_size=2, stride=2
            )
            self.conv = DoubleConv(x1_channels // 2 + skip_channels,
                                   out_channels, fused_bn=fused_bn)

    def forward(self, x1, x2, valid_trim=0, x1_trim=0):
        """Decode one level: ``x1`` from below, ``x2`` the skip."""
        t, s = int(valid_trim), int(x1_trim)
        fast = (
            t >= 2
            and self.trilinear
            and not self.training
            and all(2 * (a + 2 * s) == b and b - 2 * t > 0
                    for a, b in zip(x1.shape[2:], x2.shape[2:]))
        )
        if s and not fast:
            raise ValueError(
                "x1_trim requires the valid-region fast path "
                f"(valid_trim={t}, trilinear={self.trilinear}, "
                f"train={self.training}, shapes {tuple(x1.shape[2:])}/"
                f"{tuple(x2.shape[2:])})"
            )
        if fast:
            ranges = tuple((t - 2, 2 * (a + 2 * s) - (t - 2))
                           for a in x1.shape[2:])
            x1 = trilinear_upsample_x2(x1, out_ranges=ranges, in_trim=s)
            c = t - 2
            x2 = x2[:, :, c:x2.shape[2] - c, c:x2.shape[3] - c,
                    c:x2.shape[4] - c]
            return self.conv(torch.cat([x2, x1], dim=1), padding=0)
        x1 = pad_to_skip(self.up(x1), x2)
        out = self.conv(torch.cat([x2, x1], dim=1))
        if t > 0:
            out = out[:, :, t:-t, t:-t, t:-t]
        return out


class OutConv(nn.Module):
    """1x1x1 conv to the output channels."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size=1)

    def forward(self, x):
        """Project to logits."""
        return self.conv(x)


class UNet3D(nn.Module):
    """4-level 3D U-Net over (N, 1, D, H, W) volumes, logits out.

    Activations run in the dtype of the parameters (bfloat16 on the GPU
    in production, float32 for parity); the logits come back in the
    dtype of the input.
    """

    def __init__(self, output_channels=1, trilinear=True,
                 width_multiplier=1, channels=DEFAULT_CHANNELS,
                 fused_bn=False):
        super().__init__()
        ch = [int(c * width_multiplier) for c in channels]
        factor = 2 if trilinear else 1
        self.output_channels = output_channels
        self.trilinear = trilinear
        self.fused_bn = fused_bn
        fb = fused_bn
        self.inc = DoubleConv(1, ch[0], fused_bn=fb)
        self.down1 = Down(ch[0], ch[1], fused_bn=fb)
        self.down2 = Down(ch[1], ch[2], fused_bn=fb)
        self.down3 = Down(ch[2], ch[3], fused_bn=fb)
        self.down4 = Down(ch[3], ch[4] // factor, fused_bn=fb)
        self.up1 = Up(ch[4] // factor, ch[3], ch[3] // factor, trilinear, fb)
        self.up2 = Up(ch[3] // factor, ch[2], ch[2] // factor, trilinear, fb)
        self.up3 = Up(ch[2] // factor, ch[1], ch[1] // factor, trilinear, fb)
        self.up4 = Up(ch[1] // factor, ch[0], ch[0], trilinear, fb)
        self.outc = OutConv(ch[0], output_channels)

    def forward(self, x, valid_trim=0):
        """Forward logits (N, C, D, H, W).

        ``valid_trim=t`` returns only the central ``dim - 2t`` region of
        every spatial axis -- what callers keep after the ``t``-voxel
        border trim. In eval mode up4 decodes only that region when the
        geometry allows (:class:`Up`), and up3 then decodes only the rows
        up4's upsample reads (``x1_trim``; the rows it drops have zero
        weight there, :func:`x2_support_trim`). The values equal the
        sliced full forward's unless the backend picks another algorithm
        for the unpadded convs (none did on the CPU or on an H100).
        """
        in_dtype = x.dtype
        x = x.to(self.outc.conv.weight.dtype)
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        t = int(valid_trim)
        vt3 = 0
        if t >= 2 and self.trilinear and not self.training:
            a_dims, b_dims = x2.shape[2:], x1.shape[2:]
            if all(2 * a == b and b - 2 * t > 0
                   for a, b in zip(a_dims, b_dims)):
                s = min(x2_support_trim(a, t - 2, 2 * a - (t - 2))
                        for a in a_dims)
                if s >= 2 and all(a - 2 * s > 0 for a in a_dims):
                    vt3 = s
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2, valid_trim=vt3)
        y = self.up4(y, x1, valid_trim=t, x1_trim=vt3)
        return self.outc(y).to(in_dtype)


@torch.no_grad()
def init_weights(module, generator):
    """Fill every parameter from ``generator`` (deterministic random init).

    Conv weights and biases are uniform in ``+-1/sqrt(fan_in)`` with
    ``fan_in = weight[0].numel()``, the bound of PyTorch's default conv
    init; BatchNorm keeps weight 1 and bias 0. Drawing from an explicit
    generator keeps the weights independent of the global RNG.
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
            bound = m.weight[0].numel() ** -0.5
            for p in (m.weight, m.bias):
                p.copy_(
                    torch.rand(p.shape, generator=generator) * 2 * bound
                    - bound
                )
    return module
