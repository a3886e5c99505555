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

    def forward(self, x):
        """Apply both conv blocks."""
        return self.double_conv(x)


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
    """

    def __init__(self, x1_channels, skip_channels, out_channels,
                 trilinear=True, fused_bn=False):
        super().__init__()
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

    def forward(self, x1, x2):
        """Decode one level: ``x1`` from below, ``x2`` the skip."""
        x1 = pad_to_skip(self.up(x1), x2)
        return self.conv(torch.cat([x2, x1], dim=1))


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
        border trim. The values equal the sliced full forward exactly:
        this version runs the full forward and slices before the 1x1
        output conv. (The JAX package's valid-region decoder, which skips
        the trimmed border in the last decoder stages, is not ported yet.)
        """
        in_dtype = x.dtype
        x = x.to(self.outc.conv.weight.dtype)
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        y = self.up4(y, x1)
        t = int(valid_trim)
        if t > 0:
            y = y[:, :, t:-t, t:-t, t:-t]
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
