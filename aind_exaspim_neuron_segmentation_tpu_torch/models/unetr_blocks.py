"""MONAI's UNETR decoder blocks, NCDHW: the Swin UNETR's and SegMamba's.

As ``monai.networks.blocks`` builds them with ``norm_name="instance"``,
``res_block=True`` and stride 1:

* ``UnetResBlock``: conv3 -> InstanceNorm -> LeakyReLU(0.01) -> conv3 ->
  InstanceNorm, plus the input or, where the widths differ, its ``conv1``
  + InstanceNorm, -> LeakyReLU; convs without bias, InstanceNorm without
  affine terms (eps 1e-5);
* ``UnetrBasicBlock``: a ``UnetResBlock`` under the key ``layer``;
* ``UnetrUpBlock``: ``ConvTranspose3d(k=2, s=2)`` without bias, the
  concat ``[up, skip]`` and a ``UnetResBlock``;
* ``UnetOutBlock``: ``Conv3d(F, out, k=1)`` with bias.

Keys are MONAI's (``layer.conv1.conv.weight``, ``transp_conv.conv.weight``,
``conv_block.conv3.conv.weight``, ``conv.conv.bias``).
"""

import torch
import torch.nn.functional as F
from torch import nn


class ConvUnit(nn.Module):
    """A conv under MONAI's ``Convolution`` key (``<name>.conv``)."""

    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        """The conv."""
        return self.conv(x)


def _norm(x):
    # InstanceNorm without affine terms; the aten op, since
    # F.instance_norm refuses a one-voxel map (the bottom of a 32^3 patch),
    # which it normalizes to 0
    return torch.instance_norm(x, None, None, None, None, True, 0.0, 1e-5,
                               torch.backends.cudnn.enabled)


class UnetResBlock(nn.Module):
    """MONAI's ``UnetResBlock`` with instance norm, stride 1."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = ConvUnit(nn.Conv3d(cin, cout, 3, padding=1, bias=False))
        self.conv2 = ConvUnit(nn.Conv3d(cout, cout, 3, padding=1,
                                        bias=False))
        if cin != cout:
            self.conv3 = ConvUnit(nn.Conv3d(cin, cout, 1, bias=False))

    def forward(self, x):
        """Residual conv block, LeakyReLU(0.01) out."""
        y = F.leaky_relu(_norm(self.conv1(x)), 0.01)
        y = _norm(self.conv2(y))
        res = _norm(self.conv3(x)) if hasattr(self, "conv3") else x
        return F.leaky_relu(y + res, 0.01)


class UnetrBasicBlock(nn.Module):
    """MONAI's ``UnetrBasicBlock`` with ``res_block=True`` (key
    ``layer``)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.layer = UnetResBlock(cin, cout)

    def forward(self, x):
        """The residual block."""
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    """Transposed conv x2, concat with the skip, residual block."""

    def __init__(self, cin, cout):
        super().__init__()
        self.transp_conv = ConvUnit(nn.ConvTranspose3d(
            cin, cout, 2, stride=2, bias=False))
        self.conv_block = UnetResBlock(2 * cout, cout)

    def forward(self, x, skip):
        """``[up(x), skip]`` through the residual block."""
        return self.conv_block(torch.cat([self.transp_conv(x), skip], 1))


class UnetOutBlock(nn.Module):
    """``Conv3d(F, out, k=1)`` with bias (key ``conv.conv``)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvUnit(nn.Conv3d(cin, cout, 1))

    def forward(self, x):
        """The 1x1x1 conv."""
        return self.conv(x)
