"""PyTorch UNet3D and weight conversion."""

from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import (  # noqa: F401
    DoubleConv,
    Down,
    UNet3D,
    Up,
)
