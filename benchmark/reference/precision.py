"""TF32 off for the plain references, so float32 rounds as float32."""

import torch


def tf32_off():
    """Turn TF32 off in cuDNN and cuBLAS, so float32 rounds as float32;
    returns the previous flags for :func:`restore_tf32`."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return saved


def restore_tf32(saved):
    """Put back the flags :func:`tf32_off` returned."""
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved
