"""The port's device policy: ``cuda`` unless the caller asks otherwise."""

import torch


def resolve_device(device=None):
    """``torch.device`` for ``device`` (default ``cuda``); raises if CUDA
    is requested and unavailable."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; pass "
            "device='cpu' to run on the host"
        )
    return device
