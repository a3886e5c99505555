"""Overlap-blend scatter-add of trimmed patches (kernel K1).

:func:`scatter_batch` adds each patch ``probs[i]`` into
``acc[:, s_i + trim : s_i + trim + c]`` in batch order, in place. On a
CUDA tensor it launches the hand-written kernel of
``csrc/scatter_blend.cu`` (bit-identical to the sequential loop, see the
source note there); on a CPU tensor it runs :func:`scatter_batch_reference`,
the plain sequential loop, which is also the kernel's oracle.
"""

import ctypes

import numpy as np
import torch

from aind_exaspim_neuron_segmentation_tpu_torch import cuda_build

# Shared memory holds 3 int32 per patch (48 KB default limit).
MAX_BATCH = 4096


def scatter_batch_reference(acc, probs, starts, trim):
    """Sequential read-add-write of each trimmed patch into ``acc``.

    Plain PyTorch, any device. ``starts`` is a (B, 3) host array (or
    tensor) of patch starts; ``acc`` is updated in place and returned.
    """
    cz, cy, cx = probs.shape[2:]
    for i, (z, y, x) in enumerate(np.asarray(starts).tolist()):
        z, y, x = z + trim, y + trim, x + trim
        acc[:, z:z + cz, y:y + cy, x:x + cx] += probs[i]
    return acc


def _check(acc, probs, starts, trim, host_starts):
    if acc.dtype != torch.float32 or probs.dtype != torch.float32:
        raise TypeError(
            f"acc and probs must be float32, got {acc.dtype}, {probs.dtype}"
        )
    if starts.dtype != torch.int32:
        raise TypeError(f"starts must be int32, got {starts.dtype}")
    if not (acc.device == probs.device == starts.device):
        raise ValueError(
            f"acc, probs and starts on different devices: {acc.device}, "
            f"{probs.device}, {starts.device}"
        )
    if not (acc.is_contiguous() and probs.is_contiguous()
            and starts.is_contiguous()):
        raise ValueError("acc, probs and starts must be contiguous")
    if acc.dim() != 4 or probs.dim() != 5 or probs.shape[1] != acc.shape[0]:
        raise ValueError(
            f"expected acc (C, D, H, W) and probs (B, C, cz, cy, cx), got "
            f"{tuple(acc.shape)} and {tuple(probs.shape)}"
        )
    batch = probs.shape[0]
    if tuple(starts.shape) != (batch, 3) or host_starts.shape != (batch, 3):
        raise ValueError(
            f"starts must be ({batch}, 3), got {tuple(starts.shape)} and "
            f"host {host_starts.shape}"
        )
    if batch > MAX_BATCH:
        raise ValueError(f"batch {batch} exceeds {MAX_BATCH}")
    lo = host_starts.astype(np.int64) + trim
    hi = lo + np.asarray(probs.shape[2:])
    if (lo < 0).any() or (hi > np.asarray(acc.shape[1:])).any():
        raise ValueError(
            f"patch cores [start + trim, start + trim + core) leave acc "
            f"{tuple(acc.shape[1:])}: starts {host_starts.tolist()}, "
            f"trim {trim}"
        )


def scatter_batch(acc, probs, starts, *, trim, host_starts):
    """Add each trimmed patch into ``acc`` in batch order, IN PLACE.

    ``acc``: (C, D, H, W) float32, updated in place and returned.
    ``probs``: (B, C, cz, cy, cx) float32. ``starts``: (B, 3) int32 on
    ``acc``'s device. ``host_starts``: the same starts as a host numpy
    array -- the bounds check reads it, so the launch needs no
    device-to-host sync. Raises unless every core lies inside ``acc``.

    A CUDA ``acc`` launches the kernel (``scatter_batch.launches`` counts
    the launches) and raises if the launch fails; a CPU ``acc`` runs
    :func:`scatter_batch_reference`.
    """
    host_starts = np.asarray(host_starts)
    _check(acc, probs, starts, trim, host_starts)
    if acc.device.type == "cpu":
        return scatter_batch_reference(acc, probs, host_starts, trim)
    if acc.device.type != "cuda":
        raise ValueError(f"scatter_batch runs on cpu or cuda, not {acc.device}")
    fn = _kernel()
    with torch.cuda.device(acc.device):
        err = fn(
            acc.data_ptr(), probs.data_ptr(), starts.data_ptr(),
            probs.shape[0], probs.shape[1], *acc.shape[1:],
            *probs.shape[2:], int(trim),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"scatter_blend launch failed: CUDA error {err}")
    scatter_batch.launches += 1
    return acc


scatter_batch.launches = 0


def _kernel():
    fn = cuda_build.load().exa_scatter_blend
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return fn
