"""Overlap-blend scatter-add of trimmed patches (kernel K1).

:func:`scatter_batch` adds each patch ``probs[i]`` into
``acc[:, s_i + trim : s_i + trim + c]`` in batch order, in place. On a
CUDA tensor it launches the hand-written kernel of
``csrc/scatter_blend.cu`` (bit-identical to the sequential loop, see the
source note there) over the box that :func:`launch_plan` computes on the
host; on a CPU tensor it runs :func:`scatter_batch_reference`, the plain
sequential loop, which is also the kernel's oracle.
"""

import ctypes

import numpy as np
import torch

from aind_exaspim_neuron_segmentation_tpu_torch import cuda_build

# Patches one call takes; more than LAUNCH_BATCH run as consecutive
# launches of LAUNCH_BATCH, each kernel launch holding one bit per patch.
MAX_BATCH = 4096
LAUNCH_BATCH = 64
# One kernel thread per chunk of the box, counted in 32 bits.
MAX_CHUNKS = 2**31 - 1


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


def launch_plan(acc_shape, core, host_starts, trim):
    """Box of a batch's patch cores and the kernel's x width per thread.

    ``acc_shape``: (C, D, H, W); ``core``: (cz, cy, cx); ``host_starts``:
    (B, 3) patch starts, B >= 1. Returns ``(box_lo, box_hi, vec)``: the
    cores' bounding box ``[box_lo, box_hi)`` as (z, y, x) int tuples, and
    ``vec`` = 4 when W, cx and every core x origin ``start_x + trim`` are
    multiples of 4 (each 4-voxel x chunk then lies wholly inside or
    outside every core, and is one aligned float4), else 1.
    """
    lo = np.asarray(host_starts, np.int64).reshape(-1, 3) + trim
    box_lo = lo.min(axis=0)
    box_hi = (lo + np.asarray(core, np.int64)).max(axis=0)
    aligned = (acc_shape[-1] % 4 == 0 and core[-1] % 4 == 0
               and not (lo[:, 2] % 4).any())
    return (tuple(int(v) for v in box_lo), tuple(int(v) for v in box_hi),
            4 if aligned else 1)


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
    if batch == 0:
        return None
    plan = launch_plan(acc.shape, probs.shape[2:], host_starts, trim)
    lo, hi, _ = plan
    if min(lo) < 0 or any(h > d for h, d in zip(hi, acc.shape[1:])):
        raise ValueError(
            f"patch cores [start + trim, start + trim + core) leave acc "
            f"{tuple(acc.shape[1:])}: starts {host_starts.tolist()}, "
            f"trim {trim}"
        )
    return plan


def scatter_batch(acc, probs, starts, *, trim, host_starts):
    """Add each trimmed patch into ``acc`` in batch order, IN PLACE.

    ``acc``: (C, D, H, W) float32, updated in place and returned.
    ``probs``: (B, C, cz, cy, cx) float32. ``starts``: (B, 3) int32 on
    ``acc``'s device. ``host_starts``: the same starts as a host numpy
    array -- the bounds check reads it, so the launch needs no
    device-to-host sync. Raises unless every core lies inside ``acc``.

    A CUDA ``acc`` launches the kernel once per ``LAUNCH_BATCH`` patches
    (``scatter_batch.launches`` counts the launches,
    ``scatter_batch.last_vec`` is the x width per thread of the last one)
    and raises if a launch fails; a CPU ``acc`` runs
    :func:`scatter_batch_reference`.
    """
    host_starts = np.asarray(host_starts)
    plan = _check(acc, probs, starts, trim, host_starts)
    if acc.device.type == "cpu":
        return scatter_batch_reference(acc, probs, host_starts, trim)
    if acc.device.type != "cuda":
        raise ValueError(f"scatter_batch runs on cpu or cuda, not {acc.device}")
    batch, core = probs.shape[0], probs.shape[2:]
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(0, batch, LAUNCH_BATCH):
            n = min(LAUNCH_BATCH, batch - i)
            if n < batch:
                plan = launch_plan(acc.shape, core, host_starts[i:i + n],
                                   trim)
            lo, hi, vec = plan
            probs_ptr = probs.data_ptr() + i * probs.stride(0) * 4
            if acc.data_ptr() % 16 or probs_ptr % 16:
                vec = 1  # float4 needs 16-byte aligned base pointers
            chunks = (hi[0] - lo[0]) * (hi[1] - lo[1]) * (
                (hi[2] - lo[2]) // vec)
            if chunks > MAX_CHUNKS:
                raise ValueError(f"core box {lo}..{hi} has {chunks} chunks, "
                                 f"over {MAX_CHUNKS}")
            err = _kernel()(
                acc.data_ptr(), probs_ptr, starts.data_ptr() + i * 12, n,
                probs.shape[1], *acc.shape[1:], *core, int(trim), *lo, *hi,
                vec, stream,
            )
            if err:
                raise RuntimeError(
                    f"scatter_blend launch failed: CUDA error {err}")
            scatter_batch.launches += 1
            scatter_batch.last_vec = vec
    return acc


scatter_batch.launches = 0
scatter_batch.last_vec = None
_fn = None


def _kernel():
    """The kernel's C entry point, typed once when first loaded."""
    global _fn
    if _fn is None:
        fn = cuda_build.load().exa_scatter_blend
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 16 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn
