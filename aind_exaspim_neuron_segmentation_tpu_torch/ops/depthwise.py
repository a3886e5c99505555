"""Depthwise 3D convolutions of MedNeXt's blocks.

One function of an NCDHW map ``x``, a depthwise weight ``(C, 1, k, k,
k)`` (odd ``k``, padding ``k // 2``, one tap set a channel) and a bias,
in three modes, each the conv of a block's ``conv1``:

* ``"same"``: ``F.conv3d(x, w, b, padding=k // 2, groups=C)``;
* ``"down"``: the same at stride 2, ``(n - 1) // 2 + 1`` voxels an axis;
* ``"up"``: ``F.conv_transpose3d(x, w, b, stride=2, padding=k // 2,
  groups=C)``, ``2n - 1`` voxels an axis.

Along each axis output ``o`` reads input ``o + t - p`` through tap ``t``
(``"same"``), ``2o + t - p`` (``"down"``) or ``(o + p - t) / 2`` where
that is a whole number (``"up"``), ``p = k // 2``; inputs outside the map
read as zero.

:func:`depthwise3d` launches the hand-written kernel of
``csrc/depthwise3d.cu`` on a CUDA tensor (bfloat16 or float32, float32
accumulation; see the source note) and raises on anything it does not
take; on a CPU tensor it runs :func:`depthwise3d_reference`, the plain
version of the same index arithmetic and the kernel's oracle. A ``meta``
tensor (shapes only) goes to torch's conv of the same arguments, so a
walk of the model on ``meta`` sees each depthwise conv as the conv it
is. ``depthwise3d.launches`` counts the kernel's launches: one a conv,
62 a MedNeXt-L forward whatever the batch.
"""

import ctypes

import torch
import torch.nn.functional as F

from aind_exaspim_neuron_segmentation_tpu_torch import cuda_build

MODES = ("same", "down", "up")
KERNEL_SIZES = (3, 5, 7)
DTYPES = (torch.bfloat16, torch.float32)


def output_side(mode, n):
    """Voxels of an output axis of ``n`` input voxels."""
    return {"same": n, "down": (n - 1) // 2 + 1, "up": 2 * n - 1}[mode]


def _axis_taps(mode, k, n):
    """For each tap ``t`` of one axis of ``n`` input voxels, the output
    slice it writes and the slice of the input, padded by ``k // 2`` at
    each end, it reads."""
    p = k // 2
    no = output_side(mode, n)
    taps = []
    for t in range(k):
        if mode == "same":
            taps.append((slice(0, no), slice(t, t + no)))
        elif mode == "down":
            taps.append((slice(0, no), slice(t, t + 2 * no - 1, 2)))
        else:
            first = (t - p) % 2  # the outputs with o + p - t even
            count = len(range(first, no, 2))
            i = (first + p - t) // 2 + p
            taps.append((slice(first, no, 2), slice(i, i + count)))
    return taps


def depthwise3d_reference(x, weight, bias, mode):
    """The depthwise conv of ``mode`` in plain torch: for each of the
    ``k^3`` taps, the weight times the input voxels it reads added into
    the outputs that read them (float32 or wider sums, ``x``'s dtype
    out)."""
    n, c = x.shape[:2]
    k = weight.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc), (k // 2,) * 6)
    w = weight.to(acc).reshape(c, k, k, k)
    y = x.new_zeros((n, c, *(output_side(mode, s) for s in x.shape[2:])),
                    dtype=acc)
    taps = [_axis_taps(mode, k, s) for s in x.shape[2:]]
    for kd, (od, idd) in enumerate(taps[0]):
        for kh, (oh, ih) in enumerate(taps[1]):
            for kw, (ow, iw) in enumerate(taps[2]):
                y[:, :, od, oh, ow] += (w[:, kd, kh, kw, None, None, None]
                                        * xp[:, :, idd, ih, iw])
    if bias is not None:
        y += bias.to(acc).view(1, c, 1, 1, 1)
    return y.to(x.dtype)


def _torch_conv(x, weight, bias, mode):
    p, c = weight.shape[-1] // 2, x.shape[1]
    if mode == "up":
        return F.conv_transpose3d(x, weight, bias, stride=2, padding=p,
                                  groups=c)
    return F.conv3d(x, weight, bias, stride=2 if mode == "down" else 1,
                    padding=p, groups=c)


def _check(x, weight, bias, mode):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if x.dim() != 5:
        raise ValueError(f"x must be (N, C, D, H, W), got {tuple(x.shape)}")
    c, k = x.shape[1], weight.shape[-1]
    if k not in KERNEL_SIZES or tuple(weight.shape) != (c, 1, k, k, k):
        raise ValueError(
            f"weight must be ({c}, 1, k, k, k) with k in {KERNEL_SIZES}, "
            f"got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"bias must be ({c},), got {tuple(bias.shape)}")
    tensors = [x, weight] + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, weight and bias must be on one device")
    if x.device.type == "cuda":
        if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in tensors):
            raise TypeError(
                f"the kernel takes bfloat16 or float32 x, weight and bias "
                f"of one dtype, got {[t.dtype for t in tensors]}")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("x, weight and bias must be contiguous")


def depthwise3d(x, weight, bias, mode):
    """The depthwise conv of ``mode`` (``"same"``, ``"down"``, ``"up"``)
    of an NCDHW ``x``; NCDHW out, in ``x``'s dtype. ``bias`` may be None.

    A CUDA ``x`` launches the kernel once (counted in
    ``depthwise3d.launches`` when it launched, so an empty output counts
    none) and raises if it is refused; a CPU ``x`` runs
    :func:`depthwise3d_reference`; a ``meta`` ``x`` torch's conv.
    """
    _check(x, weight, bias, mode)
    if x.device.type == "cpu":
        return depthwise3d_reference(x, weight, bias, mode)
    if x.device.type == "meta":
        return _torch_conv(x, weight, bias, mode)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise3d runs on cpu or cuda, not {x.device}")
    return torch.ops.exaspim.depthwise3d(x, weight, bias, MODES.index(mode))


def _launch(x, weight, bias, mode):
    """One launch of the kernel on checked CUDA tensors: the CUDA kernel
    of the op ``exaspim::depthwise3d``; counts the launch."""
    n, c, d, h, w = x.shape
    y = x.new_empty((n, c, *(output_side(MODES[mode], s) for s in (d, h, w))))
    if y.numel() == 0:
        return y
    # rows copied in 16-byte chunks: W a whole number of them, x aligned
    vec = int(w * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), weight.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            mode, weight.shape[-1], int(x.dtype == torch.bfloat16), n, c, d,
            h, w, vec, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"depthwise3d launch failed: CUDA error {err}")
    depthwise3d.launches += 1
    return y


# The launch is a torch op, so a profiler links the kernel to the op and
# to the spans around it (a plain Python call under a span is not linked).
# A library op, not torch.library.custom_op: that one imports torch._dynamo
# and torch._inductor at its first call, seconds of set-up.
_OPS = torch.library.Library("exaspim", "DEF")
_OPS.define("depthwise3d(Tensor x, Tensor weight, Tensor? bias, int mode) "
            "-> Tensor")
_OPS.impl("depthwise3d", _launch, "CUDA")


depthwise3d.launches = 0


def depthwise_conv3d(x, weight, bias):
    """:func:`depthwise3d` of mode ``"same"``: a block's stride-1 conv."""
    return depthwise3d(x, weight, bias, "same")


def depthwise_conv_transpose3d(x, weight, bias):
    """:func:`depthwise3d` of mode ``"up"``: an up block's conv."""
    return depthwise3d(x, weight, bias, "up")


_fn = None


def _kernel():
    """The kernel's C entry point, typed once when first loaded."""
    global _fn
    if _fn is None:
        fn = cuda_build.load("depthwise3d").exa_depthwise3d
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn
