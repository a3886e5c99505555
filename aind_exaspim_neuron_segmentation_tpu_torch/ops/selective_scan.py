"""The selective scan of SegMamba's Mamba layers, in three token orders.

A Mamba layer (``mamba_ssm``'s ``Mamba`` as SegMamba forks it,
``bimamba_type="v3"``) of ``d`` inner channels over the ``L`` tokens of a
map (W fastest, then H, then D) scans its input in three orders, each with
its own weights. Position ``p`` of an order holds token :func:`token_order`
``[p]``:

* ``"forward"``: the tokens as they are;
* ``"backward"``: the tokens reversed;
* ``"slice"``: the ``L / S`` tokens of each of ``S`` depth slices stacked
  on a new last axis and flattened: position ``hw * S + s`` holds token
  ``s * HW + hw``, so the scan runs along depth at each (h, w) and then
  moves on to the next (h, w).

One direction, from the token-major ``xz = in_proj(LN(tokens))`` of shape
(B, L, 2d) (``x``, then the gate ``z``), in its order:

* :func:`scan_conv`: ``u = SiLU(causal_conv1d(x))``, a depthwise conv of 4
  taps with bias, left-padded 3;
* ``dbl = x_proj(u)`` (a GEMM, the caller's): the rank-R ``delta_r``, then
  ``B`` and ``C`` (16 each);
* :func:`selective_scan`: ``delta = softplus(dt_proj(delta_r))``, ``A =
  -exp(A_log)``, ``h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t`` and
  ``y_t = C_t . h_t + D u_t``, each channel with its 16 states; delta, A,
  the state and the exp in float32 whatever the activation dtype.

Every tensor stays in token order: an order is an index map, never a
reordered copy. :func:`selective_scan` writes a direction's ``y`` in
float32, adds it to an accumulator, or adds it and gates the sum,
``(acc + y) * SiLU(z)``, in the activation dtype: the gate is per token,
so gating the three directions' sum once equals gating each direction's
``y`` with its own reordered ``z``.

On a CUDA tensor both run the hand-written kernels of
``csrc/selective_scan.cu`` (bfloat16 or float32, d_state 16 and 4 conv
taps only; anything else raises), launched through the torch ops
``exaspim::scan_conv`` and ``exaspim::selective_scan`` so that a profiler
links them to the spans around them; ``selective_scan.launches`` counts
the scans (one a direction, three a Mamba layer). On a CPU tensor they run
the plain version, :func:`scan_chunked` and the conv in torch, the
kernels' oracle; on ``meta`` (shapes only) the conv is torch's
``conv1d`` and ``dt_proj`` a ``linear``, so a FLOP count on ``meta`` sees
them.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from aind_exaspim_neuron_segmentation_tpu_torch import cuda_build

ORDERS = ("forward", "backward", "slice")
D_STATE = 16
D_CONV = 4
DTYPES = (torch.bfloat16, torch.float32)
# positions a chunk of the plain version's scan
CHUNK = 64
# the kernel's chunk: the longest power of two in range that still gives
# the card about two waves of threads, one a (batch, chunk, channel): 256
# at SegMamba's stage 0 (batch 9), 64 at stage 1, 32 beyond, each the
# fastest or within 5 % of it on an H100
KERNEL_CHUNKS = (32, 256)
CARD_THREADS = 540_000
MODES = {"write": 0, "add": 1, "gate": 2}


def token_order(order, length, nslices):
    """The token at each position of ``order`` (a LongTensor)."""
    p = torch.arange(length)
    if order == "forward":
        return p
    if order == "backward":
        return p.flip(0)
    if order != "slice":
        raise ValueError(f"order {order!r} is not one of {ORDERS}")
    hw = length // nslices
    return (p % nslices) * hw + p // nslices


def inverse_order(order, length, nslices):
    """The position of each token in ``order``."""
    perm = token_order(order, length, nslices)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(length)
    return inv


def scan_chunked(u, delta, A, Bm, Cm, D, chunk=CHUNK):
    """The selective scan of sequences already in order, in the inputs'
    dtype (float32 or wider): ``u``, ``delta`` (Bt, L, d), ``A`` (d, N),
    ``Bm``, ``Cm`` (Bt, L, N), ``D`` (d); returns ``y`` (Bt, L, d).

    In chunks of ``chunk`` positions, as the kernel runs it: every chunk's
    recurrence stepped from a zero state, all chunks at once, giving its
    end state; the state entering each chunk carried across the chunks
    through their decays ``exp(A * sum(delta))``; every chunk stepped again
    from its entering state, giving ``y``.
    """
    bt, length, d = u.shape
    nc = -(-length // chunk)
    pad = nc * chunk - length

    def split(t):  # zero delta in the pad: no decay, no input
        return F.pad(t, (0, 0, 0, pad)).view(bt, nc, chunk, t.shape[-1])

    u_, dl, bc, cc = (split(t) for t in (u, delta, Bm, Cm))
    du = dl * u_

    def steps(h, out):
        ys = []
        for t in range(chunk):
            h = (torch.exp(dl[:, :, t, :, None] * A) * h
                 + du[:, :, t, :, None] * bc[:, :, t, None, :])
            if out:
                ys.append(torch.einsum("bkdn,bkn->bkd", h, cc[:, :, t]))
        return h, ys

    zero = u.new_zeros((bt, nc, d, A.shape[1]))
    end, _ = steps(zero, False)
    decay = torch.exp(dl.sum(2)[..., None] * A)
    entering = torch.empty_like(end)
    carry = zero[:, 0]
    for k in range(nc):
        entering[:, k] = carry
        carry = decay[:, k] * carry + end[:, k]
    _, ys = steps(entering, True)
    y = torch.stack(ys, 2).reshape(bt, nc * chunk, d)[:, :length]
    return y + D * u


def _in_order(t, order, nslices):
    return t.index_select(1, token_order(order, t.shape[1], nslices).to(
        t.device))


def _in_tokens(t, order, nslices):
    return t.index_select(1, inverse_order(order, t.shape[1], nslices).to(
        t.device))


def conv_reference(xz, weight, bias, order, nslices):
    """:func:`scan_conv` in plain torch, float32 or wider sums, ``xz``'s
    dtype out."""
    d = weight.shape[0]
    acc = torch.promote_types(xz.dtype, torch.float32)
    x = _in_order(xz[..., :d].to(acc), order, nslices)
    xp = F.pad(x, (0, 0, D_CONV - 1, 0))
    w = weight.to(acc).reshape(d, D_CONV)
    y = bias.to(acc) + sum(w[:, j] * xp[:, j:j + x.shape[1]]
                           for j in range(D_CONV))
    return _in_tokens(F.silu(y), order, nslices).to(xz.dtype)


def scan_reference(u, dbl, dt_weight, dt_bias, A_log, D, order, nslices,
                   chunk=CHUNK):
    """One direction's ungated ``y`` in token order, float32 or wider, by
    :func:`scan_chunked`."""
    acc = torch.promote_types(u.dtype, torch.float32)
    r = dt_weight.shape[1]
    dbl = _in_order(dbl.to(acc), order, nslices)
    delta = F.softplus(dbl[..., :r] @ dt_weight.to(acc).T
                       + dt_bias.to(acc))
    y = scan_chunked(_in_order(u.to(acc), order, nslices), delta,
                     -torch.exp(A_log.to(acc)), dbl[..., r:r + D_STATE],
                     dbl[..., r + D_STATE:], D.to(acc), chunk)
    return _in_tokens(y, order, nslices)


def _check_order(order, length, nslices):
    if order not in ORDERS:
        raise ValueError(f"order {order!r} is not one of {ORDERS}")
    if nslices < 1 or length % nslices:
        raise ValueError(f"{length} tokens do not split into {nslices} "
                         "slices")


def _check_card(tensors, dtype):
    if any(t.dtype != dtype for t in tensors):
        raise TypeError(f"the kernel takes bfloat16 or float32 maps of one "
                        f"dtype, got {[t.dtype for t in tensors]}")
    if dtype not in DTYPES:
        raise TypeError(f"the kernel takes bfloat16 or float32, not {dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the maps must be contiguous")


def scan_conv(xz, weight, bias, order, nslices):
    """``SiLU`` of the causal depthwise conv (``weight`` (d, 1, 4), ``bias``
    (d)) of the ``x`` half of ``xz`` (B, L, 2d) in ``order``: ``u`` (B, L,
    d) in token order and ``xz``'s dtype."""
    b, length, two_d = xz.shape
    d = weight.shape[0]
    _check_order(order, length, nslices)
    if two_d != 2 * d or tuple(weight.shape) != (d, 1, D_CONV) \
            or tuple(bias.shape) != (d,):
        raise ValueError(f"xz {tuple(xz.shape)}, weight "
                         f"{tuple(weight.shape)} and bias {tuple(bias.shape)}"
                         f" are no conv of {D_CONV} taps over d channels")
    if xz.device.type == "cpu":
        return conv_reference(xz, weight, bias, order, nslices)
    if xz.device.type == "meta":
        x = F.pad(xz[..., :d].transpose(1, 2), (D_CONV - 1, 0))
        return F.conv1d(x, weight, bias, groups=d).transpose(1, 2)
    if xz.device.type != "cuda":
        raise ValueError(f"scan_conv runs on cpu or cuda, not {xz.device}")
    _check_card([xz], xz.dtype)
    if (d * xz.element_size()) % 16 or xz.data_ptr() % 16:
        raise ValueError("the kernel reads x in 16-byte rows: d must be a "
                         "multiple of 16 bytes and xz 16-byte aligned")
    return torch.ops.exaspim.scan_conv(xz, weight, bias, ORDERS.index(order),
                                       nslices)


def kernel_chunk(batch, length, d):
    """The kernel's chunk for ``batch`` sequences of ``length`` positions
    and ``d`` channels (:data:`KERNEL_CHUNKS`, :data:`CARD_THREADS`)."""
    lo, hi = KERNEL_CHUNKS
    want = batch * d * length / CARD_THREADS
    chunk = lo
    while chunk * 2 <= min(want, hi):
        chunk *= 2
    return chunk


def selective_scan(u, dbl, dt_weight, dt_bias, A_log, D, order, nslices,
                   acc=None, xz=None):
    """One direction's scan of ``u`` (B, L, d) with ``dbl = x_proj(u)``
    (B, L, R + 32), ``dt_proj``'s ``dt_weight`` (d, R) and ``dt_bias``
    (d), ``A_log`` (d, 16) and ``D`` (d), in ``order``; every map in token
    order.

    Returns ``y`` in float32 (no ``acc``), ``acc += y`` (``acc`` given,
    updated in place on a card), or ``(acc + y) * SiLU(z)`` in ``u``'s
    dtype (``acc`` and ``xz`` given; ``z`` the second half of ``xz``).
    """
    b, length, d = u.shape
    r = dt_weight.shape[1]
    _check_order(order, length, nslices)
    if tuple(dbl.shape) != (b, length, r + 2 * D_STATE) \
            or tuple(dt_weight.shape) != (d, r) \
            or tuple(A_log.shape) != (d, D_STATE) \
            or tuple(dt_bias.shape) != (d,) or tuple(D.shape) != (d,):
        raise ValueError(
            f"u {tuple(u.shape)}, dbl {tuple(dbl.shape)}, dt_weight "
            f"{tuple(dt_weight.shape)}, A_log {tuple(A_log.shape)}: no scan "
            f"of d_state {D_STATE}")
    if xz is not None and acc is None:
        raise ValueError("the gate adds y to an accumulator: pass acc")
    if u.device.type in ("cpu", "meta"):
        if u.device.type == "meta":  # dt_proj as the linear it is
            F.linear(dbl[..., :r], dt_weight, dt_bias)
            y = u.new_empty(u.shape, dtype=torch.float32)
        else:
            y = scan_reference(u, dbl, dt_weight, dt_bias, A_log, D, order,
                               nslices).float()
        if acc is None:
            return y
        if xz is None:
            return acc.add_(y)
        return ((acc + y) * F.silu(xz[..., d:].float())).to(u.dtype)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cpu or cuda, not "
                         f"{u.device}")
    _check_card([u, dbl] + ([xz] if xz is not None else []), u.dtype)
    if xz is not None and tuple(xz.shape) != (b, length, 2 * d):
        raise ValueError(f"xz {tuple(xz.shape)} is not (B, L, 2d)")
    if acc is not None and (acc.dtype != torch.float32
                            or tuple(acc.shape) != (b, length, d)
                            or not acc.is_contiguous()):
        raise ValueError("acc must be a contiguous float32 (B, L, d)")
    mode = "write" if acc is None else "add" if xz is None else "gate"
    if acc is None:
        acc = u.new_empty(u.shape, dtype=torch.float32)
    out = u.new_empty(u.shape if mode == "gate" else (0,))
    f32 = [t.float().contiguous() for t in (dt_weight, dt_bias, D)]
    a2 = (-torch.exp(A_log.float()) * math.log2(math.e)).contiguous()
    torch.ops.exaspim.selective_scan(
        u, dbl, f32[0], f32[1], a2, f32[2], xz if xz is not None else u,
        acc, out, ORDERS.index(order), nslices, MODES[mode],
        kernel_chunk(b, length, d))
    return out if mode == "gate" else acc


def _conv_launch(xz, weight, bias, order, nslices):
    """The conv kernel on checked CUDA tensors (``exaspim::scan_conv``)."""
    b, length, two_d = xz.shape
    d = two_d // 2
    u = xz.new_empty((b, length, d))
    if u.numel() == 0:
        return u
    w = weight.float().reshape(d, D_CONV).contiguous()
    bias = bias.float().contiguous()
    with torch.cuda.device(xz.device):
        err = _fn("exa_scan_conv")(
            xz.data_ptr(), w.data_ptr(), bias.data_ptr(), u.data_ptr(),
            int(xz.dtype == torch.bfloat16), b, length, d, order, nslices,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"scan_conv launch failed: CUDA error {err}")
    return u


def _scan_launch(u, dbl, dt_weight, dt_bias, a2, D, xz, acc, out, order,
                 nslices, mode, chunk):
    """The scan kernels on checked CUDA tensors
    (``exaspim::selective_scan``); counts the scan."""
    b, length, d = u.shape
    if u.numel() == 0:
        return
    nc = -(-length // chunk)
    states = acc.new_empty((b, nc, D_STATE, d))
    sums = acc.new_empty((b, nc, d))
    with torch.cuda.device(u.device):
        err = _fn("exa_selective_scan")(
            u.data_ptr(), dbl.data_ptr(), dt_weight.data_ptr(),
            dt_bias.data_ptr(), a2.data_ptr(), D.data_ptr(), xz.data_ptr(),
            acc.data_ptr(), out.data_ptr(), states.data_ptr(),
            sums.data_ptr(), int(u.dtype == torch.bfloat16), b, length, d,
            dt_weight.shape[1], order, nslices, chunk, mode,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"selective_scan launch failed: CUDA error {err}")
    selective_scan.launches += 1


# The launches are torch ops, so a profiler links the kernels to the ops
# and to the spans around them. A fragment: ops.depthwise defines the
# namespace.
_OPS = torch.library.Library("exaspim", "FRAGMENT")
_OPS.define("scan_conv(Tensor xz, Tensor weight, Tensor bias, int order, "
            "int nslices) -> Tensor")
_OPS.impl("scan_conv", _conv_launch, "CUDA")
_OPS.define("selective_scan(Tensor u, Tensor dbl, Tensor dt_weight, "
            "Tensor dt_bias, Tensor a2, Tensor D, Tensor xz, Tensor(a!) acc, "
            "Tensor(b!) out, int order, int nslices, int mode, int chunk) "
            "-> ()")
_OPS.impl("selective_scan", _scan_launch, "CUDA")

selective_scan.launches = 0

_fns = {}


def _fn(name):
    """A C entry point of the kernels' library, typed once when first
    loaded."""
    if name not in _fns:
        fn = getattr(cuda_build.load("selective_scan"), name)
        if name == "exa_scan_conv":
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [
                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]
