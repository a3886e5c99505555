"""Exact order statistics and percentiles without a global sort.

A full-volume ``np.percentile`` needs the volume dense on the host, and
``torch.quantile`` refuses inputs above 2**24 elements. These functions
compute the same linearly interpolated percentile of a tensor on any
device by **radix select**: float32 values map monotonically onto 32-bit
keys (sign-magnitude flip, held in int64 since torch has no uint32
arithmetic), and the k-th order statistic is located by three rounds of
histogramming the key space (12 + 12 + 8 bits), each over the keys left
in the chosen bin: no sort, exact to the bit. ``psum_fn`` sums each
histogram across ranks (:mod:`..parallel.stats`); integer sums are
order-free, so the result is the same for any rank count.
"""

import numpy as np
import torch

# Radix plan: shifts and bin counts per round (total 32 bits).
_PLAN = ((20, 1 << 12), (8, 1 << 12), (0, 1 << 8))
_U32 = 0xFFFFFFFF
_SIGN = 0x80000000


def _float_keys(x):
    """Monotone 32-bit keys (int64): a <= b  <=>  key(a) <= key(b)."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    u = u & _U32
    return torch.where(u >= _SIGN, u ^ _U32, u | _SIGN)


def _keys_to_float(key):
    u = torch.where(key >= _SIGN, key & 0x7FFFFFFF, key ^ _U32)
    u = torch.where(u >= _SIGN, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def _order_stat_keys(keys, ks, psum_fn):
    """Keys (0-dim int64 tensors) of the k-th (0-based) smallest elements
    for each k of ``ks``; int64 counts, so ranks past 2**31 are exact.

    The first round's histogram is the same for every k, so it is built
    (and summed across ranks) once; each later round histograms only the
    keys left in the chosen bin, which every rank selects alike.
    """
    keys = keys.reshape(-1)
    (shift0, bins0), rest = _PLAN[0], _PLAN[1:]
    idx0 = keys >> shift0  # the top 12 bits
    hist0 = psum_fn(torch.bincount(idx0, minlength=bins0))
    below0 = torch.cumsum(hist0, 0) - hist0
    out = []
    for k in ks:
        remaining = torch.tensor(int(k), dtype=torch.int64,
                                 device=keys.device)
        prefix, sub, idx, hist, below = None, keys, idx0, hist0, below0
        for shift, bins in ((shift0, bins0),) + rest:
            if prefix is not None:
                idx = (sub >> shift) & (bins - 1)
                hist = psum_fn(torch.bincount(idx, minlength=bins))
                below = torch.cumsum(hist, 0) - hist
            in_bin = (below <= remaining) & (below + hist > remaining)
            b = torch.argmax(in_bin.to(torch.uint8))
            prefix = (b << shift) if prefix is None else prefix | (b << shift)
            remaining = remaining - below[b]
            sub = sub[idx == b]
        out.append(prefix)
    return out


def order_stats(x, ks, psum_fn=lambda v: v):
    """Exact k-th smallest float32 values (0-based) of tensor ``x``, each
    k of ``ks``, stacked on its device."""
    keys = _order_stat_keys(_float_keys(x), ks, psum_fn)
    return torch.stack([_keys_to_float(key) for key in keys])


def order_stat(x, k, psum_fn=lambda v: v):
    """:func:`order_stats` of one ``k``, a 0-dim tensor."""
    return order_stats(x, [k], psum_fn)[0]


def rank_plan(n_total, qs):
    """np.percentile's linear-interpolation rank plan.

    Returns ``(ks, plan)``: ``ks`` are the 0-based order-stat ranks to
    fetch and ``plan`` holds one ``(idx_lo, idx_hi, frac)`` triple per
    q indexing into ``ks`` (``idx_hi is None`` when the rank is
    integral). Counts are int64, so any element count is exact.
    """
    ks, plan = [], []
    for q in qs:
        rank = (n_total - 1) * (float(q) / 100.0)
        k_lo = int(np.floor(rank))
        frac = rank - k_lo
        idx_lo = len(ks)
        ks.append(k_lo)
        idx_hi = None
        if frac > 0:
            idx_hi = len(ks)
            ks.append(k_lo + 1)
        plan.append((idx_lo, idx_hi, frac))
    return ks, plan


def lerp_plan(order_vals, plan, dtype=np.float32):
    """float64 percentiles from fetched order statistics ``order_vals``
    (host floats) and :func:`rank_plan`'s ``plan``, interpolated as
    ``np.percentile`` does (numpy's ``_lerp``: from the upper value when
    the fraction is >= 0.5, the difference of the two values taken in
    their ``dtype``), so the result equals ``np.percentile`` of the same
    float32 (or integer, below 2**24) data bit for bit; with ``dtype``
    float64, of float64 (or integer, below 2**53) data."""
    vals = np.asarray(order_vals, dtype)
    outs = []
    for idx_lo, idx_hi, frac in plan:
        a = float(vals[idx_lo])
        if idx_hi is None:
            outs.append(a)
            continue
        b = float(vals[idx_hi])
        diff = float(vals[idx_hi] - vals[idx_lo])
        outs.append(b - diff * (1 - frac) if frac >= 0.5
                    else a + diff * frac)
    return outs


def percentiles(x, qs, n_total, psum_fn):
    """Percentiles ``qs`` of ``n_total`` elements (``x`` and what
    ``psum_fn`` adds), as ``np.percentile``, interpolated in float32."""
    ks, plan = rank_plan(n_total, qs)
    vals = order_stats(x, ks, psum_fn)
    outs = []
    for idx_lo, idx_hi, frac in plan:
        v_lo = vals[idx_lo]
        if idx_hi is not None:
            frac32 = torch.tensor(np.float32(frac), device=v_lo.device)
            outs.append(v_lo + (vals[idx_hi] - v_lo) * frac32)
        else:
            outs.append(v_lo)
    return torch.stack(outs)


def percentile_device(x, qs):
    """Percentiles of tensor ``x`` on its own device, as ``np.percentile``
    (linear interpolation, in float32). Any element count."""
    return percentiles(x, tuple(qs), x.numel(), lambda v: v)
