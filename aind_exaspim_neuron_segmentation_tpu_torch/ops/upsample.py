"""Trilinear x2 upsampling with ``align_corners=True``, row-ranged.

The counterpart of the JAX package's ``ops/upsample.py`` on NCDHW
tensors (spatial axes 2-4). Output row ``i`` of an ``n_in -> n_out``
resize samples the input at ``i * (n_in - 1) / (n_out - 1)``.

``out_range`` keeps only some output rows; ``in_range`` declares that
the input holds only some rows of its nominal axis, and the requested
rows must not weight a row it lacks (checked from the weights PyTorch
uses, a ``ValueError`` otherwise). The valid-region decoder
(``models.unet3d.UNet3D(valid_trim=)``) uses both.

The form: the held rows are zero-padded back to the nominal axis, resized
whole by ``F.interpolate`` and the requested rows kept. A row the
requested outputs do not weight enters them multiplied by a zero weight,
so every kept row equals the same row of ``F.interpolate`` on the whole
input bit for bit, on the CPU and on the card, in any dtype. (A per-axis
gather and lerp, or a matmul per axis, computes only the kept rows but
rounds its lerps in another order than PyTorch's kernels, and runs as
several passes over float32 temporaries where ``F.interpolate`` is one
fused kernel.)
"""

import functools

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def _weights(n_in, n_out):
    """(i0, i1, l0, l1) of every output row: the two input rows it reads
    and their float32 weights, as PyTorch computes them for
    ``align_corners=True``."""
    if n_out > 1:
        ratio = torch.tensor(float(n_in - 1)) / float(n_out - 1)
    else:
        ratio = torch.tensor(0.0)
    real = ratio * torch.arange(n_out, dtype=torch.float32)
    i0 = torch.clamp(real.floor().long(), max=n_in - 1)
    i1 = torch.where(i0 < n_in - 1, i0 + 1, i0)
    l1 = torch.clamp(real - i0.float(), 0.0, 1.0)
    return i0, i1, 1.0 - l1, l1


def _support(n_in, n_out, lo, hi):
    """Input rows that output rows ``[lo, hi)`` weight (nonzero), sorted."""
    i0, i1, l0, l1 = (w[lo:hi] for w in _weights(n_in, n_out))
    return sorted(set(torch.cat([i0[l0 != 0], i1[l1 != 0]]).tolist()))


def _check_held(n_in, n_out, out_range, held):
    """Raise unless output rows ``out_range`` weight only rows of
    ``held`` = ``(ilo, ihi)``."""
    rows = _support(n_in, n_out, *out_range)
    if rows and (rows[0] < held[0] or rows[-1] >= held[1]):
        raise ValueError(
            "in_range drops input rows the requested output rows depend on"
        )


def linear_resize_axis(x, axis, n_out, out_range=None, in_range=None,
                       nominal_in=None):
    """Resize one axis of ``x`` to ``n_out`` rows (``align_corners=True``).

    ``out_range=(lo, hi)`` keeps only output rows ``lo:hi`` of the full
    resize. ``in_range=(ilo, ihi)`` (requires ``nominal_in``) declares
    that ``x`` holds only rows ``ilo:ihi`` of a ``nominal_in``-row axis.
    """
    if in_range is not None:
        if nominal_in is None:
            raise ValueError("in_range requires nominal_in")
        if x.shape[axis] != in_range[1] - in_range[0]:
            raise ValueError(
                f"in_range {in_range} does not match axis size "
                f"{x.shape[axis]}"
            )
        n_in = nominal_in
    else:
        n_in = x.shape[axis]
    if n_in == n_out and out_range is None and in_range is None:
        return x
    lo, hi = out_range if out_range is not None else (0, n_out)
    moved = x.movedim(axis, -1)
    if in_range is not None:
        _check_held(n_in, n_out, (lo, hi), in_range)
        moved = F.pad(moved, [in_range[0], n_in - in_range[1]])
    lead = moved.shape[:-1]
    out = F.interpolate(moved.reshape(-1, 1, n_in), size=n_out,
                        mode="linear", align_corners=True)
    return out.reshape(lead + (n_out,))[..., lo:hi].movedim(-1, axis)


def x2_support_trim(n_in, out_lo, out_hi):
    """Largest symmetric input trim whose dropped border rows have zero
    weight in output rows ``[out_lo, out_hi)`` of the x2 upsample of an
    ``n_in``-row axis: how much of the previous decoder stage's output
    the next stage's row-ranged upsample reads."""
    rows = _support(n_in, 2 * n_in, out_lo, out_hi)
    if not rows:
        return 0
    return int(min(rows[0], n_in - (rows[-1] + 1)))


def trilinear_upsample_x2(x, out_ranges=None, in_trim=0):
    """x2 upsample of an NCDHW tensor on its spatial axes (2, 3, 4).

    ``out_ranges``: optional per-spatial-axis ``(lo, hi)`` (D, H, W order)
    selecting output rows of each doubled axis, each equal to the same
    position of the full upsample. ``in_trim=s`` declares that ``x`` holds
    only the central ``[s, a - s)`` rows of a nominal ``a``-row grid on
    every spatial axis (the doubled axis is ``2a``); the requested rows
    must not depend on the dropped border rows (a ``ValueError``
    otherwise).
    """
    nominal = [n + 2 * in_trim for n in x.shape[2:]]
    ranges = [(0, 2 * n) if out_ranges is None or out_ranges[i] is None
              else tuple(out_ranges[i]) for i, n in enumerate(nominal)]
    if in_trim:
        for n, rng in zip(nominal, ranges):
            _check_held(n, 2 * n, rng, (in_trim, n - in_trim))
        x = F.pad(x, [in_trim] * 6)
    out = F.interpolate(x, size=tuple(2 * n for n in nominal),
                        mode="trilinear", align_corners=True)
    (d0, d1), (h0, h1), (w0, w1) = ranges
    return out[:, :, d0:d1, h0:h1, w0:w1]
