"""ctypes bindings over the port's C++ engine (the dense inference tail).

Watershed, agglomeration and the label remaps that the reference takes
from waterz and fastremap, compiled at first use by :mod:`.build`. Every
function takes and returns numpy arrays on the host.
"""

import ctypes

import numpy as np

from aind_exaspim_neuron_segmentation_tpu_torch.native import build


def _lib():
    lib = build.load()
    if not getattr(lib, "_exa_bound", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.exa_unique_counts.restype = ctypes.c_int64
        lib.exa_unique_counts.argtypes = [
            u32p, ctypes.c_int64, u32p, i64p, ctypes.c_int64,
        ]
        lib.exa_mask_except.restype = None
        lib.exa_mask_except.argtypes = [
            u32p, ctypes.c_int64, u32p, ctypes.c_int64,
        ]
        lib.exa_renumber.restype = ctypes.c_int64
        lib.exa_renumber.argtypes = [u32p, ctypes.c_int64, ctypes.c_int32]
        lib.exa_watershed.restype = ctypes.c_int64
        lib.exa_watershed.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, u32p,
        ]
        lib.exa_agglomerate.restype = ctypes.c_int64
        lib.exa_agglomerate.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
            ctypes.c_int32, u32p,
        ]
        lib.exa_watershed_plan.restype = ctypes.c_int64
        lib.exa_watershed_plan.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u32p,
        ]
        for name in ("exa_agglomerate_pre", "exa_agglomerate_pre_last"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                u8p, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                f32p, ctypes.c_int64, ctypes.c_int32, u32p,
            ]
        lib._exa_bound = True
    return lib


def _u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _f32(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _thresholds(thresholds):
    th = np.ascontiguousarray(thresholds, dtype=np.float32)
    if len(th) == 0 or np.any(np.diff(th) < 0):
        raise ValueError("thresholds must be non-empty and ascending")
    return th


def _affinities(affinities):
    affs = np.ascontiguousarray(affinities, dtype=np.float32)
    if affs.ndim != 4 or affs.shape[0] != 3:
        raise ValueError(f"expected (3, D, H, W) affinities, got {affs.shape}")
    return affs


def _plan(plan):
    plan = np.ascontiguousarray(plan, dtype=np.uint8)
    if plan.ndim != 3:
        raise ValueError(f"expected (D, H, W) plan bytes, got {plan.shape}")
    return plan


def _digests(plan, qaff):
    plan = _plan(plan)
    qaff = np.ascontiguousarray(qaff, dtype=np.uint8)
    if qaff.shape != (3,) + plan.shape:
        raise ValueError(
            f"qaff shape {qaff.shape} does not match plan {plan.shape}"
        )
    return plan, qaff


def unique(labels, return_counts=False):
    """Sorted distinct labels (and int64 counts), as ``fastremap.unique``.

    One pass: the engine fills up to ``cap`` entries and returns the true
    distinct count, so one generously sized call suffices; it retries
    with the exact count only past 2^20 distinct labels.
    """
    lab = np.ascontiguousarray(labels, dtype=np.uint32).ravel()
    lib = _lib()
    cap = max(min(lab.size, 1 << 20), 1)
    while True:
        ids = np.empty(cap, np.uint32)
        counts = np.empty(cap, np.int64)
        n = lib.exa_unique_counts(
            _u32(lab), lab.size, _u32(ids), _i64(counts), cap
        )
        if n <= cap:
            ids, counts = ids[:n], counts[:n]
            break
        cap = n
    if return_counts:
        return ids, counts
    return ids


def mask_except(labels, keep_ids):
    """Zero every label not in ``keep_ids`` (``fastremap.mask_except``).

    Returns a new uint32 array shaped like ``labels``.
    """
    out = np.ascontiguousarray(labels, dtype=np.uint32)
    if out is labels or out.base is not None:
        out = out.copy()
    keep = np.ascontiguousarray(keep_ids, dtype=np.uint32).ravel()
    _lib().exa_mask_except(_u32(out.ravel()), out.size, _u32(keep), keep.size)
    return out


def renumber(labels, preserve_zero=True, in_place=False):
    """Relabel to contiguous ids by first appearance (``fastremap``).

    Returns ``(labels, n_labels)``. ``in_place=False`` always works on a
    fresh buffer, even when ``labels`` is a view of caller-owned memory.
    """
    if in_place:
        out = np.ascontiguousarray(labels, dtype=np.uint32)
    else:
        out = np.array(labels, dtype=np.uint32, order="C")
    n = _lib().exa_renumber(_u32(out.ravel()), out.size,
                            1 if preserve_zero else 0)
    return out, int(n)


def watershed(affinities, aff_threshold_low=0.1, aff_threshold_high=0.9999):
    """Steepest-ascent affinity watershed fragments (uint32, 0 =
    background) of float32 ``(3, D, H, W)`` affinities."""
    affs = _affinities(affinities)
    out = np.empty(affs.shape[1:], np.uint32)
    k = _lib().exa_watershed(
        _f32(affs), *affs.shape[1:],
        ctypes.c_float(aff_threshold_low), ctypes.c_float(aff_threshold_high),
        _u32(out.ravel()),
    )
    if k < 0:
        raise RuntimeError("watershed failed")
    return out


def watershed_plan(plan):
    """Watershed fragments from digested plan bytes.

    ``plan``: uint8 (D, H, W) from :func:`..ops.predigest.predigest_slab`;
    pure integer replay, bit-identical to :func:`watershed` on the float
    volume the plan was digested from. A plan whose directions leave the
    volume or use an undefined code raises ``RuntimeError``.
    """
    plan = _plan(plan)
    out = np.empty(plan.shape, np.uint32)
    k = _lib().exa_watershed_plan(_u8p(plan), *plan.shape, _u32(out.ravel()))
    if k < 0:
        raise RuntimeError("watershed replay failed")
    return out


def agglomerate_all_pre(plan, qaff, thresholds, quantile_pct=85):
    """All per-threshold segmentations, ``(T, D, H, W)`` uint32, from the
    digest pair: ``plan`` uint8 (D, H, W) and ``qaff`` uint8 (3, D, H, W).

    Bit-identical to :func:`agglomerate_all` on the float volume they were
    digested from (the low/high thresholds are baked into the plan).
    """
    plan, qaff = _digests(plan, qaff)
    th = _thresholds(thresholds)
    out = np.empty((len(th),) + plan.shape, np.uint32)
    k = _lib().exa_agglomerate_pre(
        _u8p(plan), _u8p(qaff), *plan.shape, _f32(th), len(th),
        quantile_pct, _u32(out.ravel()),
    )
    if k < 0:
        raise RuntimeError("agglomeration failed")
    return out


def agglomerate_last_pre(plan, qaff, thresholds, quantile_pct=85):
    """The final threshold's segmentation only, ``(D, H, W)`` uint32, from
    the digest pair; bit-identical to ``agglomerate_all_pre(...)[-1]``
    with one volume of output instead of ``T``."""
    plan, qaff = _digests(plan, qaff)
    th = _thresholds(thresholds)
    out = np.empty(plan.shape, np.uint32)
    k = _lib().exa_agglomerate_pre_last(
        _u8p(plan), _u8p(qaff), *plan.shape, _f32(th), len(th),
        quantile_pct, _u32(out.ravel()),
    )
    if k < 0:
        raise RuntimeError("agglomeration failed")
    return out


def agglomerate_all(affinities, thresholds, aff_threshold_low=0.1,
                    aff_threshold_high=0.9999, quantile_pct=85):
    """All per-threshold segmentations of float32 ``(3, D, H, W)``
    affinities at once, as ``(T, D, H, W)`` uint32: seeded watershed
    fragments, then agglomeration scored by 1 - quantile(affinity)."""
    affs = _affinities(affinities)
    th = _thresholds(thresholds)
    out = np.empty((len(th),) + affs.shape[1:], np.uint32)
    k = _lib().exa_agglomerate(
        _f32(affs), *affs.shape[1:], _f32(th), len(th),
        ctypes.c_float(aff_threshold_low), ctypes.c_float(aff_threshold_high),
        quantile_pct, _u32(out.ravel()),
    )
    if k < 0:
        raise RuntimeError("agglomeration failed")
    return out
