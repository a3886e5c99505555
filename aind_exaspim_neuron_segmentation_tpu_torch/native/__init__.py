"""ctypes bindings over the port's C++ engine.

Watershed, agglomeration and the label remaps that the reference takes
from waterz and fastremap, the slab-streaming segmenter
(:class:`StreamSegmenter`, with its distributed mode) and the
distributed merge (:func:`merge_rag_parts`, :func:`route_rag_parts`,
:func:`merge_rag_local`, :func:`compose_rag_lut`), and the codecs behind
``io`` (Blosc1, raw zstd, CRC-32C, JPEG), compiled at first use by
:mod:`.build`. Every function takes and returns numpy arrays or bytes on
the host.
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
        lib.exa_streamseg_new.restype = ctypes.c_void_p
        lib.exa_streamseg_new.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.exa_streamseg_free.restype = None
        lib.exa_streamseg_free.argtypes = [ctypes.c_void_p]
        lib.exa_streamseg_feed.restype = ctypes.c_int64
        lib.exa_streamseg_feed.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int64, u32p,
        ]
        lib.exa_streamseg_fragments_done.restype = ctypes.c_int64
        lib.exa_streamseg_fragments_done.argtypes = [ctypes.c_void_p]
        lib.exa_streamseg_rag_feed.restype = ctypes.c_int64
        lib.exa_streamseg_rag_feed.argtypes = [
            ctypes.c_void_p, u32p, u8p, ctypes.c_int64,
        ]
        lib.exa_streamseg_merge.restype = ctypes.c_int64
        lib.exa_streamseg_merge.argtypes = [
            ctypes.c_void_p, f32p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64,
        ]
        lib.exa_streamseg_map.restype = ctypes.c_int64
        lib.exa_streamseg_map.argtypes = [
            ctypes.c_void_p, u32p, ctypes.c_int64, u32p,
        ]
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.exa_streamseg_set_distributed.restype = ctypes.c_int64
        lib.exa_streamseg_set_distributed.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.exa_streamseg_local_done.restype = ctypes.c_int64
        lib.exa_streamseg_local_done.argtypes = [ctypes.c_void_p]
        lib.exa_streamseg_get_piece_table.restype = ctypes.c_int64
        lib.exa_streamseg_get_piece_table.argtypes = [
            ctypes.c_void_p, u64p, u64p,
        ]
        lib.exa_streamseg_get_boundary.restype = ctypes.c_int64
        lib.exa_streamseg_get_boundary.argtypes = [
            ctypes.c_void_p, u32p, u8p, u32p, u8p,
        ]
        lib.exa_streamseg_set_ws.restype = ctypes.c_int64
        lib.exa_streamseg_set_ws.argtypes = [
            ctypes.c_void_p, u32p, ctypes.c_int64,
        ]
        lib.exa_streamseg_rag_flush.restype = ctypes.c_int64
        lib.exa_streamseg_rag_flush.argtypes = [ctypes.c_void_p, u32p]
        lib.exa_streamseg_rag_export_size.restype = ctypes.c_int64
        lib.exa_streamseg_rag_export_size.argtypes = [ctypes.c_void_p]
        lib.exa_streamseg_rag_export.restype = ctypes.c_int64
        lib.exa_streamseg_rag_export.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int64,
        ]
        lib.exa_streamseg_set_lut.restype = ctypes.c_int64
        lib.exa_streamseg_set_lut.argtypes = [
            ctypes.c_void_p, u32p, ctypes.c_int64,
        ]
        lib.exa_streamseg_merge_parts.restype = ctypes.c_int64
        lib.exa_streamseg_merge_parts.argtypes = [
            u8p, i64p, ctypes.c_int64, ctypes.c_int64, u64p, f32p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, u32p,
        ]
        lib.exa_ragroute_new.restype = ctypes.c_void_p
        lib.exa_ragroute_new.argtypes = [
            ctypes.POINTER(u8p), i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.exa_ragroute_free.restype = None
        lib.exa_ragroute_free.argtypes = [ctypes.c_void_p]
        lib.exa_ragroute_sizes.restype = ctypes.c_int64
        lib.exa_ragroute_sizes.argtypes = [ctypes.c_void_p, i64p]
        lib.exa_ragroute_fill.restype = ctypes.c_int64
        lib.exa_ragroute_fill.argtypes = [ctypes.c_void_p, u8p, i64p]
        lib.exa_streamseg_merge_local.restype = ctypes.c_int64
        lib.exa_streamseg_merge_local.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, f32p, ctypes.c_int64,
            ctypes.c_int32, u32p, ctypes.c_int64,
        ]
        lib.exa_streamseg_compose_lut.restype = ctypes.c_int64
        lib.exa_streamseg_compose_lut.argtypes = [
            ctypes.c_int64, u64p, u32p, ctypes.c_int64, ctypes.c_int64,
            u32p,
        ]
        lib.exa_blosc_info.restype = ctypes.c_int64
        lib.exa_blosc_info.argtypes = [u8p, ctypes.c_int64, i64p]
        lib.exa_blosc_decompress.restype = ctypes.c_int64
        lib.exa_blosc_decompress.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
        ]
        lib.exa_blosc_compress.restype = ctypes.c_int64
        lib.exa_blosc_compress.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            u8p, ctypes.c_int64,
        ]
        lib.exa_have_zstd.restype = ctypes.c_int32
        lib.exa_have_zstd.argtypes = []
        lib.exa_zstd_decompress.restype = ctypes.c_int64
        lib.exa_zstd_decompress.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
        ]
        lib.exa_zstd_compress.restype = ctypes.c_int64
        lib.exa_zstd_compress.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.exa_crc32c.restype = ctypes.c_uint32
        lib.exa_crc32c.argtypes = [u8p, ctypes.c_int64]
        lib.exa_jpeg_info.restype = ctypes.c_int64
        lib.exa_jpeg_info.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64, i64p,
        ]
        lib.exa_jpeg_decode.restype = ctypes.c_int64
        lib.exa_jpeg_decode.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_int32, u8p,
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


def _u64(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


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


# --- codecs behind io (Blosc1, raw zstd, CRC-32C, JPEG) ---

_NO_ZSTD = -7  # blosc_lite.cpp kErrNoZstd

_BLOSC_ERRORS = {
    -1: "truncated blosc chunk",
    -2: "destination buffer too small",
    -3: "corrupt blosc chunk",
    -4: "unsupported blosc inner codec (snappy)",
    -5: "blosc bit-shuffle decode error",
    -6: "unsupported blosc format version",
}


def have_zstd():
    """True when the engine was built against the system zstd (the build
    found ``<zstd.h>``); else zstd streams raise ``RuntimeError``."""
    return bool(_lib().exa_have_zstd())


def _zstd_missing():
    return RuntimeError(
        "this build of the port's engine has no zstd: <zstd.h> and -lzstd "
        "were not found when it was compiled (native/build.py), so zstd "
        "streams cannot be read or written; lz4, blosclz and zlib work"
    )


def _src(data):
    """(ctypes buffer, length) of ``data``; never a zero-length buffer."""
    data = bytes(data)
    return (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(
        data or b"\0"
    ), len(data)


def blosc_decompress(data):
    """Decode one Blosc1 chunk (the numcodecs.Blosc frame) to bytes.

    Inner codecs lz4/lz4hc, blosclz, zlib and (with :func:`have_zstd`)
    zstd; byte and bit shuffle; memcpyed chunks.
    """
    lib = _lib()
    src, n = _src(data)
    info = (ctypes.c_int64 * 6)()
    rc = lib.exa_blosc_info(src, n, info)
    if rc < 0:
        raise ValueError(_BLOSC_ERRORS.get(rc, f"blosc error {rc}"))
    nbytes = int(info[0])
    out = np.empty(nbytes, np.uint8)
    rc = lib.exa_blosc_decompress(src, n, _u8p(out), nbytes)
    if rc == _NO_ZSTD:
        raise _zstd_missing()
    if rc < 0:
        raise ValueError(_BLOSC_ERRORS.get(rc, f"blosc error {rc}"))
    return out.tobytes()


def blosc_compress(data, typesize=1, shuffle=1):
    """Encode bytes as a Blosc1 chunk (inner LZ4, optional shuffle).

    ``shuffle``: numcodecs.Blosc codes -- 0 = none, 1 = byte shuffle,
    2 = bit shuffle. The output decodes under libblosc and under
    :func:`blosc_decompress`.
    """
    if shuffle not in (0, 1, 2):
        raise ValueError("shuffle must be 0 (none), 1 (byte), 2 (bit)")
    lib = _lib()
    src, n = _src(data)
    blocksize = min(n, 1 << 20) or 1
    nblocks = -(-n // blocksize) if n else 0
    cap = n + 16 + 8 * max(nblocks, 1) + 64
    out = np.empty(cap, np.uint8)
    rc = lib.exa_blosc_compress(src, n, typesize, shuffle, _u8p(out), cap)
    if rc < 0:
        raise ValueError(_BLOSC_ERRORS.get(rc, f"blosc error {rc}"))
    return out[:rc].tobytes()


def zstd_decompress(data, expected_size):
    """Raw zstd frame decode (zarr v3 'zstd' codec)."""
    lib = _lib()
    src, n = _src(data)
    out = np.empty(expected_size, np.uint8)
    rc = lib.exa_zstd_decompress(src, n, _u8p(out), expected_size)
    if rc == _NO_ZSTD:
        raise _zstd_missing()
    if rc < 0:
        raise ValueError("corrupt zstd frame")
    return out[:rc].tobytes()


def zstd_compress(data, level=5):
    """Raw zstd frame encode (zarr v3 'zstd' codec)."""
    lib = _lib()
    src, n = _src(data)
    cap = n + n // 2 + 256
    out = np.empty(cap, np.uint8)
    rc = lib.exa_zstd_compress(src, n, _u8p(out), cap, level)
    if rc == _NO_ZSTD:
        raise _zstd_missing()
    if rc < 0:
        raise ValueError("zstd compression failed")
    return out[:rc].tobytes()


def crc32c(data):
    """CRC-32C (Castagnoli) checksum -- zarr v3 'crc32c' codec."""
    src, n = _src(data)
    return int(_lib().exa_crc32c(src, n))


_JPEG_ERRORS = {
    -1: "malformed JPEG stream",
    -2: "unsupported JPEG mode (arithmetic/lossless/hierarchical)",
    -3: "unsupported JPEG precision (only 8- and 12-bit)",
    -4: "unsupported JPEG component count or sampling factors",
    -5: "JPEG scan references a missing quantization/Huffman table",
    -6: "truncated or corrupt JPEG entropy data",
    -7: "JPEG restart-marker desynchronization",
}


def jpeg_decode(data, tables=None, color_transform=-1):
    """Decode a sequential or progressive JPEG stream to a ``(H, W)``
    or ``(H, W, C)`` array: uint8 for 8-bit streams, uint16 for 12-bit.

    The decoder behind compression-7 TIFF pages (:mod:`..io.tiff_lite`).
    ``tables`` is a TIFF ``JPEGTables`` (tag 347) abbreviated stream
    holding shared DQT/DHT segments; ``color_transform`` is 1 for
    YCbCr->RGB, 0 to emit stored component values, -1 to auto-detect
    (3-component streams convert).
    """
    lib = _lib()
    src, n = _src(data)
    if tables:
        tab, ntab = _src(tables)
    else:
        tab, ntab = None, 0
    info = (ctypes.c_int64 * 4)()
    rc = lib.exa_jpeg_info(src, n, tab, ntab, info)
    if rc < 0:
        raise ValueError(_JPEG_ERRORS.get(rc, f"JPEG error {rc}"))
    h, w, ncomp = int(info[0]), int(info[1]), int(info[2])
    dtype = np.uint16 if int(info[3]) > 8 else np.uint8
    out = np.empty(h * w * ncomp, dtype)
    rc = lib.exa_jpeg_decode(src, n, tab, ntab, color_transform, _u8p(out))
    if rc < 0:
        raise ValueError(_JPEG_ERRORS.get(rc, f"JPEG error {rc}"))
    return out.reshape((h, w) if ncomp == 1 else (h, w, ncomp))


# --- slab-streaming segmentation ---


class StreamSegmenter:
    """Slab-streaming watershed + agglomeration (C++ ``streamseg.cpp``).

    The beyond-RAM counterpart of :func:`agglomerate_last_pre`: slabs of
    digest bytes (:mod:`..ops.predigest`) stream in, provisional fragment
    labels stream out (parked by the caller, e.g. in a temp file), then
    the RAG streams through the shared merge loop and slabs relabel
    through one lut. Peak host RAM is O(RAG + slab) instead of
    O(volume). Output is bit-identical to the dense engine, including
    the min-size filter and the first-appearance renumber.

    Call order: ``feed`` per slab (ascending Z, exact cover) ->
    ``fragments_done`` -> ``rag_feed`` per slab -> ``merge`` ->
    ``map`` per slab.
    """

    def __init__(self, shape):
        self._h = None  # __del__ runs even when _lib() raises below
        d, h, w = (int(v) for v in shape)
        self._lib = _lib()
        self._h = self._lib.exa_streamseg_new(d, h, w)
        if not self._h:
            raise ValueError(f"bad streamseg shape {shape}")
        self.shape = (d, h, w)
        self.n_fragments = None
        self.n_segments = None

    def close(self):
        """Free the native handle (idempotent; also runs on GC/exit)."""
        if self._h:
            self._lib.exa_streamseg_free(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def feed(self, plan_slab):
        """Watershed one (nz, H, W) uint8 plan slab -> provisional labels."""
        plan = np.ascontiguousarray(plan_slab, dtype=np.uint8)
        out = np.empty(plan.shape, np.uint32)
        rc = self._lib.exa_streamseg_feed(
            self._h, _u8p(plan), plan.shape[0], _u32(out.ravel())
        )
        if rc < 0:
            raise RuntimeError("streamseg feed failed (order/extent)")
        return out

    def fragments_done(self):
        """Stitch pieces across slabs; returns the fragment count K."""
        k = self._lib.exa_streamseg_fragments_done(self._h)
        if k < 0:
            raise RuntimeError("streamseg fragment finalize failed")
        self.n_fragments = int(k)
        return self.n_fragments

    def rag_feed(self, frag_slab, qaff_slab):
        """Stream (nz, H, W) provisional labels + (nz, 3, H, W) u8 affs."""
        frag = np.ascontiguousarray(frag_slab, dtype=np.uint32)
        qaff = np.ascontiguousarray(qaff_slab, dtype=np.uint8)
        if qaff.shape != (frag.shape[0], 3) + frag.shape[1:]:
            raise ValueError(
                f"qaff slab {qaff.shape} does not match frag {frag.shape}"
            )
        rc = self._lib.exa_streamseg_rag_feed(
            self._h, _u32(frag.ravel()), _u8p(qaff), frag.shape[0]
        )
        if rc < 0:
            raise RuntimeError("streamseg rag feed failed (order/extent)")

    def merge(self, thresholds, quantile_pct=85, min_segment_size=0):
        """Merge loop + min-size filter; returns the segment count."""
        th = np.ascontiguousarray(thresholds, dtype=np.float32)
        n = self._lib.exa_streamseg_merge(
            self._h, _f32(th), len(th), quantile_pct,
            int(min_segment_size),
        )
        if n < 0:
            raise RuntimeError(
                "streamseg merge failed (thresholds must be non-empty "
                "ascending; all slabs must have been rag-fed)"
            )
        self.n_segments = int(n)
        return self.n_segments

    def map(self, frag_slab):
        """Relabel provisional labels through the final lut."""
        frag = np.ascontiguousarray(frag_slab, dtype=np.uint32)
        out = np.empty(frag.shape, np.uint32)
        rc = self._lib.exa_streamseg_map(
            self._h, _u32(frag.ravel()), frag.size, _u32(out.ravel())
        )
        if rc < 0:
            raise RuntimeError("streamseg map before merge")
        return out

    # -- distributed mode (multi-rank Z partition; see
    # postprocess/distributed.py for the full protocol). The engine's
    # ``shape`` is then the rank's LOCAL (nz, H, W) extent and
    # ``z_offset`` the global Z index of local plane 0. --

    def set_distributed(self, z_offset):
        """Enable distributed mode (global scan offset ``z_offset``)."""
        rc = self._lib.exa_streamseg_set_distributed(
            self._h, int(z_offset)
        )
        if rc < 0:
            raise RuntimeError("set_distributed must precede feed")

    def local_done(self):
        """Finish local pass 1; returns the rank's piece-table export.

        ``(first_fg, fg_count, first_root, first_plan, last_root,
        last_plan)``: per-local-root u64 global first-foreground scan
        index (``~0`` = none) and foreground count, plus both boundary
        planes as (H*W,) root-index+1 / plan-byte arrays.
        """
        n = self._lib.exa_streamseg_local_done(self._h)
        if n < 0:
            raise RuntimeError(
                "local_done requires distributed mode and a complete "
                "pass 1"
            )
        first_fg = np.empty(n, np.uint64)
        fg_count = np.empty(n, np.uint64)
        self._lib.exa_streamseg_get_piece_table(
            self._h, _u64(first_fg), _u64(fg_count)
        )
        hw = self.shape[1] * self.shape[2]
        first_root = np.empty(hw, np.uint32)
        first_plan = np.empty(hw, np.uint8)
        last_root = np.empty(hw, np.uint32)
        last_plan = np.empty(hw, np.uint8)
        self._lib.exa_streamseg_get_boundary(
            self._h, _u32(first_root), _u8p(first_plan),
            _u32(last_root), _u8p(last_plan),
        )
        return (first_fg, fg_count, first_root, first_plan, last_root,
                last_plan)

    def set_ws(self, ws_of_root, n_fragments):
        """Install rank 0's root -> global fragment numbering."""
        ws = np.ascontiguousarray(ws_of_root, dtype=np.uint32)
        rc = self._lib.exa_streamseg_set_ws(
            self._h, _u32(ws), int(n_fragments)
        )
        if rc < 0:
            raise RuntimeError("set_ws requires local_done")
        self.n_fragments = int(n_fragments)

    def rag_flush(self, next_plane=None):
        """Flush pass 2; ``next_plane``: (H*W,) u32 global fragment ids
        of the next rank's first plane (None for the last rank)."""
        if next_plane is None:
            ptr = None
        else:
            next_plane = np.ascontiguousarray(next_plane, dtype=np.uint32)
            ptr = _u32(next_plane.ravel())
        rc = self._lib.exa_streamseg_rag_flush(self._h, ptr)
        if rc < 0:
            raise RuntimeError("rag_flush requires a complete rag_feed")

    def rag_export(self):
        """Serialize (and free) the local RAG; returns bytes."""
        size = self._lib.exa_streamseg_rag_export_size(self._h)
        if size < 0:
            raise RuntimeError("rag_export requires rag_flush")
        out = np.empty(size, np.uint8)
        rc = self._lib.exa_streamseg_rag_export(self._h, _u8p(out), size)
        if rc < 0:
            raise RuntimeError("rag serialization failed")
        return out[:rc].tobytes()

    def set_lut(self, lut_ws, n_segments):
        """Install rank 0's fragment -> final-label lut; enables map."""
        lut = np.ascontiguousarray(lut_ws, dtype=np.uint32)
        if lut.size != (self.n_fragments or 0) + 1:
            raise ValueError(
                f"lut has {lut.size} entries, expected K+1 = "
                f"{(self.n_fragments or 0) + 1}"
            )
        rc = self._lib.exa_streamseg_set_lut(
            self._h, _u32(lut), int(n_segments)
        )
        if rc < 0:
            raise RuntimeError("set_lut requires set_ws")
        self.n_segments = int(n_segments)


def merge_rag_parts(parts, n_fragments, frag_fg, thresholds,
                    quantile_pct=85, min_segment_size=0):
    """Rank 0's merge over the ranks' serialized RAG parts.

    ``parts``: list of ``StreamSegmenter.rag_export`` payloads in RANK
    ORDER (ascending Z ranges -- the order IS the global scan order);
    ``frag_fg``: (K+1,) u64 per-fragment foreground voxel counts.
    Returns ``(lut_ws, n_segments)`` with ``lut_ws`` the (K+1,) u32
    fragment -> final-label table (shared merge loop + min-size filter
    + first-appearance renumber; bit-identical to the single-process
    engine by construction).
    """
    buf = np.concatenate(
        [np.frombuffer(p, np.uint8) for p in parts]
        + [np.zeros(1, np.uint8)]  # keep the pointer valid when empty
    )
    offsets = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=offsets[1:])
    frag_fg = np.ascontiguousarray(frag_fg, dtype=np.uint64)
    k = int(n_fragments)
    if frag_fg.size != k + 1:
        raise ValueError(f"frag_fg has {frag_fg.size} entries, need K+1")
    th = np.ascontiguousarray(thresholds, dtype=np.float32)
    if len(th) == 0 or np.any(np.diff(th) < 0):
        raise ValueError("thresholds must be non-empty and ascending")
    lut = np.empty(k + 1, np.uint32)
    n = _lib().exa_streamseg_merge_parts(
        _u8p(buf), _i64(offsets), len(parts), k, _u64(frag_fg),
        _f32(th), len(th), int(quantile_pct), int(min_segment_size),
        _u32(lut),
    )
    if n < 0:
        raise RuntimeError(f"merge_parts failed (rc={n})")
    return lut, int(n)


def route_rag_parts(parts, n_fragments, n_owners):
    """Rank 0: partition the ranks' serialized RAG parts by connected
    component across ``n_owners`` merge workers.

    The component-partitioned counterpart of :func:`merge_rag_parts`:
    instead of rebuilding the global RAG, the parts are scanned for
    edge endpoints only, components are greedily assigned to owners by
    edge load (deterministic), and each serialized edge record is
    routed -- in global stream order -- to its component's owner.
    Returns ``n_owners`` self-contained payloads for
    :func:`merge_rag_local` (an owner with no components gets an empty
    8-byte payload). ``parts`` must be in RANK ORDER.
    """
    lib = _lib()
    if not parts:
        raise ValueError("need at least one RAG part")
    arrs = [np.frombuffer(p, np.uint8) for p in parts]
    u8pp = ctypes.POINTER(ctypes.c_uint8)
    ptrs = (u8pp * len(arrs))(*[a.ctypes.data_as(u8pp) for a in arrs])
    sizes = np.array([a.size for a in arrs], np.int64)
    h = lib.exa_ragroute_new(
        ptrs, _i64(sizes), len(arrs), int(n_fragments), int(n_owners)
    )
    if not h:
        raise RuntimeError("malformed serialized RAG parts")
    try:
        owner_bytes = np.empty(n_owners, np.int64)
        lib.exa_ragroute_sizes(h, _i64(owner_bytes))
        offsets = np.zeros(n_owners + 1, np.int64)
        np.cumsum(owner_bytes, out=offsets[1:])
        out = np.empty(int(offsets[-1]), np.uint8)
        rc = lib.exa_ragroute_fill(h, _u8p(out), _i64(offsets))
        if rc < 0:
            raise RuntimeError(f"RAG routing failed (rc={rc})")
    finally:
        lib.exa_ragroute_free(h)
    return [
        out[offsets[o]: offsets[o + 1]].tobytes() for o in range(n_owners)
    ]


def merge_rag_local(routed, n_fragments, thresholds, quantile_pct=85):
    """One rank's merge over its routed component payload.

    Runs the shared merge loop (rag.hpp run_merge, fragment ids
    remapped to a dense local range) over the components
    :func:`route_rag_parts` assigned to this rank and returns the
    executed ``(keep, drop)`` unions up to the LAST threshold as an
    ``(n, 2)`` uint32 array in GLOBAL fragment ids -- the exact replay
    prefix :func:`compose_rag_lut` needs (the reference keeps only the
    final threshold's labeling, reference inference.py:229-233).
    """
    buf = np.frombuffer(routed, np.uint8)
    if buf.size < 8:
        raise ValueError("routed payload too short")
    th = np.ascontiguousarray(thresholds, dtype=np.float32)
    if len(th) == 0 or np.any(np.diff(th) < 0):
        raise ValueError("thresholds must be non-empty and ascending")
    # Unions are bounded by the fragment count (each union drops one
    # fragment), not the routed record count -- records repeat (a, b)
    # across rank parts, so the header alone over-sizes the buffer by
    # 8 B per duplicate at multi-million-edge scale.
    cap = min(
        int(np.frombuffer(routed[:8], np.uint64)[0]), int(n_fragments)
    )
    pairs = np.empty((max(cap, 1), 2), np.uint32)
    n = _lib().exa_streamseg_merge_local(
        _u8p(buf), buf.size, int(n_fragments), _f32(th), len(th),
        int(quantile_pct), _u32(pairs.ravel()), cap,
    )
    if n < 0:
        raise RuntimeError(f"local merge failed (rc={n})")
    return pairs[:n].copy()


def compose_rag_lut(n_fragments, frag_fg, pairs_list, min_segment_size=0):
    """Rank 0: compose the ranks' merge pairs into the final lut.

    ``pairs_list``: the ranks' :func:`merge_rag_local` outputs (any
    order -- components touch disjoint fragments). Returns
    ``(lut_ws, n_segments)`` exactly like :func:`merge_rag_parts`
    (shared min-size filter + first-appearance renumber tail).
    """
    k = int(n_fragments)
    frag_fg = np.ascontiguousarray(frag_fg, dtype=np.uint64)
    if frag_fg.size != k + 1:
        raise ValueError(f"frag_fg has {frag_fg.size} entries, need K+1")
    chunks = [
        np.ascontiguousarray(p, dtype=np.uint32).reshape(-1, 2)
        for p in pairs_list
    ]
    pairs = (
        np.concatenate(chunks) if chunks else np.empty((0, 2), np.uint32)
    )
    if not pairs.flags.c_contiguous:
        pairs = np.ascontiguousarray(pairs)
    lut = np.empty(k + 1, np.uint32)
    n = _lib().exa_streamseg_compose_lut(
        k, _u64(frag_fg), _u32(pairs.ravel()), len(pairs),
        int(min_segment_size), _u32(lut),
    )
    if n < 0:
        raise RuntimeError(f"lut composition failed (rc={n})")
    return lut, int(n)
