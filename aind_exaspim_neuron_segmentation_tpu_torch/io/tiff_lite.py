"""In-tree TIFF / BigTIFF volume IO (no tifffile dependency).

The reference reads ``.tif``/``.tiff`` volumes through ``tifffile``
(reference img_util.py:100-121), which handles the scientific-imaging
corners Pillow does not: BigTIFF (>4 GB microscopy stacks), tiled
layouts, horizontal-differencing predictors, float samples. This module
implements the format directly:

* classic TIFF (magic 42) and BigTIFF (magic 43), both byte orders;
* striped and tiled layouts; grayscale, contiguous multi-sample, and
  planar-separate (PlanarConfiguration=2) pages — striped or tiled,
  any compression including per-plane JPEG streams;
* compressions: none, LZW (TIFF variant: MSB-first codes, early
  change), Deflate/AdobeDeflate, PackBits, ZSTD (tag 50000), new-style
  JPEG (compression 7, baseline 8-bit, shared tables via the
  JPEGTables tag, YCbCr->RGB by photometric -- decoded by the in-tree
  native codec, native/src/jpeg_lite.cpp); predictor 2 (horizontal
  differencing, per-sample);
* sample formats: unsigned/signed int 8/16/32/64, float 32/64;
* multi-page stacks decode page-on-demand (``lazy=True`` returns a
  ``TiffStack`` with numpy-style indexing, matching the chunked-read
  design of :mod:`.zarr_lite`).

The writer emits striped classic TIFF or BigTIFF (``bigtiff=True`` or
automatically for >= 4 GB payloads), optionally deflate-compressed.
The port's copy of the JAX package's ``io/tiff_lite.py``: every page
decodes to the same array (tests/test_torch_io.py).
"""

import copy
import struct
import zlib

import numpy as np

# Tag ids (TIFF 6.0 / BigTIFF).
_T_WIDTH = 256
_T_LENGTH = 257
_T_BITS = 258
_T_COMPRESSION = 259
_T_PHOTOMETRIC = 262
_T_STRIP_OFFSETS = 273
_T_SAMPLES = 277
_T_ROWS_PER_STRIP = 278
_T_STRIP_COUNTS = 279
_T_PLANAR = 284
_T_PREDICTOR = 317
_T_TILE_WIDTH = 322
_T_TILE_LENGTH = 323
_T_TILE_OFFSETS = 324
_T_TILE_COUNTS = 325
_T_SAMPLE_FORMAT = 339
_T_JPEG_TABLES = 347
_T_YCBCR_SUBSAMPLING = 530

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d", 16: "Q", 17: "q"}


def _unpack_lzw(data):
    """TIFF-variant LZW: 8-bit data, MSB-first codes, early code-width
    change (TIFF 6.0 section 13)."""
    out = bytearray()
    table = None
    prev = None
    width = 9
    next_code = 258
    bitbuf = 0
    bits = 0
    pos = 0
    n = len(data)
    while True:
        while bits < width and pos < n:
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            bits += 8
        if bits < width:
            break
        code = (bitbuf >> (bits - width)) & ((1 << width) - 1)
        bits -= width
        if code == 256:  # Clear
            table = None
            prev = None
            width = 9
            next_code = 258
            continue
        if code == 257:  # EOI
            break
        if table is None:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
        if code < len(table) and (code < 258 or table[code]):
            entry = table[code]
        elif code == next_code and prev is not None:
            entry = prev + prev[:1]
        else:
            raise ValueError("corrupt LZW stream")
        out += entry
        if prev is not None:
            table.append(prev + entry[:1])
            next_code += 1
        prev = entry
        # early change: widen one code before the table is full
        if next_code >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def _unpack_packbits(data, expected):
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i: i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i: i + 1] * (257 - h)
            i += 1
        # 128: no-op
    return bytes(out)


def _decompress(data, compression, expected):
    if compression == 1:
        return data
    if compression in (8, 32946):  # Deflate / AdobeDeflate
        return zlib.decompress(data)
    if compression == 5:
        return _unpack_lzw(data)
    if compression == 32773:
        return _unpack_packbits(data, expected)
    if compression in (50000, 34926):  # ZSTD (imagecodecs / legacy id)
        from aind_exaspim_neuron_segmentation_tpu_torch import native

        return native.zstd_decompress(bytes(data), expected)
    raise ValueError(
        f"unsupported TIFF compression {compression} (supported: none, "
        "LZW, Deflate, PackBits, ZSTD)"
    )


def _upsample_chroma(a, h, v, out_l, out_w):
    """Upsample one chroma plane to luma resolution with libjpeg's
    default resamplers (jdsample.c): the triangle ("fancy") filters
    for the 2x1-horizontal and 2x2 cases -- including their edge
    special cases and rounding constants -- and nearest replication
    for every other ratio. This is the same selection the in-tree
    chunky JPEG decoder makes (native/src/jpeg_lite.cpp upsample()),
    so planar-separate and chunky YCbCr pages decode through one
    contract."""
    a = a.astype(np.int32)
    ch, cw = a.shape
    if h == 1 and v == 1:
        return a[:out_l, :out_w]
    if h == 2 and v == 1:
        left = a[:, np.r_[0, 0: cw - 1]]
        right = a[:, np.r_[1:cw, cw - 1]]
        up = np.empty((ch, cw * 2), np.int32)
        up[:, 0::2] = (3 * a + left + 1) >> 2
        up[:, 1::2] = (3 * a + right + 2) >> 2
        return up[:out_l, :out_w]
    if h == 2 and v == 2:
        ys = np.arange(out_l)
        near = np.minimum(ys >> 1, ch - 1)
        far = np.clip(np.where(ys & 1, near + 1, near - 1), 0, ch - 1)
        colsum = 3 * a[near] + a[far]  # (out_l, cw)
        left = colsum[:, np.r_[0, 0: cw - 1]]
        right = colsum[:, np.r_[1:cw, cw - 1]]
        up = np.empty((out_l, cw * 2), np.int32)
        up[:, 0::2] = (3 * colsum + left + 8) >> 4
        up[:, 1::2] = (3 * colsum + right + 7) >> 4
        return up[:, :out_w]
    # replication (libjpeg int_upsample) for 1x2, 4x1, ...
    up = np.repeat(np.repeat(a, v, axis=0), h, axis=1)
    return up[:out_l, :out_w]


def _ycbcr_to_rgb(planes, maxv):
    """BT.601 full-range YCbCr->RGB (the JFIF convention libjpeg
    applies), float32 with lround-style rounding -- numerically the
    same conversion native/src/jpeg_lite.cpp emit_t() performs for
    chunky streams. ``planes`` is (..., 3) int; chroma is centered at
    (maxv+1)/2 (128 for 8-bit, 2048 for 12-bit samples)."""
    y = planes[..., 0].astype(np.float32)
    center = np.float32((maxv + 1) // 2)
    cb = planes[..., 1].astype(np.float32) - center
    cr = planes[..., 2].astype(np.float32) - center
    rgb = np.stack(
        [
            y + np.float32(1.402) * cr,
            y - np.float32(0.344136) * cb - np.float32(0.714136) * cr,
            y + np.float32(1.772) * cb,
        ],
        axis=-1,
    )
    return np.clip(np.floor(rgb + np.float32(0.5)), 0, maxv)


class _Page:
    """One decoded IFD: geometry, dtype, and segment locations."""

    def __init__(self, tags, order):
        self.order = order
        self.width = int(tags[_T_WIDTH][0])
        self.length = int(tags[_T_LENGTH][0])
        self.samples = int(tags.get(_T_SAMPLES, [1])[0])
        self.compression = int(tags.get(_T_COMPRESSION, [1])[0])
        self.photometric = int(tags.get(_T_PHOTOMETRIC, [1])[0])
        self.jpeg_tables = tags.get(_T_JPEG_TABLES)
        self.predictor = int(tags.get(_T_PREDICTOR, [1])[0])
        self.planar = int(tags.get(_T_PLANAR, [1])[0])
        # YCbCrSubSampling (530): TIFF 6.0 defaults to 4:2:0 when the
        # tag is absent on a photometric-6 page.
        sub = tags.get(_T_YCBCR_SUBSAMPLING, [2, 2])
        self.subsampling = (int(sub[0]), int(sub[1] if len(sub) > 1
                                             else sub[0]))
        if self.planar not in (1, 2):
            raise ValueError(f"unknown planar configuration {self.planar}")
        bits = tags.get(_T_BITS, [8])
        bits = int(bits[0])
        fmt = int(tags.get(_T_SAMPLE_FORMAT, [1])[0])
        kind = {1: "u", 2: "i", 3: "f"}.get(fmt)
        if bits == 12 and self.compression == 7 and kind == "u":
            # 12-bit JPEG pages: the codec emits u16 samples (the same
            # mapping tifffile/imagecodecs apply), so the page dtype is
            # u16 even though BitsPerSample says 12.
            bits = 16
        if kind is None or bits % 8:
            raise ValueError(f"unsupported sample format {fmt}/{bits}bit")
        self.dtype = np.dtype(f"{order}{kind}{bits // 8}")
        if _T_TILE_OFFSETS in tags:
            self.tiled = True
            self.tile_w = int(tags[_T_TILE_WIDTH][0])
            self.tile_l = int(tags[_T_TILE_LENGTH][0])
            self.offsets = [int(v) for v in tags[_T_TILE_OFFSETS]]
            self.counts = [int(v) for v in tags[_T_TILE_COUNTS]]
        else:
            self.tiled = False
            self.rows_per_strip = int(
                tags.get(_T_ROWS_PER_STRIP, [self.length])[0]
            )
            self.offsets = [int(v) for v in tags[_T_STRIP_OFFSETS]]
            self.counts = [int(v) for v in tags[_T_STRIP_COUNTS]]

    @property
    def shape(self):
        """Page shape: (H, W) or (H, W, samples)."""
        base = (self.length, self.width)
        return base if self.samples == 1 else base + (self.samples,)

    def _decode_jpeg(self, data, nrows, ncols):
        """Decode one compression-7 segment to ``(nrows, ncols*samples)``
        samples (uint8, or uint16 for 12-bit streams). Each strip/tile
        is an independent JPEG stream (optionally abbreviated, with
        shared DQT/DHT in the JPEGTables tag); photometric 6 streams
        are stored YCbCr and convert to RGB, matching the reference's
        tifffile/libjpeg behavior."""
        from aind_exaspim_neuron_segmentation_tpu_torch import native

        color = 1 if self.photometric == 6 and self.samples >= 3 else 0
        arr = native.jpeg_decode(
            bytes(data), tables=self.jpeg_tables, color_transform=color
        )
        if arr.dtype.itemsize != self.dtype.itemsize:
            raise ValueError(
                f"JPEG stream precision ({arr.dtype}) disagrees with "
                f"the page's declared sample width ({self.dtype})"
            )
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.shape[2] != self.samples:
            raise ValueError(
                f"JPEG segment has {arr.shape[2]} components, page "
                f"declares {self.samples} samples"
            )
        if arr.shape[0] < nrows or arr.shape[1] < ncols:
            raise ValueError("JPEG segment smaller than its strip/tile")
        return arr[:nrows, :ncols].reshape(nrows, ncols * self.samples)

    def _read_planar(self, buf):
        """Planar-separate (PlanarConfiguration=2) pages: the
        strip/tile list holds all of sample 0's segments, then sample
        1's, ... (TIFF 6.0 section 13). Each plane decodes as an
        independent single-sample page through the normal :meth:`read`
        path — striped or tiled, every compression (including
        per-plane JPEG streams, which are plain grayscale JPEGs),
        predictor 2 cumsumming plainly over width — and the planes
        stack on the trailing sample axis.

        Planar YCbCr JPEG pages (photometric 6) additionally honor
        YCbCrSubSampling (TIFF 6.0 section 21): the chroma planes are
        stored at reduced resolution with correspondingly scaled
        strip/tile geometry, then upsampled with libjpeg's default
        resamplers and converted BT.601 full-range to RGB — the same
        upsample+convert contract the chunky JPEG path applies inside
        ``jpeg_lite.cpp``, matching the reference's tifffile/libjpeg
        output for both layouts."""
        ycc_jpeg = self.compression == 7 and self.photometric == 6
        if ycc_jpeg:
            sub_h, sub_v = self.subsampling
            if self.samples != 3:
                raise ValueError(
                    "planar YCbCr page must have exactly 3 samples"
                )
            if sub_h not in (1, 2, 4) or sub_v not in (1, 2, 4):
                raise ValueError(
                    f"bad YCbCrSubSampling ({sub_h}, {sub_v})"
                )
            if self.tiled:
                if self.tile_w % sub_h or self.tile_l % sub_v:
                    raise ValueError(
                        "planar YCbCr tile size must be a multiple of "
                        "the subsampling factors (TIFF 6.0 section 21)"
                    )
            elif self.rows_per_strip % sub_v and \
                    self.rows_per_strip < self.length:
                raise ValueError(
                    "planar YCbCr RowsPerStrip must be a multiple of "
                    "the vertical subsampling (TIFF 6.0 section 21)"
                )
        if self.tiled:
            across = -(-self.width // self.tile_w)
            down = -(-self.length // self.tile_l)
            per_plane = across * down
        else:
            per_plane = -(-self.length // self.rows_per_strip)
        if len(self.offsets) != per_plane * self.samples:
            raise ValueError(
                "planar segment count does not factor into samples"
            )
        planes = []
        for s in range(self.samples):
            plane = copy.copy(self)
            plane.samples = 1
            plane.planar = 1
            # each plane is a single component; never color-transform
            plane.photometric = min(self.photometric, 1)
            plane.offsets = self.offsets[s * per_plane:(s + 1) * per_plane]
            plane.counts = self.counts[s * per_plane:(s + 1) * per_plane]
            if ycc_jpeg and s > 0 and (sub_h, sub_v) != (1, 1):
                # chroma plane: stored at reduced resolution with
                # proportionally scaled segment geometry; the segment
                # count per plane is unchanged (the factorization
                # check above still holds).
                plane.width = -(-self.width // sub_h)
                plane.length = -(-self.length // sub_v)
                if self.tiled:
                    plane.tile_w = self.tile_w // sub_h
                    plane.tile_l = self.tile_l // sub_v
                else:
                    plane.rows_per_strip = max(
                        1, -(-self.rows_per_strip // sub_v)
                    )
                arr = plane.read(buf).reshape(plane.length, plane.width)
                arr = _upsample_chroma(
                    arr, sub_h, sub_v, self.length, self.width
                )
            else:
                arr = plane.read(buf).reshape(self.length, self.width)
            planes.append(arr)
        out = np.stack(planes, axis=-1)
        if ycc_jpeg:
            maxv = 255 if self.dtype.itemsize == 1 else 4095
            out = _ycbcr_to_rgb(out, maxv).astype(self.dtype)
        return out

    def _undo_predictor(self, arr):
        # TIFF 6.0 predictor 2 differences per sample: with contiguous
        # multi-sample rows the cumsum must run over the width axis only,
        # not across interleaved channels.
        if self.predictor == 2:
            if self.samples > 1:
                rows = arr.shape[0]
                v = arr.reshape(rows, -1, self.samples)
                np.cumsum(v, axis=1, dtype=arr.dtype, out=v)
            else:
                np.cumsum(arr, axis=1, dtype=arr.dtype, out=arr)
        elif self.predictor != 1:
            raise ValueError(f"unsupported predictor {self.predictor}")
        return arr

    def read(self, buf):
        """Decode this page from the file buffer into an ndarray."""
        if self.planar == 2 and self.samples > 1:
            return self._read_planar(buf)
        item = self.dtype.itemsize * self.samples
        if not self.tiled:
            rows = []
            for si, (off, cnt) in enumerate(zip(self.offsets, self.counts)):
                nrows = min(self.rows_per_strip,
                            self.length - si * self.rows_per_strip)
                if self.compression == 7:
                    rows.append(self._decode_jpeg(
                        buf[off: off + cnt], nrows, self.width
                    ).astype(self.dtype, copy=False))
                    continue
                expected = nrows * self.width * item
                raw = _decompress(
                    bytes(buf[off: off + cnt]), self.compression, expected
                )
                arr = np.frombuffer(raw[:expected], self.dtype)
                arr = arr.reshape(nrows, self.width * self.samples).copy()
                rows.append(self._undo_predictor(arr))
            out = np.concatenate(rows) if len(rows) > 1 else rows[0]
            return out.reshape(self.shape)
        tw, tl = self.tile_w, self.tile_l
        across = -(-self.width // tw)
        out = np.zeros(
            (self.length, self.width * self.samples), self.dtype
        )
        for ti, (off, cnt) in enumerate(zip(self.offsets, self.counts)):
            ty, tx = divmod(ti, across)
            expected = tl * tw * item
            if self.compression == 7:
                tile = self._decode_jpeg(
                    buf[off: off + cnt], tl, tw
                ).astype(self.dtype, copy=False)
            else:
                raw = _decompress(
                    bytes(buf[off: off + cnt]), self.compression, expected
                )
                tile = np.frombuffer(raw[:expected], self.dtype)
                tile = tile.reshape(tl, tw * self.samples).copy()
                tile = self._undo_predictor(tile)
            y0, x0 = ty * tl, tx * tw
            ny = min(tl, self.length - y0)
            nx = min(tw, self.width - x0) * self.samples
            out[y0: y0 + ny, x0 * self.samples: x0 * self.samples + nx] = (
                tile[:ny, :nx]
            )
        return out.reshape(self.shape)


def _parse(buf):
    """Parse header + IFD chain -> (pages, byte order)."""
    order = {b"II": "<", b"MM": ">"}.get(bytes(buf[:2]))
    if order is None:
        raise ValueError("not a TIFF file")
    magic = struct.unpack(order + "H", buf[2:4])[0]
    if magic == 42:
        big = False
        (first,) = struct.unpack(order + "I", buf[4:8])
    elif magic == 43:
        big = True
        off_size, zero = struct.unpack(order + "HH", buf[4:8])
        if off_size != 8 or zero != 0:
            raise ValueError("malformed BigTIFF header")
        (first,) = struct.unpack(order + "Q", buf[8:16])
    else:
        raise ValueError(f"bad TIFF magic {magic}")

    count_fmt = order + ("Q" if big else "H")
    count_size = 8 if big else 2
    entry_size = 20 if big else 12
    off_fmt = order + ("Q" if big else "I")
    inline = 8 if big else 4

    pages = []
    pos = first
    seen = set()
    while pos:
        if pos in seen:
            # Corrupt/adversarial next-IFD pointer looping back: fail
            # like tifffile instead of spinning forever.
            raise ValueError("circular IFD chain in TIFF")
        seen.add(pos)
        (n_entries,) = struct.unpack(
            count_fmt, buf[pos: pos + count_size]
        )
        tags = {}
        base = pos + count_size
        for i in range(n_entries):
            e = base + i * entry_size
            tag, typ = struct.unpack(order + "HH", buf[e: e + 4])
            (cnt,) = struct.unpack(off_fmt, buf[e + 4: e + 4 + inline])
            vpos = e + 4 + inline
            size = _TYPE_SIZES.get(typ, 1) * cnt
            if size > inline:
                (voff,) = struct.unpack(
                    off_fmt, buf[vpos: vpos + inline]
                )
                raw = buf[voff: voff + size]
            else:
                raw = buf[vpos: vpos + size]
            if tag == _T_JPEG_TABLES:
                tags[tag] = bytes(raw)  # opaque abbreviated JPEG stream
                continue
            fmt = _TYPE_FMT.get(typ)
            if fmt is None:
                continue  # rationals/ascii: not needed for decode
            tags[tag] = struct.unpack(order + fmt * cnt, bytes(raw))
        next_pos = base + n_entries * entry_size
        (pos,) = struct.unpack(off_fmt, buf[next_pos: next_pos + inline])
        if _T_WIDTH in tags and _T_LENGTH in tags:
            pages.append(_Page(tags, order))
    return pages


class TiffStack:
    """Lazy multi-page TIFF: pages decode on first access.

    Numpy-style indexing over (Z, H, W[, S]); ``[:]`` densifies. Pages
    must share shape and dtype (scientific stacks do). Decoded pages
    are memoized in a byte-capped LRU (``cache_bytes``, default
    256 MiB) -- raise it for random-access workloads that re-touch
    many pages, or lower it on tight hosts.
    """

    def __init__(self, buf, *, cache_bytes=256 * 1024**2):
        self._buf = buf
        self.pages = _parse(buf)
        if not self.pages:
            raise ValueError("TIFF contains no image pages")
        p0 = self.pages[0]
        for p in self.pages[1:]:
            if p.shape != p0.shape or p.dtype != p0.dtype:
                raise ValueError("pages differ in shape/dtype")
        self.shape = (len(self.pages),) + p0.shape
        self.dtype = p0.dtype.newbyteorder("=")
        # Decoded-page LRU: unbounded memoization would quietly hold
        # the whole decoded volume after one streaming pass, defeating
        # the lazy contract on beyond-RAM stacks. Bytes-capped.
        self.cache_bytes = int(cache_bytes)
        self._page_bytes = int(
            np.prod(p0.shape) * self.dtype.itemsize
        )
        from collections import OrderedDict

        self._cache = OrderedDict()

    @property
    def ndim(self):
        """Number of stack dimensions."""
        return len(self.shape)

    def __len__(self):
        return self.shape[0]

    def _page(self, i):
        if i in self._cache:
            self._cache.move_to_end(i)
            return self._cache[i]
        page = np.ascontiguousarray(
            self.pages[i].read(self._buf), dtype=self.dtype
        )
        keep = max(self.cache_bytes // max(self._page_bytes, 1), 1)
        while len(self._cache) >= keep:
            self._cache.popitem(last=False)
        self._cache[i] = page
        return page

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        zkey = key[0] if key else slice(None)
        rest = key[1:]
        if isinstance(zkey, (int, np.integer)):
            z = int(zkey)
            n = self.shape[0]
            if not -n <= z < n:  # numpy semantics: no silent wrap
                raise IndexError(
                    f"index {z} out of range for axis 0 with size {n}"
                )
            page = self._page(z % n)
            return page[rest] if rest else page
        idx = range(*zkey.indices(self.shape[0]))
        stack = np.stack([self._page(i) for i in idx]) if len(idx) else (
            np.empty((0,) + self.shape[1:], self.dtype)
        )
        return stack[(slice(None),) + rest] if rest else stack


def read_tiff(path_or_bytes, lazy=False, cache_bytes=256 * 1024**2):
    """Read a TIFF/BigTIFF into an ndarray (Z, H, W), (H, W), or, with
    ``lazy=True`` and multiple pages, a page-on-demand :class:`TiffStack`
    whose decoded-page LRU holds at most ``cache_bytes``.
    """
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        buf = memoryview(bytes(path_or_bytes))
    else:
        with open(path_or_bytes, "rb") as f:
            buf = memoryview(f.read())
    stack = TiffStack(buf, cache_bytes=cache_bytes)
    if lazy and len(stack) > 1:
        return stack
    if len(stack) == 1:
        return stack[0]
    return stack[:]


def write_tiff(path, array, bigtiff=None, compress=False):
    """Write (Z, H, W) / (H, W) grayscale data as striped TIFF.

    ``bigtiff=None`` selects BigTIFF automatically for >= 4 GB payloads;
    ``compress=True`` deflates each page's single strip.
    """
    array = np.asarray(array)
    if array.ndim == 2:
        array = array[None]
    if array.ndim != 3:
        raise ValueError(f"expected 2D/3D array, got {array.shape}")
    if bigtiff is None:
        bigtiff = array.nbytes >= (1 << 32) - (1 << 24)
    dt = array.dtype
    fmt_code = {"u": 1, "i": 2, "f": 3}.get(dt.kind)
    if fmt_code is None:
        raise ValueError(f"unsupported dtype {dt}")
    order = "<"
    arr = array.astype(dt.newbyteorder(order), copy=False)

    off_fmt = "Q" if bigtiff else "I"
    inline = 8 if bigtiff else 4

    def entry(tag, typ, count, value):
        raw = struct.pack(order + "HH", tag, typ)
        raw += struct.pack(order + off_fmt, count)
        vraw = struct.pack(order + _TYPE_FMT[typ] * count, *value)
        return raw + vraw.ljust(inline, b"\0")

    header_size = 16 if bigtiff else 8
    out = bytearray()
    if bigtiff:
        out += b"II" + struct.pack(order + "HHH", 43, 8, 0)
        out += struct.pack(order + "Q", 0)  # first IFD offset (patched)
    else:
        out += b"II" + struct.pack(order + "H", 42)
        out += struct.pack(order + "I", 0)
    assert len(out) == header_size

    z, h, w = arr.shape
    val_t = 16 if bigtiff else 4  # LONG8 / LONG
    ifd_offsets = []
    prev_link = header_size - inline
    for zi in range(z):
        payload = arr[zi].tobytes()
        if compress:
            payload = zlib.compress(payload, 6)
        data_off = len(out)
        out += payload
        if len(out) % 2:
            out += b"\0"
        ifd_off = len(out)
        ifd_offsets.append(ifd_off)
        tags = [
            entry(_T_WIDTH, 4, 1, (w,)),
            entry(_T_LENGTH, 4, 1, (h,)),
            entry(_T_BITS, 3, 1, (dt.itemsize * 8,)),
            entry(_T_COMPRESSION, 3, 1, (8 if compress else 1,)),
            entry(_T_PHOTOMETRIC, 3, 1, (1,)),
            entry(_T_STRIP_OFFSETS, val_t, 1, (data_off,)),
            entry(_T_SAMPLES, 3, 1, (1,)),
            entry(_T_ROWS_PER_STRIP, 4, 1, (h,)),
            entry(_T_STRIP_COUNTS, val_t, 1, (len(payload),)),
            entry(_T_SAMPLE_FORMAT, 3, 1, (fmt_code,)),
        ]
        out += struct.pack(order + ("Q" if bigtiff else "H"), len(tags))
        for t in tags:
            out += t
        out += struct.pack(order + off_fmt, 0)  # next-IFD link
        # patch the previous link to point here
        struct.pack_into(order + off_fmt, out, prev_link, ifd_off)
        prev_link = len(out) - inline
    with open(path, "wb") as f:
        f.write(out)
    return path
