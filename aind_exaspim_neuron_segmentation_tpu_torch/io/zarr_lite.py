"""Minimal Zarr v2 + N5 chunked-array IO (no zarr/numcodecs dependency).

The reference reads volumes through zarr-python over DirectoryStore /
gcsfs / s3fs and N5Store (reference img_util.py:53-97); this module
implements the formats directly, with no zarr or numcodecs dependency:

* **Zarr v2**: ``.zarray`` JSON metadata; chunk keys ``i.j.k`` (or ``/``
  per ``dimension_separator``); compressors: ``null``, ``zlib``, ``gzip``,
  and ``blosc`` via the in-tree Blosc1 codec (``native/src/blosc_lite.cpp``:
  inner lz4/zlib/zstd + byte shuffle -- the numcodecs default for AIND
  production stores; zstd needs an engine built with ``<zstd.h>``,
  :func:`..native.have_zstd`). C order only.
* **Zarr v3** (read): ``zarr.json`` metadata, regular chunk grid,
  default/v2 chunk key encodings, codec pipeline ``bytes`` (either
  endian) + ``blosc``/``gzip``/``zstd``/``crc32c`` -- forward-compat
  for stores written by zarr-python 3.
* **N5**: ``attributes.json`` with ``dimensions`` in XYZ (fastest-first)
  order, chunk keys ``x/y/z``, big-endian block headers (mode 0), raw or
  gzip compression, block payload in fortran order relative to the XYZ
  dims (equals C order over ZYX) -- the zarr N5Store convention.

Both expose :class:`LazyArray` -- shape/dtype/ndim plus numpy-style slice
reads that touch only the chunks a patch needs, which is what the
patch-sampling datasets index (reference data_handling.py:134-153).
"""

import gzip as _gzip
import itertools
import json
import math
import zlib

import numpy as np

from aind_exaspim_neuron_segmentation_tpu_torch.io.stores import open_store


def _decompress(data, compressor):
    if compressor is None:
        return data
    cid = compressor.get("id")
    if cid == "zlib":
        return zlib.decompress(data)
    if cid == "gzip":
        return _gzip.decompress(data)
    if cid == "blosc":
        from aind_exaspim_neuron_segmentation_tpu_torch import native

        return native.blosc_decompress(data)
    raise ValueError(
        f"unsupported compressor {cid!r}: this build supports null/zlib/"
        "gzip/blosc (numcodecs is not installed)"
    )


_SUPPORTED_FILTERS = ("delta", "fixedscaleoffset", "astype", "quantize")


def _filter_decode(conf, buf):
    """Undo one numcodecs array-to-array filter (decode direction).

    Semantics match numcodecs' Delta / FixedScaleOffset / AsType /
    Quantize codecs (the filter chains common in AIND/OME zarr v2
    stores the reference opens via ``zarr.open``,
    reference utils/img_util.py:53-75). ``buf`` is bytes or an ndarray
    from the next filter's decode; returns a 1-D ndarray in this
    filter's output dtype.
    """
    if isinstance(buf, np.ndarray):
        buf = buf.tobytes()
    fid = conf.get("id")
    if fid == "delta":
        dtype = np.dtype(conf["dtype"])
        astype = np.dtype(conf.get("astype") or dtype)
        enc = np.frombuffer(buf, astype)
        dec = np.empty(enc.shape, dtype)
        np.cumsum(enc, out=dec)
        return dec
    if fid == "fixedscaleoffset":
        dtype = np.dtype(conf["dtype"])
        astype = np.dtype(conf.get("astype") or dtype)
        enc = np.frombuffer(buf, astype)
        dec = enc / conf["scale"] + conf["offset"]
        return dec.astype(dtype)
    if fid == "astype":
        enc = np.frombuffer(buf, np.dtype(conf["encode_dtype"]))
        return enc.astype(np.dtype(conf["decode_dtype"]))
    if fid == "quantize":
        # encode does the rounding; decode is a pure dtype cast
        dtype = np.dtype(conf["dtype"])
        astype = np.dtype(conf.get("astype") or dtype)
        return np.frombuffer(buf, astype).astype(dtype)
    raise ValueError(
        f"unsupported zarr filter {fid!r}: this build decodes "
        f"{'/'.join(_SUPPORTED_FILTERS)} chains (numcodecs is not "
        "installed)"
    )


def _compress(data, compressor):
    if compressor is None:
        return data
    cid = compressor.get("id")
    if cid == "zlib":
        return zlib.compress(data, compressor.get("level", 1))
    if cid == "gzip":
        return _gzip.compress(data, compressor.get("level", 1))
    if cid == "blosc":
        from aind_exaspim_neuron_segmentation_tpu_torch import native

        return native.blosc_compress(
            data,
            typesize=compressor.get("typesize", 1),
            shuffle=compressor.get("shuffle", 1),
        )
    raise ValueError(f"unsupported compressor {cid!r}")


class LazyArray:
    """Chunked lazy reader; subclasses supply per-chunk decode."""

    shape = ()
    chunks = ()
    dtype = None
    fill_value = 0

    @property
    def ndim(self):
        """Number of array dimensions."""
        return len(self.shape)

    def __len__(self):
        return self.shape[0]

    def _chunk(self, idx):
        raise NotImplementedError

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        key = key + (slice(None),) * (self.ndim - len(key))
        squeeze = []
        slices = []
        # Steps are handled by reading the contiguous covering range and
        # striding the result (post), so chunk walking stays simple.
        post = []
        for axis, k in enumerate(key):
            if isinstance(k, (int, np.integer)):
                k = int(k)
                if k < 0:
                    k += self.shape[axis]
                if not 0 <= k < self.shape[axis]:
                    raise IndexError(
                        f"index {k} out of bounds for axis {axis} with "
                        f"size {self.shape[axis]}"
                    )
                slices.append(slice(k, k + 1))
                squeeze.append(axis)
                post.append(slice(None))
            else:
                start, stop, step = k.indices(self.shape[axis])
                if step == 1:
                    slices.append(slice(start, stop))
                    post.append(slice(None))
                elif step > 1:
                    slices.append(slice(start, max(stop, start)))
                    post.append(slice(None, None, step))
                else:  # negative step: read the covering range, reverse
                    lo = max(stop + 1, 0)  # stop resolved by indices()
                    hi = max(start + 1, lo)  # empty selections stay empty
                    slices.append(slice(lo, hi))
                    post.append(slice(None, None, step))
        out_shape = tuple(s.stop - s.start for s in slices)
        out = np.full(out_shape, self.fill_value, dtype=self.dtype)
        ranges = [
            range(s.start // c, (max(s.stop - 1, s.start) // c) + 1)
            if s.stop > s.start else range(0)
            for s, c in zip(slices, self.chunks)
        ]

        # Iterative chunk walk (same nested-loop visit order a recursive
        # helper would produce). Deliberately NOT a recursive closure: a
        # function that closes over itself is a reference cycle, and it
        # would drag `out` (a whole decoded block) along until the
        # cyclic GC happens to run -- measured as ~one retained block
        # PER READ on streaming workloads, defeating the beyond-RAM
        # paths built on this reader.
        if all(len(r) for r in ranges):
            for idx in itertools.product(*ranges):
                chunk = self._chunk(idx)
                src, dst = [], []
                for ci, s, c in zip(idx, slices, self.chunks):
                    lo = max(s.start, ci * c)
                    hi = min(s.stop, (ci + 1) * c)
                    src.append(slice(lo - ci * c, hi - ci * c))
                    dst.append(slice(lo - s.start, hi - s.start))
                out[tuple(dst)] = chunk[tuple(src)]
        out = out[tuple(post)]
        if squeeze:
            out = out.reshape(
                tuple(
                    n for a, n in enumerate(out.shape) if a not in squeeze
                )
            )
        return out


class ZarrArray(LazyArray):
    """Read-only Zarr v2 array over a key-value store."""

    def __init__(self, store, meta):
        self.store = store
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.compressor = meta.get("compressor")
        self.fill_value = meta.get("fill_value", 0) or 0
        self.order = meta.get("order", "C")
        self.sep = meta.get("dimension_separator", ".")
        self.filters = list(meta.get("filters") or [])
        for f in self.filters:
            if f.get("id") not in _SUPPORTED_FILTERS:
                raise ValueError(
                    f"unsupported zarr filter {f.get('id')!r}: this "
                    f"build decodes {'/'.join(_SUPPORTED_FILTERS)} "
                    "chains (numcodecs is not installed)"
                )

    def _chunk(self, idx):
        key = self.sep.join(str(i) for i in idx)
        data = self.store.get(key)
        cshape = self.chunks
        if data is None:
            return np.full(cshape, self.fill_value, self.dtype)
        raw = _decompress(data, self.compressor)
        # filters applied in listed order at encode time: undo reversed
        for conf in reversed(self.filters):
            raw = _filter_decode(conf, raw)
        arr = np.frombuffer(raw, dtype=self.dtype) \
            if not isinstance(raw, np.ndarray) else raw.astype(
                self.dtype, copy=False)
        return arr.reshape(cshape, order=self.order)


class N5Array(LazyArray):
    """Read-only N5 dataset over a key-value store.

    ``attributes.json`` lists dimensions fastest-first (XYZ); exposed
    shape is reversed to ZYX like zarr's N5 adapters.
    """

    _DTYPES = {
        "uint8": ">u1", "uint16": ">u2", "uint32": ">u4", "uint64": ">u8",
        "int8": ">i1", "int16": ">i2", "int32": ">i4", "int64": ">i8",
        "float32": ">f4", "float64": ">f8",
    }

    def __init__(self, store, attrs):
        self.store = store
        dims_xyz = attrs["dimensions"]
        block_xyz = attrs["blockSize"]
        self.shape = tuple(reversed(dims_xyz))
        self.chunks = tuple(reversed(block_xyz))
        self.dtype = np.dtype(self._DTYPES[attrs["dataType"]])
        self.compression = attrs.get("compression", {"type": "raw"})
        self.fill_value = 0

    def _chunk(self, idx):
        # N5 chunk paths are fastest-dim first: reverse the zyx index.
        key = "/".join(str(i) for i in reversed(idx))
        data = self.store.get(key)
        if data is None:
            return np.zeros(self.chunks, self.dtype)
        mode = int.from_bytes(data[0:2], "big")
        ndim = int.from_bytes(data[2:4], "big")
        dims = [
            int.from_bytes(data[4 + i * 4: 8 + i * 4], "big")
            for i in range(ndim)
        ]
        off = 4 + 4 * ndim
        if mode == 1:
            off += 4  # varlength: num elements (unused here)
        payload = data[off:]
        ctype = self.compression.get("type", "raw")
        if ctype == "gzip":
            payload = _gzip.decompress(payload)
        elif ctype != "raw":
            raise ValueError(f"unsupported N5 compression {ctype!r}")
        block_zyx = tuple(reversed(dims))
        arr = np.frombuffer(payload, dtype=self.dtype).reshape(block_zyx)
        if block_zyx == tuple(self.chunks):
            return arr
        full = np.zeros(self.chunks, self.dtype)
        full[tuple(slice(0, d) for d in block_zyx)] = arr
        return full


def _parse_v3_codecs(codecs):
    """Split a zarr v3 codec list into (endian, bytes->bytes codecs).

    ``sharding_indexed`` is handled by the caller; anything else
    unknown is rejected with a clear message.
    """
    endian = "little"
    bytes_codecs = []
    for c in codecs:
        name = c.get("name")
        conf = c.get("configuration", {}) or {}
        if name == "bytes":
            endian = conf.get("endian", "little")
        elif name in ("blosc", "gzip", "zstd", "crc32c"):
            bytes_codecs.append((name, conf))
        else:
            raise ValueError(
                f"unsupported zarr v3 codec {name!r} (supported: bytes, "
                "blosc, gzip, zstd, crc32c, sharding_indexed)"
            )
    return endian, bytes_codecs


def _decode_v3(data, bytes_codecs, nbytes):
    """Run bytes->bytes codecs in decode order (outermost last)."""
    for name, conf in reversed(bytes_codecs):
        if name == "crc32c":
            from aind_exaspim_neuron_segmentation_tpu_torch import native

            body, stored = data[:-4], data[-4:]
            got = native.crc32c(body)
            want = int.from_bytes(bytes(stored), "little")
            if got != want:
                raise ValueError(
                    f"crc32c mismatch: stored {want:#010x}, computed "
                    f"{got:#010x} (corrupt chunk)"
                )
            data = body
        elif name == "gzip":
            data = _gzip.decompress(data)
        elif name == "zstd":
            from aind_exaspim_neuron_segmentation_tpu_torch import native

            data = native.zstd_decompress(data, nbytes)
        elif name == "blosc":
            from aind_exaspim_neuron_segmentation_tpu_torch import native

            data = native.blosc_decompress(data)
    return data


class Zarr3Array(LazyArray):
    """Read-only Zarr v3 array (zarr.json metadata).

    Forward-compat for stores written by zarr-python 3 (the reference's
    zarr dependency is migrating there). Supported: regular chunk grid,
    default/v2 chunk key encodings, codec pipeline ``bytes`` (either
    endian, normalized to native on read) followed by any of ``blosc``
    / ``gzip`` / ``zstd`` / ``crc32c``, and the ``sharding_indexed``
    codec (read): inner chunks resolve through the shard's
    offset/length index (end or start location), with the last-touched
    shard's index cached for sequential reads. ``transpose`` is
    rejected with a clear message.
    """

    _DTYPES = {
        "bool": "|b1", "uint8": "|u1", "uint16": "u2", "uint32": "u4",
        "uint64": "u8", "int8": "|i1", "int16": "i2", "int32": "i4",
        "int64": "i8", "float32": "f4", "float64": "f8",
    }

    def __init__(self, store, meta):
        if meta.get("node_type") != "array":
            raise ValueError("zarr.json is a group, not an array")
        self.store = store
        self.shape = tuple(meta["shape"])
        grid = meta["chunk_grid"]
        if grid.get("name") != "regular":
            raise ValueError(f"unsupported chunk grid {grid.get('name')!r}")
        outer = tuple(grid["configuration"]["chunk_shape"])
        fv = meta.get("fill_value", 0)
        self.fill_value = 0 if fv is None else fv
        key_enc = meta.get(
            "chunk_key_encoding", {"name": "default"}
        )
        if key_enc.get("name") == "v2":
            # The v2 encoding's SPEC default separator is "." (zarr v3
            # spec, chunk-key-encoding section) -- defaulting to "/"
            # here would make zarr-python's {"name": "v2"} stores read
            # back as silent fill-value zeros.
            sep = key_enc.get("configuration", {}).get("separator", ".")
            self._key = lambda idx: sep.join(str(i) for i in idx)
        else:
            sep = key_enc.get("configuration", {}).get("separator", "/")
            self._key = lambda idx: "c" + sep + sep.join(
                str(i) for i in idx
            )

        codecs = list(meta.get("codecs", []))
        self._sharding = None
        if codecs and codecs[0].get("name") == "sharding_indexed":
            conf = codecs[0]["configuration"]
            inner = tuple(conf["chunk_shape"])
            if any(o % i for o, i in zip(outer, inner)):
                raise ValueError(
                    f"shard shape {outer} not divisible by inner chunk "
                    f"shape {inner}"
                )
            ratio = tuple(o // i for o, i in zip(outer, inner))
            _, index_codecs = _parse_v3_codecs(
                conf.get("index_codecs", [{"name": "bytes"}])
            )
            index_size = int(np.prod(ratio)) * 16 + sum(
                4 for name, _ in index_codecs if name == "crc32c"
            )
            self._sharding = {
                "ratio": ratio,
                "location": conf.get("index_location", "end"),
                "index_codecs": index_codecs,
                "index_size": index_size,
                "cache_key": None,
                "cache": None,  # (shard bytes, index array)
            }
            endian, bytes_codecs = _parse_v3_codecs(
                conf.get("codecs", [{"name": "bytes"}])
            )
            self.chunks = inner  # LazyArray walks inner chunks
            self._outer = outer
        else:
            endian, bytes_codecs = _parse_v3_codecs(codecs)
            self.chunks = outer
            self._outer = outer
        self._bytes_codecs = bytes_codecs

        dt = self._DTYPES.get(meta["data_type"])
        if dt is None:
            raise ValueError(f"unsupported data_type {meta['data_type']!r}")
        order = {"little": "<", "big": ">"}[endian]
        self._stored_dtype = np.dtype(
            dt if dt.startswith("|") else order + dt
        )
        self.dtype = self._stored_dtype.newbyteorder("=")

    def _shard_index(self, shard_idx):
        """(shard bytes, (..., 2) uint64 offset/length index) or None."""
        sh = self._sharding
        if sh["cache_key"] == shard_idx:
            return sh["cache"]
        data = self.store.get(self._key(shard_idx))
        if data is None:
            sh["cache_key"] = shard_idx
            sh["cache"] = None
            return None
        data = bytes(data)
        n = sh["index_size"]
        raw = data[-n:] if sh["location"] == "end" else data[:n]
        nbytes = int(np.prod(sh["ratio"])) * 16
        raw = _decode_v3(raw, sh["index_codecs"], nbytes)
        index = np.frombuffer(raw[:nbytes], "<u8").reshape(
            sh["ratio"] + (2,)
        )
        sh["cache_key"] = shard_idx
        sh["cache"] = (data, index)
        return sh["cache"]

    def _chunk(self, idx):
        nbytes = int(np.prod(self.chunks)) * self.dtype.itemsize
        if self._sharding is None:
            data = self.store.get(self._key(idx))
            if data is None:
                return np.full(self.chunks, self.fill_value, self.dtype)
            data = _decode_v3(bytes(data), self._bytes_codecs, nbytes)
        else:
            ratio = self._sharding["ratio"]
            shard_idx = tuple(i // r for i, r in zip(idx, ratio))
            within = tuple(i % r for i, r in zip(idx, ratio))
            entry = self._shard_index(shard_idx)
            if entry is None:
                return np.full(self.chunks, self.fill_value, self.dtype)
            shard, index = entry
            off, length = (int(v) for v in index[within])
            if off == 2**64 - 1:  # missing inner chunk sentinel
                return np.full(self.chunks, self.fill_value, self.dtype)
            data = _decode_v3(
                shard[off: off + length], self._bytes_codecs, nbytes
            )
        arr = np.frombuffer(bytes(data)[:nbytes], self._stored_dtype)
        return np.ascontiguousarray(
            arr.reshape(self.chunks), dtype=self.dtype
        )


def open_zarr(path, mode="r"):
    """Open a Zarr array: v2 (``.zarray``) or v3 (``zarr.json``)."""
    store = open_store(path)
    meta = store.get(".zarray")
    if meta is not None:
        arr = ZarrArray(store, json.loads(meta))
        del mode
        return arr
    meta3 = store.get("zarr.json")
    if meta3 is not None:
        del mode
        return Zarr3Array(store, json.loads(meta3))
    raise FileNotFoundError(f"no .zarray or zarr.json at {path}")


def _encode_v3(data, codecs, itemsize):
    """bytes -> bytes through a v3 codec chain in ENCODE order.

    Mirrors :func:`_decode_v3` (which runs the chain reversed); the
    ``bytes`` codec is a no-op here because callers serialize blocks in
    the declared endianness before calling.
    """
    for c in codecs:
        name = c.get("name")
        conf = c.get("configuration", {}) or {}
        if name == "bytes":
            continue
        if name == "gzip":
            data = _gzip.compress(data, conf.get("level", 5))
        elif name == "zstd":
            from aind_exaspim_neuron_segmentation_tpu_torch import native

            data = native.zstd_compress(data, conf.get("level", 5))
        elif name == "blosc":
            from aind_exaspim_neuron_segmentation_tpu_torch import native

            shuf_name = conf.get("shuffle", "shuffle")
            shuf = {"noshuffle": 0, "shuffle": 1, "bitshuffle": 2}.get(
                shuf_name
            )
            if shuf is None:
                raise ValueError(
                    f"unsupported blosc shuffle {shuf_name!r}"
                )
            data = native.blosc_compress(
                data, typesize=itemsize, shuffle=shuf,
            )
        elif name == "crc32c":
            from aind_exaspim_neuron_segmentation_tpu_torch import native

            data = data + native.crc32c(data).to_bytes(4, "little")
        else:
            raise ValueError(f"unsupported writer codec {name!r}")
    return data


_V3_INDEX_CODECS = [
    {"name": "bytes", "configuration": {"endian": "little"}},
    {"name": "crc32c"},
]


def write_zarr3(path, array, chunks=None, codecs=None, shards=None):
    """Write a numpy array as a Zarr v3 store (zarr.json metadata).

    Default codec pipeline: little-endian ``bytes`` + ``zstd`` level 5
    (the zarr-python 3 ecosystem default); pass ``codecs=[...]`` with
    names from bytes/gzip/zstd/blosc to override. Round-trips through
    :class:`Zarr3Array` and is readable by zarr-python 3.

    ``shards`` enables the ``sharding_indexed`` layout (one store
    object per shard holding ``shards/chunks`` independently-encoded
    inner chunks plus a crc32c-protected offset/length index at the
    shard end -- zarr-python 3's defaults): ``chunks`` stays the inner
    (read-granular) chunk shape and ``shards`` is the outer per-object
    shape, exactly the ``chunks=``/``shards=`` split zarr-python 3
    exposes. Inner chunks that fall entirely outside the array bounds
    get the missing-chunk sentinel rather than padded payload.
    """
    array = np.asarray(array)
    chunks = tuple(chunks or (min(64, s) for s in array.shape))
    if codecs is None:
        codecs = [
            {"name": "bytes", "configuration": {"endian": "little"}},
            {"name": "zstd", "configuration": {"level": 5,
                                               "checksum": False}},
        ]
    if shards is not None:
        shards = tuple(shards)
        if len(shards) != array.ndim or any(
            s % c for s, c in zip(shards, chunks)
        ):
            raise ValueError(
                f"shard shape {shards} must be divisible by the inner "
                f"chunk shape {chunks}"
            )
        meta_codecs = [{
            "name": "sharding_indexed",
            "configuration": {
                "chunk_shape": list(chunks),
                "codecs": codecs,
                "index_codecs": _V3_INDEX_CODECS,
                "index_location": "end",
            },
        }]
    else:
        meta_codecs = codecs
    native_dt = array.dtype.newbyteorder("=")
    meta = {
        "zarr_format": 3,
        "node_type": "array",
        "shape": list(array.shape),
        "data_type": str(native_dt.name),
        "chunk_grid": {
            "name": "regular",
            "configuration": {"chunk_shape": list(shards or chunks)},
        },
        "chunk_key_encoding": {"name": "default",
                               "configuration": {"separator": "/"}},
        "fill_value": 0,
        "codecs": meta_codecs,
    }
    store = open_store(path)
    store.put("zarr.json", json.dumps(meta).encode())
    endian = next(
        (c.get("configuration", {}).get("endian", "little")
         for c in codecs if c.get("name") == "bytes"), "little",
    )
    order = {"little": "<", "big": ">"}[endian]
    out_dt = (native_dt if native_dt.itemsize == 1
              else native_dt.newbyteorder(order))

    def encode_chunk(idx):
        """Inner chunk ``idx`` (global grid coords) -> encoded bytes,
        zero-padding partial edge chunks (fill_value is 0)."""
        block = np.zeros(chunks, array.dtype)
        sl = tuple(
            slice(i * c, min((i + 1) * c, s))
            for i, c, s in zip(idx, chunks, array.shape)
        )
        block[tuple(slice(0, a.stop - a.start) for a in sl)] = array[sl]
        return _encode_v3(
            block.astype(out_dt, copy=False).tobytes(), codecs,
            array.dtype.itemsize,
        )

    if shards is None:
        grid = [math.ceil(s / c) for s, c in zip(array.shape, chunks)]
        for idx in np.ndindex(*grid):
            store.put("c/" + "/".join(str(i) for i in idx),
                      encode_chunk(idx))
        return path

    ratio = tuple(s // c for s, c in zip(shards, chunks))
    grid = [math.ceil(s / c) for s, c in zip(array.shape, shards)]
    for sidx in np.ndindex(*grid):
        parts = []
        index = np.full(ratio + (2,), 2**64 - 1, "<u8")
        offset = 0
        for widx in np.ndindex(*ratio):
            gidx = tuple(
                s * r + w for s, r, w in zip(sidx, ratio, widx)
            )
            if any(g * c >= d for g, c, d in
                   zip(gidx, chunks, array.shape)):
                continue  # fully outside the array: missing sentinel
            data = encode_chunk(gidx)
            index[widx] = (offset, len(data))
            parts.append(data)
            offset += len(data)
        raw_index = _encode_v3(
            index.tobytes(), _V3_INDEX_CODECS, 8
        )
        store.put("c/" + "/".join(str(i) for i in sidx),
                  b"".join(parts) + raw_index)
    return path


def open_n5(path):
    """Open an N5 dataset (the store root must hold ``attributes.json``)."""
    store = open_store(path)
    attrs = store.get("attributes.json")
    if attrs is None:
        raise FileNotFoundError(f"no attributes.json at {path}")
    attrs = json.loads(attrs)
    if "dimensions" not in attrs:
        raise ValueError(
            f"{path} is an N5 group, not a dataset (pass the dataset dir)"
        )
    return N5Array(store, attrs)


def write_zarr(path, array, chunks=None, compressor=None):
    """Write a numpy array as a Zarr v2 store (zlib level 1 default)."""
    if compressor is None:
        compressor = {"id": "zlib", "level": 1}
    array = np.asarray(array)
    if chunks is None:
        chunks = tuple(min(64, s) for s in array.shape)
    store = open_store(path)
    meta = {
        "zarr_format": 2,
        "shape": list(array.shape),
        "chunks": list(chunks),
        "dtype": array.dtype.str,
        "compressor": compressor,
        "fill_value": 0,
        "order": "C",
        "filters": None,
        "dimension_separator": ".",
    }
    store.put(".zarray", json.dumps(meta).encode())
    # Encode-time copy: blosc shuffles by element width, which numcodecs
    # infers from the array (never serialized into .zarray).
    enc = dict(compressor) if compressor else None
    if enc and enc.get("id") == "blosc":
        enc.setdefault("typesize", array.dtype.itemsize)
    grid = [math.ceil(s / c) for s, c in zip(array.shape, chunks)]
    for idx in np.ndindex(*grid):
        sl = tuple(
            slice(i * c, min((i + 1) * c, s))
            for i, c, s in zip(idx, chunks, array.shape)
        )
        block = np.zeros(chunks, array.dtype)
        block[tuple(slice(0, s.stop - s.start) for s in sl)] = array[sl]
        key = ".".join(str(i) for i in idx)
        store.put(key, _compress(block.tobytes(order="C"), enc))
    return path


class ZarrAppendWriter:
    """Incremental Zarr v2 writer: append along the LAST-minus-2 axis.

    Built for streaming inference outputs that never fit in RAM: slabs
    arrive in increasing Z order (any slab thickness), the writer
    buffers at most one chunk-row of Z planes, and flushes complete
    chunk rows to the store as they fill. Supports 3D (D, H, W) and 4D
    (C, D, H, W) arrays (channels stored as one chunk along C).
    """

    def __init__(self, path, shape, dtype, chunks=None, compressor=None):
        compressor = (
            {"id": "zlib", "level": 1} if compressor is None
            else dict(compressor)
        )
        if len(shape) == 3:
            self.channels = None
            d, h, w = shape
        elif len(shape) == 4:
            self.channels = shape[0]
            d, h, w = shape[1:]
        else:
            raise ValueError(f"expected 3D/4D shape, got {shape}")
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        cz, cy, cx = chunks or (64, min(256, h), min(256, w))
        self.chunks = (cz, cy, cx)
        self.compressor = compressor
        self.store = open_store(path)
        self.path = path
        full_chunks = (
            [self.channels] if self.channels else []
        ) + [cz, cy, cx]
        meta = {
            "zarr_format": 2,
            "shape": list(shape),
            "chunks": full_chunks,
            "dtype": self.dtype.str,
            "compressor": compressor,
            "fill_value": 0,
            "order": "C",
            "filters": None,
            "dimension_separator": ".",
        }
        self.store.put(".zarray", json.dumps(meta).encode())
        # Encode-time copy (blosc element width; never serialized).
        self._enc = dict(compressor)
        if self._enc.get("id") == "blosc":
            self._enc.setdefault("typesize", self.dtype.itemsize)
        buf_shape = (
            ((self.channels,) if self.channels else ()) + (cz, h, w)
        )
        self._buf = np.zeros(buf_shape, self.dtype)
        self._z = 0  # next absolute z plane to receive

    def append(self, block):
        """Add the next Z planes: (dz, H, W) or (C, dz, H, W)."""
        block = np.asarray(block, self.dtype)
        z_axis = 0 if self.channels is None else 1
        dz = block.shape[z_axis]
        d = self.shape[z_axis]
        if self._z + dz > d:
            raise ValueError("append past the declared Z extent")
        cz = self.chunks[0]
        off = 0
        while off < dz:
            buf_lo = (self._z + off) % cz
            take = min(cz - buf_lo, dz - off)
            src = [slice(None)] * block.ndim
            src[z_axis] = slice(off, off + take)
            dst = [slice(None)] * self._buf.ndim
            dst[z_axis] = slice(buf_lo, buf_lo + take)
            self._buf[tuple(dst)] = block[tuple(src)]
            off += take
            if buf_lo + take == cz or self._z + off == d:
                self._flush_row((self._z + off - 1) // cz)
        self._z += dz
        if self._z == d:
            self._buf = None  # complete

    def _flush_row(self, row):
        cz, cy, cx = self.chunks
        z_axis = 0 if self.channels is None else 1
        d, h, w = self.shape[z_axis:]
        for yi in range(math.ceil(h / cy)):
            for xi in range(math.ceil(w / cx)):
                chunk_shape = (
                    ((self.channels,) if self.channels else ())
                    + (cz, cy, cx)
                )
                chunk = np.zeros(chunk_shape, self.dtype)
                ys = slice(yi * cy, min((yi + 1) * cy, h))
                xs = slice(xi * cx, min((xi + 1) * cx, w))
                src = [slice(None)] * self._buf.ndim
                src[z_axis + 1] = ys
                src[z_axis + 2] = xs
                dst = [slice(None)] * chunk.ndim
                dst[z_axis + 1] = slice(0, ys.stop - ys.start)
                dst[z_axis + 2] = slice(0, xs.stop - xs.start)
                chunk[tuple(dst)] = self._buf[tuple(src)]
                idx = ([0] if self.channels else []) + [row, yi, xi]
                key = ".".join(str(i) for i in idx)
                self.store.put(
                    key, _compress(chunk.tobytes(order="C"), self._enc)
                )
        self._buf[...] = 0

    def close(self):
        """Verify every plane arrived (partial tails flush on append)."""
        z_axis = 0 if self.channels is None else 1
        if self._z != self.shape[z_axis]:
            raise ValueError(
                f"only {self._z} of {self.shape[z_axis]} Z planes written"
            )
        return self.path


class ZarrPlaneWriter:
    """Random-access Z-plane writer for multi-process output streaming.

    Chunks are one Z plane deep (``(1, cy, cx)``, channels whole), so a
    write of ANY contiguous z-range touches only chunk keys no other
    z-range touches -- multiple processes can write disjoint z-ranges of
    one store with no coordination (each process owns whole chunks).
    Metadata is written identically by every process (idempotent bytes).
    Used by ``parallel.predict_sharded(out_path=...)`` on multi-process
    meshes; single-process streaming keeps the buffered
    :class:`ZarrAppendWriter` (deeper chunks, fewer objects).
    """

    def __init__(self, path, shape, dtype, chunks_yx=None):
        if len(shape) == 3:
            self.channels = None
            d, h, w = shape
        elif len(shape) == 4:
            self.channels = shape[0]
            d, h, w = shape[1:]
        else:
            raise ValueError(f"expected 3D/4D shape, got {shape}")
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        cy, cx = chunks_yx or (min(256, h), min(256, w))
        self.chunks = (1, cy, cx)
        self.store = open_store(path)
        self.path = path
        full_chunks = (
            [self.channels] if self.channels else []
        ) + [1, cy, cx]
        meta = {
            "zarr_format": 2,
            "shape": list(shape),
            "chunks": full_chunks,
            "dtype": self.dtype.str,
            "compressor": {"id": "zlib", "level": 1},
            "fill_value": 0,
            "order": "C",
            "filters": None,
            "dimension_separator": ".",
        }
        self.store.put(".zarray", json.dumps(meta).encode())

    def write_planes(self, z0, block, y0=0):
        """Write ``block`` ((dz, H, W) or (C, dz, H, W)) at plane z0.

        ``y0``: global Y offset of the block (default 0 = full-height
        planes). Must sit on the chunk grid (``y0 % cy == 0``) and the
        block must end on the grid or at the array's Y extent, so that
        writers with disjoint chunk-aligned Y ranges touch disjoint
        chunk keys -- this is what lets a 2-D multi-process mesh whose
        Z rows split Y across processes stream one shared store
        (``parallel.predict_sharded`` picks ``cy`` = gcd of the Y
        shard boundaries).
        """
        block = np.asarray(block, self.dtype)
        z_axis = 0 if self.channels is None else 1
        dz = block.shape[z_axis]
        hb = block.shape[z_axis + 1]
        _, cy, cx = self.chunks
        d, h, w = self.shape[z_axis:]
        if y0 % cy or ((y0 + hb) % cy and y0 + hb != h):
            raise ValueError(
                f"Y range [{y0}, {y0 + hb}) is not aligned to the "
                f"chunk grid (cy={cy}, H={h}): concurrent writers "
                "would share chunk keys"
            )
        for dzi in range(dz):
            for yi in range(y0 // cy, math.ceil((y0 + hb) / cy)):
                for xi in range(math.ceil(w / cx)):
                    cshape = (
                        ((self.channels,) if self.channels else ())
                        + (1, cy, cx)
                    )
                    chunk = np.zeros(cshape, self.dtype)
                    ys = slice(yi * cy, min((yi + 1) * cy, h))
                    xs = slice(xi * cx, min((xi + 1) * cx, w))
                    src = [slice(None)] * block.ndim
                    src[z_axis] = slice(dzi, dzi + 1)
                    src[z_axis + 1] = slice(ys.start - y0, ys.stop - y0)
                    src[z_axis + 2] = xs
                    dst = [slice(None)] * chunk.ndim
                    dst[z_axis + 1] = slice(0, ys.stop - ys.start)
                    dst[z_axis + 2] = slice(0, xs.stop - xs.start)
                    chunk[tuple(dst)] = block[tuple(src)]
                    idx = (
                        ([0] if self.channels else [])
                        + [z0 + dzi, yi, xi]
                    )
                    key = ".".join(str(i) for i in idx)
                    self.store.put(
                        key,
                        _compress(chunk.tobytes(order="C"),
                                  {"id": "zlib", "level": 1}),
                    )


def write_n5(path, array, chunks=None, compression=None):
    """Write a numpy array (zyx) as an N5 dataset (gzip default)."""
    if compression is None:
        compression = {"type": "gzip"}
    array = np.asarray(array)
    if chunks is None:
        chunks = tuple(min(64, s) for s in array.shape)
    store = open_store(path)
    dtype_name = array.dtype.name
    if dtype_name not in N5Array._DTYPES:
        raise ValueError(f"unsupported N5 dtype {dtype_name}")
    attrs = {
        "dimensions": list(reversed(array.shape)),
        "blockSize": list(reversed(chunks)),
        "dataType": dtype_name,
        "compression": compression,
    }
    store.put("attributes.json", json.dumps(attrs).encode())
    be = np.dtype(N5Array._DTYPES[dtype_name])
    grid = [math.ceil(s / c) for s, c in zip(array.shape, chunks)]
    for idx in np.ndindex(*grid):
        sl = tuple(
            slice(i * c, min((i + 1) * c, s))
            for i, c, s in zip(idx, chunks, array.shape)
        )
        block = np.ascontiguousarray(array[sl], dtype=be)
        dims_xyz = list(reversed(block.shape))
        header = (0).to_bytes(2, "big") + len(dims_xyz).to_bytes(2, "big")
        for d in dims_xyz:
            header += int(d).to_bytes(4, "big")
        payload = block.tobytes(order="C")
        if compression.get("type") == "gzip":
            payload = _gzip.compress(payload, 1)
        key = "/".join(str(i) for i in reversed(idx))
        store.put(key, header + payload)
    return path
