"""The port's ``io`` and codecs against the JAX package's, on the CPU.

Every writer case writes the same array through both packages: every
file of the two stores must hold the same bytes (gzip headers carry the
write time, so the clock is frozen while they write), and each package
reads the other's store back to the array. Reader cases decode one file
through both packages. zstd cases skip only where the port's engine was
built without ``<zstd.h>`` (``native.have_zstd()``). Each comparison
prints a ``{"parity": ...}`` line (``pytest -s``).
"""

import ctypes
import io as pyio
import json
import os
import struct
import subprocess
import time
import zlib

import numpy as np
import pytest

from aind_exaspim_neuron_segmentation_tpu import io as jio
from aind_exaspim_neuron_segmentation_tpu import native as jnative
from aind_exaspim_neuron_segmentation_tpu.io import tiff_lite as jtiff
from aind_exaspim_neuron_segmentation_tpu.io import zarr_lite as jzarr
from aind_exaspim_neuron_segmentation_tpu_torch import io, native
from aind_exaspim_neuron_segmentation_tpu_torch.io import tiff_lite, zarr_lite
from aind_exaspim_neuron_segmentation_tpu_torch.native import build
from aind_exaspim_neuron_segmentation_tpu_torch.utils import img_util
from tests.test_torch_gpu import parity_line

BLOSC_LZ4 = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}


def _zstd_or_skip():
    if not native.have_zstd():
        pytest.skip("the port's engine was built without <zstd.h>")


@pytest.fixture
def frozen_clock(monkeypatch):
    """gzip stamps the time into each header: freeze it."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


def _vol(shape=(20, 18, 13), dtype=np.uint16, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 900, shape)
    base[:, : shape[1] // 2] //= 60  # a compressible half
    return base.astype(dtype)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _same_files(what, got_root, want_root):
    got, want = _tree(got_root), _tree(want_root)
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k] == want[k], f"{what}: {k} differs"
    parity_line(what, files=len(want), bytes_equal=True)


# --- writers: port and JAX write the same bytes, each reads the other ----


def _append(writer_cls, path, arr, step):
    z_axis = arr.ndim - 3
    w = writer_cls(path, arr.shape, arr.dtype, chunks=(5, 8, 8))
    d = arr.shape[z_axis]
    for lo in range(0, d, step):
        w.append(arr[:, lo:lo + step] if z_axis else arr[lo:lo + step])
    w.close()


def _planes(writer_cls, path, arr):
    w = writer_cls(path, arr.shape, arr.dtype, chunks_yx=(8, 8))
    w.write_planes(7, arr[:, 7:])
    w.write_planes(0, arr[:, :7])


WRITERS = {
    # zarr v2
    "v2_null": lambda m, p, a: m.write_zarr(p, a, chunks=(8, 8, 8),
                                            compressor=None),
    "v2_zlib": lambda m, p, a: m.write_zarr(p, a, chunks=(8, 8, 8)),
    "v2_gzip": lambda m, p, a: m.write_zarr(
        p, a, chunks=(8, 8, 8), compressor={"id": "gzip", "level": 5}),
    "v2_blosc_lz4_byteshuffle": lambda m, p, a: m.write_zarr(
        p, a, chunks=(8, 8, 8), compressor=BLOSC_LZ4),
    "v2_blosc_lz4_bitshuffle": lambda m, p, a: m.write_zarr(
        p, a, chunks=(8, 8, 8), compressor=dict(BLOSC_LZ4, shuffle=2)),
    # zarr v3
    "v3_bytes_zstd": lambda m, p, a: m.write_zarr3(p, a, chunks=(8, 8, 8)),
    "v3_gzip": lambda m, p, a: m.write_zarr3(p, a, chunks=(8, 8, 8), codecs=[
        {"name": "bytes", "configuration": {"endian": "little"}},
        {"name": "gzip", "configuration": {"level": 3}}]),
    "v3_blosc_bigendian": lambda m, p, a: m.write_zarr3(
        p, a, chunks=(8, 8, 8), codecs=[
            {"name": "bytes", "configuration": {"endian": "big"}},
            {"name": "blosc", "configuration": {"shuffle": "bitshuffle"}}]),
    "v3_gzip_crc32c": lambda m, p, a: m.write_zarr3(
        p, a, chunks=(8, 8, 8), codecs=[
            {"name": "bytes", "configuration": {"endian": "little"}},
            {"name": "gzip", "configuration": {"level": 1}},
            {"name": "crc32c"}]),
    "v3_sharded_zstd": lambda m, p, a: m.write_zarr3(
        p, a, chunks=(4, 4, 4), shards=(8, 8, 12)),
    # N5
    "n5_raw": lambda m, p, a: m.write_n5(p, a, chunks=(8, 8, 8),
                                         compression={"type": "raw"}),
    "n5_gzip": lambda m, p, a: m.write_n5(p, a, chunks=(8, 8, 8)),
    # streaming writers
    "append_3d_blosc": lambda m, p, a: _append(
        lambda *x, **k: m.ZarrAppendWriter(*x, compressor=BLOSC_LZ4, **k),
        p, a, 3),
    "append_4d_zlib": lambda m, p, a: _append(
        m.ZarrAppendWriter, p, np.stack([a, a // 2, a // 3]), 7),
    "plane_writer_4d": lambda m, p, a: _planes(
        m.ZarrPlaneWriter, p, np.stack([a, a + 1, a + 2])),
}


@pytest.mark.parametrize("kind", sorted(WRITERS))
def test_writers_bytes_equal_and_cross_read(tmp_path, frozen_clock, kind):
    if "zstd" in kind:
        _zstd_or_skip()
    vol = _vol()
    port, jax_ = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
    if kind.startswith("n5"):
        port, jax_ = port[:-5] + ".n5", jax_[:-5] + ".n5"
    WRITERS[kind](zarr_lite, port, vol)
    WRITERS[kind](jzarr, jax_, vol)
    _same_files(f"io writer {kind}", port, jax_)
    want = jio.read(jax_)[:]
    got = io.read(port)[:]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(jio.read(port)[:], want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(io.read(jax_)[:], want)
    if want.ndim == 3:
        np.testing.assert_array_equal(got, vol)


@pytest.mark.parametrize("shuffle", [0, 1, 2])
@pytest.mark.parametrize("typesize,n", [(1, 5000), (2, 70_000), (4, 4097),
                                        (4, (1 << 20) + 12)])
def test_blosc_compress_bytes_equal_jax(typesize, n, shuffle):
    raw = np.cumsum(np.random.default_rng(n).normal(0, 3, n // 4 + 1)
                    ).astype(np.float32).tobytes()[:n]
    got = native.blosc_compress(raw, typesize=typesize, shuffle=shuffle)
    assert got == jnative.blosc_compress(raw, typesize=typesize,
                                         shuffle=shuffle)
    assert native.blosc_decompress(got) == raw
    parity_line(f"blosc_compress ts {typesize} n {n} shuffle {shuffle}",
                bytes_equal=True)


# --- readers: one file, both packages ------------------------------------


def _bitshuffle(block, typesize):
    """c-blosc bit transpose of one block (body in 8-element groups)."""
    n_el = len(block) // typesize
    if len(block) < 128 or n_el % 8:
        return block
    body = np.frombuffer(block, np.uint8).reshape(n_el, typesize)
    bits = np.unpackbits(body[:, :, None], axis=2, bitorder="little")
    return np.packbits(bits.transpose(1, 2, 0), axis=2,
                       bitorder="little").tobytes()


def _blosc_frame(raw, typesize, codec, shuffle):
    """A one-block Blosc1 chunk (dont-split) with inner zlib or zstd."""
    if shuffle == 1:
        n = len(raw) // typesize
        body = np.frombuffer(raw, np.uint8)
        block = (body[: n * typesize].reshape(n, typesize).T.tobytes()
                 + raw[n * typesize:])
    elif shuffle == 2:
        block = _bitshuffle(raw, typesize)
    else:
        block = raw
    if codec == "zlib":
        stream, code = zlib.compress(block, 5), 3
    else:
        stream, code = jnative.zstd_compress(block, 5), 4
    flags = 0x10 | (code << 5) | {0: 0, 1: 0x1, 2: 0x4}[shuffle]
    body = struct.pack("<I", len(stream)) + stream
    total = 16 + 4 + len(body)
    header = bytes([2, 1, flags, typesize]) + struct.pack(
        "<III", len(raw), len(raw), total)
    return header + struct.pack("<i", 20) + body


@pytest.mark.parametrize("shuffle", [1, 2], ids=["byteshuffle",
                                                "bitshuffle"])
@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_blosc_inner_codecs_read_equal_jax(tmp_path, codec, shuffle):
    if codec == "zstd":
        _zstd_or_skip()
    vol = _vol((16, 16, 16))
    root = tmp_path / "hand.zarr"
    root.mkdir()
    (root / ".zarray").write_text(json.dumps({
        "zarr_format": 2, "shape": [16, 16, 16], "chunks": [8, 16, 16],
        "dtype": "<u2", "compressor": {"id": "blosc", "cname": codec,
                                       "shuffle": shuffle},
        "fill_value": 0, "order": "C", "filters": None,
    }))
    for i in range(2):
        raw = vol[8 * i: 8 * i + 8].tobytes()
        frame = _blosc_frame(raw, 2, codec, shuffle)
        assert native.blosc_decompress(frame) == raw
        (root / f"{i}.0.0").write_bytes(frame)
    got = io.read(str(root))[:]
    np.testing.assert_array_equal(got, jio.read(str(root))[:])
    np.testing.assert_array_equal(got, vol)
    parity_line(f"blosc inner {codec} shuffle {shuffle} read",
                bytes_equal=True)


def test_n5_varlength_block_reads_equal_jax(tmp_path):
    v = np.arange(4 * 3 * 2, dtype=np.uint16).reshape(4, 3, 2)
    path = tmp_path / "m1.n5"
    (path / "0" / "0").mkdir(parents=True)
    (path / "attributes.json").write_text(json.dumps({
        "dimensions": [2, 3, 4], "blockSize": [2, 3, 4],
        "dataType": "uint16", "compression": {"type": "raw"},
    }))
    header = struct.pack(">HH3II", 1, 3, 2, 3, 4, v.size)  # mode 1
    (path / "0" / "0" / "0").write_bytes(header + v.astype(">u2").tobytes())
    got = io.read(str(path))[:]
    np.testing.assert_array_equal(got, jio.read(str(path))[:])
    np.testing.assert_array_equal(got, v)


def test_crc32c_and_corrupt_chunk_equal_jax(tmp_path):
    data = np.random.default_rng(3).bytes(1000)
    assert native.crc32c(b"123456789") == 0xE3069283
    assert native.crc32c(data) == jnative.crc32c(data)
    path = str(tmp_path / "c.zarr")
    zarr_lite.write_zarr3(path, _vol((8, 8, 8)), codecs=[
        {"name": "bytes", "configuration": {"endian": "little"}},
        {"name": "crc32c"}])
    chunk = os.path.join(path, "c", "0", "0", "0")
    raw = bytearray(open(chunk, "rb").read())
    raw[5] ^= 0xFF
    open(chunk, "wb").write(bytes(raw))
    for read in (io.read, jio.read):
        with pytest.raises(ValueError, match="crc32c mismatch"):
            read(path)[:]


# --- TIFF ---------------------------------------------------------------


def _tiff(pages, compression=1, predictor=1, tile=None, planar=1):
    """Classic little-endian TIFF of (H, W) or (H, W, S) uint8/uint16
    ``pages``: strips of the whole page, or ``tile`` (T, T) tiles;
    ``compression`` 1 (none) or 8 (deflate); ``predictor`` 2 = horizontal
    differencing; ``planar`` 2 = one plane per sample."""
    def encode(a):
        a = np.ascontiguousarray(a)
        if predictor == 2:
            d = a.astype(np.int64)
            d[:, 1:] -= a[:, :-1].astype(np.int64)
            a = d.astype(a.dtype)
        raw = a.astype(a.dtype.newbyteorder("<")).tobytes()
        return zlib.compress(raw) if compression == 8 else raw

    def entry(tag, typ, values, at):
        fmt = {3: "H", 4: "I"}[typ]
        head = struct.pack("<HHI", tag, typ, len(values))
        if len(values) * struct.calcsize(fmt) <= 4:
            return head + struct.pack("<%d%s" % (len(values), fmt),
                                      *values).ljust(4, b"\0"), b""
        return head + struct.pack("<I", at), struct.pack(
            "<%d%s" % (len(values), fmt), *values)

    buf = bytearray(b"II" + struct.pack("<HI", 42, 0))
    link = 4
    for page in pages:
        samples = page.shape[2] if page.ndim == 3 else 1
        planes = ([page[:, :, s] for s in range(samples)] if planar == 2
                  else [page])
        blocks = []
        for plane in planes:
            if tile is None:
                blocks.append(encode(plane))
                continue
            for ty in range(0, page.shape[0], tile):
                for tx in range(0, page.shape[1], tile):
                    t = np.zeros((tile, tile) + plane.shape[2:], plane.dtype)
                    part = plane[ty:ty + tile, tx:tx + tile]
                    t[: part.shape[0], : part.shape[1]] = part
                    blocks.append(encode(t))
        offs = []
        for b in blocks:
            offs.append(len(buf))
            buf += b
        if len(buf) % 2:
            buf += b"\0"
        tags = [
            (256, 4, [page.shape[1]]), (257, 4, [page.shape[0]]),
            (258, 3, [page.dtype.itemsize * 8] * samples),
            (259, 3, [compression]),
            (262, 3, [2 if samples == 3 else 1]), (277, 3, [samples]),
            (284, 3, [planar]), (317, 3, [predictor]),
            (339, 3, [1] * samples),
        ]
        if tile is None:
            tags += [(273, 4, offs), (278, 4, [page.shape[0]]),
                     (279, 4, [len(b) for b in blocks])]
        else:
            tags += [(322, 4, [tile]), (323, 4, [tile]), (324, 4, offs),
                     (325, 4, [len(b) for b in blocks])]
        tags.sort()
        ifd = len(buf)
        extra_at = ifd + 2 + 12 * len(tags) + 4
        entries, extra = b"", b""
        for tag, typ, values in tags:
            e, x = entry(tag, typ, values, extra_at + len(extra))
            entries += e
            extra += x
        struct.pack_into("<I", buf, link, ifd)
        buf += struct.pack("<H", len(tags)) + entries
        link = len(buf)
        buf += struct.pack("<I", 0) + extra
    return bytes(buf)


def _pillow_tiff(path, pages, **save):
    from PIL import Image

    frames = [Image.fromarray(p) for p in pages]
    frames[0].save(path, save_all=True, append_images=frames[1:], **save)


def _tiff_case(kind, path):
    """Write the case's file at ``path``; returns (array it holds or
    None when lossy, port read, JAX read)."""
    rng = np.random.default_rng(5)
    u16 = rng.integers(0, 3000, (3, 21, 19)).astype(np.uint16)
    u8 = rng.integers(0, 250, (3, 21, 19)).astype(np.uint8)
    rgb = rng.integers(0, 250, (2, 20, 25, 3)).astype(np.uint8)
    if kind == "deflate":
        jtiff.write_tiff(path, u16, compress=True)
        want = u16
    elif kind == "bigtiff":
        jtiff.write_tiff(path, u16, bigtiff=True, compress=True)
        want = u16
    elif kind in ("lzw", "packbits"):
        _pillow_tiff(path, u8, compression={"lzw": "tiff_lzw"}.get(
            kind, kind))
        want = u8
    else:
        blob, want = {
            "predictor2": lambda: (_tiff(u16, 8, predictor=2), u16),
            "tiled": lambda: (_tiff(u16, 8, tile=16), u16),
            "planar": lambda: (_tiff(rgb, 8, predictor=2, planar=2), rgb),
            "planar_tiled": lambda: (_tiff(rgb, tile=16, planar=2), rgb),
        }[kind]()
        with open(path, "wb") as f:
            f.write(blob)
    return want


@pytest.mark.parametrize("kind", ["deflate", "bigtiff", "lzw", "packbits",
                                  "predictor2", "tiled", "planar",
                                  "planar_tiled"])
def test_tiff_reads_equal_jax(tmp_path, kind):
    path = str(tmp_path / f"{kind}.tif")
    want = _tiff_case(kind, path)
    got = io.read(path)
    np.testing.assert_array_equal(got, jio.read(path))
    np.testing.assert_array_equal(got, want)
    lazy = tiff_lite.read_tiff(path, lazy=True)
    np.testing.assert_array_equal(lazy[1:, 3:9], want[1:, 3:9])
    parity_line(f"tiff read {kind}", bytes_equal=True)


@pytest.mark.parametrize("bigtiff,compress", [(False, False), (False, True),
                                              (True, True)])
def test_tiff_writer_bytes_equal_jax(tmp_path, bigtiff, compress):
    vol = _vol((4, 20, 17))
    port, jax_ = str(tmp_path / "p.tif"), str(tmp_path / "j.tif")
    tiff_lite.write_tiff(port, vol, bigtiff=bigtiff, compress=compress)
    jtiff.write_tiff(jax_, vol, bigtiff=bigtiff, compress=compress)
    assert open(port, "rb").read() == open(jax_, "rb").read()
    np.testing.assert_array_equal(jio.read(port), vol)
    np.testing.assert_array_equal(img_util.read(jax_), vol)


def _pillow_jpeg(img, **save):
    from PIL import Image

    buf = pyio.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90, **save)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["gray", "rgb_420", "rgb_444",
                                  "progressive", "tiff_rgb", "tiff_gray"])
def test_jpeg_decodes_equal_jax(tmp_path, kind):
    """JPEG streams and JPEG-in-TIFF pages written by Pillow: the port's
    decode equals the JAX package's byte for byte."""
    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[0:40, 0:48]
    smooth = np.stack([(yy * 5 + xx * 2) % 256, (xx * 4) % 256,
                       (yy * 3 + 40) % 256], -1).astype(np.uint8)
    smooth = np.clip(smooth + rng.integers(0, 6, smooth.shape), 0,
                     255).astype(np.uint8)
    if kind.startswith("tiff"):
        path = str(tmp_path / "j.tif")
        pages = [smooth, smooth[::-1]] if kind == "tiff_rgb" else [
            smooth[..., 0], smooth[::-1, :, 1]]
        _pillow_tiff(path, pages, compression="jpeg")
        got, want = io.read(path), jio.read(path)
    else:
        img = smooth[..., 0] if kind == "gray" else smooth
        save = {"progressive": dict(progressive=True),
                "rgb_444": dict(subsampling=0)}.get(kind, {})
        data = _pillow_jpeg(img, **save)
        got, want = native.jpeg_decode(data), jnative.jpeg_decode(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    parity_line(f"jpeg decode {kind}", bytes_equal=True)


# --- dispatch, stores, the build ----------------------------------------


def test_read_dispatch_and_store_errors_equal_jax(tmp_path, monkeypatch):
    vol = _vol((8, 8, 8))
    zarr_lite.write_zarr(str(tmp_path / "v.zarr"), vol)
    sub = tmp_path / "c.zarr" / "0"
    zarr_lite.write_zarr(str(sub), vol)
    np.testing.assert_array_equal(img_util.read(str(sub))[:], vol)
    np.testing.assert_array_equal(
        img_util.read(str(tmp_path / "v.zarr"))[2:5, 1, ::-2],
        vol[2:5, 1, ::-2])
    for read in (io.read, jio.read):
        with pytest.raises(ValueError, match="unsupported extension"):
            read("volume.h5")
        with pytest.raises(FileNotFoundError):
            read(str(tmp_path / "missing.zarr"))
    import builtins

    real_import = builtins.__import__

    def no_cloud(name, *args, **kw):
        if name in ("gcsfs", "s3fs"):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cloud)
    for uri, pkg in (("gs://b/v.zarr", "gcsfs"), ("s3://b/v.zarr", "s3fs")):
        with pytest.raises(ImportError, match=pkg):
            io.read(uri)


def test_retry_backs_off_on_transient_errors(monkeypatch):
    from aind_exaspim_neuron_segmentation_tpu_torch.utils import retry

    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("drop")
        return "ok"

    assert retry.retry(flaky) == "ok" and len(calls) == 3
    with pytest.raises(FileNotFoundError):
        retry.retry(lambda: open("/nonexistent/x"))


def test_engine_without_zstd_raises_naming_the_header(tmp_path,
                                                      monkeypatch):
    """The codec source built as the card's host builds it when
    ``<zstd.h>`` is absent: zstd streams raise a ``RuntimeError`` naming
    it; lz4 and zlib blosc chunks still decode."""
    so = str(tmp_path / "libnozstd.so")
    src = os.path.join(build.SRC_DIR, "blosc_lite.cpp")
    subprocess.run([build.CXX, *build.CXXFLAGS, "-o", so, src, "-lz"],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    u8p, i64p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(
        ctypes.c_int64)
    lib.exa_have_zstd.restype = ctypes.c_int32
    lib.exa_blosc_info.restype = ctypes.c_int64
    lib.exa_blosc_info.argtypes = [u8p, ctypes.c_int64, i64p]
    for name in ("exa_blosc_decompress", "exa_zstd_decompress"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [u8p, ctypes.c_int64, u8p,
                                       ctypes.c_int64]
    lib.exa_zstd_compress.restype = ctypes.c_int64
    lib.exa_zstd_compress.argtypes = [u8p, ctypes.c_int64, u8p,
                                      ctypes.c_int64, ctypes.c_int32]
    monkeypatch.setattr(native, "_lib", lambda: lib)
    assert not native.have_zstd()
    raw = _vol((8, 16, 16)).tobytes()
    for frame in (jnative.blosc_compress(raw, typesize=2),
                  _blosc_frame(raw, 2, "zlib", 1)):
        assert native.blosc_decompress(frame) == raw
    with pytest.raises(RuntimeError, match="zstd.h"):
        native.blosc_decompress(_blosc_frame(raw, 2, "zstd", 1))
    with pytest.raises(RuntimeError, match="zstd.h"):
        native.zstd_compress(raw)
    with pytest.raises(RuntimeError, match="zstd.h"):
        native.zstd_decompress(jnative.zstd_compress(raw), len(raw))
    with pytest.raises(RuntimeError, match="zstd.h"):
        zarr_lite.write_zarr3(str(tmp_path / "z.zarr"), _vol((4, 4, 4)))
