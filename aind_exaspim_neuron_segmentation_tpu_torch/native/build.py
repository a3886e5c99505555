"""Build and load the port's C++ engine (``native/src``).

The host engine -- watershed, agglomeration, remap, EDT, TEASAR, the
slab-streaming segmenter, and the Blosc1 / zstd / CRC-32C / JPEG codecs
behind ``io`` -- is C++ with a plain C interface, loaded with ``ctypes``.
It compiles with ``g++`` at first use, never at import time. The library
file is named by a hash of the sources, flags and libraries
(``_build/libexaspim_native_<hash>.so``): editing a source builds a new
file, so ``ctypes.CDLL`` loads the new code (``dlopen`` deduplicates by
path), and the temp-file-then-rename is atomic for concurrent processes.
An ``fcntl.flock`` on ``_build/.lock`` makes concurrent processes build
it once: the first compiles, the others wait and load its file.

The build links libstdc++, pthreads and the system zlib (``-lz``). It
links the system zstd only where a one-line probe finds ``<zstd.h>`` and
``-lzstd`` (:func:`have_zstd`); it then defines ``EXA_HAVE_ZSTD``.
Without it, blosc's inner zstd streams and the raw ``zstd`` codec raise
``RuntimeError``; lz4, blosclz, zlib and both shuffles need nothing
else. ``-march=native`` makes the binary host-specific, so build outputs
are git-ignored.
"""

import contextlib
import ctypes
import fcntl
import functools
import glob
import hashlib
import os
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "src")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX = os.environ.get("CXX", "g++")
CXXFLAGS = [
    "-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
    "-fvisibility=hidden", "-DEXA_EXPORT=1", "-pthread",
]
CXX_TIMEOUT_S = 600
_ZSTD_PROBE = (
    "#include <zstd.h>\nint main() { return ZSTD_versionNumber() == 0; }\n"
)

_LOCK = threading.Lock()
_loaded = None
_loaded_path = None


def sources():
    """Every C++ source and header of the engine, sorted."""
    return sorted(
        os.path.join(SRC_DIR, f)
        for f in os.listdir(SRC_DIR)
        if f.endswith((".cpp", ".hpp"))
    )


@functools.lru_cache(maxsize=None)
def have_zstd():
    """True when ``<zstd.h>`` compiles and ``-lzstd`` links on this host
    (one small ``g++`` run, once per process)."""
    with tempfile.TemporaryDirectory() as tmp:
        try:
            res = subprocess.run(
                [CXX, "-x", "c++", "-", "-o", os.path.join(tmp, "probe"),
                 "-lzstd"],
                input=_ZSTD_PROBE, capture_output=True, text=True,
                timeout=120,
            )
        except (OSError, subprocess.TimeoutExpired):
            return False
    return res.returncode == 0


def flags():
    """(compile flags, libraries) for this host's build."""
    if have_zstd():
        return CXXFLAGS + ["-DEXA_HAVE_ZSTD"], ["-lz", "-lzstd"]
    return list(CXXFLAGS), ["-lz"]


def lib_path():
    """Path of the shared library for the current sources, flags and
    libraries (the zstd probe's answer included)."""
    cflags, libs = flags()
    h = hashlib.sha256(" ".join([CXX, *cflags, *libs]).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libexaspim_native_{h.hexdigest()[:16]}.so")


@contextlib.contextmanager
def _build_lock():
    """Exclusive ``flock`` on ``_build/.lock``, released on exit (and by
    the kernel if the process dies)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def _compile(target):
    tmp = f"{target}.tmp{os.getpid()}"
    cflags, libs = flags()
    cpps = [p for p in sources() if p.endswith(".cpp")]
    cmd = [CXX, *cflags, "-o", tmp, *cpps, *libs]
    try:
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=CXX_TIMEOUT_S)
        except subprocess.TimeoutExpired as err:
            raise RuntimeError(
                f"native build timed out after {CXX_TIMEOUT_S} s: "
                f"{' '.join(cmd)}") from err
        if res.returncode:
            raise RuntimeError(
                f"native build failed ({' '.join(cmd)}):\n"
                f"{res.stdout}{res.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    # superseded builds of this library only
    for old in glob.glob(os.path.join(BUILD_DIR, "libexaspim_native_*.so")):
        if old != target:
            try:
                os.unlink(old)
            except OSError:
                pass


def rebuild(target=None):
    """Compile the library into ``target`` under the build lock; raises
    ``RuntimeError`` with the compiler's output if ``g++`` fails or times
    out."""
    target = target or lib_path()
    with _build_lock():
        _compile(target)
    return target


def _ensure_built(target):
    """Build ``target`` unless it exists; a process that finds another
    one building waits on the lock and then finds the file."""
    if not os.path.exists(target):
        with _build_lock():
            if not os.path.exists(target):
                _compile(target)


def load():
    """ctypes handle of the engine for the current sources, building it
    if needed (once across processes: the others wait on the build lock).
    Opened ``RTLD_LOCAL`` (the ``ctypes`` default), so another library
    exporting the same ``exa_*`` names never shadows this one."""
    global _loaded, _loaded_path
    with _LOCK:
        target = lib_path()
        if _loaded is not None and _loaded_path == target:
            return _loaded
        _ensure_built(target)
        _loaded = ctypes.CDLL(target)
        _loaded_path = target
    return _loaded


def loaded_path():
    """Path of the library :func:`load` opened last (None before)."""
    return _loaded_path
