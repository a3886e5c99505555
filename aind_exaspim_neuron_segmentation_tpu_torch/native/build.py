"""Build and load the port's C++ engine (``native/src``).

The dense inference tail -- watershed, agglomeration, remap, EDT and
TEASAR -- is host C++ with a plain C interface, loaded with ``ctypes``.
It compiles with ``g++`` at first use, never at import time. The library
file is named by a hash of the sources and flags
(``_build/libexaspim_native_<hash>.so``): editing a source builds a new
file, so ``ctypes.CDLL`` loads the new code (``dlopen`` deduplicates by
path), and the temp-file-then-rename is atomic for concurrent processes.
The build links nothing beyond libstdc++ and pthreads. ``-march=native``
makes the binary host-specific, so build outputs are git-ignored.
"""

import ctypes
import glob
import hashlib
import os
import subprocess
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


def lib_path():
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join([CXX, *CXXFLAGS]).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libexaspim_native_{h.hexdigest()[:16]}.so")


def rebuild(target=None):
    """Compile the library into ``target``; raises ``RuntimeError`` with
    the compiler's output if ``g++`` fails or times out."""
    target = target or lib_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.tmp{os.getpid()}"
    cpps = [p for p in sources() if p.endswith(".cpp")]
    cmd = [CXX, *CXXFLAGS, "-o", tmp, *cpps]
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
    return target


def load():
    """ctypes handle of the engine for the current sources, building it
    if needed. Opened ``RTLD_LOCAL`` (the ``ctypes`` default), so another
    library exporting the same ``exa_*`` names never shadows this one."""
    global _loaded, _loaded_path
    with _LOCK:
        target = lib_path()
        if _loaded is not None and _loaded_path == target:
            return _loaded
        if not os.path.exists(target):
            rebuild(target)
        _loaded = ctypes.CDLL(target)
        _loaded_path = target
    return _loaded


def loaded_path():
    """Path of the library :func:`load` opened last (None before)."""
    return _loaded_path
