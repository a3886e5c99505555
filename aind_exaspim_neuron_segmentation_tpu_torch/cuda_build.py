"""Build and load the port's CUDA kernels (``csrc/<name>.cu``).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into a shared
library of its own with a plain C interface, loaded with ``ctypes``: K1
(``scatter_blend``) and the depthwise conv (``depthwise3d``, linked to the
shared CUDA runtime, :data:`LIB_FLAGS`). A library file is named by a
hash of its source and flags (``_build/lib<name>_<hash>.so``): editing
the source builds a new file, so ``ctypes.CDLL`` loads the new code, and
the temp-file-then-rename is atomic for concurrent processes. Nothing is
compiled at import time; a library is built at its kernel's first launch.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
# The depthwise library calls the process's own CUDA runtime (torch's
# libcudart.so), not a static copy, so the profiler sees its launches and
# links each kernel to the host span that launched it.
LIB_FLAGS = {"depthwise3d": ["-cudart", "shared"]}
NVCC_TIMEOUT_S = 600

_LOCK = threading.Lock()
_libs = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the port's CUDA "
            "kernels need the CUDA toolkit"
        )
    return path


def load(name="scatter_blend"):
    """ctypes handle of ``csrc/<name>.cu``'s library (K1's by default),
    compiling it at first use; raises with the compiler's output if
    ``nvcc`` fails."""
    with _LOCK:
        if name in _libs:
            return _libs[name]
        src = os.path.join(_HERE, "csrc", f"{name}.cu")
        flags = NVCC_FLAGS + LIB_FLAGS.get(name, [])
        h = hashlib.sha256(" ".join(flags).encode())
        with open(src, "rb") as f:
            h.update(f.read())
        path = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            try:
                res = subprocess.run(
                    [_nvcc(), *flags, "-o", tmp, src],
                    capture_output=True, text=True, timeout=NVCC_TIMEOUT_S,
                )
                if res.returncode:
                    raise RuntimeError(
                        f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        _libs[name] = ctypes.CDLL(path)
        return _libs[name]
