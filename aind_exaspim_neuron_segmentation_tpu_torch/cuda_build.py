"""Build and load kernel K1 (``csrc/scatter_blend.cu``).

The source compiles with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. The library file
is named by a hash of the source and flags
(``_build/libscatter_blend_<hash>.so``): editing the source builds a new
file, so ``ctypes.CDLL`` loads the new code, and the temp-file-then-rename
is atomic for concurrent processes. Nothing is compiled at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "scatter_blend.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
NVCC_TIMEOUT_S = 600

_LOCK = threading.Lock()
_lib = None


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; kernel K1 needs the "
            "CUDA toolkit"
        )
    return path


def load():
    """ctypes handle of K1's library, compiling it at first use; raises
    with the compiler's output if ``nvcc`` fails."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        with open(SOURCE, "rb") as src:
            h.update(src.read())
        path = os.path.join(BUILD_DIR,
                            f"libscatter_blend_{h.hexdigest()[:16]}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            try:
                res = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                    capture_output=True, text=True, timeout=NVCC_TIMEOUT_S,
                )
                if res.returncode:
                    raise RuntimeError(
                        f"nvcc failed on {SOURCE}:\n{res.stdout}{res.stderr}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        _lib = ctypes.CDLL(path)
        return _lib
