"""Build and load the CUDA ``stream_rf`` kernel (``csrc/stream_rf.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, under ``build/kernels/`` at the
root of the checkout, and loaded with :mod:`ctypes`.  The library's name
carries a hash of the source, so an edited kernel is rebuilt and a stale
build is never loaded.  Nothing here runs at import time: the CPU tests
import this module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "stream_rf.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output of the last build in this process ("" if cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA stream_rf kernel cannot be built")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libstream_rf-{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the source unless this version is already built; returns
    the library's path.  Concurrent builders each write a private file
    and rename it into place."""

    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, check=False,
    )
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {SOURCE.name}:\n{build_log}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library (built on first call)."""

    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.stream_stats_launch
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib
