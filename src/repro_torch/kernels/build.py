"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` source with a plain C interface.  It
is compiled with ``nvcc`` for ``sm_90a`` into a shared library at first
use, under ``build/kernels/`` at the root of the checkout, and loaded with
:mod:`ctypes`.  The library's name carries a hash of the source and the
flags, so an edited kernel is rebuilt and a stale build is never loaded.
Nothing here runs at import time: the CPU tests import every kernel module
on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Callable

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


class CudaLibrary:
    """One kernel source, built on first :meth:`load` and bound by ``bind``
    (which sets each C function's ``argtypes`` and ``restype``).
    ``extra_flags`` are this library's own, after :data:`NVCC_FLAGS`."""

    def __init__(self, source: pathlib.Path, bind: Callable[[ctypes.CDLL], None],
                 extra_flags: tuple[str, ...] = ()):
        self.source = source
        self._bind = bind
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.build_log = ""  # nvcc's output of the last build ("" if cached)

    def library_path(self) -> pathlib.Path:
        digest = hashlib.sha256(self.source.read_bytes() + " ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{digest.hexdigest()[:16]}.so"

    def build(self) -> pathlib.Path:
        """Compile the source unless this version is already built; returns
        the library's path.  Concurrent builds each write a private file
        and rename it into place."""

        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run(
            [nvcc(), *self.flags, "-o", str(tmp), str(self.source)],
            capture_output=True, text=True, check=False,
        )
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {self.source.name}:\n{self.build_log}")
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        """The loaded, bound library (built on first call)."""

        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
            return self._lib
