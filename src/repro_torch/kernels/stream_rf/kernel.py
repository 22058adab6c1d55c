"""Build and load the CUDA ``stream_rf`` kernel (``csrc/stream_rf.cu``)
through the shared build helper (:mod:`repro_torch.kernels.build`)."""

from __future__ import annotations

import ctypes
import pathlib

from ..build import CudaLibrary

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "stream_rf.cu"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.stream_stats_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind)
build = LIBRARY.build
load = LIBRARY.load
