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
    fn = lib.stream_stats_wide_rows
    fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind)
build = LIBRARY.build
load = LIBRARY.load


def wide_rows(reset: bool = False) -> int:
    """Rows the kernel has scored by its exact wide branch (rows whose
    32-bit bucket keys came out of order) since the last reset, summed over
    every launch on the card."""

    out = ctypes.c_ulonglong(0)
    err = load().stream_stats_wide_rows(ctypes.byref(out), int(reset))
    if err != 0:
        raise RuntimeError(f"stream_rf wide-row count failed: cudaError {err}")
    return out.value
