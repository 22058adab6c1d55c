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
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    for name in ("stream_stats_wide_rows", "stream_stats_long_rows",
                 "stream_stats_long_wide_rows"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind)
build = LIBRARY.build
load = LIBRARY.load


def _count(name: str, reset: bool) -> int:
    out = ctypes.c_ulonglong(0)
    err = getattr(load(), name)(ctypes.byref(out), int(reset))
    if err != 0:
        raise RuntimeError(f"stream_rf {name} failed: cudaError {err}")
    return out.value


def wide_rows(reset: bool = False) -> int:
    """Rows the kernel has scored by its exact wide branch (rows whose
    32-bit bucket keys came out of order) since the last reset, summed over
    every launch on the card."""

    return _count("stream_stats_wide_rows", reset)


def long_rows(reset: bool = False) -> int:
    """Rows of more than 1024 requests that the long-row kernel (one block
    a row) has scored since the last reset, summed over every launch."""

    return _count("stream_stats_long_rows", reset)


def long_wide_rows(reset: bool = False) -> int:
    """Rows the long-row kernel has scored by its exact branch (rows whose
    32-bit bucket keys its repair rounds could not put in order; see
    ``testing.stream_rows.long_row_exact``) since the last reset, summed
    over every launch."""

    return _count("stream_stats_long_wide_rows", reset)
