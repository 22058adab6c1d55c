"""Build and load the CUDA ``tapes`` kernel (``csrc/tapes.cu``) through
the shared build helper (:mod:`repro_torch.kernels.build`).

It is built with ``-fmad=false``: the host tape builder computes each
product and sum of a suffix anchor's time as its own NumPy op, so a fused
multiply-add would round otherwise than it does."""

from __future__ import annotations

import ctypes
import pathlib

from ..build import CudaLibrary

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "tapes.cu"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.tapes_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p] + [ctypes.c_double] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind, extra_flags=("-fmad=false",))
build = LIBRARY.build
load = LIBRARY.load
