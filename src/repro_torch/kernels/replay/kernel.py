"""Build and load the CUDA ``replay`` kernel (``csrc/replay.cu``) through
the shared build helper (:mod:`repro_torch.kernels.build`).

It is built with ``-fmad=false``: the plain version computes every
product and sum as separate torch ops, so a fused multiply-add would round
otherwise than it does."""

from __future__ import annotations

import ctypes
import pathlib

from ..build import CudaLibrary

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "replay.cu"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.replay_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_double] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind, extra_flags=("-fmad=false",))
build = LIBRARY.build
load = LIBRARY.load
