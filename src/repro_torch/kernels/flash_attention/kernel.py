"""Build and load the CUDA ``flash_attention`` kernel
(``csrc/flash_attention.cu``) through the shared build helper
(:mod:`repro_torch.kernels.build`)."""

from __future__ import annotations

import ctypes
import pathlib

from ..build import CudaLibrary

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int] + [ctypes.c_longlong] * 12
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind)
build = LIBRARY.build
load = LIBRARY.load
