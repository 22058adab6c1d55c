"""Build and load the CUDA ``ssm_scan`` kernel (``csrc/ssm_scan.cu``)
through the shared build helper (:mod:`repro_torch.kernels.build`)."""

from __future__ import annotations

import ctypes
import pathlib

from ..build import CudaLibrary

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ssm_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind)
build = LIBRARY.build
load = LIBRARY.load
