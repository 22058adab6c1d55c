"""Public wrapper of the ``ssm_scan`` kernel.

:func:`ssm_scan_op` keeps the reference's contract: delta (B,S,DI) f32,
B/C (B,S,N) f32, x (B,S,DI) f32 or bf16, A (DI,N) f32 -> (y (B,S,DI) in
x's dtype, h_last (B,DI,N) f32), with h starting at zero.  It raises
``ValueError`` where the reference raises: S not divisible by
``min(chunk, S)`` or DI by ``min(block_d, DI)``.  Beyond that check the two
block sizes cannot change the result: the kernel walks the whole sequence
in one loop per (b, d) channel.

On a CUDA tensor it launches the hand-written kernel (``csrc/ssm_scan.cu``)
on the current stream, and raises if it cannot be built or launched; on a
CPU tensor it runs the plain torch version
(:mod:`repro_torch.kernels.ssm_scan.ref`).  There is no fallback from the
card to the plain version.

The tracer's counter ``launch.ssm_scan`` counts kernel launches
(:mod:`repro_torch.tracing`), so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import torch

from ... import tracing
from . import ref

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(delta, B_ssm, C_ssm, x, A, block_d: int, chunk: int) -> None:
    named = (("delta", delta), ("B", B_ssm), ("C", C_ssm), ("x", x), ("A", A))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != delta.device:
            raise ValueError("all inputs must be on one device")
        if name != "x" and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if delta.dim() != 3 or x.shape != delta.shape:
        raise ValueError(f"delta {tuple(delta.shape)} and x {tuple(x.shape)} must be (B,S,DI)")
    b, s, di = delta.shape
    if B_ssm.dim() != 3 or B_ssm.shape[:2] != (b, s) or C_ssm.shape != B_ssm.shape:
        raise ValueError(f"B {tuple(B_ssm.shape)} and C {tuple(C_ssm.shape)} must be (B,S,N)")
    n = B_ssm.shape[2]
    if A.shape != (di, n):
        raise ValueError(f"A {tuple(A.shape)} must be (DI, N) = ({di}, {n})")
    if b < 1 or s < 1 or di < 1:
        raise ValueError(f"empty scan {tuple(delta.shape)}")
    bd, ck = min(block_d, di), min(chunk, s)
    if bd < 1 or ck < 1 or di % bd != 0 or s % ck != 0:
        raise ValueError(f"dims ({di}, {s}) not divisible by blocks ({bd}, {ck})")
    if delta.device.type == "cuda" and (n > 32 or n & (n - 1)):
        raise ValueError(f"state size {n} must be a power of two up to 32")


def _launch(delta, B_ssm, C_ssm, x, A):
    from .kernel import load  # builds with nvcc on first use

    b, s, di = delta.shape
    n = B_ssm.shape[2]
    y = torch.empty_like(x)
    h_last = torch.empty(b, di, n, dtype=torch.float32, device=x.device)
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssm_scan_launch(
            delta.data_ptr(), B_ssm.data_ptr(), C_ssm.data_ptr(), x.data_ptr(),
            A.data_ptr(), y.data_ptr(), h_last.data_ptr(), _X_DTYPES[x.dtype],
            b, s, di, n, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: cudaError {err}")
    tracing.count("launch.ssm_scan")
    return y, h_last


def ssm_scan_op(delta: torch.Tensor, B_ssm: torch.Tensor, C_ssm: torch.Tensor,
                x: torch.Tensor, A: torch.Tensor, *, block_d: int = 512,
                chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan from h = 0 -> (y in x.dtype, h_last f32)."""

    _check(delta, B_ssm, C_ssm, x, A, block_d, chunk)
    if delta.device.type == "cpu":
        return ref.ssm_scan_ref(delta, B_ssm, C_ssm, x, A)
    if delta.device.type == "cuda":
        return _launch(delta, B_ssm, C_ssm, x, A)
    raise ValueError(f"no ssm_scan kernel for device {delta.device}")
