"""Plain torch version of the ``ssm_scan`` kernel (Mamba-1 selective scan).

    a_t = exp(delta_t ⊗ A)                    (B, DI, N)
    h_t = a_t * h_{t-1} + delta_t * B_t * x_t
    y_t = <h_t, C_t>                           (B, DI)

A loop over time in f32: slow, and exact for every shape the kernel takes.
"""

from __future__ import annotations

import torch


def ssm_scan_ref(delta, B_ssm, C_ssm, x, A, h0=None):
    """delta: (B,S,DI) f32; B/C: (B,S,N) f32; x: (B,S,DI); A: (DI,N) f32.
    Returns (y (B,S,DI) in x.dtype, h_last (B,DI,N) f32)."""

    b, s, di = delta.shape
    n = B_ssm.shape[-1]
    h = (torch.zeros(b, di, n, dtype=torch.float32, device=delta.device)
         if h0 is None else h0.float())
    A = A.float()
    ys = []
    for t in range(s):
        d = delta[:, t].float()
        a = torch.exp(d[..., None] * A[None])
        bx = d[..., None] * B_ssm[:, t, None, :].float() * x[:, t].float()[..., None]
        h = a * h + bx
        ys.append(torch.einsum("bdn,bn->bd", h, C_ssm[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), h
