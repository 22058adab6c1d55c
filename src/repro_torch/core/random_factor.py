"""Random-factor traffic detection (SSDUP+ paper, Section 2.2).

Group write requests into *request streams* of ``stream_len`` (128, the CFQ
queue depth), sort each stream by logical offset, and count the
sorted-adjacent pairs that are not contiguous (each costs one seek):

    resid_i = sorted_offset[i+1] - sorted_offset[i] - size[i]
    S       = #(resid_i != 0)                 (Eq. 1)
    dist    = sum_i |resid_i|                 (Eq. 6 seek distance)
    random_percentage = S / (N - 1)

Two implementations of the batched statistics live here, both int64 and
exact at any offset magnitude:

* :func:`stream_stats_batch_np` — the NumPy host oracle;
* :func:`stream_stats_batch` — the same arithmetic in torch on any device
  (``torch.sort(stable=True)``), the plain version the CUDA kernel in
  :mod:`repro_torch.kernels.stream_rf` is held against.

Both break offset ties by arrival order (stable sort), so rows with equal
offsets of differing sizes score identically in every implementation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_STREAM_LEN = 128  # paper: CFQ queue size, Section 2.3.1


@dataclasses.dataclass(frozen=True, slots=True)
class Request:
    """One write request's metadata, as traced by the I/O-node server."""

    offset: int
    size: int
    file_id: int = 0
    app_id: int = 0
    time: float = 0.0

    @property
    def end(self) -> int:
        return self.offset + self.size


def stream_stats_batch_np(offsets, sizes):
    """Vectorized host-side scoring of many streams at once (int64, exact).

    ``(M, N)`` -> ``(rf_sum int64, percentage float64, seek_distance
    int64)``, each ``(M,)``.
    """

    offs = np.asarray(offsets, dtype=np.int64)
    szs = np.broadcast_to(np.asarray(sizes, dtype=np.int64), offs.shape)
    m, n = offs.shape
    if n <= 1:
        z = np.zeros(m, dtype=np.int64)
        return z, np.zeros(m, dtype=np.float64), z.copy()
    order = np.argsort(offs, axis=-1, kind="stable")
    so = np.take_along_axis(offs, order, axis=-1)
    ss = np.take_along_axis(szs, order, axis=-1)
    resid = so[:, 1:] - so[:, :-1] - ss[:, :-1]
    rf = np.count_nonzero(resid, axis=-1).astype(np.int64)
    pct = rf / (n - 1)
    dist = np.abs(resid).sum(axis=-1)
    return rf, pct, dist


def stream_stats_batch(
    offsets: torch.Tensor, sizes: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch scoring: ``(M, N)`` int64 -> ``(rf int64, percentage
    float64, seek_distance int64)`` on the inputs' device.

    Bit-equal to :func:`stream_stats_batch_np`: int64 residuals, a stable
    sort, and an int64 distance sum that wraps exactly as NumPy's does.
    """

    offs = offsets.to(torch.int64)
    szs = sizes.to(torch.int64).expand_as(offs)
    m, n = offs.shape
    if n <= 1:
        z = torch.zeros(m, dtype=torch.int64, device=offs.device)
        return z, z.to(torch.float64), z.clone()
    so, order = torch.sort(offs, dim=-1, stable=True)
    ss = torch.gather(szs, -1, order)
    resid = so[:, 1:] - so[:, :-1] - ss[:, :-1]
    rf = torch.count_nonzero(resid, dim=-1).to(torch.int64)
    pct = rf.to(torch.float64) / (n - 1)
    dist = resid.abs().sum(dim=-1)
    return rf, pct, dist
