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
The scalar scorers (:func:`random_factor_sum`, :class:`StreamGrouper`,
:func:`sorted_seek_distance`, ...) are the host control plane's and the
per-request replay engine's; :func:`random_factor_batch` and its siblings
are the torch batch scorers.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence

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


def random_factor_sum(
    offsets: Sequence[int] | np.ndarray,
    sizes: Sequence[int] | np.ndarray | int,
) -> int:
    """Total random factor ``S`` of one stream (paper Eq. 1).

    ``sizes`` may be a scalar (uniform request size, the common IOR case) or a
    per-request array.  Offsets are sorted first — the paper sorts each
    128-request block exactly like the CFQ elevator would, and only then
    counts seeks; adjacent-after-sort contiguity is what matters, not arrival
    order (Fig. 4).
    """

    offs = np.asarray(offsets, dtype=np.int64)
    if offs.size <= 1:
        return 0
    szs = np.broadcast_to(np.asarray(sizes, dtype=np.int64), offs.shape)
    order = np.argsort(offs, kind="stable")
    so = offs[order]
    ss = szs[order]
    gaps = so[1:] - so[:-1]
    return int(np.sum(gaps != ss[:-1]))


def random_percentage(
    offsets: Sequence[int] | np.ndarray,
    sizes: Sequence[int] | np.ndarray | int,
) -> float:
    """``S / (N - 1)`` — the stream's level of randomness in [0, 1]."""

    offs = np.asarray(offsets, dtype=np.int64)
    n = offs.size
    if n <= 1:
        return 0.0
    return random_factor_sum(offs, sizes) / (n - 1)


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
    offsets: torch.Tensor, sizes: torch.Tensor,
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch scoring: ``(M, N)`` int64 -> ``(rf int64, percentage
    float64, seek_distance int64)`` on the inputs' device.

    Bit-equal to :func:`stream_stats_batch_np`: int64 residuals, a stable
    sort, and an int64 distance sum that wraps exactly as NumPy's does.
    ``lengths`` (``(M,)`` int64) scores row ``i``'s first ``lengths[i]``
    requests only: the rest sort last, as ``INT64_MAX`` behind every real
    offset (a real ``INT64_MAX`` stays before them, the sort being stable),
    and their residuals are dropped.
    """

    offs = offsets.to(torch.int64)
    szs = sizes.to(torch.int64).expand_as(offs)
    m, n = offs.shape
    if n <= 1:
        z = torch.zeros(m, dtype=torch.int64, device=offs.device)
        return z, z.to(torch.float64), z.clone()
    if lengths is None:
        so, order = torch.sort(offs, dim=-1, stable=True)
        ss = torch.gather(szs, -1, order)
        resid = so[:, 1:] - so[:, :-1] - ss[:, :-1]
        denom = n - 1
    else:
        lens = lengths.to(torch.int64).clamp(0, n)
        pos = torch.arange(n, device=offs.device)
        key = torch.where(pos >= lens[:, None], torch.iinfo(torch.int64).max, offs)
        so, order = torch.sort(key, dim=-1, stable=True)
        ss = torch.gather(szs, -1, order)
        resid = so[:, 1:] - so[:, :-1] - ss[:, :-1]
        resid = torch.where(pos[:-1] < (lens - 1)[:, None], resid, 0)
        denom = torch.clamp(lens - 1, min=1)
    rf = torch.count_nonzero(resid, dim=-1).to(torch.int64)
    pct = rf.to(torch.float64) / denom
    dist = resid.abs().sum(dim=-1)
    return rf, pct, dist


def random_factor_batch(offsets, sizes) -> torch.Tensor:
    """Batched Eq. 1 seek count: ``(M, N) -> (M,)`` int64 on the inputs'
    device (the counterpart of the reference's jnp scorer, exact in int64
    where that one counts in int32)."""

    offs = torch.as_tensor(offsets)
    return stream_stats_batch(offs, torch.as_tensor(sizes, device=offs.device))[0]


def random_percentage_batch(offsets, sizes) -> torch.Tensor:
    """Batched ``S / (N - 1)``: ``(M, N) -> (M,)`` float64 (0 for N <= 1)."""

    offs = torch.as_tensor(offsets)
    return stream_stats_batch(offs, torch.as_tensor(sizes, device=offs.device))[1]


def seek_distance_batch(offsets, sizes) -> torch.Tensor:
    """Batched Eq. 6 sorted seek distance: ``(M, N) -> (M,)`` int64, the
    same definition as :func:`sorted_seek_distance`."""

    offs = torch.as_tensor(offsets)
    return stream_stats_batch(offs, torch.as_tensor(sizes, device=offs.device))[2]


class StreamGrouper:
    """Groups an arriving request sequence into fixed-length streams.

    The paper's server groups requests in arrival order into blocks of
    ``stream_len`` (Section 2.1: "SSDUP+ groups the requests into blocks...
    also called a request stream").  A trailing partial stream can be flushed
    explicitly at end-of-trace.
    """

    def __init__(self, stream_len: int = DEFAULT_STREAM_LEN):
        if stream_len < 2:
            raise ValueError(f"stream_len must be >= 2, got {stream_len}")
        self.stream_len = stream_len
        self._pending: list[Request] = []
        self.streams_emitted = 0

    def push(self, req: Request) -> list[Request] | None:
        """Add one request; returns a full stream when one completes."""

        self._pending.append(req)
        if len(self._pending) >= self.stream_len:
            stream, self._pending = self._pending, []
            self.streams_emitted += 1
            return stream
        return None

    def push_many(self, reqs: Iterable[Request]) -> Iterator[list[Request]]:
        for r in reqs:
            out = self.push(r)
            if out is not None:
                yield out

    def flush(self) -> list[Request] | None:
        """Emit the trailing partial stream (end of trace / app barrier)."""

        if not self._pending:
            return None
        stream, self._pending = self._pending, []
        self.streams_emitted += 1
        return stream

    @property
    def pending(self) -> int:
        return len(self._pending)


def stream_percentage(stream: Sequence[Request]) -> float:
    """Random percentage of a list of :class:`Request`."""

    if len(stream) <= 1:
        return 0.0
    offs = np.fromiter((r.offset for r in stream), dtype=np.int64, count=len(stream))
    szs = np.fromiter((r.size for r in stream), dtype=np.int64, count=len(stream))
    return random_percentage(offs, szs)


def seek_distance_np(
    offsets: Sequence[int] | np.ndarray, sizes: Sequence[int] | np.ndarray
) -> int:
    """Sorted seek distance of one stream given as plain arrays (int64,
    exact) — the array-native form of :func:`sorted_seek_distance`, used
    by the batched replay engine for overflow subsets that have no
    precomputed score."""

    offs = np.asarray(offsets, dtype=np.int64)
    if offs.size <= 1:
        return 0
    szs = np.asarray(sizes, dtype=np.int64)
    order = np.argsort(offs, kind="stable")
    so, ss = offs[order], szs[order]
    gaps = so[1:] - so[:-1] - ss[:-1]
    return int(np.abs(gaps[gaps != 0]).sum())


def sorted_seek_distance(stream: Sequence[Request]) -> int:
    """Total logical seek distance after sorting (used by the HDD model).

    The paper argues seek time is roughly linear in logical-offset distance
    (Section 2.2, citing FS2); the device model consumes this aggregate.
    """

    if len(stream) <= 1:
        return 0
    offs = np.fromiter((r.offset for r in stream), dtype=np.int64, count=len(stream))
    szs = np.fromiter((r.size for r in stream), dtype=np.int64, count=len(stream))
    return seek_distance_np(offs, szs)
