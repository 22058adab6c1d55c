"""Struct-of-arrays traces and batched per-stream scoring.

* :class:`TraceBatch` — one trace as parallel host columns (offset, size,
  file id, app id, time) plus out-of-band compute gaps
  (``gap_positions[i]`` is the request index gap ``i`` precedes).
* :class:`StreamScores` — per stream: Eq. 1 seek count, random percentage
  ``S/(N-1)``, Eq. 6 sorted seek distance, bytes and an offset checksum.
* :func:`compute_stream_scores` — scores every stream of a trace at once.
  ``backend="kernel"`` (the default) scores the padded stream matrix on
  the program's device: the CUDA kernel on ``cuda``, its plain torch
  version on ``cpu``.  ``backend="numpy"`` is the host oracle.  Both are
  int64 and exact at any offset magnitude, so they agree bit for bit.
  The kernel takes any ``stream_len`` up to
  :data:`~repro_torch.kernels.stream_rf.ops.MAX_STREAM_LEN`; longer
  streams need ``backend="numpy"``.

Streams are blocks of ``stream_len`` requests in arrival order; gaps do not
flush a partial block.  The trailing partial stream is padded into a
score-neutral row (:meth:`TraceBatch.padded_stream_matrix`; where no pad
can be, it is scored on its true length) so that one launch scores every
stream; a fleet's shards stack their matrices so that one launch scores
every shard (``FleetProgram``, ``FleetSimulator``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from .random_factor import DEFAULT_STREAM_LEN, Request, stream_stats_batch_np


@dataclasses.dataclass(frozen=True, slots=True)
class Gap:
    """A compute phase between I/O phases (no foreground I/O)."""

    seconds: float


TraceItem = Request | Gap

_COLUMNS = {
    "offsets": np.int64,
    "sizes": np.int64,
    "file_ids": np.int64,
    "app_ids": np.int64,
    "times": np.float64,
    "gap_positions": np.int64,
    "gap_seconds": np.float64,
}


@dataclasses.dataclass(frozen=True, eq=False)
class TraceBatch:
    """A request trace in struct-of-arrays form (+ out-of-band gaps).

    Gap positions are non-decreasing in ``[0, num_requests]``; several
    gaps may share a position.
    """

    offsets: np.ndarray  # (R,) int64
    sizes: np.ndarray  # (R,) int64
    file_ids: np.ndarray  # (R,) int64
    app_ids: np.ndarray  # (R,) int64
    times: np.ndarray  # (R,) float64
    gap_positions: np.ndarray  # (G,) int64
    gap_seconds: np.ndarray  # (G,) float64

    def __post_init__(self):
        r = self.offsets.shape[0]
        for name in ("sizes", "file_ids", "app_ids", "times"):
            arr = getattr(self, name)
            if arr.shape[0] != r:
                raise ValueError(f"{name} length {arr.shape[0]} != offsets length {r}")
        g = self.gap_positions.shape[0]
        if self.gap_seconds.shape[0] != g:
            raise ValueError("gap_positions / gap_seconds length mismatch")
        if g and (np.any(self.gap_positions < 0) or np.any(self.gap_positions > r)):
            raise ValueError("gap position out of range")

    def validate(self) -> None:
        """Deep per-element invariants (sanitize mode; ``__post_init__``
        only checks shapes).  Raises :class:`ValueError` on the first
        violated one: non-negative sizes/offsets, finite non-negative gap
        durations, non-decreasing gap positions and request times."""

        if self.num_requests:
            if np.any(self.sizes < 0):
                raise ValueError("negative request size in trace")
            if np.any(self.offsets < 0):
                raise ValueError("negative request offset in trace")
            if not np.all(np.isfinite(self.times)):
                raise ValueError("non-finite request time in trace")
        if self.num_gaps:
            if np.any(np.diff(self.gap_positions) < 0):
                raise ValueError("gap_positions must be non-decreasing")
            if not np.all(np.isfinite(self.gap_seconds)):
                raise ValueError("non-finite gap duration in trace")
            if np.any(self.gap_seconds < 0):
                raise ValueError("negative gap duration in trace")

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_numpy(cls, **arrays) -> "TraceBatch":
        """Build from column arrays, e.g. another implementation's trace
        (``offsets``, ``sizes``, ``file_ids``, ``app_ids``; ``times`` and
        the gap columns default to zeros / no gaps).  Columns are copied
        into the canonical dtypes."""

        unknown = set(arrays) - set(_COLUMNS)
        if unknown:
            raise ValueError(f"unknown trace columns {sorted(unknown)}")
        r = np.asarray(arrays["offsets"]).shape[0]
        defaults = {"times": np.zeros(r), "gap_positions": np.zeros(0),
                    "gap_seconds": np.zeros(0)}
        cols = {k: np.array(arrays.get(k, defaults.get(k)), dtype=dt)
                for k, dt in _COLUMNS.items()}
        return cls(**cols)

    @classmethod
    def from_items(cls, items: Iterable[TraceItem]) -> "TraceBatch":
        """Build from a mixed ``Request | Gap`` sequence."""

        offs: list[int] = []
        szs: list[int] = []
        fids: list[int] = []
        aids: list[int] = []
        tms: list[float] = []
        gpos: list[int] = []
        gsec: list[float] = []
        for item in items:
            if isinstance(item, Gap):
                gpos.append(len(offs))
                gsec.append(item.seconds)
                continue
            offs.append(item.offset)
            szs.append(item.size)
            fids.append(item.file_id)
            aids.append(item.app_id)
            tms.append(item.time)
        return cls.from_numpy(offsets=offs, sizes=szs, file_ids=fids,
                              app_ids=aids, times=tms, gap_positions=gpos,
                              gap_seconds=gsec)

    @classmethod
    def from_requests(cls, requests: Sequence[Request]) -> "TraceBatch":
        """Build from a gap-free request sequence (e.g. ``Workload.trace``)."""

        return cls.from_items(requests)

    # -- converters -----------------------------------------------------
    def to_items(self) -> list[TraceItem]:
        """Round-trip back to the simulator's item list (gaps in place)."""

        out: list[TraceItem] = []
        gi = 0
        ng = len(self.gap_positions)
        for i in range(self.num_requests):
            while gi < ng and self.gap_positions[gi] == i:
                out.append(Gap(float(self.gap_seconds[gi])))
                gi += 1
            out.append(
                Request(
                    offset=int(self.offsets[i]),
                    size=int(self.sizes[i]),
                    file_id=int(self.file_ids[i]),
                    app_id=int(self.app_ids[i]),
                    time=float(self.times[i]),
                )
            )
        while gi < ng:
            out.append(Gap(float(self.gap_seconds[gi])))
            gi += 1
        return out

    def to_requests(self) -> list[Request]:
        """Requests only (gap markers dropped)."""

        return [r for r in self.to_items() if isinstance(r, Request)]

    # -- basic queries --------------------------------------------------
    @property
    def num_requests(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def num_gaps(self) -> int:
        return int(self.gap_positions.shape[0])

    @property
    def total_bytes(self) -> int:
        return int(self.sizes.sum())

    @property
    def gap_seconds_total(self) -> float:
        return float(self.gap_seconds.sum())

    def num_streams(self, stream_len: int = DEFAULT_STREAM_LEN) -> int:
        return -(-self.num_requests // stream_len) if self.num_requests else 0

    # -- slicing / sharding --------------------------------------------
    def select(self, indices: np.ndarray) -> "TraceBatch":
        """Sub-trace of the requests at sorted ``indices``.  Gaps are
        replicated into every selection (a compute phase idles the whole
        fleet), with positions remapped to the local indexing."""

        idx = np.asarray(indices, dtype=np.int64)
        if idx.size > 1 and np.any(np.diff(idx) < 0):
            raise ValueError("selection indices must be sorted (arrival order)")
        return TraceBatch(
            offsets=self.offsets[idx],
            sizes=self.sizes[idx],
            file_ids=self.file_ids[idx],
            app_ids=self.app_ids[idx],
            times=self.times[idx],
            gap_positions=np.searchsorted(idx, self.gap_positions, side="left"),
            gap_seconds=self.gap_seconds.copy(),
        )

    def shard(self, assignment: np.ndarray, num_nodes: int) -> list["TraceBatch"]:
        """Split by a per-request node assignment into ``num_nodes`` batches."""

        assignment = np.asarray(assignment)
        if assignment.shape[0] != self.num_requests:
            raise ValueError("assignment length != num_requests")
        if assignment.size and (assignment.min() < 0 or assignment.max() >= num_nodes):
            raise ValueError("node assignment out of range")
        return [
            self.select(np.nonzero(assignment == node)[0])
            for node in range(num_nodes)
        ]

    # -- stream view ----------------------------------------------------
    def stream_bounds(self, stream_len: int = DEFAULT_STREAM_LEN) -> np.ndarray:
        """``bounds[s] .. bounds[s+1]`` is stream ``s`` (full blocks, then
        the trailing partial)."""

        r = self.num_requests
        if r == 0:
            return np.zeros(1, dtype=np.int64)
        return np.append(np.arange(0, r, stream_len, dtype=np.int64), r)

    def stream_sums(
        self, stream_len: int = DEFAULT_STREAM_LEN
    ) -> tuple[np.ndarray, np.ndarray]:
        """Per-stream ``(nbytes, offset_sum)``."""

        starts = self.stream_bounds(stream_len)[:-1]
        if not len(starts):
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy()
        return (
            np.add.reduceat(self.sizes, starts),
            np.add.reduceat(self.offsets, starts),
        )

    def stream_matrix(
        self, stream_len: int = DEFAULT_STREAM_LEN
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """``(offsets (M, L), sizes (M, L), tail_offsets, tail_sizes)``:
        the M full streams, then the (possibly empty) trailing partial."""

        m = self.num_requests // stream_len
        full = m * stream_len
        return (
            self.offsets[:full].reshape(m, stream_len),
            self.sizes[:full].reshape(m, stream_len),
            self.offsets[full:],
            self.sizes[full:],
        )

    def padded_stream_matrix(
        self, stream_len: int = DEFAULT_STREAM_LEN
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(offsets (S, L), sizes (S, L), true_lens (S,))``: every stream
        as a row, the trailing partial padded to ``stream_len``.

        The padding is score-neutral: zero-size requests placed at the
        sorted-last real request's end.  Sorted (ties in arrival order),
        they land after every real request, the (last, pad) residual is 0
        and so are the pad-pad residuals: no seek and no distance is added.
        Only the percentage's denominator (``true_lens - 1``) needs the
        true length.  Where that end lies past INT64_MAX, no offset can
        hold it: the pad then sits at INT64_MAX and only scoring on the
        true length is exact.
        """

        rows = -(-self.num_requests // stream_len)
        offs = np.empty((rows, stream_len), dtype=np.int64)
        szs = np.empty((rows, stream_len), dtype=np.int64)
        return offs, szs, self._fill_padded_streams(stream_len, offs, szs)[0]

    def _fill_padded_streams(self, stream_len: int, offs: np.ndarray,
                             szs: np.ndarray) -> tuple[np.ndarray, bool]:
        """Write :meth:`padded_stream_matrix`'s rows into ``offs`` and
        ``szs`` (each ``(S, stream_len)``, e.g. slices of a larger matrix);
        returns the true lengths and whether the pad is score-neutral."""

        m, t = divmod(self.num_requests, stream_len)
        full = m * stream_len
        offs[:m] = self.offsets[:full].reshape(m, stream_len)
        szs[:m] = self.sizes[:full].reshape(m, stream_len)
        lens = np.full(m + (t > 0), stream_len, dtype=np.int64)
        neutral = True
        if t:
            tail_offs, tail_szs = self.offsets[full:], self.sizes[full:]
            # sorted-last real request = LAST occurrence of the max offset
            j = t - 1 - int(np.argmax(tail_offs[::-1]))
            offs[m, :t], szs[m, :t] = tail_offs, tail_szs
            end = int(tail_offs[j]) + int(tail_szs[j])
            neutral = end <= np.iinfo(np.int64).max
            offs[m, t:] = np.int64(min(end, np.iinfo(np.int64).max))
            szs[m, t:] = 0
            lens[m] = t
        return lens, neutral


@dataclasses.dataclass(frozen=True, eq=False)
class StreamScores:
    """Per-stream statistics in stream order (full blocks, then the
    trailing partial)."""

    rf_sum: np.ndarray  # (S,) int64
    percentage: np.ndarray  # (S,) float64
    seek_distance: np.ndarray  # (S,) int64
    nbytes: np.ndarray  # (S,) int64
    offset_sum: np.ndarray  # (S,) int64
    stream_len: int
    backend: str

    def __len__(self) -> int:
        return int(self.rf_sum.shape[0])

    def validate(self) -> None:
        """Deep per-element invariants (sanitize mode): every score row
        in range — random percentage in [0, 1], non-negative seek sums,
        byte counts and distances.  Raises :class:`ValueError`."""

        n = len(self)
        for name in ("percentage", "seek_distance", "nbytes", "offset_sum"):
            if getattr(self, name).shape[0] != n:
                raise ValueError(f"{name} length != rf_sum length {n}")
        if n == 0:
            return
        if np.any(self.rf_sum < 0) or np.any(self.seek_distance < 0):
            raise ValueError("negative seek score")
        if np.any(self.nbytes < 0):
            raise ValueError("negative stream byte count")
        if np.any((self.percentage < 0.0) | (self.percentage > 1.0)):
            raise ValueError("random percentage outside [0, 1]")


SCORE_BACKENDS = ("numpy", "kernel")


def _score_numpy(batch: TraceBatch, stream_len: int):
    offs2d, szs2d, tail_offs, tail_szs = batch.stream_matrix(stream_len)
    rf, pct, dist = stream_stats_batch_np(offs2d, szs2d)
    if tail_offs.size:
        trf, tpct, tdist = stream_stats_batch_np(tail_offs[None, :],
                                                 tail_szs[None, :])
        rf = np.concatenate([rf, trf])
        pct = np.concatenate([pct, tpct])
        dist = np.concatenate([dist, tdist])
    return rf, pct, dist


def _score_shards_kernel(
    batches: Sequence[TraceBatch], stream_len: int, device: torch.device
) -> list[StreamScores]:
    """Score every stream of several traces (a fleet's shards) in one
    kernel launch: their padded stream matrices are stacked into one
    ``(sum S, stream_len)`` matrix, copied to ``device`` once, scored, and
    read back once.  Rows are independent and the padding is
    score-neutral, so each trace's scores equal scoring it alone.  Where a
    pad cannot be (a trailing stream ending past INT64_MAX), the launch
    also takes every row's true length, and the kernel leaves the
    positions past it out; the kernel's instance for true lengths is the
    slower one, so the common case does without."""

    from ..kernels.stream_rf.ops import stream_stats_op

    rows = np.cumsum([0] + [-(-b.num_requests // stream_len) for b in batches])
    both = np.empty((2, rows[-1], stream_len), dtype=np.int64)  # offsets, sizes
    filled = [b._fill_padded_streams(stream_len, both[0, lo:hi], both[1, lo:hi])
              for b, lo, hi in zip(batches, rows[:-1], rows[1:])]
    lens = [f[0] for f in filled]
    rf = np.zeros(0, dtype=np.int64)
    dist = rf
    if rows[-1]:
        both = tracing.to_device(torch.from_numpy(both), device)  # one copy
        true_lens = None
        if not all(f[1] for f in filled):
            true_lens = tracing.to_device(torch.from_numpy(np.concatenate(lens)), device)
        rf_d, _, dist_d = stream_stats_op(both[0], both[1], true_lens)
        rf, dist = tracing.to_host(torch.stack([rf_d, dist_d])).numpy()  # one readback
    out = []
    for b, n, lo, hi in zip(batches, lens, rows[:-1], rows[1:]):
        nbytes, osum = b.stream_sums(stream_len)
        # the true length divides on the host in float64, as the oracle does
        pct = rf[lo:hi] / np.maximum(n - 1, 1)
        out.append(_stream_scores(rf[lo:hi], pct, dist[lo:hi], nbytes, osum,
                                  stream_len, "kernel"))
    return out


def _stream_scores(rf, pct, dist, nbytes, osum, stream_len: int,
                   backend: str) -> StreamScores:
    return StreamScores(
        rf_sum=np.asarray(rf, dtype=np.int64),
        percentage=np.asarray(pct, dtype=np.float64),
        seek_distance=np.asarray(dist, dtype=np.int64),
        nbytes=np.asarray(nbytes, dtype=np.int64),
        offset_sum=np.asarray(osum, dtype=np.int64),
        stream_len=stream_len,
        backend=backend,
    )


def compute_stream_scores(
    trace: "TraceBatch | Sequence[TraceItem]",
    stream_len: int = DEFAULT_STREAM_LEN,
    backend: str = "kernel",
    device: "torch.device | str | None" = None,
) -> StreamScores:
    """Score every stream of a trace in one pass.

    ``backend="kernel"`` scores on ``device`` (``None``: the CUDA card;
    raises without one), launching the CUDA kernel there or running its
    plain torch version on ``"cpu"``; ``stream_len`` may be anything up to
    the kernel's limit (8192).  ``backend="numpy"`` is the host oracle,
    takes any ``stream_len`` and ignores ``device``.
    Both are bit-exact against the scalar definitions.
    """

    if backend not in SCORE_BACKENDS:
        raise ValueError(f"backend must be one of {SCORE_BACKENDS}, got {backend!r}")
    batch = trace if isinstance(trace, TraceBatch) else TraceBatch.from_items(trace)
    if backend == "kernel":
        return _score_shards_kernel([batch], stream_len, resolve_device(device))[0]
    nbytes, osum = batch.stream_sums(stream_len)
    rf, pct, dist = _score_numpy(batch, stream_len)
    return _stream_scores(rf, pct, dist, nbytes, osum, stream_len, backend)
