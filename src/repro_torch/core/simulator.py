"""Event-level I/O-node simulator (the port's copy of the reference's).

Replays a request trace against one I/O node under four schemes:

* ``orangefs``     — no buffer; every stream goes to the HDD (CFQ-sorted).
* ``orangefs-bb``  — plain burst buffer: ALL data to the SSD; when the SSD is
                     full, incoming data goes straight to HDD while the SSD
                     flushes (the paper's OrangeFS-BB).
* ``ssdup``        — SSDUP (ICS'17): static watermark thresholds (45/30),
                     two-region pipeline, IMMEDIATE flushing.
* ``ssdup+``       — SSDUP+: adaptive threshold + traffic-aware flushing.

Timing model:

* Every foreground stream is bounded by BOTH the network ingest link
  (GbE ≈ 110 MB/s per node on the paper's testbed) and the device:
  ``wall = max(net_time, device_time)``.
* HDD device time = CFQ-sorted seeks × seek_time + sweep distance × coeff
  + bytes / seq_bw  (see ``device_model`` calibration notes).
* Flushes are charged per the paper's Eq. 6: a flush job of ``bytes``
  with ``seeks`` residual (post-sort) head movements drains in
  ``seeks × seek_time + bytes / seq_bw`` of exclusive HDD time — the
  seek cost is amortized into :meth:`FlushJob.effective_rate` so EVERY
  drain path pays it: foreground-overlapped flushing, the
  interference-shared path, compute gaps, the blocked-writer drain, and
  the end-of-trace drain.
* The background flusher shares the HDD with foreground HDD writes through
  :class:`InterferenceModel` (fair share + inflation phi, paper Eq. 7); it
  runs at the job's effective rate while the foreground is on the SSD or
  during compute gaps.
* A ``Gap`` item models a compute phase (paper Fig. 14): only the flusher
  runs, continuing through the flush backlog until the gap budget or the
  backlog is exhausted.

Three replay engines; the two host engines produce bit-identical
:class:`SimResult`\\ s:

* ``engine="batched"`` (default) — routes and accounts WHOLE streams
  against precomputed :class:`repro_torch.core.trace.StreamScores`; SSD-bound
  streams are appended via :meth:`LogRegion.append_batch` and timed in
  vectorized runs that only drop to Python at state boundaries (region
  swap, writer block, flush-job completion).  No per-request Python in
  the hot path.
* ``engine="per-request"`` — the request-at-a-time loop, kept as the
  oracle.
* ``engine="device"`` — the torch transition of
  :mod:`repro_torch.core.engine_device` on the simulator's ``device``,
  within ``DEVICE_TOLERANCES`` of the other two.

The host engines' accounting stays NumPy on purpose: their bit-identity
rests on ``np.add.accumulate``'s strictly sequential order and on flush
quanta truncated per request, which torch's ``cumsum`` does not promise.
Scoring (``score_backend="kernel"``, the default) runs the CUDA stream
kernel on ``device`` (``None``: the card; ``"cpu"``: its plain version);
``score_backend="numpy"`` is the host oracle.  Both give the same scores.

Vectorized accounting preserves bit-exactness by construction: per-request
walls are elementwise IEEE ops, clock accumulation uses the strictly
sequential ``np.add.accumulate`` (not pairwise ``np.sum``), and flush
quanta truncate per request exactly like the scalar ``int(rate * wall)``.

Accounting matches the paper's measurements: reported throughput uses the
**application-visible I/O time** (``io_seconds``: last foreground byte
absorbed, compute gaps excluded); the final background drain is tracked
separately in ``total_seconds`` (the paper's burst buffer likewise hides the
final flush in the next compute phase).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

import numpy as np

from ..analysis import sanitize as _sanitize
from ..device import resolve_device
from .adaptive import AdaptiveThreshold, StaticWatermarkThreshold
from .device_model import (
    HDDModel,
    IngestLink,
    InterferenceModel,
    SSDModel,
    StorageModel,
    clone_storage,
    make_storage_model,
)
from .log_store import LogRegion
from .pipeline import SingleRegionBuffer, TwoRegionPipeline
from .random_factor import (
    DEFAULT_STREAM_LEN,
    Request,
    StreamGrouper,
    random_factor_sum,
    seek_distance_np,
    sorted_seek_distance,
    stream_percentage,
    stream_stats_batch_np,
)
from .redirector import DataRedirector, Device
from .trace import (
    SCORE_BACKENDS,
    Gap,
    StreamScores,
    TraceBatch,
    TraceItem,
    compute_stream_scores,
)

ENGINES = ("batched", "per-request", "device")


def _seq_add(start: float, values: np.ndarray) -> float:
    """Left-to-right float accumulation — bit-identical to looping
    ``start += v`` (``np.add.accumulate`` is strictly sequential, unlike
    ``np.sum``'s pairwise reduction)."""

    n = len(values)
    if n == 0:
        return start
    arr = np.empty(n + 1, dtype=np.float64)
    arr[0] = start
    arr[1:] = values
    return float(np.add.accumulate(arr)[-1])


@dataclasses.dataclass
class SimResult:
    scheme: str
    io_seconds: float  # application-visible I/O time (gaps excluded)
    total_seconds: float  # includes compute gaps and the final drain
    total_bytes: int
    bytes_to_ssd: int
    bytes_to_hdd_direct: int
    flushes: int
    flush_paused_seconds: float
    blocked_seconds: float
    peak_ssd_occupancy: int
    metadata_bytes: int
    per_app_bytes: dict[int, int]

    @property
    def throughput_mbs(self) -> float:
        return self.total_bytes / self.io_seconds / 1e6 if self.io_seconds else 0.0

    @property
    def ssd_byte_ratio(self) -> float:
        return self.bytes_to_ssd / self.total_bytes if self.total_bytes else 0.0

    def app_throughput_mbs(self, app_id: int) -> float:
        if not self.io_seconds:  # gap-only / empty traces: no I/O time
            return 0.0
        return self.per_app_bytes.get(app_id, 0) / self.io_seconds / 1e6


@dataclasses.dataclass
class _ReplayState:
    """Mutable per-run accounting shared by both engines."""

    clock: float = 0.0
    gap_seconds: float = 0.0
    bytes_ssd: int = 0
    bytes_hdd: int = 0
    blocked_seconds: float = 0.0
    peak_ssd: int = 0
    per_app: dict[int, int] = dataclasses.field(default_factory=dict)


class IONodeSimulator:
    """One I/O node running one of the four schemes.

    ``device=None`` scores (and, with ``engine="device"``, replays) on the
    CUDA card and raises without one; pass ``device="cpu"`` to run on the
    CPU.  ``score_backend`` is ``"kernel"`` (default) or ``"numpy"``.
    """

    def __init__(
        self,
        scheme: str = "ssdup+",
        ssd_capacity: int = 8 << 30,
        hdd: HDDModel | None = None,
        ssd: StorageModel | str | None = None,
        link: IngestLink | None = None,
        interference: InterferenceModel | None = None,
        stream_len: int = DEFAULT_STREAM_LEN,
        flush_gate: float | str = 0.5,
        adaptive_window: int | None = 64,
        index_backend: str = "numpy",
        engine: str = "batched",
        threshold_warmup: Sequence[float] | None = None,
        sanitize: bool | None = None,
        score_backend: str = "kernel",
        device=None,
    ):
        if scheme not in ("orangefs", "orangefs-bb", "ssdup", "ssdup+"):
            raise ValueError(f"unknown scheme {scheme}")
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        if threshold_warmup is not None and scheme not in ("ssdup", "ssdup+"):
            raise ValueError(
                "threshold_warmup requires a threshold scheme "
                f"(ssdup/ssdup+), got {scheme!r}"
            )
        if isinstance(flush_gate, str) and flush_gate != "device":
            raise ValueError(
                f"flush_gate must be a float or 'device', got {flush_gate!r}"
            )
        if score_backend not in SCORE_BACKENDS:
            raise ValueError(
                f"score_backend must be one of {SCORE_BACKENDS}, "
                f"got {score_backend!r}"
            )
        self.device = resolve_device(device)
        self.score_backend = score_backend
        self.scheme = scheme
        self.engine = engine
        # runtime invariant checks: True/False pins the instance, None
        # defers to REPRO_SANITIZE / the sanitizing() override
        self.sanitize = _sanitize.resolve(sanitize)
        self.hdd = hdd or HDDModel()
        # pluggable storage backend: "constant" (stateless, the default)
        # or "ftl" (page-mapped, GC + write amplification) or an instance
        self.ssd = make_storage_model(ssd, logical_bytes=ssd_capacity)
        self.ssd_stateful = bool(getattr(self.ssd, "stateful", False))
        # stateful models cap the flusher's SSD-read side and receive
        # trim() calls; None keeps the constant path bit-exact
        self._flush_storage: StorageModel | None = (
            self.ssd if self.ssd_stateful else None
        )
        self._fg_ssd = False  # foreground device of the running stream
        self.link = link or IngestLink()
        self.interference = interference or InterferenceModel()
        self.stream_len = stream_len
        self.ssd_capacity = ssd_capacity
        # kept for the device engine, which rebuilds its lane state from
        # these instead of the host pipeline/redirector objects below
        self.flush_gate = flush_gate
        self.adaptive_window = adaptive_window
        self.threshold_warmup = (
            None if threshold_warmup is None else list(threshold_warmup)
        )

        self._last_pct = 0.0
        self._session: _ReplayState | None = None
        if scheme == "ssdup+":
            policy = AdaptiveThreshold(window=adaptive_window)
            self.pipeline = TwoRegionPipeline(
                ssd_capacity // 2, traffic_aware=True, flush_gate=flush_gate,
                percentage_source=lambda: self._last_pct,
                index_backend=index_backend,
                storage=self._flush_storage,
                fg_ssd_source=lambda: self._fg_ssd,
            )
            self.redirector: DataRedirector | None = DataRedirector(policy, stream_len)
        elif scheme == "ssdup":
            policy = StaticWatermarkThreshold()
            self.pipeline = TwoRegionPipeline(
                ssd_capacity // 2, traffic_aware=False,
                percentage_source=lambda: self._last_pct,
                index_backend=index_backend,
                storage=self._flush_storage,
            )
            self.redirector = DataRedirector(policy, stream_len)
        elif scheme == "orangefs-bb":
            self.pipeline = SingleRegionBuffer(
                ssd_capacity,
                percentage_source=lambda: self._last_pct,
                index_backend=index_backend,
                storage=self._flush_storage,
            )
            self.redirector = None
        else:  # orangefs
            self.pipeline = None  # type: ignore[assignment]
            self.redirector = None

        if threshold_warmup is not None and self.redirector is not None:
            # warm detector history (e.g. fleet-scope PercentList) — seeded
            # before replay so the first stream already sees an adapted
            # threshold instead of the cold default
            self.redirector.policy.seed(threshold_warmup)

    # -- shared timing primitives (both engines) -----------------------
    def _advance_fg(
        self, st: _ReplayState, device_dt: float, nbytes: int,
        hdd_foreground: bool,
    ) -> None:
        """One foreground operation: device time ``device_dt`` alone,
        network-capped, with the background flush sharing the HDD."""

        self._fg_ssd = not hdd_foreground  # flush-gate v2 device signal
        flushing = (
            self.pipeline is not None and self.pipeline.flush_job is not None
        )
        allowed = flushing and self.pipeline.flush_allowed()
        net_dt = self.link.time(nbytes)
        if not flushing or not allowed:
            wall = max(net_dt, device_dt)
            if flushing:
                self.pipeline.note_pause(wall)
            st.clock += wall
            return
        job = self.pipeline.flush_job
        if hdd_foreground:
            disk_dt = device_dt * self.interference.foreground_slowdown()
            wall = max(net_dt, disk_dt)
            rate = (
                job.effective_rate(self.hdd, self._flush_storage)
                * self.interference.flush_rate_fraction()
            )
        else:
            wall = max(net_dt, device_dt)
            rate = job.effective_rate(self.hdd, self._flush_storage)
        self.pipeline.flush_progress(int(rate * wall))
        st.clock += wall

    def _drain_current_flush(self, st: _ReplayState) -> float:
        """Block the writer until the active flush finishes (Eq. 6 rate)."""

        if self.pipeline is None or self.pipeline.flush_job is None:
            raise RuntimeError("no active flush job to drain")
        self.pipeline.force_flush()
        job = self.pipeline.flush_job
        dt = job.bytes_left / job.effective_rate(self.hdd, self._flush_storage)
        self.pipeline.flush_progress(job.bytes_left)
        st.clock += dt
        return dt

    def _gap(self, st: _ReplayState, seconds: float) -> None:
        """Compute phase: the flusher gets the HDD to itself and keeps
        draining through the backlog until the gap budget runs out."""

        if self.sanitize:
            _sanitize.check(
                seconds >= 0.0 and np.isfinite(seconds),
                "compute gap must be a finite non-negative duration, got %r",
                seconds,
            )
        if self.pipeline is not None:
            budget = seconds
            while budget > 0 and self.pipeline.flush_job is not None:
                job = self.pipeline.flush_job
                rate = job.effective_rate(self.hdd, self._flush_storage)
                need = job.bytes_left / rate
                if need <= budget:
                    self.pipeline.flush_progress(job.bytes_left)
                    budget -= need
                else:
                    self.pipeline.flush_progress(int(rate * budget))
                    break
        st.clock += seconds
        st.gap_seconds += seconds

    def _finalize(self, st: _ReplayState, drain: bool = True) -> SimResult:
        io_seconds = st.clock - st.gap_seconds  # application-visible I/O time

        # -- drain: flush whatever is still buffered (overlaps the NEXT
        #    compute phase in a real deployment; excluded from io_seconds).
        #    ``drain=False`` models a crashed node: buffered bytes stay in
        #    the pipeline for the caller to salvage (or count as stranded).
        if drain and self.pipeline is not None:
            self.pipeline.drain()
            while self.pipeline.flush_job is not None:
                job = self.pipeline.flush_job
                st.clock += job.bytes_left / job.effective_rate(
                    self.hdd, self._flush_storage
                )
                self.pipeline.flush_progress(job.bytes_left)

        total_bytes = st.bytes_ssd + st.bytes_hdd
        if self.sanitize:
            self._sanitize_final(st, io_seconds, drain)
        return SimResult(
            scheme=self.scheme,
            io_seconds=io_seconds,
            total_seconds=st.clock,
            total_bytes=total_bytes,
            bytes_to_ssd=st.bytes_ssd,
            bytes_to_hdd_direct=st.bytes_hdd,
            flushes=self.pipeline.flushes_completed if self.pipeline else 0,
            flush_paused_seconds=(
                self.pipeline.total_paused_seconds if self.pipeline else 0.0
            ),
            blocked_seconds=st.blocked_seconds,
            peak_ssd_occupancy=st.peak_ssd,
            metadata_bytes=self.pipeline.metadata_bytes if self.pipeline else 0,
            per_app_bytes=st.per_app,
        )

    def _sanitize_final(
        self, st: _ReplayState, io_seconds: float, drained: bool
    ) -> None:
        """End-of-replay invariants (sanitize mode): finite monotone
        clocks, non-negative byte ledgers that close against the per-app
        split, and — after a drain — an empty pipeline."""

        _sanitize.check(
            np.isfinite(st.clock) and st.clock >= 0.0,
            "total_seconds non-finite or negative: %r", st.clock,
        )
        _sanitize.check(
            np.isfinite(io_seconds) and 0.0 <= io_seconds <= st.clock,
            "io_seconds %r outside [0, total_seconds=%r]",
            io_seconds, st.clock,
        )
        _sanitize.check(
            st.bytes_ssd >= 0 and st.bytes_hdd >= 0,
            "negative byte ledger (ssd=%d, hdd=%d)",
            st.bytes_ssd, st.bytes_hdd,
        )
        total = st.bytes_ssd + st.bytes_hdd
        per_app = sum(st.per_app.values())
        _sanitize.check(
            total == per_app,
            "byte ledger does not close: ssd+hdd=%d but per-app sum=%d",
            total, per_app,
        )
        if self.pipeline is not None:
            _sanitize.check(
                self.pipeline.total_flushed_bytes <= st.bytes_ssd,
                "flushed %d B from an SSD that only absorbed %d B",
                self.pipeline.total_flushed_bytes, st.bytes_ssd,
            )
            if drained:
                _sanitize.check(
                    self.pipeline.flush_job is None,
                    "drain left an active flush job",
                )
                left = sum(r.used_bytes for r in self.pipeline.regions)
                _sanitize.check(
                    left == 0, "drain left %d B buffered on the SSD", left
                )
        if self.ssd_stateful:
            check_fn = getattr(self.ssd, "sanitize_check", None)
            if check_fn is not None:
                check_fn()  # FTL page/byte conservation ledgers

    # -- online session API (for the service layer) ---------------------
    #
    # The offline engines replay a COMPLETE trace; the service layer
    # instead streams scored windows into the simulator as clients
    # arrive.  A session is the exact same state machine as
    # ``_run_batched`` — same _ReplayState, same _replay_stream, same
    # scoring math — just driven one window at a time, so a no-fault
    # session replaying the same windows in the same order produces a
    # bit-identical SimResult.

    def begin_session(self) -> None:
        """Start an incremental replay (requires ``engine="batched"``)."""

        if self.engine != "batched":
            raise ValueError(
                f"sessions require engine='batched', got {self.engine!r}"
            )
        if self._session is not None:
            raise RuntimeError("session already open; call end_session first")
        self._session = _ReplayState()

    @property
    def session(self) -> _ReplayState:
        if self._session is None:
            raise RuntimeError("no open session; call begin_session first")
        return self._session

    def feed_window(
        self,
        offsets: np.ndarray,
        sizes: np.ndarray,
        file_ids: np.ndarray,
        app_ids: np.ndarray,
        *,
        force_hdd: bool = False,
        scores: tuple[int, float, int] | None = None,
    ) -> float:
        """Score and replay one request window; returns the service time
        (clock delta) it consumed.

        ``scores`` is the window's ``(seek count, random percentage, seek
        distance)`` when it was scored beforehand (the service scores all
        its windows in one launch); ``None`` scores it here with the same
        numpy oracle call the offline engine uses (full windows and the
        <``stream_len`` trailing partial alike), so session replay stays
        bit-exact either way.  ``force_hdd`` is admission control's
        redirect-to-HDD: the detector still sees the stream, but its bytes
        bypass the burst buffer.
        """

        st = self.session
        if len(sizes) == 0:
            return 0.0
        if len(sizes) > self.stream_len:
            raise ValueError(
                f"window of {len(sizes)} requests exceeds "
                f"stream_len={self.stream_len}"
            )
        offsets = np.asarray(offsets, dtype=np.int64)
        sizes = np.asarray(sizes, dtype=np.int64)
        file_ids = np.asarray(file_ids, dtype=np.int64)
        if scores is None:
            rf, pct, dist = stream_stats_batch_np(offsets[None, :], sizes[None, :])
            scores = (rf[0], pct[0], dist[0])
        nbytes = int(sizes.sum())
        apps, inverse = np.unique(np.asarray(app_ids), return_inverse=True)
        sums = np.zeros(len(apps), dtype=np.int64)
        np.add.at(sums, inverse, sizes)
        for a_id, a_sum in zip(apps, sums):
            st.per_app[int(a_id)] = st.per_app.get(int(a_id), 0) + int(a_sum)
        t0 = st.clock
        self._replay_stream(
            st, offsets, sizes, file_ids,
            nbytes=nbytes,
            pct=float(scores[1]),
            seeks=int(scores[0]),
            dist=int(scores[2]),
            force_hdd=force_hdd,
        )
        return st.clock - t0

    def feed_gap(self, seconds: float) -> float:
        """Replay a compute gap (flusher-only time); returns the delta."""

        st = self.session
        t0 = st.clock
        self._gap(st, float(seconds))
        return st.clock - t0

    def end_session(self, drain: bool = True) -> SimResult:
        """Close the session and return its :class:`SimResult`.

        ``drain=False`` models a crashed node: the final background
        flush never happens, so buffered-but-unflushed bytes stay in
        ``self.pipeline`` for the failover path to enumerate (replay on
        a takeover node, or account as stranded data loss).
        """

        st = self.session
        self._session = None
        return self._finalize(st, drain=drain)

    # ------------------------------------------------------------------
    def run(
        self,
        trace: TraceBatch | Sequence[TraceItem],
        scores: StreamScores | None = None,
    ) -> SimResult:
        """Replay ``trace``; ``scores`` (from
        :func:`repro_torch.core.trace.compute_stream_scores`, same ``stream_len``)
        supplies every stream's random percentage / seek count / seek
        distance so the hot loop never re-sorts a stream on the host.  The
        batched engine computes them itself when omitted.

        Accuracy contract: ``engine="batched"`` is bit-identical to the
        ``engine="per-request"`` oracle; ``engine="device"`` matches the
        oracle to the ``DEVICE_TOLERANCES`` tiers."""

        if scores is not None and scores.stream_len != self.stream_len:
            raise ValueError(
                f"scores computed for stream_len={scores.stream_len}, "
                f"simulator uses {self.stream_len}"
            )
        if self.engine in ("batched", "device"):
            batch = (
                trace if isinstance(trace, TraceBatch)
                else TraceBatch.from_items(trace)
            )
            if scores is None:
                scores = compute_stream_scores(
                    batch, self.stream_len, backend=self.score_backend,
                    device=self.device,
                )
            if self.sanitize:
                batch.validate()
                scores.validate()
            if self.engine == "device":
                from . import engine_device

                return engine_device.simulate_device(
                    batch,
                    scores,
                    sanitize=self.sanitize,
                    scheme=self.scheme,
                    ssd_capacity=self.ssd_capacity,
                    hdd=self.hdd,
                    ssd=self.ssd,
                    link=self.link,
                    interference=self.interference,
                    stream_len=self.stream_len,
                    flush_gate=self.flush_gate,
                    adaptive_window=self.adaptive_window,
                    threshold_warmup=self.threshold_warmup,
                    device=self.device,
                )
            return self._run_batched(batch, scores)
        items = trace.to_items() if isinstance(trace, TraceBatch) else trace
        return self._run_scalar(items, scores)

    # -- per-request engine (the oracle) -------------------------------
    def _hdd_stream_time(
        self,
        stream: Sequence[Request],
        seeks: int | None = None,
        dist: int | None = None,
    ) -> float:
        nbytes = sum(r.size for r in stream)
        if seeks is None:
            offs = [r.offset for r in stream]
            szs = [r.size for r in stream]
            seeks = random_factor_sum(offs, szs)
        if dist is None:
            dist = sorted_seek_distance(stream)
        return self.hdd.write_time(nbytes, seeks, dist)

    def _run_scalar(
        self,
        trace: Sequence[TraceItem],
        scores: StreamScores | None,
    ) -> SimResult:
        st = _ReplayState()
        grouper = StreamGrouper(self.stream_len)
        stream_idx = 0

        def handle_stream(stream: list[Request]) -> None:
            nonlocal stream_idx
            idx = stream_idx
            stream_idx += 1
            seeks: int | None = None
            dist: int | None = None
            nbytes = sum(r.size for r in stream)
            if scores is not None:
                if (
                    idx >= len(scores)
                    or int(scores.nbytes[idx]) != nbytes
                    or int(scores.offset_sum[idx])
                    != sum(r.offset for r in stream)
                ):
                    raise ValueError(
                        f"stream {idx} does not match the precomputed scores "
                        "(wrong trace or stream grouping?)"
                    )
                pct = float(scores.percentage[idx])
                seeks = int(scores.rf_sum[idx])
                dist = int(scores.seek_distance[idx])
            else:
                pct = stream_percentage(stream)
            for r in stream:
                st.per_app[r.app_id] = st.per_app.get(r.app_id, 0) + r.size

            if self.scheme == "orangefs":
                self._advance_fg(
                    st, self._hdd_stream_time(stream, seeks, dist), nbytes,
                    hdd_foreground=True,
                )
                st.bytes_hdd += nbytes
                self._last_pct = pct
                return

            if self.scheme == "orangefs-bb":
                device = Device.SSD  # plain BB caches everything it can
            else:
                if self.redirector is None:
                    raise RuntimeError(f"scheme {self.scheme} needs a redirector")
                routed = self.redirector.route_stream(stream, percentage=pct)
                device = routed.device
            self._last_pct = pct

            if device is Device.SSD:
                overflow: list[Request] = []
                for r in stream:
                    out = self.pipeline.append(r.file_id, r.offset, r.size)
                    if out.blocked:
                        if self.scheme == "orangefs-bb":
                            # plain BB overflow goes straight to HDD while
                            # the SSD flushes (paper Section 1, option 1);
                            # it still passes through the server queue, so
                            # it gets CFQ-sorted with its stream peers.
                            overflow.append(r)
                            continue
                        # SSDUP/SSDUP+: wait for a region to free up
                        st.blocked_seconds += self._drain_current_flush(st)
                        out = self.pipeline.append(r.file_id, r.offset, r.size)
                        if not out.ok:
                            raise RuntimeError(
                                "append rejected after a full drain"
                            )
                    if self.ssd_stateful:
                        # charge the FTL at the LBA the append landed on
                        reg = self.pipeline.active_region
                        lba = np.array(
                            [reg.base_lba + reg.tail - r.size], dtype=np.int64
                        )
                        dev_dt = float(self.ssd.charge_write(
                            lba, np.array([r.size], dtype=np.int64),
                            t=st.clock,
                        )[0])
                    else:
                        dev_dt = self.ssd.write_time(r.size)
                    self._advance_fg(st, dev_dt, r.size, hdd_foreground=False)
                    st.bytes_ssd += r.size
                if overflow:
                    # overflow is a subset of the stream — no precomputed
                    # score exists for it, so fall back to scalar scoring
                    ob = sum(r.size for r in overflow)
                    self._advance_fg(
                        st, self._hdd_stream_time(overflow), ob,
                        hdd_foreground=True,
                    )
                    st.bytes_hdd += ob
                st.peak_ssd = max(st.peak_ssd, self.pipeline.buffered_bytes)
            else:
                self._advance_fg(
                    st, self._hdd_stream_time(stream, seeks, dist), nbytes,
                    hdd_foreground=True,
                )
                st.bytes_hdd += nbytes

        # -- main loop ----------------------------------------------------
        for item in trace:
            if isinstance(item, Gap):
                self._gap(st, item.seconds)
                continue
            full = grouper.push(item)
            if full is not None:
                handle_stream(full)
        tail = grouper.flush()
        if tail is not None:
            handle_stream(tail)
        if scores is not None and stream_idx != len(scores):
            raise ValueError(
                f"precomputed scores cover {len(scores)} streams but the "
                f"trace produced {stream_idx} (wrong trace?)"
            )
        return self._finalize(st)

    # -- batched engine -------------------------------------------------
    def _run_batched(self, batch: TraceBatch, scores: StreamScores) -> SimResult:
        st = _ReplayState()
        stream_len = self.stream_len
        bounds = batch.stream_bounds(stream_len)
        n_streams = len(bounds) - 1
        if len(scores) != n_streams:
            raise ValueError(
                f"precomputed scores cover {len(scores)} streams but the "
                f"trace produced {n_streams} (wrong trace?)"
            )
        if n_streams:
            nb, osum = batch.stream_sums(stream_len)
            bad = np.nonzero((nb != scores.nbytes) | (osum != scores.offset_sum))[0]
            if len(bad):
                raise ValueError(
                    f"stream {int(bad[0])} does not match the precomputed "
                    "scores (wrong trace or stream grouping?)"
                )

        num_requests = batch.num_requests
        # per-app byte totals are order-independent: one whole-trace pass
        # instead of per-stream dict updates
        if num_requests:
            apps, inverse = np.unique(batch.app_ids, return_inverse=True)
            sums = np.zeros(len(apps), dtype=np.int64)
            np.add.at(sums, inverse, batch.sizes)
            st.per_app = {int(a): int(s) for a, s in zip(apps, sums)}
        gap_pos = batch.gap_positions
        gap_sec = batch.gap_seconds
        n_gaps = len(gap_pos)
        gi = 0
        for s in range(n_streams):
            a, b = int(bounds[s]), int(bounds[s + 1])
            # a full stream completes AT its last request, i.e. before any
            # gap marker at position b; the trailing partial stream is only
            # flushed at end-of-trace, i.e. after ALL remaining gaps.
            fire_before = b if b - a == stream_len else num_requests + 1
            while gi < n_gaps and gap_pos[gi] < fire_before:
                self._gap(st, float(gap_sec[gi]))
                gi += 1
            self._handle_stream_batched(st, batch, scores, s, a, b)
        while gi < n_gaps:
            self._gap(st, float(gap_sec[gi]))
            gi += 1
        return self._finalize(st)

    def _advance_ssd_run(self, st: _ReplayState, walls: np.ndarray) -> None:
        """Vectorized counterpart of per-request ``_advance_fg(...,
        hdd_foreground=False)`` over a run of SSD writes: one numpy pass
        per flush-state segment, dropping to Python only when a flush job
        completes mid-run."""

        self._fg_ssd = True  # flush-gate v2 device signal
        i, m = 0, len(walls)
        while i < m:
            job = self.pipeline.flush_job
            if job is None or not self.pipeline.flush_allowed():
                seg = walls[i:]
                if job is not None:  # paused: same pause accounting
                    job.paused_seconds = _seq_add(job.paused_seconds, seg)
                    self.pipeline.total_paused_seconds = _seq_add(
                        self.pipeline.total_paused_seconds, seg
                    )
                st.clock = _seq_add(st.clock, seg)
                return
            rate = job.effective_rate(self.hdd, self._flush_storage)
            quanta = (rate * walls[i:]).astype(np.int64)
            cq = np.cumsum(quanta)
            j = int(np.searchsorted(cq, job.bytes_left, side="left"))
            if j >= m - i:  # job survives the whole run
                self.pipeline.flush_progress(int(cq[-1]))
                st.clock = _seq_add(st.clock, walls[i:])
                return
            # requests i..i+j drain the job dry (overshoot in the final
            # quantum is discarded, like the scalar per-request call)
            self.pipeline.flush_progress(int(cq[j]))
            st.clock = _seq_add(st.clock, walls[i:i + j + 1])
            i += j + 1

    def _handle_stream_batched(
        self,
        st: _ReplayState,
        batch: TraceBatch,
        scores: StreamScores,
        s: int,
        a: int,
        b: int,
    ) -> None:
        self._replay_stream(
            st,
            batch.offsets[a:b],
            batch.sizes[a:b],
            batch.file_ids[a:b],
            nbytes=int(scores.nbytes[s]),
            pct=float(scores.percentage[s]),
            seeks=int(scores.rf_sum[s]),
            dist=int(scores.seek_distance[s]),
        )

    def _replay_stream(
        self,
        st: _ReplayState,
        offsets: np.ndarray,
        sizes: np.ndarray,
        file_ids: np.ndarray,
        *,
        nbytes: int,
        pct: float,
        seeks: int,
        dist: int,
        force_hdd: bool = False,
    ) -> None:
        """Replay one scored stream against ``st`` (shared by the offline
        batched engine and the online session API).  ``force_hdd`` is the
        service layer's admission-control override: the detector still
        observes the stream (identical policy evolution), but its bytes
        are written HDD-direct regardless of the routing decision.

        With ``sanitize`` on, stream inputs (scores consistent with the
        raw arrays, sane ranges) and the wall clock (monotonic, finite)
        are checked around the replay."""

        if not self.sanitize:
            self._replay_stream_impl(
                st, offsets, sizes, file_ids, nbytes=nbytes, pct=pct,
                seeks=seeks, dist=dist, force_hdd=force_hdd,
            )
            return
        t0 = st.clock
        # one fused branch on the happy path; the per-condition checks
        # re-run only on failure to produce a precise message
        smin = int(sizes.min()) if len(sizes) else 0
        ssum = int(sizes.sum())
        if not (smin >= 0 and nbytes == ssum and 0.0 <= pct <= 1.0
                and seeks >= 0 and dist >= 0):
            _sanitize.check(smin >= 0, "negative request size in stream")
            _sanitize.check(
                nbytes == ssum,
                "stream score nbytes=%d disagrees with sizes.sum()=%d",
                nbytes, ssum,
            )
            _sanitize.check(
                0.0 <= pct <= 1.0, "random percentage %r outside [0, 1]", pct
            )
            _sanitize.check(
                seeks >= 0 and dist >= 0,
                "negative seek score (seeks=%d, dist=%d)", seeks, dist,
            )
        self._replay_stream_impl(
            st, offsets, sizes, file_ids, nbytes=nbytes, pct=pct,
            seeks=seeks, dist=dist, force_hdd=force_hdd,
        )
        if not (st.clock >= t0 and math.isfinite(st.clock)):
            _sanitize.check(
                False,
                "wall clock went backwards or non-finite across a stream "
                "(%r -> %r)", t0, st.clock,
            )

    def _replay_stream_impl(
        self,
        st: _ReplayState,
        offsets: np.ndarray,
        sizes: np.ndarray,
        file_ids: np.ndarray,
        *,
        nbytes: int,
        pct: float,
        seeks: int,
        dist: int,
        force_hdd: bool = False,
    ) -> None:

        if self.scheme == "orangefs":
            self._advance_fg(
                st, self.hdd.write_time(nbytes, seeks, dist), nbytes,
                hdd_foreground=True,
            )
            st.bytes_hdd += nbytes
            self._last_pct = pct
            return

        if self.scheme == "orangefs-bb":
            device = Device.SSD  # plain BB caches everything it can
        else:
            if self.redirector is None:
                raise RuntimeError(f"scheme {self.scheme} needs a redirector")
            device = self.redirector.route_scored(nbytes, pct)
        self._last_pct = pct
        if force_hdd:
            device = Device.HDD

        if device is not Device.SSD:
            self._advance_fg(
                st, self.hdd.write_time(nbytes, seeks, dist), nbytes,
                hdd_foreground=True,
            )
            st.bytes_hdd += nbytes
            return

        net = sizes / self.link.bw
        # stateless models: one vectorized wall per request (bit-exact with
        # the pre-refactor inline math).  Stateful models (walls=None):
        # device times depend on mapping state, so the run helpers charge
        # request-by-request with the landed LBAs.
        walls = (
            None if self.ssd_stateful
            else np.maximum(net, self.ssd.charge_write(None, sizes))
        )
        csum = np.cumsum(sizes)
        if isinstance(self.pipeline, SingleRegionBuffer):
            self._ssd_stream_single_region(
                st, offsets, sizes, file_ids, walls, net, csum
            )
        else:
            self._ssd_stream_two_region(
                st, offsets, sizes, file_ids, walls, net, csum
            )
        st.peak_ssd = max(st.peak_ssd, self.pipeline.buffered_bytes)

    def _charge_ssd_run(
        self,
        st: _ReplayState,
        region: "LogRegion",
        log_offsets: np.ndarray,
        sizes: np.ndarray,
        net: np.ndarray,
        walls: np.ndarray | None,
    ) -> None:
        """Advance the clock over one appended run of SSD writes.

        Stateless models (``walls`` given) ride the vectorized pass.
        Stateful models charge request-by-request at the landed LBAs so
        flush-completion trims interleave with device charging exactly
        like the per-request oracle (bit-parity for the FTL backend).
        """

        if walls is not None:
            self._advance_ssd_run(st, walls)
            return
        lbas = region.base_lba + log_offsets
        for i in range(len(sizes)):
            dev = self.ssd.charge_write(
                lbas[i:i + 1], sizes[i:i + 1], t=st.clock
            )
            self._advance_ssd_run(st, np.maximum(net[i:i + 1], dev))

    def _ssd_stream_two_region(
        self, st, offsets, sizes, file_ids, walls, net, csum
    ) -> None:
        """SSDUP/SSDUP+ SSD path: maximal in-region runs appended and timed
        in one shot; region swaps and writer blocks at run boundaries."""

        n = len(sizes)
        pos = 0
        while pos < n:
            region = self.pipeline.active_region
            base = int(csum[pos - 1]) if pos else 0
            limit = base + region.free_bytes()
            k = int(np.searchsorted(csum, limit, side="right"))
            if k > pos:  # requests [pos, k) fit the active region
                logs = region.tail + (csum[pos:k] - sizes[pos:k]) - base
                region.append_batch(
                    file_ids[pos:k], offsets[pos:k], sizes[pos:k]
                )
                self._charge_ssd_run(
                    st, region, logs, sizes[pos:k], net[pos:k],
                    None if walls is None else walls[pos:k],
                )
                st.bytes_ssd += int(csum[k - 1]) - base
                pos = k
                continue
            # request `pos` does not fit: swap, or block + drain, then retry
            out = self.pipeline.append(
                int(file_ids[pos]), int(offsets[pos]), int(sizes[pos])
            )
            if out.blocked:
                st.blocked_seconds += self._drain_current_flush(st)
                out = self.pipeline.append(
                    int(file_ids[pos]), int(offsets[pos]), int(sizes[pos])
                )
                if not out.ok:
                    raise RuntimeError("append rejected after a full drain")
            landed = self.pipeline.active_region
            self._charge_ssd_run(
                st, landed,
                np.array([landed.tail - int(sizes[pos])], dtype=np.int64),
                sizes[pos:pos + 1], net[pos:pos + 1],
                None if walls is None else walls[pos:pos + 1],
            )
            st.bytes_ssd += int(sizes[pos])
            pos += 1

    def _ssd_stream_single_region(
        self, st, offsets, sizes, file_ids, walls, net, csum
    ) -> None:
        """Plain-BB SSD path: buffer until (nearly) full, then everything
        else in the stream overflows straight to the HDD."""

        n = len(sizes)
        pos = 0
        overflow_from: int | None = None
        region = self.pipeline.regions[0]
        cap_quantum = region.capacity // 256
        while pos < n:
            if self.pipeline.flush_job is not None:
                # region draining: every remaining append is rejected (the
                # per-request path counts each as a blocked event)
                self.pipeline.blocked_events += n - pos
                overflow_from = pos
                break
            base = int(csum[pos - 1]) if pos else 0
            free = region.free_bytes()
            k = int(np.searchsorted(csum, base + free, side="right"))
            if k == pos:
                # doesn't fit: the append schedules the forced flush and
                # rejects; everything from here on overflows
                out = self.pipeline.append(
                    int(file_ids[pos]), int(offsets[pos]), int(sizes[pos])
                )
                if not out.blocked:
                    raise RuntimeError(
                        "over-capacity append unexpectedly accepted"
                    )
                self.pipeline.blocked_events += n - pos - 1
                overflow_from = pos
                break
            # eager-flush trigger: first t in [pos, k) whose append leaves
            # free space below max(size_t, capacity/256)
            rel = csum[pos:k] - base
            trig = (free - rel) < np.maximum(sizes[pos:k], cap_quantum)
            if trig.any():
                t = pos + int(np.argmax(trig))
                if t > pos:
                    logs = region.tail + (csum[pos:t] - sizes[pos:t]) - base
                    region.append_batch(
                        file_ids[pos:t], offsets[pos:t], sizes[pos:t]
                    )
                    self._charge_ssd_run(
                        st, region, logs, sizes[pos:t], net[pos:t],
                        None if walls is None else walls[pos:t],
                    )
                    st.bytes_ssd += int(csum[t - 1]) - base
                # the trigger request goes through the scalar append, which
                # schedules the forced flush exactly like the oracle
                out = self.pipeline.append(
                    int(file_ids[t]), int(offsets[t]), int(sizes[t])
                )
                if not out.ok:
                    raise RuntimeError("eager-flush trigger append rejected")
                self._charge_ssd_run(
                    st, region,
                    np.array([region.tail - int(sizes[t])], dtype=np.int64),
                    sizes[t:t + 1], net[t:t + 1],
                    None if walls is None else walls[t:t + 1],
                )
                st.bytes_ssd += int(sizes[t])
                pos = t + 1
            else:
                logs = region.tail + (csum[pos:k] - sizes[pos:k]) - base
                region.append_batch(
                    file_ids[pos:k], offsets[pos:k], sizes[pos:k]
                )
                self._charge_ssd_run(
                    st, region, logs, sizes[pos:k], net[pos:k],
                    None if walls is None else walls[pos:k],
                )
                st.bytes_ssd += int(csum[k - 1]) - base
                pos = k
        if overflow_from is not None:
            o_offs = offsets[overflow_from:]
            o_szs = sizes[overflow_from:]
            ob = int(o_szs.sum())
            seeks = random_factor_sum(o_offs, o_szs)
            dist = seek_distance_np(o_offs, o_szs)
            self._advance_fg(
                st, self.hdd.write_time(ob, seeks, dist), ob,
                hdd_foreground=True,
            )
            st.bytes_hdd += ob


def run_schemes(
    trace: TraceBatch | Sequence[TraceItem],
    schemes: Iterable[str] = ("orangefs", "orangefs-bb", "ssdup", "ssdup+"),
    scores: StreamScores | None = None,
    **kwargs,
) -> dict[str, SimResult]:
    """Run the same trace under several schemes (paper's comparison set).

    Accuracy contract: same as :meth:`IONodeSimulator.run` — bit-identical
    numpy engines, ``DEVICE_TOLERANCES`` tiers on the device engine.

    ``scores`` precomputed once (they are scheme-independent) is reused
    across every scheme's replay.
    """

    if not isinstance(trace, TraceBatch):
        trace = list(trace)
    out: dict[str, SimResult] = {}
    for s in schemes:
        kw = dict(kwargs)
        if "ssd" in kw:
            # stateful storage (FTL) must not leak mapping state across
            # scheme replays of the same trace
            kw["ssd"] = clone_storage(kw["ssd"])
        out[s] = IONodeSimulator(scheme=s, **kw).run(trace, scores=scores)
    return out
