"""Two-region SSD pipeline with traffic-aware flushing (paper Section 2.4).

The fast tier is split into two equal regions.  One region buffers incoming
redirected writes while the other flushes to the slow tier; when the
buffering region fills, the roles swap (Eq. 5: all but the first/last m/2
stages are fully pipelined).  If both regions are full the writer *blocks*
until a flush completes (paper: "the system waits until a region becomes
empty").

Traffic-aware flushing (Section 2.4.2): the flusher checks the detector's
current random percentage.  High percentage ⇒ most traffic is being absorbed
by the fast tier, the slow tier is idle ⇒ flush.  Low percentage ⇒ the slow
tier is busy with direct sequential writes ⇒ pause the flush to avoid head
thrashing (Eq. 7's T_f' > T_f), unless the pipeline is out of space (both
regions full), in which case flushing is forced.

This module is a pure state machine — the simulator / checkpoint runtime own
the clock and call :meth:`flush_progress` with byte quantities.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import TYPE_CHECKING, Callable

from .log_store import LogRegion

if TYPE_CHECKING:
    from .device_model import HDDModel, StorageModel


class FlushState(enum.Enum):
    IDLE = "idle"
    FLUSHING = "flushing"
    PAUSED = "paused"


@dataclasses.dataclass
class FlushJob:
    region: LogRegion
    bytes_total: int
    seeks: int  # residual seeks of the index-ordered flush
    bytes_done: int = 0
    paused_seconds: float = 0.0
    forced: bool = False

    @property
    def bytes_left(self) -> int:
        return self.bytes_total - self.bytes_done

    @property
    def done(self) -> bool:
        return self.bytes_done >= self.bytes_total

    # -- Eq. 6 flush cost (paper Section 2.5) --------------------------
    def service_seconds(self, hdd: "HDDModel") -> float:
        """Exclusive-HDD time to drain the whole job:
        ``seeks × seek_time + bytes / seq_bw`` (paper Eq. 6).

        The residual seeks are the gaps left between live extents after
        the index-ordered sort — the part of the flush the log-structured
        buffer cannot make sequential.
        """

        return self.seeks * hdd.seek_time + self.bytes_total / hdd.seq_bw

    def effective_rate(
        self, hdd: "HDDModel", storage: "StorageModel | None" = None
    ) -> float:
        """Drain rate (B/s) with the residual seeks amortized per byte.

        Every byte-budget drain path charges the flush at this rate, so
        the seek cost is paid no matter which code path drains the job
        (foreground-overlapped, compute gap, blocked writer, final
        drain).  With a stateful ``storage`` model the flusher's SSD
        *read* side can also bind (e.g. a degraded device): the rate is
        then capped by ``storage.read_time``; the default models read
        faster than the HDD writes, so the constant path is unchanged.
        """

        if self.bytes_total <= 0:
            return hdd.seq_bw
        secs = self.service_seconds(hdd)
        if storage is not None:
            secs = max(secs, storage.read_time(self.bytes_total))
        return self.bytes_total / secs


@dataclasses.dataclass(frozen=True)
class AppendOutcome:
    ok: bool
    swapped: bool = False  # filled region handed to the flusher
    blocked: bool = False  # both regions full; caller must drain a flush


class TwoRegionPipeline:
    """The paper's two-region buffering/flushing pipeline."""

    def __init__(
        self,
        region_capacity: int,
        traffic_aware: bool = True,
        flush_gate: float | str = 0.5,
        percentage_source: Callable[[], float] | None = None,
        index_backend: str = "numpy",
        storage: "StorageModel | None" = None,
        fg_ssd_source: Callable[[], bool] | None = None,
    ):
        if isinstance(flush_gate, str) and flush_gate != "device":
            raise ValueError(
                f"flush_gate must be a float or 'device', got {flush_gate!r}"
            )
        self.regions = (
            LogRegion(region_capacity, "R0", index_backend=index_backend),
            LogRegion(region_capacity, "R1", index_backend=index_backend),
        )
        # region 1 lives in the upper half of the SSD's logical space
        self.regions[1].base_lba = region_capacity
        self.active = 0
        self.flush_job: FlushJob | None = None
        self._flush_backlog: list[FlushJob] = []
        self.traffic_aware = traffic_aware
        self.flush_gate = flush_gate
        # Detector hook: returns the current stream random percentage.
        self.percentage_source = percentage_source or (lambda: 1.0)
        # Stateful storage backend (FTL): receives trim() when a flushed
        # region's log dies.  None for the stateless constant model.
        self.storage = storage
        # Flush-gate v2 hook (flush_gate="device"): returns True while the
        # foreground stream is writing the SSD (HDD quiet => flush).
        self.fg_ssd_source = fg_ssd_source or (lambda: True)
        # stats
        self.flushes_completed = 0
        self.total_flushed_bytes = 0
        self.total_paused_seconds = 0.0
        self.blocked_events = 0

    # -- write path -------------------------------------------------------
    @property
    def active_region(self) -> LogRegion:
        return self.regions[self.active]

    @property
    def standby_region(self) -> LogRegion:
        return self.regions[1 - self.active]

    def append(self, file_id: int, offset: int, size: int) -> AppendOutcome:
        """Append one redirected request; may swap regions or report a block."""

        region = self.active_region
        if region.fits(size):
            region.append(file_id, offset, size)
            return AppendOutcome(ok=True)

        # Active region is full: try to swap to the standby region.
        standby = self.standby_region
        standby_busy = standby.used_bytes > 0 or self._scheduled(standby)
        if standby_busy:
            self.blocked_events += 1
            return AppendOutcome(ok=False, blocked=True)

        self._schedule_flush(region)
        self.active = 1 - self.active
        if not self.active_region.fits(size):
            raise ValueError(
                f"request of {size} B exceeds region capacity {self.active_region.capacity}"
            )
        self.active_region.append(file_id, offset, size)
        return AppendOutcome(ok=True, swapped=True)

    def _scheduled(self, region: LogRegion) -> bool:
        return (
            self.flush_job is not None and self.flush_job.region is region
        ) or any(j.region is region for j in self._flush_backlog)

    def _schedule_flush(self, region: LogRegion) -> None:
        # bytes/seeks are fixed at schedule time: a scheduled region never
        # receives further appends (it is no longer the active region)
        nbytes = region.flush_bytes()
        if nbytes <= 0:
            # Nothing live to flush (e.g. an oversized request rejected by
            # an EMPTY single-region buffer).  A zero-byte job would wedge
            # the drain loop: flush_progress() ignores nbytes <= 0, so the
            # job could never complete.  Clear the region and skip the job.
            self._trim_region(region)
            region.reset()
            return
        job = FlushJob(
            region=region,
            bytes_total=nbytes,
            seeks=region.seek_count_sorted(),
        )
        if self.flush_job is None:
            self.flush_job = job
        else:
            self._flush_backlog.append(job)

    # -- flush path -------------------------------------------------------
    def flush_state(self) -> FlushState:
        job = self.flush_job
        if job is None:
            return FlushState.IDLE
        if self.flush_allowed():
            return FlushState.FLUSHING
        return FlushState.PAUSED

    def flush_allowed(self) -> bool:
        """Traffic-aware gate (Section 2.4.2)."""

        job = self.flush_job
        if job is None:
            return False
        if job.forced or not self.traffic_aware:
            return True
        if isinstance(self.flush_gate, str):  # flush_gate="device" (v2)
            # Pause whenever the foreground stream is writing the HDD:
            # the device itself, not the detector's percentage, decides.
            return self.fg_ssd_source()
        # High random percentage => slow tier is quiet => flush now.
        return self.percentage_source() >= self.flush_gate

    def force_flush(self) -> None:
        """Used when the writer is blocked: space reclaim beats interference."""

        if self.flush_job is not None:
            self.flush_job.forced = True

    def flush_progress(self, nbytes: int) -> int:
        """Advance the current flush by up to ``nbytes``; returns bytes used."""

        job = self.flush_job
        if job is None or nbytes <= 0:
            return 0
        used = min(nbytes, job.bytes_left)
        job.bytes_done += used
        self.total_flushed_bytes += used
        if job.done:
            self._complete_flush()
        return used

    def note_pause(self, seconds: float) -> None:
        if self.flush_job is not None:
            self.flush_job.paused_seconds += seconds
        self.total_paused_seconds += seconds

    def _trim_region(self, region: LogRegion) -> None:
        """Tell a stateful storage model the region's log content died."""

        if self.storage is not None and region.used_bytes > 0:
            self.storage.trim(region.base_lba, region.used_bytes)

    def _complete_flush(self) -> None:
        if self.flush_job is None:
            raise RuntimeError("completing a flush with no active job")
        self._trim_region(self.flush_job.region)
        self.flush_job.region.reset()
        self.flush_job = None
        self.flushes_completed += 1
        if self._flush_backlog:
            self.flush_job = self._flush_backlog.pop(0)

    def drain(self) -> list[FlushJob]:
        """Schedule and force flushes for ALL remaining data (end of I/O
        phase), returning every outstanding job — the active one AND the
        backlog — so a caller draining the returned jobs can never stall
        on a never-forced second region."""

        for region in self.regions:
            if region.used_bytes > 0 and not self._scheduled(region):
                self._schedule_flush(region)
        jobs: list[FlushJob] = []
        if self.flush_job is not None:
            self.flush_job.forced = True
            jobs.append(self.flush_job)
        for job in self._flush_backlog:
            job.forced = True
            jobs.append(job)
        return jobs

    # -- accounting ---------------------------------------------------------
    @property
    def buffered_bytes(self) -> int:
        return sum(r.used_bytes for r in self.regions)

    @property
    def metadata_bytes(self) -> int:
        return sum(r.metadata_bytes() for r in self.regions)


class SingleRegionBuffer(TwoRegionPipeline):
    """Plain burst buffer: the whole SSD as ONE region (OrangeFS-BB baseline).

    Paper Section 4.2.3: "in OrangeFS-BB, the 8GB is used as an entire
    space".  When the region fills it flushes; until the flush completes the
    buffer rejects appends (the simulator then routes those writes straight
    to the HDD, the paper's overflow behaviour).
    """

    def __init__(self, capacity: int, **kwargs):
        kwargs.setdefault("traffic_aware", False)
        super().__init__(capacity, **kwargs)
        # keep only region 0; region 1 is permanently retired
        self.regions = (self.regions[0],)

    @property
    def active_region(self) -> LogRegion:
        return self.regions[0]

    @property
    def standby_region(self) -> LogRegion:  # pragma: no cover - not used
        return self.regions[0]

    def append(self, file_id: int, offset: int, size: int) -> AppendOutcome:
        region = self.regions[0]
        if self.flush_job is not None:
            # region is being drained; cannot buffer until it completes
            self.blocked_events += 1
            return AppendOutcome(ok=False, blocked=True)
        if region.fits(size):
            region.append(file_id, offset, size)
            if region.free_bytes() < max(size, region.capacity // 256):
                # buffer is (effectively) full: plain BB starts its flush
                # phase right away (paper Section 4.2.4: "after the first IOR
                # instance fills the SSD buffer, OrangeFS-BB starts the
                # flushing phase") — eagerly, so a following compute gap can
                # drain it.
                self._schedule_flush(region)
                if self.flush_job is not None:
                    self.flush_job.forced = True
            return AppendOutcome(ok=True)
        self._schedule_flush(region)
        if self.flush_job is not None:
            self.flush_job.forced = True  # plain BB flushes immediately
        self.blocked_events += 1
        return AppendOutcome(ok=False, blocked=True)
