"""Service-level metrics: tail latency, degraded-mode throughput, recovery.

The offline fleet layer reports aggregate MB/s; a production burst-buffer
service is judged on its tails and its behaviour under failure.  This
module holds the accounting structs the service loop
(:mod:`repro_torch.service.loop`) fills in:

* :class:`FaultRecord` — one injected fault's lifecycle: when it was
  injected, when the controller *detected* it (heartbeat timeout /
  straggler rule), when recovery (reshard + backlog replay) completed,
  and the bytes it stranded or replayed.
* :class:`ServiceMetrics` — per-scheme service accounting: request
  latency percentiles (p50/p99/p999; a request's latency is the wall
  time from its arrival to the completion of the 128-request window that
  carried it), healthy- vs degraded-mode throughput, and the byte ledger
  (completed / rejected / redirected / replayed / stranded / rebalanced).

Byte conservation is checked at two levels
(:meth:`ServiceMetrics.conservation_violations`):

* service level — every offered byte is either completed, rejected by
  admission control, or unserved (no surviving node):
  ``completed + rejected + unserved == offered``.
* SSD level — every byte written to a burst buffer is either flushed to
  the HDD, replayed on a takeover node after a crash, stranded (lost,
  ``replay=False``), or superseded by a newer version of the same extent
  before it was flushed (log-structure dedup):
  ``written_ssd == flushed + replayed + stranded + deduped``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FaultRecord:
    """Lifecycle of one injected fault, as the controller saw it."""

    kind: str  # "crash" | "slow" | "ssd_degrade" | "stall"
    node: int
    injected_at: float
    detected_at: float | None = None  # controller declared it (None: never)
    recovered_at: float | None = None  # reshard + backlog replay done
    stranded_bytes: int = 0
    replayed_bytes: int = 0

    @property
    def detection_seconds(self) -> float | None:
        if self.detected_at is None:
            return None
        return self.detected_at - self.injected_at

    @property
    def recovery_seconds(self) -> float | None:
        if self.recovered_at is None:
            return None
        return self.recovered_at - self.injected_at


@dataclasses.dataclass
class ServiceMetrics:
    """Per-scheme service accounting (see module docstring)."""

    scheme: str
    offered_bytes: int = 0

    # -- byte ledger (service level) -----------------------------------
    completed_bytes: int = 0  # fed through a node simulator
    rejected_bytes: int = 0  # admission control: reject
    redirected_bytes: int = 0  # admission control: redirect-to-HDD
    unserved_bytes: int = 0  # no surviving node to run them
    rebalanced_bytes: int = 0  # moved off stragglers/degraded nodes

    # -- byte ledger (SSD level) ---------------------------------------
    written_ssd_bytes: int = 0  # appended to some burst buffer
    written_hdd_bytes: int = 0  # HDD-direct foreground writes
    flushed_bytes: int = 0  # drained SSD -> HDD
    replayed_bytes: int = 0  # unflushed backlog replayed on takeover
    stranded_bytes: int = 0  # unflushed backlog lost (replay=False)
    deduped_bytes: int = 0  # superseded in the log before flushing

    # -- time accounting ------------------------------------------------
    makespan_seconds: float = 0.0  # last lane's wall at completion
    healthy_seconds: float = 0.0
    degraded_seconds: float = 0.0
    healthy_bytes: int = 0  # completed while the fleet was healthy
    degraded_bytes: int = 0  # completed while any node was impaired

    faults: list[FaultRecord] = dataclasses.field(default_factory=list)

    _latency_chunks: list[np.ndarray] = dataclasses.field(
        default_factory=list, repr=False
    )

    # -- latency ---------------------------------------------------------
    def record_latencies(self, seconds: np.ndarray) -> None:
        arr = np.asarray(seconds, dtype=np.float64)
        if arr.size:
            self._latency_chunks.append(arr)

    @property
    def latencies(self) -> np.ndarray:
        if not self._latency_chunks:
            return np.zeros(0, dtype=np.float64)
        return np.concatenate(self._latency_chunks)

    def latency_percentile(self, q: float) -> float:
        lat = self.latencies
        if not lat.size:
            return 0.0
        return float(np.percentile(lat, q, method="nearest"))

    @property
    def p50_latency(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p99_latency(self) -> float:
        return self.latency_percentile(99.0)

    @property
    def p999_latency(self) -> float:
        return self.latency_percentile(99.9)

    # -- throughput ------------------------------------------------------
    @property
    def throughput_mbs(self) -> float:
        if not self.makespan_seconds:
            return 0.0
        return self.completed_bytes / self.makespan_seconds / 1e6

    @property
    def healthy_throughput_mbs(self) -> float:
        if not self.healthy_seconds:
            return 0.0
        return self.healthy_bytes / self.healthy_seconds / 1e6

    @property
    def degraded_throughput_mbs(self) -> float:
        if not self.degraded_seconds:
            return 0.0
        return self.degraded_bytes / self.degraded_seconds / 1e6

    @property
    def recovery_seconds(self) -> float | None:
        """Worst recovery time across recovered faults (None: no fault
        completed recovery)."""

        times = [
            f.recovery_seconds for f in self.faults
            if f.recovery_seconds is not None
        ]
        return max(times) if times else None

    # -- conservation ----------------------------------------------------
    def conservation_violations(self) -> list[str]:
        """Byte-ledger identities that must hold; non-empty = bug."""

        out: list[str] = []
        served = (
            self.completed_bytes + self.rejected_bytes + self.unserved_bytes
        )
        if served != self.offered_bytes:
            out.append(
                f"service ledger: completed({self.completed_bytes}) + "
                f"rejected({self.rejected_bytes}) + "
                f"unserved({self.unserved_bytes}) = {served} "
                f"!= offered({self.offered_bytes})"
            )
        ssd_out = (
            self.flushed_bytes + self.replayed_bytes
            + self.stranded_bytes + self.deduped_bytes
        )
        if ssd_out != self.written_ssd_bytes:
            out.append(
                f"SSD ledger: flushed({self.flushed_bytes}) + "
                f"replayed({self.replayed_bytes}) + "
                f"stranded({self.stranded_bytes}) + "
                f"deduped({self.deduped_bytes}) = {ssd_out} "
                f"!= written_ssd({self.written_ssd_bytes})"
            )
        if self.deduped_bytes < 0:
            out.append(f"negative dedup: {self.deduped_bytes}")
        return out
