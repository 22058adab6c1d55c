"""Per-node replay results.

The reference module also holds the per-request and batched NumPy replay
engines (``IONodeSimulator``) and ``run_schemes``.  They are a later slice
of the port (ROADMAP Queue 1); this slice replays through the device
engine (:mod:`repro_torch.core.engine_device`) only, and needs just the
result record.
"""

from __future__ import annotations

import dataclasses


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
