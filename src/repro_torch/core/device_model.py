"""Storage-device timing models (the port's copy of the reference's).

The HDD model follows the paper's abstraction (Section 2.2): one seek per
random-factor unit, seek time linear in logical-offset distance, plus
sequential-bandwidth transfer.  The constants are the reference's
calibration to the paper's testbed (Section 4.1: OrangeFS on 2 I/O nodes,
a SAS disk and a SATA SSD per node, Gigabit Ethernet ingest).

Only the constant-bandwidth SSD (``ssd="constant"``) is ported so far.
The page-mapped FTL backend (``ssd="ftl"``) is a later slice of the port
(ROADMAP, Queue 1: "FTL lanes"); asking for it raises
:class:`NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar


@dataclasses.dataclass(frozen=True)
class HDDModel:
    """Seek + distance + sequential-bandwidth disk model: a sorted batch
    costs ``seeks * seek_time + distance * seek_dist_coeff + bytes /
    seq_bw``."""

    seq_bw: float = 220e6  # bytes/s, large sequential writes
    seek_time: float = 3.56e-3  # s per head movement (random-factor unit)
    seek_dist_coeff: float = 5.1e-12  # s per byte of logical seek distance
    name: str = "hdd"


@dataclasses.dataclass(frozen=True)
class SSDModel:
    """Flash model: bandwidth-only, near-zero seek (paper Section 2.5).

    The ``ssd="constant"`` storage backend: stateless, every request
    costs ``size / write_bw``.
    """

    write_bw: float = 380e6  # bytes/s sequential (log-structured appends)
    read_bw: float = 450e6  # bytes/s (random reads ~ sequential on flash)
    name: str = "ssd"
    stateful: ClassVar[bool] = False


STORAGE_BACKENDS = ("constant",)


def make_storage_model(spec: Any = None, logical_bytes: int = 0, **kwargs: Any):
    """Resolve an ``ssd=`` spec: ``None``/``"constant"`` build
    :class:`SSDModel`; any other object passes through unchanged.

    ``"ftl"`` raises :class:`NotImplementedError` until the FTL lanes are
    ported (ROADMAP Queue 1)."""

    del logical_bytes
    if spec is None or spec == "constant":
        return SSDModel(**kwargs)
    if spec == "ftl":
        raise NotImplementedError(
            "ssd='ftl' is not ported yet (ROADMAP Queue 1: FTL lanes, "
            "core/ftl.py); use ssd='constant'"
        )
    if isinstance(spec, str):
        raise ValueError(
            f"unknown storage model {spec!r}; choose from {STORAGE_BACKENDS}"
        )
    return spec


@dataclasses.dataclass(frozen=True)
class IngestLink:
    """Per-I/O-node network ingest (GbE on the paper's testbed)."""

    bw: float = 110e6  # bytes/s


@dataclasses.dataclass(frozen=True)
class InterferenceModel:
    """Cost of concurrent HDD writers (paper Sections 2.4.2-2.4.3, Eq. 7):
    a fair 50/50 share with service-time inflation ``phi`` while the
    flusher and the foreground write the disk together."""

    phi: float = 2.0

    def foreground_slowdown(self) -> float:
        return 2.0 * self.phi

    def flush_rate_fraction(self) -> float:
        return 1.0 / (2.0 * self.phi)
