"""Storage-device timing models (the port's copy of the reference's).

The HDD model follows the paper's abstraction (Section 2.2): one seek per
random-factor unit, seek time linear in logical-offset distance, plus
sequential-bandwidth transfer.  The constants are the reference's
calibration to the paper's testbed (Section 4.1: OrangeFS on 2 I/O nodes,
a SAS disk and a SATA SSD per node, Gigabit Ethernet ingest): two
constants fitted to two of Fig. 2/6's measurements (segmented-random
~95 MB/s, strided at 32 processes ~176 MB/s) give ``seek_time`` 3.56 ms
and ``seek_dist_coeff`` 5.1e-12 s/B.

Two SSD backends: the stateless constant-bandwidth :class:`SSDModel`
(``ssd="constant"``) and the page-mapped :class:`~repro_torch.core.ftl.FTLModel`
(``ssd="ftl"``: GC, channel striping, measured write amplification).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, ClassVar, Protocol, runtime_checkable

import numpy as np

if TYPE_CHECKING:
    from .ftl import FTLModel


@runtime_checkable
class StorageModel(Protocol):
    """Pluggable SSD timing backend threaded through all four engines.

    Two shipped backends: the stateless constant-bandwidth
    :class:`SSDModel` (``ssd="constant"``, the default — bit-exact with
    the pre-refactor inline ``nbytes / write_bw`` math everywhere) and
    the stateful page-mapped :class:`~repro_torch.core.ftl.FTLModel`
    (``ssd="ftl"`` — GC, channel striping, measured write
    amplification).  Engines branch on ``stateful``: stateless models
    may be charged without offsets (vectorized, order-free); stateful
    models are charged with per-request LBAs in arrival order and get
    :meth:`trim` calls when a flushed region's content dies.
    """

    stateful: bool
    name: str
    read_bw: float

    def charge_write(
        self,
        offsets: np.ndarray | None,
        sizes: np.ndarray,
        t: float = 0.0,
    ) -> np.ndarray:
        """Per-request SSD service times (seconds, float64) for a batch."""
        ...

    def write_time(self, nbytes: int) -> float: ...

    def read_time(self, nbytes: int) -> float: ...

    def trim(self, offset: int, nbytes: int) -> None: ...

    def clone(self) -> "StorageModel": ...

    def degraded(self, factor: float) -> "StorageModel": ...

    def config_fingerprint(self) -> dict[str, Any]: ...


@dataclasses.dataclass(frozen=True)
class HDDModel:
    """Seek + distance + sequential-bandwidth disk model."""

    seq_bw: float = 220e6  # bytes/s, large sequential writes
    seek_time: float = 3.56e-3  # s per head movement (random-factor unit)
    seek_dist_coeff: float = 5.1e-12  # s per byte of logical seek distance
    name: str = "hdd"

    def write_time(self, nbytes: int, seeks: int, seek_distance: int = 0) -> float:
        """Service time of a sorted request batch with ``seeks`` movements."""

        if nbytes < 0 or seeks < 0:
            raise ValueError("negative work")
        return (
            seeks * self.seek_time
            + seek_distance * self.seek_dist_coeff
            + nbytes / self.seq_bw
        )

    def sequential_time(self, nbytes: int) -> float:
        return nbytes / self.seq_bw


@dataclasses.dataclass(frozen=True)
class SSDModel:
    """Flash model: bandwidth-only, near-zero seek (paper Section 2.5).

    The ``ssd="constant"`` storage backend.  Stateless: ``charge_write``
    is exactly ``sizes / write_bw`` elementwise (same IEEE operations as
    the pre-refactor inline math, so every golden fixture stays
    bit-exact) and ``trim`` is a no-op.
    """

    write_bw: float = 380e6  # bytes/s sequential (log-structured appends)
    read_bw: float = 450e6  # bytes/s (random reads ~ sequential on flash)
    name: str = "ssd"
    stateful: ClassVar[bool] = False

    def write_time(self, nbytes: int) -> float:
        return nbytes / self.write_bw

    def read_time(self, nbytes: int) -> float:
        return nbytes / self.read_bw

    def charge_write(
        self,
        offsets: np.ndarray | None,
        sizes: np.ndarray,
        t: float = 0.0,
    ) -> np.ndarray:
        """Per-request SSD write times; stateless, so offsets/t are
        ignored and the result is exactly ``sizes / write_bw``."""

        del offsets, t
        return np.asarray(sizes) / self.write_bw

    def trim(self, offset: int, nbytes: int) -> None:
        """No device state to invalidate in the constant model."""

    def clone(self) -> "SSDModel":
        return self  # immutable: safe to share across nodes

    def degraded(self, factor: float) -> "SSDModel":
        """New model with bandwidths scaled by ``factor`` (< 1 degrades)."""

        if not factor > 0.0:
            raise ValueError(f"degradation factor must be > 0, got {factor!r}")
        return dataclasses.replace(
            self, write_bw=self.write_bw * factor, read_bw=self.read_bw * factor
        )

    def config_fingerprint(self) -> dict[str, Any]:
        return {
            "name": "constant",
            "write_bw": float(self.write_bw),
            "read_bw": float(self.read_bw),
        }


STORAGE_BACKENDS = ("constant", "ftl")


def make_storage_model(
    spec: "StorageModel | str | None",
    logical_bytes: int = 0,
    **kwargs: Any,
) -> "StorageModel":
    """Resolve an ``ssd=`` spec into a :class:`StorageModel` instance.

    ``None`` / ``"constant"`` build the stateless :class:`SSDModel`;
    ``"ftl"`` builds an :class:`~repro_torch.core.ftl.FTLModel` sized to
    ``logical_bytes`` (the buffer capacity it backs); an object that
    already implements the protocol passes through unchanged.
    """

    if spec is None or (isinstance(spec, str) and spec == "constant"):
        return SSDModel(**kwargs)
    if isinstance(spec, str):
        if spec == "ftl":
            from .ftl import FTLModel

            if logical_bytes <= 0:
                raise ValueError(
                    "ssd='ftl' needs a positive buffer capacity to size "
                    "the logical address space"
                )
            return FTLModel(logical_bytes=logical_bytes, **kwargs)
        raise ValueError(
            f"unknown storage model {spec!r}; choose from "
            f"{STORAGE_BACKENDS} or pass a StorageModel instance"
        )
    if isinstance(spec, StorageModel):
        return spec
    raise TypeError(
        f"ssd= expects {STORAGE_BACKENDS}, None, or a StorageModel "
        f"instance; got {type(spec).__name__}"
    )


def clone_storage(
    spec: "StorageModel | str | None",
) -> "StorageModel | str | None":
    """Per-node copy of an ``ssd=`` spec.

    Stateful instances are cloned so fleet nodes and scheme sweeps never
    share FTL mapping state; strings/None resolve to fresh models per
    node anyway and stateless instances are immutable, so both pass
    through unchanged.
    """

    if isinstance(spec, str) or spec is None:
        return spec
    if getattr(spec, "stateful", False):
        return spec.clone()
    return spec


@dataclasses.dataclass(frozen=True)
class IngestLink:
    """Per-I/O-node network ingest (GbE on the paper's testbed)."""

    bw: float = 110e6  # bytes/s

    def time(self, nbytes: int) -> float:
        return nbytes / self.bw


@dataclasses.dataclass(frozen=True)
class InterferenceModel:
    """Cost of concurrent HDD writers (paper Sections 2.4.2-2.4.3, Eq. 7).

    When the flusher and direct application writes hit the HDD together the
    disk head ping-pongs between the two streams.  We model the shared disk
    as a fair (50/50) server with a service-time inflation ``phi`` on every
    byte while shared: a foreground batch whose disk time is ``dt`` alone
    needs ``2 * phi * dt`` of disk occupancy when shared, and the concurrent
    flusher drains at ``seq_bw / (2 * phi)``.

    ``phi = 2.0`` calibrates SSDUP+ on the paper's workload_1 (Fig. 9/13)
    to within 2% of the paper's aggregate (176.9 vs 180.7 MB/s) and keeps
    the SSDUP+ > SSDUP ordering (the fair-share model flips the one
    between BB and SSDUP).
    """

    phi: float = 2.0

    def foreground_slowdown(self) -> float:
        return 2.0 * self.phi

    def flush_rate_fraction(self) -> float:
        return 1.0 / (2.0 * self.phi)


# The tiers of the *framework* deployment (checkpoint path).  Relative speeds
# mirror the paper's SSD:HDD asymmetry one level up the hierarchy: local
# NVMe/DRAM burst tier vs. a remote parallel FS whose effective per-client
# bandwidth collapses under unmerged small writes.
@dataclasses.dataclass(frozen=True)
class TierSpec:
    name: str
    bw: float  # bytes/s
    seek_time: float = 0.0  # per non-contiguous write (request-merge miss)


LOCAL_BURST_TIER = TierSpec("local-nvme", bw=2.0e9)
REMOTE_PFS_TIER = TierSpec("remote-pfs", bw=0.5e9, seek_time=0.8e-3)
