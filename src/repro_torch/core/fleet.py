"""Fleet sweep: shard one trace over N I/O nodes and replay every
``scheme x node`` lane in one device program.

The fleet's I/O time is the straggler's (applications block on their
slowest I/O server), aggregate throughput is total bytes over that time,
and ``load_imbalance`` is max-over-mean node bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..device import resolve_device
from ..distributed.sharding import TRACE_POLICIES, assign_nodes
from . import engine_device as ed
from .device_model import make_storage_model
from .random_factor import DEFAULT_STREAM_LEN
from .simulator import SimResult
from .trace import TraceBatch, TraceItem, _score_shards_kernel


@dataclasses.dataclass(frozen=True)
class FleetResult:
    """Aggregate of one fleet replay: per-node results + fleet metrics."""

    scheme: str
    policy: str
    num_nodes: int
    node_results: tuple[SimResult, ...]

    @property
    def total_bytes(self) -> int:
        return sum(r.total_bytes for r in self.node_results)

    @property
    def bytes_to_ssd(self) -> int:
        return sum(r.bytes_to_ssd for r in self.node_results)

    @property
    def bytes_to_hdd_direct(self) -> int:
        return sum(r.bytes_to_hdd_direct for r in self.node_results)

    @property
    def io_seconds(self) -> float:
        """Fleet I/O time = the straggler node's I/O time."""

        return max((r.io_seconds for r in self.node_results), default=0.0)

    @property
    def total_seconds(self) -> float:
        return max((r.total_seconds for r in self.node_results), default=0.0)

    @property
    def throughput_mbs(self) -> float:
        """Aggregate fleet throughput (bytes over straggler time)."""

        t = self.io_seconds
        return self.total_bytes / t / 1e6 if t else 0.0

    @property
    def load_imbalance(self) -> float:
        """max / mean of per-node byte loads; 1.0 = perfectly balanced."""

        if not self.node_results or not self.total_bytes:
            return 1.0
        loads = np.asarray([r.total_bytes for r in self.node_results],
                           dtype=np.float64)
        return float(loads.max() / loads.mean())


class FleetProgram:
    """One device sweep over the whole shard matrix.

    Every shard is scored once, all shards in one launch of the CUDA
    kernel (or its plain version on the CPU), and lowered to an event
    tape; tapes are scheme-independent, so one lane per ``scheme x node``
    replays them all in a single
    :func:`~repro_torch.core.engine_device.replay_lanes` call.  ``device=None`` runs on the CUDA card and raises without one;
    pass ``device="cpu"`` to run on the CPU.  ``ssd_capacity`` is per node.
    """

    def __init__(
        self,
        num_nodes: int = 2,
        schemes: Sequence[str] = ("orangefs", "orangefs-bb", "ssdup", "ssdup+"),
        policy: str = "round-robin-app",
        stream_len: int = DEFAULT_STREAM_LEN,
        ssd_capacity: int = 8 << 30,
        hdd=None,
        ssd=None,
        link=None,
        interference=None,
        flush_gate: float | str = 0.5,
        adaptive_window: int = 64,
        threshold_warmup: Sequence[float] | None = None,
        device=None,
    ):
        if num_nodes < 1:
            raise ValueError(f"num_nodes must be >= 1, got {num_nodes}")
        if policy not in TRACE_POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; choose from {sorted(TRACE_POLICIES)}"
            )
        unknown = [s for s in schemes if s not in ed.SCHEME_IDS]
        if unknown:
            raise ValueError(f"unknown schemes {unknown}")
        self.device = resolve_device(device)
        self.num_nodes = num_nodes
        self.schemes = tuple(schemes)
        self.policy = policy
        self.stream_len = stream_len
        self.ssd_capacity = ssd_capacity
        self.hdd = hdd
        self.ssd = (make_storage_model(ssd, logical_bytes=ssd_capacity)
                    if isinstance(ssd, str) else ssd)
        self.link = link
        self.interference = interference
        self.flush_gate = flush_gate
        self.adaptive_window = adaptive_window
        self.threshold_warmup = threshold_warmup
        # tapes are pure functions of the trace: repeat sweeps of the same
        # TraceBatch reuse them.  Keyed by identity, with the batch kept
        # alive so a recycled id can never alias another trace.
        self._tape_cache: tuple[TraceBatch, list, list] | None = None

    def shard(self, batch: TraceBatch) -> list[TraceBatch]:
        assignment = assign_nodes(
            self.policy, batch.offsets, batch.file_ids, batch.app_ids,
            self.num_nodes,
        )
        return batch.shard(assignment, self.num_nodes)

    def _tapes(self, batch: TraceBatch) -> tuple[list, list]:
        if self._tape_cache is not None and self._tape_cache[0] is batch:
            return self._tape_cache[1], self._tape_cache[2]
        shards = self.shard(batch)
        scores = _score_shards_kernel(shards, self.stream_len, self.device)
        tapes = [
            ed.build_events(shard, sc, stream_len=self.stream_len,
                            hdd=self.hdd, ssd=self.ssd, link=self.link)
            for shard, sc in zip(shards, scores)
        ]
        per_app = [ed.per_app_bytes(shard) for shard in shards]
        self._tape_cache = (batch, tapes, per_app)
        return tapes, per_app

    def run(self, trace: TraceBatch | Sequence[TraceItem]) -> dict[str, FleetResult]:
        """Replay every ``scheme x node`` lane in one device program.

        Accuracy contract: each lane is within the device engine's
        ``DEVICE_TOLERANCES`` tiers of the batched NumPy oracle, and
        bit-equal to replaying that lane alone.
        """

        batch = trace if isinstance(trace, TraceBatch) else TraceBatch.from_items(trace)
        tapes, per_app = self._tapes(batch)
        n = self.num_nodes
        # lane order is scheme-major: lane s * N + n replays shard n under
        # scheme s (every scheme reuses the same N tapes)
        events = ed.stack_events([tapes[i] for _ in self.schemes for i in range(n)])
        lanes = ed._stack_lanes([
            ed.lane_consts(s, self.ssd_capacity, self.flush_gate, ssd=self.ssd)
            for s in self.schemes for _ in range(n)
        ])
        state0 = ed._stack_lanes([
            ed.initial_lane_state(s, self.adaptive_window, self.threshold_warmup,
                                  ssd=self.ssd)
            for s in self.schemes for _ in range(n)
        ])
        out = ed.replay_lanes(events, lanes, state0, hdd=self.hdd,
                              interference=self.interference, device=self.device)
        return {
            scheme: FleetResult(
                scheme=scheme, policy=self.policy, num_nodes=n,
                node_results=tuple(
                    ed.lane_result(out, si * n + i, scheme, per_app[i])
                    for i in range(n)
                ),
            )
            for si, scheme in enumerate(self.schemes)
        }
