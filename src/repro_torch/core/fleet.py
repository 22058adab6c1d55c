"""Fleet replays: shard one trace over N I/O nodes and replay every shard.

* :class:`FleetSimulator` — one scheme, every node replayed by the host
  engines of :class:`~repro_torch.core.simulator.IONodeSimulator` (or its
  device engine), bit-identical to the reference's.
* :class:`FleetProgram` — every ``scheme x node`` lane in one device
  program (:func:`~repro_torch.core.engine_device.replay_lanes`), within
  ``DEVICE_TOLERANCES`` of the host engines.

Both score every shard once, all shards in one launch of the CUDA stream
kernel (``score_backend="kernel"``, the default; its plain version on the
CPU) or with the NumPy oracle (``score_backend="numpy"``).  Both run on
``device`` (``None``: the CUDA card, raising without one; ``"cpu"``).

Aggregation matches the paper's accounting: the fleet's I/O time is the
straggler's (applications block on their slowest I/O server), aggregate
throughput is total bytes over that time, and ``load_imbalance`` is
max-over-mean node bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .. import tracing
from ..analysis import sanitize as _sanitize
from ..device import resolve_device
from ..distributed.sharding import TRACE_POLICIES, assign_nodes
from . import engine_device as ed
from .device_model import clone_storage, make_storage_model
from .random_factor import DEFAULT_STREAM_LEN
from .simulator import IONodeSimulator, SimResult
from .trace import (
    SCORE_BACKENDS,
    StreamScores,
    TraceBatch,
    TraceItem,
    _score_shards_kernel,
    compute_stream_scores,
)


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
    def ssd_byte_ratio(self) -> float:
        return self.bytes_to_ssd / self.total_bytes if self.total_bytes else 0.0

    @property
    def io_seconds(self) -> float:
        """Fleet I/O time = the straggler node's I/O time."""

        return max((r.io_seconds for r in self.node_results), default=0.0)

    @property
    def total_seconds(self) -> float:
        return max((r.total_seconds for r in self.node_results), default=0.0)

    @property
    def straggler(self) -> int:
        """Index of the node whose I/O time bounds the fleet."""

        secs = [r.io_seconds for r in self.node_results]
        return int(np.argmax(secs)) if secs else 0

    @property
    def throughput_mbs(self) -> float:
        """Aggregate fleet throughput (bytes over straggler time)."""

        t = self.io_seconds
        return self.total_bytes / t / 1e6 if t else 0.0

    @property
    def node_throughputs_mbs(self) -> tuple[float, ...]:
        return tuple(r.throughput_mbs for r in self.node_results)

    @property
    def node_bytes(self) -> tuple[int, ...]:
        return tuple(r.total_bytes for r in self.node_results)

    @property
    def load_imbalance(self) -> float:
        """max / mean of per-node byte loads; 1.0 = perfectly balanced."""

        if not self.node_results or not self.total_bytes:
            return 1.0
        loads = np.asarray(self.node_bytes, dtype=np.float64)
        return float(loads.max() / loads.mean())


def _check_policy(policy: str, score_backend: str) -> None:
    if policy not in TRACE_POLICIES:
        raise ValueError(
            f"unknown policy {policy!r}; choose from {sorted(TRACE_POLICIES)}"
        )
    if score_backend not in SCORE_BACKENDS:
        raise ValueError(
            f"score_backend must be one of {SCORE_BACKENDS}, got {score_backend!r}"
        )


def _score_all(batches: Sequence[TraceBatch], stream_len: int, backend: str,
               device) -> list[StreamScores]:
    """Every batch's scores: one kernel launch for all of them, or the
    NumPy oracle batch by batch."""

    if backend == "kernel":
        return _score_shards_kernel(batches, stream_len, device)
    return [compute_stream_scores(b, stream_len, backend="numpy") for b in batches]


class FleetSimulator:
    """Shard one arrival trace over N I/O nodes and replay each shard.

    ``node_kwargs`` pass through to every node's
    :class:`~repro_torch.core.simulator.IONodeSimulator` (``ssd_capacity``
    is per node; a stateful ``ssd`` is cloned per node).  Every shard is
    scored up front, all in one kernel launch.

    ``threshold_scope="fleet"`` warm-starts each node's PercentList with
    the whole trace's stream percentages in arrival order (scored in the
    same launch as the shards); ``"node"`` (default) starts every node
    cold on its own shard.
    """

    def __init__(
        self,
        num_nodes: int = 2,
        scheme: str = "ssdup+",
        policy: str = "round-robin-app",
        stream_len: int = DEFAULT_STREAM_LEN,
        score_backend: str = "kernel",
        threshold_scope: str = "node",
        device=None,
        **node_kwargs,
    ):
        if num_nodes < 1:
            raise ValueError(f"num_nodes must be >= 1, got {num_nodes}")
        if threshold_scope not in ("node", "fleet"):
            raise ValueError(
                f"threshold_scope must be 'node' or 'fleet', got {threshold_scope!r}"
            )
        if threshold_scope == "fleet" and "threshold_warmup" in node_kwargs:
            raise ValueError(
                "threshold_scope='fleet' derives each node's threshold_warmup "
                "from the global trace; passing an explicit threshold_warmup "
                "is ambiguous"
            )
        _check_policy(policy, score_backend)
        self.device = resolve_device(device)
        self.num_nodes = num_nodes
        self.scheme = scheme
        self.policy = policy
        self.stream_len = stream_len
        self.score_backend = score_backend
        self.threshold_scope = threshold_scope
        self.node_kwargs = node_kwargs

    def assignment(self, batch: TraceBatch) -> np.ndarray:
        """Per-request node assignment under the policy."""

        return assign_nodes(
            self.policy, batch.offsets, batch.file_ids, batch.app_ids,
            self.num_nodes,
        )

    def shard(self, batch: TraceBatch) -> list[TraceBatch]:
        """Partition a batch into per-node sub-batches under the policy."""

        return batch.shard(self.assignment(batch), self.num_nodes)

    def run(self, trace: TraceBatch | Sequence[TraceItem]) -> FleetResult:
        """Shard ``trace`` and replay every node with the per-node engine.

        Accuracy contract: the node engine's (bit-identical to the
        per-request oracle for the host engines, ``DEVICE_TOLERANCES``
        for ``engine="device"``); nodes reduce in index order.
        """

        batch = trace if isinstance(trace, TraceBatch) else TraceBatch.from_items(trace)
        shards = self.shard(batch)
        if _sanitize.resolve(self.node_kwargs.get("sanitize")):
            # sharding must conserve the trace: every request on one node
            n_req = sum(s.num_requests for s in shards)
            _sanitize.check(
                n_req == batch.num_requests,
                "sharding dropped/duplicated requests: %d across shards "
                "vs %d offered", n_req, batch.num_requests,
            )
            n_bytes = sum(s.total_bytes for s in shards)
            _sanitize.check(
                n_bytes == batch.total_bytes,
                "sharding dropped/duplicated bytes: %d across shards "
                "vs %d offered", n_bytes, batch.total_bytes,
            )
        warm = self.threshold_scope == "fleet" and self.scheme in ("ssdup", "ssdup+")
        scores = _score_all(shards + [batch] * warm, self.stream_len,
                            self.score_backend, self.device)
        node_kwargs = dict(self.node_kwargs)
        if warm:
            node_kwargs["threshold_warmup"] = tuple(float(p) for p in scores[-1].percentage)
        results = []
        for shard, sc in zip(shards, scores):
            kw = dict(node_kwargs)
            if "ssd" in kw:
                # each I/O server has its own device: no shared FTL state
                kw["ssd"] = clone_storage(kw["ssd"])
            node = IONodeSimulator(
                scheme=self.scheme, stream_len=self.stream_len,
                score_backend=self.score_backend, device=self.device, **kw,
            )
            results.append(node.run(shard, scores=sc))
        return FleetResult(
            scheme=self.scheme, policy=self.policy, num_nodes=self.num_nodes,
            node_results=tuple(results),
        )


class FleetProgram:
    """One device sweep over the whole shard matrix.

    Every shard is scored once, all shards in one launch of the CUDA
    kernel (or its plain version on the CPU, or the NumPy oracle with
    ``score_backend="numpy"``), and lowered to an event tape; tapes are
    scheme-independent, so one lane per ``scheme x node`` replays them all
    in a single :func:`~repro_torch.core.engine_device.replay_lanes` call.
    ``device=None`` runs on the CUDA card and raises without one; pass
    ``device="cpu"`` to run on the CPU.  ``ssd_capacity`` is per node.
    ``ssd="ftl"`` resolves once to an FTL model whose geometry every lane
    shares; each lane carries its own FTL columns in its state.
    """

    def __init__(
        self,
        num_nodes: int = 2,
        schemes: Sequence[str] = ("orangefs", "orangefs-bb", "ssdup", "ssdup+"),
        policy: str = "round-robin-app",
        stream_len: int = DEFAULT_STREAM_LEN,
        score_backend: str = "kernel",
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
        _check_policy(policy, score_backend)
        unknown = [s for s in schemes if s not in ed.SCHEME_IDS]
        if unknown:
            raise ValueError(f"unknown schemes {unknown}")
        self.device = resolve_device(device)
        self.num_nodes = num_nodes
        self.schemes = tuple(schemes)
        self.policy = policy
        self.stream_len = stream_len
        self.score_backend = score_backend
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
            tracing.count("tape_cache.hit")
            return self._tape_cache[1], self._tape_cache[2]
        tracing.count("tape_cache.miss")
        with tracing.span("shard"):
            shards = self.shard(batch)
        with tracing.span("score"):
            scores = _score_all(shards, self.stream_len, self.score_backend, self.device)
        with tracing.span("tapes"):
            tapes = [
                ed.build_events(shard, sc, stream_len=self.stream_len,
                                hdd=self.hdd, ssd=self.ssd, link=self.link,
                                device=self.device)
                for shard, sc in zip(shards, scores)
            ]
            per_app = [ed.per_app_bytes(shard) for shard in shards]
        self._tape_cache = (batch, tapes, per_app)
        return tapes, per_app

    def _lane_inputs(self, batch: TraceBatch) -> tuple[dict, dict, dict, list]:
        """The stacked tape, lane constants and initial states of every
        lane (NumPy, scheme-major: lane s * N + n replays shard n under
        scheme s, every scheme reusing the same N tapes), and each shard's
        bytes per app."""

        tapes, per_app = self._tapes(batch)
        n = self.num_nodes
        with tracing.span("stack"):
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
        return events, lanes, state0, per_app

    def _replay(self, batch: TraceBatch) -> tuple[dict, list]:
        """``replay_lanes``' raw per-lane outputs (FTL relocations and live
        pages too) and each shard's bytes per app."""

        events, lanes, state0, per_app = self._lane_inputs(batch)
        out = ed.replay_lanes(events, lanes, state0, hdd=self.hdd,
                              interference=self.interference, device=self.device)
        return out, per_app

    def run(self, trace: TraceBatch | Sequence[TraceItem]) -> dict[str, FleetResult]:
        """Replay every ``scheme x node`` lane in one device program.

        Accuracy contract: each lane is within the device engine's
        ``DEVICE_TOLERANCES`` tiers of the batched NumPy oracle, and
        bit-equal to replaying that lane alone.
        """

        batch = trace if isinstance(trace, TraceBatch) else TraceBatch.from_items(trace)
        with tracing.span("sweep"):
            out, per_app = self._replay(batch)
            n = self.num_nodes
            with tracing.span("results"):
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


def run_fleet_schemes(
    trace: TraceBatch | Sequence[TraceItem],
    num_nodes: int = 2,
    schemes: Sequence[str] = ("orangefs", "orangefs-bb", "ssdup", "ssdup+"),
    policy: str = "round-robin-app",
    **kwargs,
) -> dict[str, FleetResult]:
    """Fleet counterpart of :func:`~repro_torch.core.simulator.run_schemes`
    (one :class:`FleetSimulator` per scheme; ``device`` and
    ``score_backend`` pass through).  Accuracy contract: the same as
    :meth:`FleetSimulator.run`."""

    batch = trace if isinstance(trace, TraceBatch) else TraceBatch.from_items(trace)
    return {
        s: FleetSimulator(num_nodes=num_nodes, scheme=s, policy=policy, **kwargs).run(batch)
        for s in schemes
    }
