"""Online, failure-aware burst-buffer service over the fleet engines.

:class:`BurstBufferService` turns the offline fleet replay into a
discrete-event *service*: an offered load (a timestamped
:class:`~repro_torch.core.trace.TraceBatch`, e.g. from
:mod:`repro_torch.service.arrivals`) is sharded across N I/O-node lanes
with the policies the offline :class:`~repro_torch.core.fleet.FleetSimulator`
uses, and each lane replays its windows through the incremental session
API of :class:`~repro_torch.core.simulator.IONodeSimulator` as they
*arrive*: a window starts no earlier than its last request's arrival time
and no earlier than the lane is free.

The failure model drives :mod:`repro_torch.distributed.fault_tolerance`:

* every lane heartbeats the :class:`HeartbeatTable` each epoch with its
  per-window wall times;
* a scripted :class:`~repro_torch.service.injector.FaultInjector` crashes,
  slows, degrades, or stalls lanes mid-run;
* the :class:`FaultToleranceController`'s recovery actions *execute*:
  a death declaration reshards the dead lane's pending windows to
  survivors (:func:`repro_torch.distributed.sharding.reshard_to_survivors`),
  replays its buffered-but-unflushed SSD backlog on the least-loaded
  survivor (Eq. 6 flush costing; with ``replay=False`` the backlog is
  accounted as stranded data loss), a ``steal_shard`` straggler verdict
  moves queued windows off the slow lane (LBICA-style rebalancing), and
  a ``rejoin`` brings a wrongly-declared-dead lane (stall longer than
  the heartbeat timeout) back with a fresh simulator.
* admission control (optional): when a lane's burst buffer is nearly
  full, new windows are redirected to the HDD (``force_hdd``) or
  rejected outright instead of blocking the writer.

Scoring.  A window's scores depend only on its offsets and sizes, and
every window is known before it is replayed: a shard's windows are its
``stream_bounds`` rows, and a failover cuts each survivor's resharded
requests into ``stream_len`` chunks.  So with ``score_backend="kernel"``
(the default) :meth:`BurstBufferService.run` scores every shard's windows
in one launch of the stream kernel on ``device`` (``None``: the CUDA card,
raising without one; ``"cpu"``: the kernel's plain version), each failover
that reshards pending windows scores all survivors' new windows in one
more launch, and every window carries its ``(rf, pct, dist)`` into
``feed_window``.  ``score_backend="numpy"`` leaves each window to the
host oracle inside ``feed_window``, as the reference does.  Both give the
same scores, so the same result.

Two clocks, deliberately separate: each lane's **wall** clock orders
arrivals, faults, and heartbeats; the simulator's internal ``st.clock``
accumulates pure service time exactly as the offline engine does.  A
service run with no fault and no rebalance therefore produces per-node
:class:`SimResult`\\ s **bit-identical** to ``FleetSimulator.run`` on the
same trace.  The straggler rule can fire without any fault, on the lanes'
own imbalance, and then ``steal_shard`` moves windows between lanes.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import numpy as np

from ..analysis import sanitize as _sanitize
from ..core.fleet import FleetResult
from ..core.random_factor import DEFAULT_STREAM_LEN
from ..core.simulator import IONodeSimulator, SimResult
from ..core.trace import SCORE_BACKENDS, TraceBatch, TraceItem, _score_shards_kernel
from ..device import resolve_device
from ..distributed.fault_tolerance import (
    FaultToleranceController,
    HeartbeatTable,
    Topology,
)
from ..distributed.sharding import (
    TRACE_POLICIES,
    assign_nodes,
    reshard_to_survivors,
)

from .injector import FaultEvent, FaultInjector
from .metrics import FaultRecord, ServiceMetrics

ADMISSION_ACTIONS = ("redirect", "reject")


@dataclasses.dataclass
class _Window:
    """One ≤ stream_len request window queued on a lane."""

    offsets: np.ndarray
    sizes: np.ndarray
    file_ids: np.ndarray
    app_ids: np.ndarray
    times: np.ndarray
    scores: tuple[int, float, int] | None = None  # (rf, pct, dist); None: oracle

    def __post_init__(self):
        self.nbytes = int(self.sizes.sum())
        self.ready = float(self.times.max()) if len(self.times) else 0.0


class _Lane:
    """One I/O-node lane: simulator session + wall clock + work queue."""

    def __init__(self, node_id: int, sim: IONodeSimulator):
        self.node_id = node_id
        self.sim = sim
        self.wall = 0.0
        self.queue: collections.deque = collections.deque()
        self.crash_at: float | None = None
        self.declared_dead = False
        self.stall_at = float("inf")
        self.stall_until = 0.0
        self.slow_factor = 1.0
        self.ssd_degraded = False
        self.results: list[SimResult] = []
        self.epoch_steps: list[float] = []

    @property
    def serving(self) -> bool:
        return not self.declared_dead

    def impaired(self, now: float) -> bool:
        return (
            self.crash_at is not None
            or self.declared_dead
            or self.stall_until > now
            or self.slow_factor > 1.0
            or self.ssd_degraded
        )

    def queued_window_bytes(self) -> int:
        return sum(w.nbytes for k, w in self.queue if k == "win")


@dataclasses.dataclass(frozen=True)
class ServiceResult:
    """One scheme's service run: per-node results + service metrics."""

    scheme: str
    policy: str
    num_nodes: int
    node_results: tuple[SimResult, ...]
    metrics: ServiceMetrics

    @property
    def fleet(self) -> FleetResult:
        """The run viewed through the offline aggregate accounting."""

        return FleetResult(
            scheme=self.scheme, policy=self.policy,
            num_nodes=self.num_nodes, node_results=self.node_results,
        )


def _merge_results(scheme: str, results: Sequence[SimResult]) -> SimResult:
    """Fold a lane's session results (salvaged partials + final) into one."""

    if len(results) == 1:
        return results[0]
    per_app: dict[int, int] = {}
    for r in results:
        for a, b in r.per_app_bytes.items():
            per_app[a] = per_app.get(a, 0) + b
    return SimResult(
        scheme=scheme,
        io_seconds=sum(r.io_seconds for r in results),
        total_seconds=sum(r.total_seconds for r in results),
        total_bytes=sum(r.total_bytes for r in results),
        bytes_to_ssd=sum(r.bytes_to_ssd for r in results),
        bytes_to_hdd_direct=sum(r.bytes_to_hdd_direct for r in results),
        flushes=sum(r.flushes for r in results),
        flush_paused_seconds=sum(r.flush_paused_seconds for r in results),
        blocked_seconds=sum(r.blocked_seconds for r in results),
        peak_ssd_occupancy=max(
            (r.peak_ssd_occupancy for r in results), default=0
        ),
        metadata_bytes=sum(r.metadata_bytes for r in results),
        per_app_bytes=per_app,
    )


class BurstBufferService:
    """Discrete-event service loop over N :class:`IONodeSimulator` lanes.

    Parameters mirror :class:`~repro_torch.core.fleet.FleetSimulator`
    (``node_kwargs`` pass through to every lane's simulator;
    ``ssd_capacity`` is per node), plus the service knobs:

    score_backend / device:
        ``"kernel"`` (default) scores every window in the stream kernel
        on ``device`` (``None``: the CUDA card, raising without one;
        ``"cpu"``: its plain version), one launch a run plus one a
        failover that reshards pending windows; ``"numpy"`` scores each
        window on the host (the oracle).  Both pass through to every
        lane's simulator.

    epoch_seconds:
        Wall-clock granularity of the event loop: heartbeats are
        recorded and the fault-tolerance controller ticks once per
        epoch.  Window timing itself is exact (a window's completion is
        its start plus its service time, not rounded to epochs).
    heartbeat_timeout / straggler_factor:
        Passed to :class:`HeartbeatTable` — a lane silent for longer
        than the timeout is declared dead; a lane whose median window
        wall time exceeds ``straggler_factor`` x the fleet median is a
        straggler.
    injector:
        A :class:`FaultInjector` script (None: no faults).
    replay:
        On failover, replay the dead lane's unflushed SSD backlog on the
        least-loaded survivor (True) or account it as stranded data loss
        (False).
    admission_occupancy / admission_action:
        When a lane's buffered SSD bytes reach this fraction of its
        buffer capacity, newly started windows are ``"redirect"``-ed to
        the HDD (served, but bypassing the buffer) or ``"reject"``-ed
        (dropped; the ledger counts them).  None disables admission
        control — required for bit-exact no-fault replay.
    rebalance_fraction:
        Fraction of a straggler's queued windows moved per
        ``steal_shard`` action.
    """

    def __init__(
        self,
        scheme: str = "ssdup+",
        num_nodes: int = 2,
        policy: str = "round-robin-app",
        stream_len: int = DEFAULT_STREAM_LEN,
        epoch_seconds: float = 1.0,
        heartbeat_timeout: float = 5.0,
        straggler_factor: float = 1.5,
        injector: FaultInjector | None = None,
        replay: bool = True,
        admission_occupancy: float | None = None,
        admission_action: str = "redirect",
        rebalance_fraction: float = 0.5,
        max_epochs: int = 1_000_000,
        sanitize: bool | None = None,
        score_backend: str = "kernel",
        device=None,
        **node_kwargs,
    ):
        if num_nodes < 1:
            raise ValueError(f"num_nodes must be >= 1, got {num_nodes}")
        if policy not in TRACE_POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; choose from "
                f"{sorted(TRACE_POLICIES)}"
            )
        if epoch_seconds <= 0:
            raise ValueError("epoch_seconds must be > 0")
        if admission_action not in ADMISSION_ACTIONS:
            raise ValueError(
                f"admission_action must be one of {ADMISSION_ACTIONS}"
            )
        if admission_occupancy is not None and not (
            0 < admission_occupancy <= 1
        ):
            raise ValueError("admission_occupancy must be in (0, 1]")
        if score_backend not in SCORE_BACKENDS:
            raise ValueError(
                f"score_backend must be one of {SCORE_BACKENDS}, "
                f"got {score_backend!r}"
            )
        self.device = resolve_device(device)
        self.score_backend = score_backend
        self.scheme = scheme
        self.num_nodes = num_nodes
        self.policy = policy
        self.stream_len = stream_len
        self.epoch_seconds = epoch_seconds
        self.heartbeat_timeout = heartbeat_timeout
        self.straggler_factor = straggler_factor
        self.injector = injector or FaultInjector()
        self.replay = replay
        self.admission_occupancy = admission_occupancy
        self.admission_action = admission_action
        self.rebalance_fraction = rebalance_fraction
        self.max_epochs = max_epochs
        self.sanitize = _sanitize.resolve(sanitize)
        self.node_kwargs = node_kwargs
        self._now = 0.0

    # ------------------------------------------------------------------
    def _make_sim(self) -> IONodeSimulator:
        sim = IONodeSimulator(
            scheme=self.scheme, stream_len=self.stream_len,
            engine="batched", sanitize=self.sanitize,
            score_backend=self.score_backend, device=self.device,
            **self.node_kwargs,
        )
        sim.begin_session()
        return sim

    def _score(self, batches: Sequence[TraceBatch]) -> list:
        """Per batch, each ``stream_bounds`` window's ``(rf, pct, dist)``:
        all batches in one kernel launch, or ``None`` per window with
        ``score_backend="numpy"`` (``feed_window`` runs the oracle)."""

        if self.score_backend != "kernel":
            return [[None] * b.num_streams(self.stream_len) for b in batches]
        return [
            list(zip(sc.rf_sum, sc.percentage, sc.seek_distance))
            for sc in _score_shards_kernel(batches, self.stream_len, self.device)
        ]

    def _build_queue(
        self, shard: TraceBatch, scores: Sequence
    ) -> collections.deque:
        """Lane work queue with the offline engine's exact gap/stream
        interleaving (``_run_batched``'s fire-before rule); ``scores``
        holds each window's entry of :meth:`_score`."""

        q: collections.deque = collections.deque()
        bounds = shard.stream_bounds(self.stream_len)
        n_streams = len(bounds) - 1 if shard.num_requests else 0
        gp, gs = shard.gap_positions, shard.gap_seconds
        gi, ng = 0, len(gp)
        nreq = shard.num_requests
        for s in range(n_streams):
            a, b = int(bounds[s]), int(bounds[s + 1])
            fire_before = b if b - a == self.stream_len else nreq + 1
            while gi < ng and gp[gi] < fire_before:
                q.append(("gap", float(gs[gi])))
                gi += 1
            q.append(("win", _Window(
                offsets=shard.offsets[a:b], sizes=shard.sizes[a:b],
                file_ids=shard.file_ids[a:b], app_ids=shard.app_ids[a:b],
                times=shard.times[a:b],
                scores=scores[s],
            )))
        while gi < ng:
            q.append(("gap", float(gs[gi])))
            gi += 1
        return q

    # ------------------------------------------------------------------
    def run(self, trace: TraceBatch | Sequence[TraceItem]) -> ServiceResult:
        batch = (
            trace if isinstance(trace, TraceBatch)
            else TraceBatch.from_items(trace)
        )
        metrics = ServiceMetrics(
            scheme=self.scheme, offered_bytes=batch.total_bytes
        )
        shards = batch.shard(
            assign_nodes(
                self.policy, batch.offsets, batch.file_ids, batch.app_ids,
                self.num_nodes,
            ),
            self.num_nodes,
        )
        lanes = []
        for i, (shard, scores) in enumerate(zip(shards, self._score(shards))):
            lane = _Lane(i, self._make_sim())
            lane.queue = self._build_queue(shard, scores)
            lanes.append(lane)

        self._now = 0.0
        table = HeartbeatTable(
            timeout=self.heartbeat_timeout,
            straggler_factor=self.straggler_factor,
            clock=lambda: self._now,
        )
        for lane in lanes:
            table.register(lane.node_id)
        controller = FaultToleranceController(
            table, Topology(pods=1, data=self.num_nodes, model=1)
        )
        events = collections.deque(self.injector.events)
        self._records: dict[tuple[int, str], FaultRecord] = {}

        epochs = 0
        while any(l.queue for l in lanes):
            epochs += 1
            if epochs > self.max_epochs:
                raise RuntimeError(
                    f"service loop exceeded max_epochs={self.max_epochs}"
                )
            epoch_end = self._now + self.epoch_seconds
            while events and events[0].at <= epoch_end:
                self._apply_event(lanes, events.popleft(), metrics)
            degraded = any(l.impaired(self._now) for l in lanes)

            epoch_bytes = 0
            for lane in lanes:
                epoch_bytes += self._advance_lane(lane, epoch_end, metrics)
            self._now = epoch_end
            if degraded:
                metrics.degraded_seconds += self.epoch_seconds
                metrics.degraded_bytes += epoch_bytes
            else:
                metrics.healthy_seconds += self.epoch_seconds
                metrics.healthy_bytes += epoch_bytes

            # -- heartbeats: silent while crashed or stalled ------------
            for lane in lanes:
                if lane.crash_at is not None:
                    continue
                if lane.stall_at <= self._now < lane.stall_until:
                    continue
                if lane.epoch_steps:
                    for dt in lane.epoch_steps:
                        table.heartbeat(lane.node_id, dt)
                else:
                    table.heartbeat(lane.node_id)
                lane.epoch_steps.clear()

            # -- detection + recovery -----------------------------------
            try:
                actions = controller.tick()
            except RuntimeError:
                # no data replicas left: total outage
                self._total_outage(lanes, metrics)
                break
            for action in actions:
                if action.kind == "restart_from_checkpoint":
                    for hid in action.detail["newly_dead"]:
                        self._failover(lanes, hid, metrics)
                elif action.kind == "rejoin":
                    for hid in action.detail["hosts"]:
                        self._rejoin(lanes, hid)
                elif action.kind == "steal_shard":
                    self._rebalance(
                        lanes, action.detail["from_host"], metrics
                    )

        # -- finalize: drain surviving sessions -------------------------
        for lane in lanes:
            if lane.sim._session is not None:
                res = lane.sim.end_session(drain=True)
                lane.results.append(res)
                self._account_session(lane.sim, res, 0, metrics)
        metrics.makespan_seconds = max((l.wall for l in lanes), default=0.0)
        if self.sanitize:
            violations = metrics.conservation_violations()
            _sanitize.check(
                not violations,
                "service byte ledger violated: %s", "; ".join(violations),
            )
        return ServiceResult(
            scheme=self.scheme,
            policy=self.policy,
            num_nodes=self.num_nodes,
            node_results=tuple(
                _merge_results(self.scheme, lane.results) for lane in lanes
            ),
            metrics=metrics,
        )

    # ------------------------------------------------------------------
    def _advance_lane(
        self, lane: _Lane, epoch_end: float, metrics: ServiceMetrics
    ) -> int:
        """Run the lane's queue until nothing more can START this epoch."""

        if not lane.serving:
            return 0
        done = 0
        while lane.queue:
            kind, payload = lane.queue[0]
            if kind == "gap":
                start = lane.wall
            else:
                start = max(lane.wall, payload.ready)
            if lane.stall_at <= start < lane.stall_until:
                start = lane.stall_until
            if lane.crash_at is not None and start >= lane.crash_at:
                break  # the node died before this item could start
            if start >= epoch_end:
                break
            if kind == "gap":
                lane.sim.feed_gap(payload)
                lane.wall = start + payload
                lane.queue.popleft()
                continue
            win: _Window = payload
            force_hdd = False
            if self.admission_occupancy is not None and self._overloaded(
                lane.sim
            ):
                if self.admission_action == "reject":
                    metrics.rejected_bytes += win.nbytes
                    lane.queue.popleft()
                    continue
                force_hdd = True
                metrics.redirected_bytes += win.nbytes
            dt = lane.sim.feed_window(
                win.offsets, win.sizes, win.file_ids, win.app_ids,
                force_hdd=force_hdd, scores=win.scores,
            )
            wall_dt = dt * lane.slow_factor
            lane.wall = start + wall_dt
            lane.epoch_steps.append(wall_dt)
            metrics.completed_bytes += win.nbytes
            metrics.record_latencies(lane.wall - win.times)
            done += win.nbytes
            lane.queue.popleft()
        return done

    def _overloaded(self, sim: IONodeSimulator) -> bool:
        if sim.pipeline is None:
            return False
        cap = sum(r.capacity for r in sim.pipeline.regions)
        return sim.pipeline.buffered_bytes >= self.admission_occupancy * cap

    # ------------------------------------------------------------------
    def _apply_event(
        self, lanes: list[_Lane], ev: FaultEvent, metrics: ServiceMetrics
    ) -> None:
        lane = lanes[ev.node]
        record = FaultRecord(kind=ev.kind, node=ev.node, injected_at=ev.at)
        self._records[(ev.node, ev.kind)] = record
        metrics.faults.append(record)
        if ev.kind == "crash":
            lane.crash_at = ev.at
        elif ev.kind == "slow":
            lane.slow_factor = ev.factor
        elif ev.kind == "ssd_degrade":
            # delegated to the storage model: the constant backend returns
            # a scaled copy, the FTL slows t_prog/t_erase/read_bw in place
            # (preserving identity, so pipeline trim hooks keep working)
            lane.sim.ssd = lane.sim.ssd.degraded(ev.factor)
            lane.ssd_degraded = True
        elif ev.kind == "stall":
            lane.stall_at = ev.at
            lane.stall_until = ev.at + ev.duration

    # ------------------------------------------------------------------
    def _salvage(
        self, lane: _Lane, metrics: ServiceMetrics
    ) -> tuple[int, float]:
        """End a dead lane's session without the final drain; returns
        ``(outstanding_bytes, replay_seconds)`` of the unflushed
        backlog (Eq. 6 costing)."""

        if lane.sim._session is None:
            return 0, 0.0
        partial = lane.sim.end_session(drain=False)
        lane.results.append(partial)
        pipe = lane.sim.pipeline
        outstanding = 0
        replay_dt = 0.0
        if pipe is not None:
            storage = lane.sim.ssd if lane.sim.ssd_stateful else None
            for job in pipe.drain():
                outstanding += job.bytes_left
                replay_dt += job.bytes_left / job.effective_rate(
                    lane.sim.hdd, storage
                )
        self._account_session(lane.sim, partial, outstanding, metrics)
        return outstanding, replay_dt

    def _account_session(
        self,
        sim: IONodeSimulator,
        res: SimResult,
        outstanding: int,
        metrics: ServiceMetrics,
    ) -> None:
        """Fold one session into the SSD byte ledger.  ``deduped`` is the
        log-structure savings: appended bytes whose extents were
        superseded before they were flushed."""

        metrics.written_ssd_bytes += res.bytes_to_ssd
        metrics.written_hdd_bytes += res.bytes_to_hdd_direct
        if sim.pipeline is None:
            return
        flushed = sim.pipeline.total_flushed_bytes
        metrics.flushed_bytes += flushed
        metrics.deduped_bytes += res.bytes_to_ssd - flushed - outstanding

    def _failover(
        self, lanes: list[_Lane], hid: int, metrics: ServiceMetrics
    ) -> None:
        lane = lanes[hid]
        if lane.declared_dead:
            return
        lane.declared_dead = True
        record = (
            self._records.get((hid, "crash"))
            or self._records.get((hid, "stall"))
        )
        if record is not None and record.detected_at is None:
            record.detected_at = self._now

        outstanding, replay_dt = self._salvage(lane, metrics)
        survivors = [
            l for l in lanes
            if l is not lane and l.crash_at is None and not l.declared_dead
        ]
        recovered = self._now
        if outstanding:
            if self.replay and survivors:
                takeover = min(survivors, key=lambda l: l.wall)
                takeover.wall = max(takeover.wall, self._now) + replay_dt
                recovered = self._now + replay_dt
                metrics.replayed_bytes += outstanding
                if record is not None:
                    record.replayed_bytes = outstanding
            else:
                metrics.stranded_bytes += outstanding
                if record is not None:
                    record.stranded_bytes = outstanding
        if record is not None:
            record.recovered_at = recovered

        # -- reshard the dead lane's pending windows to survivors -------
        wins = [w for k, w in lane.queue if k == "win"]
        lane.queue.clear()  # survivors hold their own copies of the gaps
        if not wins:
            return
        offs = np.concatenate([w.offsets for w in wins])
        szs = np.concatenate([w.sizes for w in wins])
        fids = np.concatenate([w.file_ids for w in wins])
        aids = np.concatenate([w.app_ids for w in wins])
        tms = np.concatenate([w.times for w in wins])
        if not survivors:
            metrics.unserved_bytes += int(szs.sum())
            return
        new_assign = reshard_to_survivors(
            self.policy, offs, fids, aids,
            np.full(len(offs), hid, dtype=np.int64),
            [l.node_id for l in survivors],
        )
        # one gap-free batch per survivor: its stream_bounds are the
        # stream_len chunks below, so one launch scores every new window
        parts = [
            TraceBatch.from_numpy(
                offsets=offs[idx], sizes=szs[idx], file_ids=fids[idx],
                app_ids=aids[idx], times=tms[idx],
            )
            for idx in (
                np.nonzero(new_assign == surv.node_id)[0] for surv in survivors
            )
        ]
        for surv, part, scores in zip(survivors, parts, self._score(parts)):
            for w, a in enumerate(range(0, part.num_requests, self.stream_len)):
                sel = slice(a, a + self.stream_len)
                surv.queue.append(("win", _Window(
                    offsets=part.offsets[sel], sizes=part.sizes[sel],
                    file_ids=part.file_ids[sel], app_ids=part.app_ids[sel],
                    times=part.times[sel], scores=scores[w],
                )))

    def _rejoin(self, lanes: list[_Lane], hid: int) -> None:
        """A declared-dead lane heartbeats again (stall ended): bring it
        back with a fresh simulator (restarted daemon, cold detector)."""

        lane = lanes[hid]
        if not lane.declared_dead or lane.crash_at is not None:
            return
        lane.declared_dead = False
        lane.sim = self._make_sim()
        record = self._records.get((hid, "stall"))
        if record is not None:
            record.recovered_at = self._now

    def _rebalance(
        self, lanes: list[_Lane], hid: int, metrics: ServiceMetrics
    ) -> None:
        """LBICA-style: move the tail of a straggler's queued windows to
        the least-loaded healthy lane."""

        lane = lanes[hid]
        if not lane.serving or lane.crash_at is not None:
            return
        for kind in ("slow", "ssd_degrade"):
            record = self._records.get((hid, kind))
            if record is not None and record.detected_at is None:
                record.detected_at = self._now
        targets = [
            l for l in lanes
            if l is not lane and l.serving and l.crash_at is None
            and l.slow_factor == 1.0 and not l.ssd_degraded
            and l.stall_until <= self._now
        ]
        if not targets:
            return
        n_wins = sum(1 for k, _ in lane.queue if k == "win")
        k = int(n_wins * self.rebalance_fraction)
        if k < 1:
            return
        target = min(
            targets, key=lambda l: (l.wall + l.queued_window_bytes(), l.node_id)
        )
        moved: list[_Window] = []
        while k and lane.queue and lane.queue[-1][0] == "win":
            moved.append(lane.queue.pop()[1])
            k -= 1
        for w in reversed(moved):  # keep arrival order on the target
            target.queue.append(("win", w))
            metrics.rebalanced_bytes += w.nbytes

    def _total_outage(
        self, lanes: list[_Lane], metrics: ServiceMetrics
    ) -> None:
        """Every lane is dead: strand open sessions, drop queued work."""

        for lane in lanes:
            if lane.sim._session is not None:
                outstanding, _ = self._salvage(lane, metrics)
                metrics.stranded_bytes += outstanding
            metrics.unserved_bytes += lane.queued_window_bytes()
            lane.queue.clear()


def run_service_schemes(
    trace: TraceBatch | Sequence[TraceItem],
    schemes: Sequence[str] = ("orangefs", "orangefs-bb", "ssdup", "ssdup+"),
    **kwargs,
) -> dict[str, ServiceResult]:
    """Run the same offered load + fault script under several schemes —
    the paper's comparison set, *under failure*."""

    return {
        s: BurstBufferService(scheme=s, **kwargs).run(trace) for s in schemes
    }
