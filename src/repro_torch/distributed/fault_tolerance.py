"""Fault-tolerance runtime: heartbeats, straggler detection, elastic plan.

The port's copy of the reference's state machines, plain Python.  Every
host heartbeats a :class:`HeartbeatTable`; the controller's view marks a
host dead after ``timeout`` and flags stragglers by a robust median rule
on step durations.  :class:`FaultToleranceController` turns the table into
recovery actions (``restart_from_checkpoint``, ``rejoin``,
``steal_shard``), which the burst-buffer service
(:mod:`repro_torch.service.loop`) executes as failover, rejoin and
rebalancing.  The clock is injected, so tests drive time explicitly.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Callable


@dataclasses.dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    window: int = 64
    step_durations: collections.deque = None  # deque[float], maxlen=window
    alive: bool = True

    def __post_init__(self):
        # step history is an O(1) bounded ring, not a list with pop(0)
        if self.step_durations is None:
            self.step_durations = collections.deque(maxlen=self.window)
        elif not isinstance(self.step_durations, collections.deque):
            self.step_durations = collections.deque(
                self.step_durations, maxlen=self.window
            )

    def record_step(self, seconds: float) -> None:
        self.step_durations.append(seconds)


class HeartbeatTable:
    """Controller-side liveness + straggler view.

    Liveness is a pure function of ``now - last_heartbeat``: a host that
    misses the timeout shows up in :meth:`dead_hosts`, and a LATE heartbeat
    revives it — callers never need to re-register.  (``register`` is only
    for admitting a brand-new host; it resets the step history.)
    """

    def __init__(self, timeout: float = 30.0,
                 straggler_factor: float = 1.5,
                 clock: Callable[[], float] | None = None,
                 step_window: int = 64):
        self.timeout = timeout
        self.straggler_factor = straggler_factor
        self.clock = clock or (lambda: 0.0)
        self.step_window = step_window
        self.hosts: dict[int, HostState] = {}

    def register(self, host_id: int) -> None:
        self.hosts[host_id] = HostState(host_id, self.clock(),
                                        window=self.step_window)

    def heartbeat(self, host_id: int, step_seconds: float | None = None) -> None:
        h = self.hosts[host_id]
        h.last_heartbeat = self.clock()
        h.alive = True  # a late heartbeat revives a declared-dead host
        if step_seconds is not None:
            h.record_step(step_seconds)

    def dead_hosts(self) -> list[int]:
        now = self.clock()
        out = []
        for h in self.hosts.values():
            timed_out = now - h.last_heartbeat > self.timeout
            h.alive = not timed_out
            if timed_out:
                out.append(h.host_id)
        return sorted(out)

    def stragglers(self) -> list[int]:
        """Hosts whose median step exceeds straggler_factor x fleet p95-of-
        medians floor (robust to a few noisy samples)."""

        meds = {
            h.host_id: statistics.median(h.step_durations)
            for h in self.hosts.values()
            if h.alive and len(h.step_durations) >= 4
        }
        if len(meds) < 4:
            return []
        fleet = statistics.median(meds.values())
        return sorted(
            hid for hid, m in meds.items() if m > self.straggler_factor * fleet
        )


@dataclasses.dataclass(frozen=True)
class Topology:
    pods: int
    data: int
    model: int

    @property
    def n_hosts(self) -> int:
        return self.pods * self.data * self.model

    def global_batch_shards(self) -> int:
        return self.pods * self.data


class ElasticPlan:
    """Shrink/grow plan when hosts die: keep the model axis intact (TP
    groups must be complete), drop whole data-parallel replicas.

    The plan is ANCHORED at the original topology: ``replan(dead)`` is a
    pure, idempotent function of the *complete* dead set, with host ids
    always interpreted in the original (pod, data, model) row-major
    layout.  Reporting the same dead set twice yields the same topology
    (the historical bug was a caller rebasing the plan on the shrunken
    topology, so a host reported twice shrank the fleet twice), and a
    SMALLER dead set (a revived host) grows the topology back.
    """

    def __init__(self, topo: Topology):
        self.topo = topo  # the original topology; never rebased

    def dead_replicas(self, dead: list[int]) -> set[int]:
        """Map dead host ids to (pod, data) replica indices."""

        return {hid // self.topo.model for hid in dead}

    def replan(self, dead: list[int]) -> Topology:
        """Topology with every replica holding a dead host dropped."""

        if not dead:
            return self.topo
        dead_replicas = self.dead_replicas(dead)
        total_replicas = self.topo.pods * self.topo.data
        remaining = total_replicas - len(dead_replicas)
        if remaining <= 0:
            raise RuntimeError("no data replicas left; cannot shrink further")
        # keep the pod structure if divisible, else collapse to one pod
        if remaining % self.topo.pods == 0:
            return Topology(self.topo.pods, remaining // self.topo.pods,
                            self.topo.model)
        return Topology(1, remaining, self.topo.model)


@dataclasses.dataclass
class RecoveryAction:
    kind: str  # "restart_from_checkpoint" | "rejoin" | "steal_shard" | "none"
    detail: dict


class FaultToleranceController:
    """Glue: observe table, emit recovery actions.

    Consumed by the trainer (restart-from-checkpoint under a smaller
    mesh) AND by the burst-buffer service layer
    (:mod:`repro_torch.service.loop`), which maps ``restart_from_checkpoint``
    to I/O-node failover (reshard + backlog replay) and ``steal_shard``
    to LBICA-style hot-stream rebalancing off the straggler.

    ``tick`` is safe to call every epoch: the elastic plan stays
    anchored at the original topology (idempotent under a repeated dead
    set), actions fire only when the dead set CHANGES, and a revived
    host (late heartbeat) grows the topology back with a ``rejoin``
    action.
    """

    def __init__(self, table: HeartbeatTable, topo: Topology):
        self.table = table
        self.plan = ElasticPlan(topo)  # anchored; never rebased
        self.initial_topo = topo
        self.topo = topo
        self._dead: tuple[int, ...] = ()

    def tick(self) -> list[RecoveryAction]:
        actions: list[RecoveryAction] = []
        dead = tuple(self.table.dead_hosts())
        if dead != self._dead:
            newly_dead = sorted(set(dead) - set(self._dead))
            revived = sorted(set(self._dead) - set(dead))
            new_topo = self.plan.replan(list(dead))
            if newly_dead:
                actions.append(RecoveryAction(
                    "restart_from_checkpoint",
                    {"dead_hosts": list(dead),
                     "newly_dead": newly_dead,
                     "old_topology": dataclasses.asdict(self.topo),
                     "new_topology": dataclasses.asdict(new_topo)},
                ))
            if revived:
                actions.append(RecoveryAction(
                    "rejoin",
                    {"hosts": revived,
                     "old_topology": dataclasses.asdict(self.topo),
                     "new_topology": dataclasses.asdict(new_topo)},
                ))
            self.topo = new_topo
            self._dead = dead
        for hid in self.table.stragglers():
            actions.append(RecoveryAction(
                "steal_shard", {"from_host": hid}))
        return actions
