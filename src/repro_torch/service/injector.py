"""Scripted, seeded fault injection for the burst-buffer service.

A :class:`FaultInjector` is an immutable, time-ordered script of
:class:`FaultEvent`\\ s the service loop applies as its wall clock passes
each event's timestamp.  Four fault kinds cover the failure modes an
I/O-node fleet actually sees:

* ``crash``       — the node stops instantly and permanently: heartbeats
  cease, buffered-but-unflushed SSD bytes are stranded (or replayed on a
  takeover node), queued work is resharded to survivors once the
  heartbeat timeout declares the node dead.
* ``slow``        — a straggler: every window's wall time is multiplied
  by ``factor`` (CPU contention, a failing NIC).  Detected by the
  heartbeat table's p95-of-medians straggler rule, answered with
  LBICA-style rebalancing.
* ``ssd_degrade`` — the node's SSD loses bandwidth (``factor`` < 1:
  a dying drive, internal GC storms).  Unlike ``slow`` this changes the
  *service* math — the node genuinely writes slower from that point on.
* ``stall``       — a transient full stop for ``duration`` seconds (GC
  pause, network partition).  A stall shorter than the heartbeat
  timeout is invisible to the controller; a longer one triggers a
  (correct!) death declaration, failover, and a ``rejoin`` when the
  node's heartbeats resume.

Scripts are either hand-written (deterministic scenario tests) or drawn
from a seeded generator (:meth:`FaultInjector.random`) for randomized
robustness sweeps — same seed, same scenario.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

FAULT_KINDS = ("crash", "slow", "ssd_degrade", "stall")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault.

    ``factor`` is the wall-time multiplier for ``slow`` (> 1) and the
    bandwidth multiplier for ``ssd_degrade`` (< 1); ``duration`` is the
    stall length for ``stall`` (ignored otherwise).
    """

    at: float
    kind: str
    node: int
    factor: float = 1.0
    duration: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; choose from {FAULT_KINDS}"
            )
        if self.at < 0:
            raise ValueError(f"fault time must be >= 0, got {self.at}")
        if self.kind == "slow" and self.factor <= 1.0:
            raise ValueError("slow faults need factor > 1")
        if self.kind == "ssd_degrade" and not (0 < self.factor < 1.0):
            raise ValueError("ssd_degrade needs 0 < factor < 1")
        if self.kind == "stall" and self.duration <= 0:
            raise ValueError("stall faults need duration > 0")


class FaultInjector:
    """An immutable, time-sorted fault script."""

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self.events: tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.at, e.node, e.kind))
        )

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    # -- convenience constructors --------------------------------------
    @classmethod
    def crash_at(cls, t: float, node: int) -> "FaultInjector":
        return cls([FaultEvent(at=t, kind="crash", node=node)])

    @classmethod
    def random(
        cls,
        seed: int,
        num_nodes: int,
        horizon_seconds: float,
        crashes: int = 1,
        slows: int = 0,
        degrades: int = 0,
        stalls: int = 0,
        slow_factor: float = 3.0,
        degrade_factor: float = 0.25,
        stall_seconds: float = 10.0,
    ) -> "FaultInjector":
        """Seeded random scenario: the given number of each fault kind at
        uniform times over ``[0, horizon_seconds)`` on distinct uniform
        nodes (nodes may repeat across kinds, not within one kind)."""

        rng = np.random.default_rng(seed)
        events: list[FaultEvent] = []
        for kind, count in (
            ("crash", crashes), ("slow", slows),
            ("ssd_degrade", degrades), ("stall", stalls),
        ):
            if count <= 0:
                continue
            if count > num_nodes:
                raise ValueError(
                    f"{count} {kind} faults on {num_nodes} nodes"
                )
            nodes = rng.choice(num_nodes, size=count, replace=False)
            times = rng.uniform(0.0, horizon_seconds, size=count)
            for node, t in zip(nodes, times):
                events.append(FaultEvent(
                    at=float(t), kind=kind, node=int(node),
                    factor=(
                        slow_factor if kind == "slow"
                        else degrade_factor if kind == "ssd_degrade"
                        else 1.0
                    ),
                    duration=stall_seconds if kind == "stall" else 0.0,
                ))
        return cls(events)


def scripted(*events: FaultEvent | Sequence) -> FaultInjector:
    """Build an injector from events or ``(at, kind, node, ...)`` tuples."""

    out = []
    for e in events:
        out.append(e if isinstance(e, FaultEvent) else FaultEvent(*e))
    return FaultInjector(out)
