"""What a traced window recorded, as the per-layer metrics read it.

Every reader in ``bench/metrics/`` gets one :class:`Window` and returns
its number, or ``None`` where it finds nothing to read (the harness then
leaves the metric out of the result line).
"""

from __future__ import annotations

import numpy as np

from . import roofline
from .probes import Recorder


class Window:
    def __init__(self, rec: Recorder, walls: list[float], counts: dict | None,
                 profiled_busy_s: float | None, window_s: float):
        self.rec = rec
        self.walls = list(walls)
        self.sweeps = len(walls)
        self.counts = counts  # roofline.counts summed over the window's sweeps
        self.profiled_busy_s = profiled_busy_s  # None where no profiler ran
        self.window_s = window_s
        self._launch = {k: sum(rec.launch_seconds(k)) for k in rec.launches}
        children = np.zeros(len(rec.spans))
        for s in rec.spans:
            if s.parent >= 0:
                children[s.parent] += s.t1 - s.t0
        self._children = children

    def total_s(self, *keys: str) -> float | None:
        """Summed duration of the spans of ``keys`` (``None``: none ran)."""

        durs = [s.t1 - s.t0 for s in self.rec.spans if s.key in keys]
        return sum(durs) if durs else None

    def self_s(self, key: str, excludes=()) -> float | None:
        """Summed self time of ``key``'s spans: each span less the spans of
        ``excludes`` called inside it (the outermost of them, through any
        spans of other keys in between)."""

        spans = self.rec.spans
        dur = {i: s.t1 - s.t0 for i, s in enumerate(spans) if s.key == key}
        if not dur:
            return None
        for s in spans:
            if s.key not in excludes:
                continue
            p = s.parent
            while p >= 0 and spans[p].key != key and spans[p].key not in excludes:
                p = spans[p].parent
            if p >= 0 and spans[p].key == key:
                dur[p] -= s.t1 - s.t0
        return sum(dur.values())

    def launch_s(self, key: str) -> float | None:
        """Summed device time of ``key``'s launches (CUDA events)."""

        return self._launch.get(key) or None

    def busy_s(self) -> float | None:
        """Device busy seconds: the profiler's device time, the ctypes
        launches' kernels included (CUPTI records them; ``None`` where no
        profiler ran)."""

        return self.profiled_busy_s

    def breakdown(self, rows: list[tuple[str, float]]) -> dict:
        """The ten device operations that took most time (the profiler's
        ``rows``), and the ten host spans whose self time, in which the
        device waited, was longest."""

        ops = [[k, t] for k, t in rows]
        host: dict[str, float] = {}
        for i, s in enumerate(self.rec.spans):
            host[s.key] = host.get(s.key, 0.0) + (s.t1 - s.t0 - self._children[i])
        return {"device_ops": sorted(ops, key=lambda r: -r[1])[:10],
                "idle_gaps": sorted(([f"host self time in {k}", t] for k, t in host.items()),
                                    key=lambda r: -r[1])[:10]}

    def per_sweep_ms(self, seconds: float | None) -> float | None:
        return None if seconds is None or not self.sweeps else seconds / self.sweeps * 1e3

    def roofline_pct(self, bound_s: float, launch_key: str) -> float | None:
        t = self.launch_s(launch_key)
        return None if t is None or not bound_s else 100.0 * bound_s / t

    stream_stats_bound_s = staticmethod(roofline.stream_stats_bound_s)
    replay_bound_s = staticmethod(roofline.replay_bound_s)
