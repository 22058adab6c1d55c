"""Adaptive random-percentage threshold (SSDUP+ paper, Section 2.3.2).

SSDUP used static high/low watermarks (45%/30%).  SSDUP+ replaces them with a
history list of recent stream percentages, kept in increasing order
(*PercentList*), and picks the threshold by the quantile rule

    avgper    = mean(PercentList)                       (Eq. 3)
    threshold = PercentList[(1 - avgper) * N]           (Eq. 2)

Intuition (paper): when recent streams are mostly sequential (low avgper) the
selected index is *high*, so the threshold is strict and little data goes to
the fast tier; when recent streams are random (high avgper) the index is low,
the threshold drops, and more streams are redirected.

Exact indexing convention: the paper's Eq. 2 leaves the rounding and the
insert-vs-average ordering ambiguous.  We brute-forced every combination of
{seed, floor/round/ceil, N vs N-1, average-before/after-insert} against the
paper's own ten-step case study (Section 2.3.2: thresholds 0.5, 0.5433,
0.5433, 0.5433, 0.5905, 0.5826, 0.5826, 0.5905, 0.5905, 0.6062) and the
convention below reproduces **9/10 values exactly** (the seventh differs by a
single index, consistent with their 4-decimal rounding):

    avgper over the list BEFORE inserting the new percentage,
    then insert, then index = floor((1 - avgper) * len(list)) clamped,
    with a default threshold of 0.5 while the list is empty.

The reference's tests lock this against the paper's numbers; the port is
held to the reference (``tests/test_torch_structures.py``).
"""

from __future__ import annotations

import bisect
from collections import deque
from typing import Iterable

DEFAULT_THRESHOLD = 0.5  # in effect before any history exists


class AdaptiveThreshold:
    """Traffic-aware adaptive threshold over stream random-percentages.

    Parameters
    ----------
    window:
        Number of most-recent stream percentages retained.  ``None`` keeps
        the full history until :meth:`reset` (the paper empties PercentList
        when the workload's access pattern changes).  The paper's case study
        tracks the latest 10 streams.
    default:
        Threshold returned before any observation.
    """

    def __init__(self, window: int | None = None, default: float = DEFAULT_THRESHOLD):
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        self.default = float(default)
        self._recent: deque[float] = deque(maxlen=window)
        self._sorted: list[float] = []
        self._threshold = self.default
        self.observations = 0

    # -- core update ------------------------------------------------------
    def observe(self, percentage: float) -> float:
        """Insert one stream percentage; returns the new threshold."""

        p = float(percentage)
        if not 0.0 <= p <= 1.0 + 1e-9:
            raise ValueError(f"random percentage out of range: {p}")

        # avgper over the PRE-insert list (see module docstring).
        avgper = (sum(self._sorted) / len(self._sorted)) if self._sorted else None

        if self.window is not None and len(self._recent) == self.window:
            evicted = self._recent[0]
            idx = bisect.bisect_left(self._sorted, evicted)
            self._sorted.pop(idx)
        self._recent.append(p)
        bisect.insort(self._sorted, p)
        self.observations += 1

        if avgper is None:
            self._threshold = self.default
        else:
            n = len(self._sorted)
            idx = int((1.0 - avgper) * n)  # floor
            idx = max(0, min(n - 1, idx))
            self._threshold = self._sorted[idx]
        return self._threshold

    def observe_many(self, percentages: Iterable[float]) -> list[float]:
        return [self.observe(p) for p in percentages]

    def seed(self, percentages: Iterable[float]) -> "AdaptiveThreshold":
        """Pre-populate PercentList with history before replay starts.

        Models a detector whose history is warm at t=0 — e.g. a
        fleet-scope PercentList shared across I/O servers
        (``FleetSimulator(threshold_scope="fleet")``) where each node
        starts from the global stream history instead of a cold default.
        Windowed instances keep only the last ``window`` entries, exactly
        as if the history had been observed live.
        """

        for p in percentages:
            self.observe(p)
        return self

    # -- queries ----------------------------------------------------------
    @property
    def threshold(self) -> float:
        return self._threshold

    @property
    def avgper(self) -> float:
        return (sum(self._sorted) / len(self._sorted)) if self._sorted else 0.0

    @property
    def percent_list(self) -> tuple[float, ...]:
        """The sorted PercentList (paper's name), read-only view."""

        return tuple(self._sorted)

    def is_random(self, percentage: float) -> bool:
        """Redirection predicate: stream goes to the fast tier iff True."""

        return percentage > self._threshold

    def reset(self) -> None:
        """Empty PercentList (paper: on workload pattern change)."""

        self._recent.clear()
        self._sorted.clear()
        self._threshold = self.default


class StaticWatermarkThreshold:
    """SSDUP's original static scheme (ICS'17) — the paper's baseline.

    High/low watermarks with hysteresis: above ``high`` the traffic is deemed
    random (fast tier), below ``low`` sequential (slow tier), in between the
    previous decision sticks.  Defaults are the paper's 45%/30%.
    """

    def __init__(self, high: float = 0.45, low: float = 0.30):
        if not 0.0 <= low <= high <= 1.0:
            raise ValueError(f"need 0 <= low <= high <= 1, got {low}, {high}")
        self.high = high
        self.low = low
        self._last_random = False
        self.observations = 0

    def observe(self, percentage: float) -> float:
        self.observations += 1
        if percentage > self.high:
            self._last_random = True
        elif percentage < self.low:
            self._last_random = False
        return self.threshold

    def seed(self, percentages: Iterable[float]) -> "StaticWatermarkThreshold":
        """Warm-start counterpart of :meth:`AdaptiveThreshold.seed` — only
        the final hysteresis state survives (watermarks keep no list)."""

        for p in percentages:
            self.observe(p)
        return self

    @property
    def threshold(self) -> float:
        # exposed for symmetric logging: the effective decision boundary
        return self.low if self._last_random else self.high

    def is_random(self, percentage: float) -> bool:
        if percentage > self.high:
            return True
        if percentage < self.low:
            return False
        return self._last_random

    def reset(self) -> None:
        self._last_random = False
