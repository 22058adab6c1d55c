"""Adaptive random-percentage threshold (SSDUP+ paper, Section 2.3.2).

The port's copy of the reference's host policies.  The device engine only
uses them on the host, to replay a ``threshold_warmup`` history and
transplant the resulting window and hysteresis state into a lane.

    avgper    = mean(PercentList)                       (Eq. 3)
    threshold = PercentList[(1 - avgper) * N]           (Eq. 2)

Convention (the reference's, fitted to the paper's case study): average
over the list BEFORE inserting the new percentage, then insert, then
index ``floor((1 - avgper) * len(list))`` clamped; 0.5 while empty.
"""

from __future__ import annotations

import bisect
from collections import deque
from typing import Iterable

DEFAULT_THRESHOLD = 0.5  # in effect before any history exists


class AdaptiveThreshold:
    """Traffic-aware adaptive threshold over stream random-percentages.

    ``window`` keeps that many most-recent percentages (``None``: all).
    """

    def __init__(self, window: int | None = None, default: float = DEFAULT_THRESHOLD):
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        self.default = float(default)
        self._recent: deque[float] = deque(maxlen=window)
        self._sorted: list[float] = []
        self._threshold = self.default

    def observe(self, percentage: float) -> float:
        """Insert one stream percentage; returns the new threshold."""

        p = float(percentage)
        if not 0.0 <= p <= 1.0 + 1e-9:
            raise ValueError(f"random percentage out of range: {p}")
        avgper = (sum(self._sorted) / len(self._sorted)) if self._sorted else None
        if self.window is not None and len(self._recent) == self.window:
            evicted = self._recent[0]
            self._sorted.pop(bisect.bisect_left(self._sorted, evicted))
        self._recent.append(p)
        bisect.insort(self._sorted, p)
        if avgper is None:
            self._threshold = self.default
        else:
            n = len(self._sorted)
            idx = max(0, min(n - 1, int((1.0 - avgper) * n)))  # floor
            self._threshold = self._sorted[idx]
        return self._threshold

    def seed(self, percentages: Iterable[float]) -> "AdaptiveThreshold":
        """Pre-populate the window with history before replay starts."""

        for p in percentages:
            self.observe(p)
        return self


class StaticWatermarkThreshold:
    """SSDUP's static high/low watermarks (45%/30%) with hysteresis."""

    def __init__(self, high: float = 0.45, low: float = 0.30):
        if not 0.0 <= low <= high <= 1.0:
            raise ValueError(f"need 0 <= low <= high <= 1, got {low}, {high}")
        self.high = high
        self.low = low
        self._last_random = False

    def observe(self, percentage: float) -> None:
        if percentage > self.high:
            self._last_random = True
        elif percentage < self.low:
            self._last_random = False

    def seed(self, percentages: Iterable[float]) -> "StaticWatermarkThreshold":
        """Warm start: only the final hysteresis state survives."""

        for p in percentages:
            self.observe(p)
        return self
