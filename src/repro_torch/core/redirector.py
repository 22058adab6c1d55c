"""Data redirector — SSDUP+ Algorithm 1 (paper Section 2.3).

The redirector consumes request streams, scores each with the random factor,
feeds the score to a threshold policy (adaptive by default, SSDUP's static
watermarks as the baseline), and decides which *device* the NEXT stream's
requests are sent to.  Note the one-stream lag in the paper's algorithm: the
percentage of the latest completed stream guides the direction of *upcoming*
requests ("the comparison between percentage and threshold is used to guide
the direction of the upcoming requests", Section 2.3.2) — HPC access patterns
are stable enough for the lag to be harmless.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Protocol, Sequence

from .random_factor import (
    DEFAULT_STREAM_LEN,
    Request,
    StreamGrouper,
    stream_percentage,
)
from .adaptive import AdaptiveThreshold


class Device(enum.Enum):
    HDD = "hdd"  # slow tier, written directly
    SSD = "ssd"  # fast tier (burst buffer)


class ThresholdPolicy(Protocol):
    def observe(self, percentage: float) -> float: ...
    @property
    def threshold(self) -> float: ...
    def reset(self) -> None: ...


@dataclasses.dataclass(frozen=True, slots=True)
class RoutedStream:
    """One stream plus the routing decision that applied to it."""

    stream: tuple[Request, ...]
    device: Device
    percentage: float  # of THIS stream (informational)
    threshold: float  # threshold in effect when the decision was made
    index: int

    @property
    def bytes(self) -> int:
        return sum(r.size for r in self.stream)


class DataRedirector:
    """Algorithm 1: route request streams to the fast or slow tier."""

    def __init__(
        self,
        policy: ThresholdPolicy | None = None,
        stream_len: int = DEFAULT_STREAM_LEN,
        initial_device: Device = Device.HDD,
    ):
        self.policy = policy if policy is not None else AdaptiveThreshold()
        self.grouper = StreamGrouper(stream_len)
        # Paper: "When the execution of an application starts, the data is
        # written to HDD" — detection needs history before redirecting.
        self.current_device = initial_device
        self._index = 0
        self.bytes_to = {Device.HDD: 0, Device.SSD: 0}
        self.streams_to = {Device.HDD: 0, Device.SSD: 0}
        self.decisions: list[tuple[float, float, Device]] = []  # (pct, thr, dev)

    # ------------------------------------------------------------------
    def route_scored(self, nbytes: int, percentage: float) -> Device:
        """Route one already-scored stream without materializing requests.

        The batched replay engine's entry point: identical policy/device
        evolution to :meth:`route_stream` (same observe, same hysteresis,
        same stats), driven by the stream's byte count and precomputed
        random percentage alone — no per-request Python.
        """

        # The device for THIS stream was decided by the previous stream
        # (Algorithm 1's "send requests of next stream to ...").
        device = self.current_device
        threshold_in_effect = self.policy.threshold
        self.policy.observe(percentage)

        self._index += 1
        self.bytes_to[device] += nbytes
        self.streams_to[device] += 1
        self.decisions.append((percentage, threshold_in_effect, device))

        # Decide where the NEXT stream goes (hysteresis: equality keeps).
        new_threshold = self.policy.threshold
        if percentage > new_threshold and device is Device.HDD:
            self.current_device = Device.SSD
        elif percentage < new_threshold and device is Device.SSD:
            self.current_device = Device.HDD
        return device

    def route_stream(
        self, stream: Sequence[Request], percentage: float | None = None
    ) -> RoutedStream:
        """Route one complete stream; updates the policy and device state.

        ``percentage`` lets a caller that already scored the stream (e.g.
        the simulator replaying with precomputed batched scores) skip the
        per-stream sort here; it must equal ``stream_percentage(stream)``.
        """

        pct = stream_percentage(stream) if percentage is None else percentage
        index = self._index
        threshold_in_effect = self.policy.threshold
        nbytes = sum(r.size for r in stream)
        device = self.route_scored(nbytes, pct)
        return RoutedStream(
            stream=tuple(stream),
            device=device,
            percentage=pct,
            threshold=threshold_in_effect,
            index=index,
        )

    def route(self, requests: Iterable[Request]) -> Iterable[RoutedStream]:
        """Stream-group an arriving request sequence and route each stream."""

        for stream in self.grouper.push_many(requests):
            yield self.route_stream(stream)

    def finish(self) -> RoutedStream | None:
        """Route the trailing partial stream, if any."""

        tail = self.grouper.flush()
        if tail is None:
            return None
        return self.route_stream(tail)

    # -- stats ----------------------------------------------------------
    @property
    def ssd_byte_ratio(self) -> float:
        total = self.bytes_to[Device.HDD] + self.bytes_to[Device.SSD]
        return self.bytes_to[Device.SSD] / total if total else 0.0

    @property
    def ssd_stream_ratio(self) -> float:
        total = self.streams_to[Device.HDD] + self.streams_to[Device.SSD]
        return self.streams_to[Device.SSD] / total if total else 0.0

    def reset(self) -> None:
        self.policy.reset()
        self.current_device = Device.HDD
