"""The least time the card could take for a sweep's two kernels, counted
from the trace the benchmark made and never from the program's buffers,
so that a change that packs, pads or stages differently cannot move it.

Peaks: one NVIDIA H100 SXM at its 700 W limit (data sheet): 3.35 TB/s of
HBM, 34 TFLOP/s float64 outside the tensor cores.

* ``stream_stats`` scores every stream once: each position's int64 offset
  and size read once (16 B), each row's int64 seek count and distance
  written once (16 B).  The sort's int64 compare-exchanges are not priced:
  the data sheet gives no int64 rate.  Bound by bytes.
* ``replay`` steps every lane through its events.  Bytes: each lane's real
  events (streams and gaps, no padding) at :data:`REPLAY_EVENT_BYTES`, and
  each lane's constants, state, window and outputs at
  :func:`replay_lane_bytes`, read or written once.  Operations (float64):
  a stream event :data:`REPLAY_OPS_STREAM` (a region fill's divisions,
  log2 and anchor interpolations, the 17-term HDD hat sum, the routing), a
  gap :data:`REPLAY_OPS_GAP`, and ahead of an SSDUP+ lane's chain each
  stream event's threshold pass, ``W`` additions and
  :data:`REPLAY_OPS_THRESHOLD` more.  The bound is the larger of the two.

The byte counts are frozen from the tape and state fields of the replay
kernel of this benchmark's first version: 73 float64, one int64 and two
byte fields an event; 8 float64 and 3 int64 lane constants, 14 float64 and
11 int64 state fields and a ``W``-entry float64 window a lane, 10 eight-byte
outputs a lane.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12

STREAM_STATS_BYTES_PER_POSITION = 16
STREAM_STATS_BYTES_PER_ROW = 16

REPLAY_EVENT_BYTES = 73 * 8 + 8 + 2
REPLAY_LANE_FIXED_BYTES = (8 + 3 + 14 + 11) * 8 + 10 * 8
REPLAY_OPS_STREAM, REPLAY_OPS_GAP, REPLAY_OPS_THRESHOLD = 200, 12, 4


def replay_lane_bytes(window: int) -> int:
    return REPLAY_LANE_FIXED_BYTES + 8 * window


def counts(node_requests, gaps: int, schemes, stream_len: int, window: int) -> dict:
    """The work of one sweep from its shards' request counts: streams,
    and, summed over every ``scheme x node`` lane, stream and gap events."""

    node_requests = np.asarray(node_requests, dtype=np.int64)
    streams = int((-(-node_requests // stream_len)).sum())
    n_schemes = len(schemes)
    return {
        "streams": streams,
        "stream_len": int(stream_len),
        "lanes": n_schemes * len(node_requests),
        "stream_events": n_schemes * streams,
        "gap_events": n_schemes * len(node_requests) * int(gaps),
        "plus_stream_events": streams * sum(s == "ssdup+" for s in schemes),
        "window": int(window),
    }


def add(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] if k not in ("stream_len", "window") else a[k] for k in a}


def stream_stats_bound_s(c: dict) -> float:
    nbytes = (c["streams"] * c["stream_len"] * STREAM_STATS_BYTES_PER_POSITION
              + c["streams"] * STREAM_STATS_BYTES_PER_ROW)
    return nbytes / HBM_BYTES_PER_S


def replay_bound_s(c: dict) -> tuple[float, str]:
    """``(seconds, "bytes" or "operations")``: the larger bound and which."""

    nbytes = ((c["stream_events"] + c["gap_events"]) * REPLAY_EVENT_BYTES
              + c["lanes"] * replay_lane_bytes(c["window"]))
    ops = (c["stream_events"] * REPLAY_OPS_STREAM + c["gap_events"] * REPLAY_OPS_GAP
           + c["plus_stream_events"] * (c["window"] + REPLAY_OPS_THRESHOLD))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP64_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
