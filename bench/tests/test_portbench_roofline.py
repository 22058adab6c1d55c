"""The frozen roofline arithmetic depends only on counts taken from the
trace, and gives the bounds the port's gate script printed for the
1M-request sweep."""

import numpy as np
import pytest

from portbench_util import REPO  # noqa: F401  (puts the repo on sys.path)

from bench.harness import roofline
from bench.harness.cell import node_requests, sweep_counts
from repro_torch.testing.traces import sweep_trace

SCHEMES = ("orangefs", "orangefs-bb", "ssdup", "ssdup+")


def _cfg():
    """The gate script's sweep: 64 nodes by byte range, 128-request streams."""

    return {"nodes": 64, "policy": "range-offset", "schemes": SCHEMES, "stream_len": 128,
            "adaptive_window": 64}


def _seed0_counts():
    t = sweep_trace(1_000_000, 0)
    cols = {"offsets": t.offsets, "gap_positions": t.gap_positions}
    return sweep_counts(cols, _cfg())


def test_stream_stats_bound_of_the_gate_scripts_sweep():
    """7,844 rows of 128 (the sweep of seed 0): 4.833 us, bytes."""

    c = _seed0_counts()
    assert c["streams"] == 7844
    assert roofline.stream_stats_bound_s(c) * 1e6 == pytest.approx(4.833, abs=5e-4)


def test_replay_bound_with_the_packed_padding_is_the_gate_scripts():
    """The gate script counted the packed buffer: 256 lanes of 128
    events, padding included (19.7 MB).  The same count here gives its
    5.877 us; its operation bound was 0.200 us."""

    padded = {"stream_events": 256 * 128, "gap_events": 0, "lanes": 256, "window": 64,
              "plus_stream_events": 7844}
    t, by = roofline.replay_bound_s(padded)
    assert by == "bytes"
    assert t * 1e6 == pytest.approx(5.877, abs=5e-4)
    c = _seed0_counts()
    ops = (c["stream_events"] * roofline.REPLAY_OPS_STREAM
           + c["gap_events"] * roofline.REPLAY_OPS_GAP
           + c["plus_stream_events"] * (c["window"] + roofline.REPLAY_OPS_THRESHOLD))
    assert ops / roofline.FP64_FLOPS * 1e6 == pytest.approx(0.200, abs=5e-4)


def test_replay_bound_by_the_logical_count_sits_under_the_padded_one():
    """Real events only (31,376 stream and 256 gap events): 5.676 us,
    3.4 % under the padded count's 5.877 us."""

    c = _seed0_counts()
    assert (c["stream_events"], c["gap_events"], c["lanes"]) == (4 * 7844, 256, 256)
    t, by = roofline.replay_bound_s(c)
    assert by == "bytes"
    assert t * 1e6 == pytest.approx(5.676, abs=5e-4)
    assert 0.95 * 5.877e-6 < t < 5.877e-6


@pytest.mark.parametrize("nodes,gaps", [(1, 0), (8, 3), (64, 1)])
def test_counts_follow_the_shards_alone(nodes, gaps):
    rng = np.random.default_rng(nodes)
    req = rng.integers(0, 5000, size=nodes)
    c = roofline.counts(req, gaps, SCHEMES, 128, 64)
    streams = int(sum(-(-int(r) // 128) for r in req))
    assert c["streams"] == streams
    assert c["stream_events"] == 4 * streams
    assert c["gap_events"] == 4 * nodes * gaps
    assert c["plus_stream_events"] == streams
    assert c["lanes"] == 4 * nodes
    doubled = roofline.add(c, c)
    assert roofline.replay_bound_s(doubled)[0] == pytest.approx(2 * roofline.replay_bound_s(c)[0])
    assert roofline.stream_stats_bound_s(doubled) == pytest.approx(
        2 * roofline.stream_stats_bound_s(c))


def test_counts_come_from_the_trace_not_the_program():
    t = sweep_trace(50_000, 3)
    cols = {"offsets": t.offsets, "gap_positions": t.gap_positions}
    cfg = dict(_cfg(), nodes=16)
    per_node = node_requests(cols, cfg)
    assert per_node.sum() == 50_000 and len(per_node) == 16
    assert sweep_counts(cols, cfg)["streams"] == int((-(-per_node // 128)).sum())
