"""The reference's fleet sweep: one trace, every ``scheme x node`` lane.

:func:`sweep` works out the shards, scores, tapes and the lane replay
again from the trace's columns and returns every lane's outputs as NumPy
arrays of shape ``(schemes, nodes)``, with each node's bytes and bytes per
app taken from its shard.
"""

from __future__ import annotations

import numpy as np
import torch

from . import replay as rp
from . import tapes as tp

SCHEME_IDS = {"orangefs": 0, "orangefs-bb": 1, "ssdup": 2, "ssdup+": 3}
# Eq. 7 interference at phi = 2: the foreground slows 2 * phi, the
# concurrent flush drains at 1 / (2 * phi) of the disk's rate
GLOBALS = {"seek_time": tp.HDD_SEEK_TIME, "seq_bw": tp.HDD_SEQ_BW, "slowdown": 4.0,
           "flush_frac": 0.25, "default_thr": 0.5, "static_high": 0.45,
           "static_low": 0.30}


def capacity(total_bytes: int, cfg: dict) -> int:
    """A node's SSD capacity by the configuration's rule: its share of the
    trace's bytes times ``share``, at least ``floor_bytes``."""

    rule = cfg["ssd_capacity"]
    share = total_bytes * rule["share_num"] // rule["share_den"] // cfg["nodes"]
    return max(share, rule["floor_bytes"])


def _lane_tensors(schemes, nodes: int, cap: int, window: int, gate: float):
    n_lanes = len(schemes) * nodes
    ids = torch.tensor([SCHEME_IDS[s] for s in schemes for _ in range(nodes)],
                       dtype=torch.int32)
    caps = torch.tensor([0 if s == "orangefs" else cap if s == "orangefs-bb" else cap // 2
                         for s in schemes for _ in range(nodes)], dtype=torch.int64)
    lane = {"scheme": ids, "cap": caps,
            "gate": torch.full((n_lanes,), float(gate), dtype=torch.float64)}
    f64 = {k: torch.zeros(n_lanes, dtype=torch.float64)
           for k in ("clock", "gap", "pause", "blocked", "a_fs", "j_left",
                     *(f"xf_{d}" for d in range(1, tp.XMERGE_D + 1)))}
    i64 = {k: torch.zeros(n_lanes, dtype=torch.int64)
           for k in ("b_ssd", "b_hdd", "a_used", "s_used", "peak")}
    st = {**f64, **i64,
          "j_rate": torch.ones(n_lanes, dtype=torch.float64),
          "j_alive": torch.zeros(n_lanes, dtype=torch.bool),
          "flushes": torch.zeros(n_lanes, dtype=torch.int32),
          "win": torch.full((n_lanes, window), float("inf"), dtype=torch.float64),
          "win_n": torch.zeros(n_lanes, dtype=torch.int32),
          "win_p": torch.zeros(n_lanes, dtype=torch.int32),
          "static_rand": torch.zeros(n_lanes, dtype=torch.bool),
          "cur_ssd": torch.zeros(n_lanes, dtype=torch.bool)}
    return lane, st


def sweep(cols: dict, cfg: dict, fdt: torch.dtype = torch.float64) -> dict:
    """Every lane of the configuration ``cfg`` over the trace ``cols``."""

    if cfg["ssd"] != "constant":
        raise ValueError(f"the reference replays the constant SSD only, not {cfg['ssd']!r}")
    trace = tp.Trace.of(cols)
    nodes, schemes, stream_len = cfg["nodes"], tuple(cfg["schemes"]), cfg["stream_len"]
    shards = tp.shard(trace, cfg["policy"], nodes)
    tapes = [tp.events(s, tp.scores(s, stream_len), stream_len) for s in shards]
    steps = max(len(t["valid"]) for t in tapes)
    ev = {}
    for k, dt in tp.EVENT_FIELDS.items():
        arr = np.zeros((steps, len(schemes) * nodes), dtype=dt)
        for n, t in enumerate(tapes):
            arr[:len(t[k]), n::nodes] = t[k][:, None]
        ev[k] = torch.from_numpy(arr)
    lane, st = _lane_tensors(schemes, nodes, capacity(trace.total_bytes, cfg),
                             cfg["adaptive_window"], cfg["flush_gate"])
    with torch.no_grad():
        out = rp.replay(GLOBALS, lane, st, ev, steps, fdt)
    res = {k: out[k].reshape(len(schemes), nodes).numpy() for k in rp.OUTPUTS}
    res["node_bytes"] = np.array([s.total_bytes for s in shards], dtype=np.int64)
    res["per_app"] = [tp.per_app_bytes(s) for s in shards]
    res["total_bytes"] = trace.total_bytes
    return res
