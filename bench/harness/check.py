"""The comparison that decides ``correct``: the program's sweeps against
the plain reference (:mod:`bench.reference.sweep`).

Three numbers, each held to the limit its configuration file states:

* ``bytes_unconserved`` -- over every sweep of the window and every
  scheme, the bytes the nodes routed less the trace's bytes, in absolute
  value (sharding and routing lose or add nothing);
* ``int_mismatches`` -- over the sampled sweeps, the lanes' integer
  outputs (bytes to the SSD and straight to the HDD, flushes, peak SSD
  occupancy), each node's bytes and its bytes per app, that differ from
  the reference's;
* ``clock_rel_gap`` -- over the sampled sweeps, the largest relative gap
  of a lane's clocks (I/O time, total time, flush pause, blocked time)
  from the reference's.
"""

from __future__ import annotations

import numpy as np

INT_FIELDS = ("bytes_to_ssd", "bytes_to_hdd_direct", "flushes", "peak_ssd_occupancy")
CLOCK_FIELDS = ("io_seconds", "total_seconds", "flush_paused_seconds", "blocked_seconds")
NUMBERS = ("bytes_unconserved", "int_mismatches", "clock_rel_gap")


def digest(result: dict, schemes) -> dict:
    """What the check keeps of one sweep's result (``scheme ->
    FleetResult``): ``(schemes, nodes)`` arrays and each lane's bytes per
    app."""

    lanes = [result[s].node_results for s in schemes]
    out = {f: np.array([[getattr(r, f) for r in rs] for rs in lanes])
           for f in (*INT_FIELDS, *CLOCK_FIELDS, "total_bytes")}
    out["per_app"] = [[r.per_app_bytes for r in rs] for rs in lanes]
    return out


def reference_digest(out: dict, n_schemes: int) -> dict:
    """A digest of the reference's own outputs, to judge it in the
    program's place (the control)."""

    d = {f: out[f] for f in (*INT_FIELDS, *CLOCK_FIELDS)}
    d["total_bytes"] = out["bytes_to_ssd"] + out["bytes_to_hdd_direct"]
    d["per_app"] = [out["per_app"]] * n_schemes
    return d


def unconserved(d: dict, total_bytes: int) -> int:
    return int(np.abs(d["total_bytes"].sum(axis=1) - total_bytes).sum())


def compare(d: dict, ref: dict) -> tuple[int, float]:
    """``(int_mismatches, clock_rel_gap)`` of one sweep's digest against
    the reference's outputs for its trace."""

    shape = np.shape(ref[INT_FIELDS[0]])
    if any(np.shape(d[f]) != shape for f in (*INT_FIELDS, *CLOCK_FIELDS, "total_bytes")):
        return len(INT_FIELDS) * int(np.prod(shape)), float("inf")
    bad = sum(int(np.count_nonzero(np.asarray(d[f]) != ref[f])) for f in INT_FIELDS)
    bad += int(np.count_nonzero(d["total_bytes"] != ref["node_bytes"][None, :]))
    bad += sum(got != want for row in d["per_app"] for got, want in zip(row, ref["per_app"]))
    gap = 0.0
    for f in CLOCK_FIELDS:
        a = np.asarray(d[f], dtype=np.float64)
        b = np.asarray(ref[f], dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.where(a == b, 0.0, np.abs(a - b) / np.abs(b))
        rel = np.where(np.isnan(rel), np.inf, rel)
        gap = max(gap, float(rel.max(initial=0.0)))
    return bad, gap


def verdict(readings: dict, limits: dict) -> bool:
    return all(readings[k] <= limits[k] for k in NUMBERS)
