"""Bisect the 8-16 node SSDUP+ shortfall (see experiments/ANOMALY.md) on the port.

Replays the fleet benchmark's mixed workload (the exact recipe behind the
``fleet_*`` rows in bench_results.csv) while varying, one axis at a time:

* node count x scheme x shard policy        (--nodes / --schemes / --policies)
* the traffic-aware flush gate              (--gates, ssdup+ only)
* per-shard vs fleet-scope threshold state  (--scopes, via
  ``FleetSimulator(threshold_scope=...)``)
* adaptive-threshold window                 (--windows)
* trace composition (arrival burstiness)    (--bursts)

plus a straggler drill-down (--straggler N) that reruns the straggler
node's shard alone and dumps the per-stream routing decisions
(percentage, threshold-in-effect, device) next to the node's clocks —
the level at which the flush-gate self-interference mechanism is visible.

Every fleet run scores all its shards in one launch of the ``stream_stats``
kernel on the CUDA card (``--device``, default the card).  Scoring is
exact and the host engines are bit-identical to the reference's, so at its
defaults the hunt writes ``experiments/anomaly_hunt.csv`` byte for byte.

    PYTHONPATH=src python experiments/anomaly_hunt_torch.py              # full hunt
    PYTHONPATH=src python experiments/anomaly_hunt_torch.py --straggler 16
    PYTHONPATH=src python experiments/anomaly_hunt_torch.py --csv out.csv
    PYTHONPATH=src python experiments/anomaly_hunt_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import Sequence

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (  # noqa: E402
    FleetSimulator,
    IONodeSimulator,
    TraceBatch,
    compute_stream_scores,
    ior,
    mixed,
    relabel,
)
from repro_torch.core.workloads import GiB, MiB  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.testing.perf import atomic_write_text  # noqa: E402

SCHEMES = ("orangefs", "orangefs-bb", "ssdup", "ssdup+")
POLICIES = ("range-offset", "round-robin-app", "hash-file")


def build_load(total_bytes: int, burst_requests: int | None = 512) -> TraceBatch:
    """The bench_fleet.bench_scaling recipe (4-app mix), parameterized
    by arrival burstiness so trace composition can be swept."""

    per_app = max(total_bytes // 4, 64 * MiB)
    apps = [
        relabel(ior("segmented-contiguous", 8, total_bytes=per_app, seed=1),
                app_id=0, file_id=0),
        relabel(ior("segmented-random", 8, total_bytes=per_app, seed=2),
                app_id=1, file_id=1),
        relabel(ior("strided", 32, total_bytes=per_app, seed=3),
                app_id=2, file_id=2),
        relabel(ior("segmented-random", 16, total_bytes=per_app, seed=4),
                app_id=3, file_id=3),
    ]
    return TraceBatch.from_requests(mixed(*apps, burst_requests=burst_requests).trace)


def run_one(batch: TraceBatch, nodes: int, scheme: str, policy: str, device,
            **kwargs):
    fleet_ssd = batch.total_bytes // 2
    return FleetSimulator(
        num_nodes=nodes, scheme=scheme, policy=policy,
        ssd_capacity=max(fleet_ssd // nodes, 64 * MiB), device=device, **kwargs,
    ).run(batch)


def _row(experiment: str, scheme: str, policy: str, nodes: int,
         variant: str, fr) -> dict:
    return {
        "experiment": experiment,
        "scheme": scheme,
        "policy": policy,
        "nodes": nodes,
        "variant": variant,
        "agg_mbs": round(fr.throughput_mbs, 1),
        "straggler_io_s": round(fr.io_seconds, 4),
        "imbalance": round(fr.load_imbalance, 3),
        "ssd_ratio": round(fr.ssd_byte_ratio, 3),
    }


def _print_rows(rows: list[dict]) -> None:
    cols = ("experiment", "scheme", "policy", "nodes", "variant",
            "agg_mbs", "straggler_io_s", "imbalance", "ssd_ratio")
    widths = {c: max(len(c), *(len(str(r[c])) for r in rows)) for c in cols}
    print("  ".join(c.ljust(widths[c]) for c in cols))
    for r in rows:
        print("  ".join(str(r[c]).ljust(widths[c]) for c in cols))


# -- the hunt axes -----------------------------------------------------


def hunt_base(batch, nodes_list, schemes, policies, device) -> list[dict]:
    """Axis 1: where does the shortfall live? (scheme x policy x nodes)"""

    rows = []
    for policy in policies:
        for nodes in nodes_list:
            for scheme in schemes:
                fr = run_one(batch, nodes, scheme, policy, device)
                rows.append(_row("base", scheme, policy, nodes, "-", fr))
    return rows


def hunt_gates(batch, nodes_list, gates, device) -> list[dict]:
    """Axis 2: the traffic-aware flush gate (ssdup+, range-offset)."""

    rows = []
    for nodes in nodes_list:
        for gate in gates:
            fr = run_one(batch, nodes, "ssdup+", "range-offset", device,
                         flush_gate=gate)
            rows.append(_row("flush-gate", "ssdup+", "range-offset", nodes,
                             f"gate={gate}", fr))
    return rows


def hunt_scopes(batch, nodes_list, device) -> list[dict]:
    """Axis 3: per-shard (cold) vs fleet-scope (warm) threshold state."""

    rows = []
    for nodes in nodes_list:
        for scope in ("node", "fleet"):
            fr = run_one(batch, nodes, "ssdup+", "range-offset", device,
                         threshold_scope=scope)
            rows.append(_row("threshold-scope", "ssdup+", "range-offset",
                             nodes, f"scope={scope}", fr))
    return rows


def hunt_windows(batch, nodes_list, windows, device) -> list[dict]:
    """Axis 4: adaptive-threshold window (history length)."""

    rows = []
    for nodes in nodes_list:
        for window in windows:
            fr = run_one(batch, nodes, "ssdup+", "range-offset", device,
                         adaptive_window=window)
            rows.append(_row("adaptive-window", "ssdup+", "range-offset",
                             nodes, f"window={window}", fr))
    return rows


def hunt_bursts(total_bytes, nodes_list, bursts, device) -> list[dict]:
    """Axis 5: trace composition (arrival burstiness changes how many
    coherent streams each shard sees)."""

    rows = []
    for burst in bursts:
        batch = build_load(total_bytes, burst_requests=burst)
        for nodes in nodes_list:
            for scheme in ("orangefs", "ssdup+"):
                fr = run_one(batch, nodes, scheme, "range-offset", device)
                rows.append(_row("burstiness", scheme, "range-offset",
                                 nodes, f"burst={burst}", fr))
    return rows


def straggler_report(batch, nodes: int, dev, scheme: str = "ssdup+",
                     policy: str = "range-offset", **kwargs) -> None:
    """Rerun the straggler node's shard alone and dump routing decisions."""

    fleet_ssd = batch.total_bytes // 2
    cap = max(fleet_ssd // nodes, 64 * MiB)
    fleet = FleetSimulator(num_nodes=nodes, scheme=scheme, policy=policy,
                           ssd_capacity=cap, device=dev, **kwargs)
    fr = fleet.run(batch)
    idx = fr.straggler
    shard = fleet.shard(batch)[idx]
    scores = compute_stream_scores(shard, device=dev)
    node = IONodeSimulator(scheme=scheme, ssd_capacity=cap, device=dev, **kwargs)
    res = node.run(shard, scores=scores)

    print(f"\n== straggler: node {idx}/{nodes} ({scheme}, {policy}) ==")
    print(f"shard: {shard.num_requests} requests, "
          f"{shard.total_bytes / MiB:.0f} MiB, "
          f"{len(scores)} streams; node ssd_capacity {cap / MiB:.0f} MiB")
    if node.redirector is not None:
        print(f"{'stream':>6s} {'pct':>7s} {'thr_in_effect':>13s} {'device':>7s}")
        for i, (pct, thr, device) in enumerate(node.redirector.decisions):
            print(f"{i:6d} {pct:7.3f} {thr:13.3f} {device.name.lower():>7s}")
    print(f"io_seconds={res.io_seconds:.4f}  total={res.total_seconds:.4f}  "
          f"flushes={res.flushes}  blocked={res.blocked_seconds:.4f}  "
          f"ssd_bytes={res.bytes_to_ssd}")
    base = IONodeSimulator(scheme="orangefs", device=dev).run(shard)
    print(f"orangefs same shard: io_seconds={base.io_seconds:.4f} "
          f"(delta {res.io_seconds - base.io_seconds:+.4f}s)")


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--total-bytes", type=int, default=2 * GiB)
    ap.add_argument("--nodes", default="1,2,4,8,16",
                    help="node counts for the base table")
    ap.add_argument("--variant-nodes", default="8,16",
                    help="node counts for the variant axes")
    ap.add_argument("--schemes", default=",".join(SCHEMES))
    ap.add_argument("--policies", default=",".join(POLICIES))
    ap.add_argument("--gates", default="0.5,0.75,1.01",
                    help="flush_gate values (>1 never flushes concurrently)")
    ap.add_argument("--windows", default="64,none")
    ap.add_argument("--bursts", default="512,128,none")
    ap.add_argument("--skip", default="",
                    help="comma-separated axes to skip "
                         "(base,flush-gate,threshold-scope,adaptive-window,"
                         "burstiness)")
    ap.add_argument("--straggler", type=int, default=None, metavar="NODES",
                    help="only dump the straggler drill-down at this size")
    ap.add_argument("--gate", type=float, default=0.5,
                    help="flush_gate for --straggler")
    ap.add_argument("--csv", default=None,
                    help="also write the sweep table to this CSV (atomic)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    batch = build_load(args.total_bytes)
    if args.straggler is not None:
        straggler_report(batch, args.straggler, dev, flush_gate=args.gate)
        return 0

    nodes_list = [int(n) for n in args.nodes.split(",")]
    vnodes = [int(n) for n in args.variant_nodes.split(",")]
    skip = set(filter(None, args.skip.split(",")))
    axes = {"base", "flush-gate", "threshold-scope", "adaptive-window",
            "burstiness"}
    if skip - axes:
        ap.error(f"unknown --skip axes {sorted(skip - axes)}; "
                 f"choose from {sorted(axes)}")
    rows: list[dict] = []
    if "base" not in skip:
        rows += hunt_base(batch, nodes_list, args.schemes.split(","),
                          args.policies.split(","), dev)
    if "flush-gate" not in skip:
        rows += hunt_gates(batch, vnodes,
                           [float(g) for g in args.gates.split(",")], dev)
    if "threshold-scope" not in skip:
        rows += hunt_scopes(batch, vnodes, dev)
    if "adaptive-window" not in skip:
        rows += hunt_windows(batch, vnodes,
                             [None if w == "none" else int(w)
                              for w in args.windows.split(",")], dev)
    if "burstiness" not in skip:
        rows += hunt_bursts(args.total_bytes, vnodes,
                            [None if b == "none" else int(b)
                             for b in args.bursts.split(",")], dev)

    _print_rows(rows)
    if args.csv:
        cols = list(rows[0])
        text = ",".join(cols) + "\n" + "\n".join(
            ",".join(str(r[c]) for c in cols) for r in rows) + "\n"
        atomic_write_text(args.csv, text)
        print(f"\nwrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
