"""Service-layer example on the port: online arrivals, a mid-run crash,
failover, on the CUDA card.

A Poisson-stamped mixed IOR load is dispatched to an 8-node burst-buffer
fleet through the discrete-event service loop.  Node 3 crashes mid-burst:
the heartbeat table times out, the controller declares it dead, its
queued windows are resharded to the survivors, and its unflushed SSD
backlog is replayed on the least-loaded takeover node (Eq. 6 flush
costing).  Each run scores its windows with the ``stream_stats`` kernel
on the card.  The byte ledgers must balance to the last byte — every
offered byte completed, every SSD byte flushed/replayed/deduped.

    PYTHONPATH=src python examples_torch/service_failover.py               # the card
    PYTHONPATH=src python examples_torch/service_failover.py --device cpu
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import TraceBatch, ior, mixed, relabel  # noqa: E402
from repro_torch.core.workloads import MiB  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.service import (  # noqa: E402
    FaultInjector,
    poisson_arrivals,
    run_service_schemes,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    per_app = 128 * MiB
    apps = [
        relabel(ior("segmented-contiguous", 8, total_bytes=per_app, seed=1),
                app_id=0, file_id=0),
        relabel(ior("segmented-random", 8, total_bytes=per_app, seed=2),
                app_id=1, file_id=1),
        relabel(ior("strided", 16, total_bytes=per_app, seed=3),
                app_id=2, file_id=2),
        relabel(ior("segmented-random", 16, total_bytes=per_app, seed=4),
                app_id=3, file_id=3),
    ]
    load = mixed(*apps, burst_requests=256)
    offered = poisson_arrivals(
        TraceBatch.from_items(load.trace), rate_rps=1500.0, seed=7
    )

    results = run_service_schemes(
        offered,
        num_nodes=8,
        policy="range-offset",
        ssd_capacity=32 * MiB,
        epoch_seconds=0.5,
        heartbeat_timeout=2.0,
        injector=FaultInjector.crash_at(0.8, 3),
        device=dev,
    )

    print(f"offered: {offered.total_bytes / MiB:.0f} MiB over 8 nodes, "
          "crash on node 3 at t=0.8s\n")
    print(f"{'scheme':>12s} {'MB/s':>8s} {'p50':>7s} {'p99':>7s} "
          f"{'p999':>7s} {'detect':>7s} {'recover':>8s} {'replayed':>9s}")
    for scheme, r in results.items():
        m = r.metrics
        violations = m.conservation_violations()
        if violations:
            raise RuntimeError(f"{scheme}: byte ledger does not balance: {violations}")
        crash = next(f for f in m.faults if f.kind == "crash")
        print(f"{scheme:>12s} {m.throughput_mbs:8.1f} "
              f"{m.p50_latency:6.2f}s {m.p99_latency:6.2f}s "
              f"{m.p999_latency:6.2f}s {crash.detection_seconds:6.2f}s "
              f"{crash.recovery_seconds:7.2f}s "
              f"{crash.replayed_bytes / MiB:7.1f}Mi")

    m = results["orangefs-bb"].metrics
    print(f"\norangefs-bb ledger: offered={m.offered_bytes / MiB:.0f}Mi "
          f"completed={m.completed_bytes / MiB:.0f}Mi "
          f"ssd={m.written_ssd_bytes / MiB:.0f}Mi "
          f"(flushed={m.flushed_bytes / MiB:.0f}Mi "
          f"replayed={m.replayed_bytes / MiB:.0f}Mi "
          f"deduped={m.deduped_bytes / MiB:.0f}Mi)")
    print("every byte accounted for: the dead node's queue moved to "
          "survivors and its unflushed backlog replayed on the takeover "
          "lane.  Note the traffic-detecting schemes had nothing to "
          "replay — node 3's sequential slice never entered the SSD, so "
          "a blind buffer (orangefs-bb) carries the crash exposure.")
    return {"offered": offered, "results": results}


if __name__ == "__main__":
    main()
