"""Fleet simulation on the port: the paper's evaluation scaled from 1 to N
I/O nodes, on the CUDA card.

Shards one mixed multi-app arrival trace across a fleet of I/O nodes under
each trace-sharding policy, replays every shard through the calibrated
single-node simulator (each run scores all its shards in one launch of the
``stream_stats`` kernel on the card), and prints the aggregate picture:
fleet throughput, SSD-byte ratio, load imbalance, and the straggler node.

    PYTHONPATH=src python examples_torch/fleet_sim.py               # the card
    PYTHONPATH=src python examples_torch/fleet_sim.py --device cpu
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (  # noqa: E402
    FleetSimulator,
    TraceBatch,
    ior,
    mixed,
    relabel,
)
from repro_torch.core.workloads import GiB, MiB  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.distributed.sharding import TRACE_POLICIES  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    per_app = GiB // 4
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
    load = mixed(*apps, burst_requests=512)
    batch = TraceBatch.from_requests(load.trace)
    print(f"workload: {batch.num_requests} requests, "
          f"{batch.total_bytes / GiB:.2f} GiB from {len(apps)} apps")

    # 1) how each policy spreads the load over 4 nodes
    print("\nsharding policies (4 nodes, ssdup+, per-node SSD = 128 MiB):")
    policies = {}
    for policy in sorted(TRACE_POLICIES):
        fleet = FleetSimulator(num_nodes=4, scheme="ssdup+", policy=policy,
                               ssd_capacity=128 * MiB, device=dev)
        fr = policies[policy] = fleet.run(batch)
        loads = ", ".join(f"{b / MiB:.0f}" for b in fr.node_bytes)
        print(f"  {policy:16s} {fr.throughput_mbs:7.1f} MB/s aggregate | "
              f"imbalance {fr.load_imbalance:4.2f} | "
              f"straggler node {fr.straggler} | node MiB [{loads}]")

    # 2) scheme comparison at the paper's 2-node testbed size
    print("\n2-node scheme comparison (paper's testbed aggregate):")
    schemes = {}
    for scheme in ("orangefs", "orangefs-bb", "ssdup", "ssdup+"):
        fr = schemes[scheme] = FleetSimulator(
            num_nodes=2, scheme=scheme, policy="range-offset",
            ssd_capacity=load.total_bytes // 4, device=dev).run(batch)
        print(f"  {scheme:12s} {fr.throughput_mbs:7.1f} MB/s | "
              f"ssd {fr.ssd_byte_ratio * 100:5.1f}%")
    return {"policies": policies, "schemes": schemes,
            "fleet_runs": len(policies) + len(schemes)}


if __name__ == "__main__":
    main()
