"""Fault-tolerance example on the port: heartbeats, straggler detection,
elastic remesh.

Simulates a 512-host fleet (2 pods x 16 data x 16 model): hosts heartbeat,
two die, one straggles; the controller emits the recovery plan — restart
from the newest checkpoint under a SHRUNK data axis (whole TP groups are
dropped together) plus a work-steal for the straggler.  The controller is
host bookkeeping and touches no device, so this script takes no
``--device``.

    PYTHONPATH=src python examples_torch/elastic_recovery.py
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    FaultToleranceController,
    HeartbeatTable,
    Topology,
)


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    clock = [0.0]
    table = HeartbeatTable(timeout=30.0, straggler_factor=1.5,
                           clock=lambda: clock[0])
    topo = Topology(pods=2, data=16, model=16)
    ctl = FaultToleranceController(table, topo)
    for h in range(topo.n_hosts):
        table.register(h)

    # steady state: everyone heartbeats with ~1s steps; host 77 runs 2.2x slow
    for t in range(8):
        clock[0] += 10.0
        for h in range(topo.n_hosts):
            if h in (3, 200):  # these two will die at t>40
                if clock[0] <= 40:
                    table.heartbeat(h, 1.0)
                continue
            table.heartbeat(h, 2.2 if h == 77 else 1.0)

    actions = ctl.tick()
    print(f"fleet: {topo.n_hosts} hosts as (pods={topo.pods}, "
          f"data={topo.data}, model={topo.model})")
    for a in actions:
        print(f"\naction: {a.kind}")
        for k, v in a.detail.items():
            print(f"    {k}: {v}")

    kinds = {a.kind for a in actions}
    if "restart_from_checkpoint" not in kinds:
        raise RuntimeError("dead hosts not detected")
    if "steal_shard" not in kinds:
        raise RuntimeError("straggler not detected")
    new_topo = ctl.topo
    print(f"\nnew topology: pods={new_topo.pods} data={new_topo.data} "
          f"model={new_topo.model} ({new_topo.n_hosts} hosts)")
    print("elastic plan keeps every TP group intact; checkpoints restore "
          "under the new mesh because they store logical arrays "
          "(repro.checkpoint).")
    return {"actions": actions, "topology": new_topo}


if __name__ == "__main__":
    main()
