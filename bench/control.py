"""The control of a cell's check, at the cell's own size: the plain
reference computed in float32 (the next precision below the float64 the
configurations state) put in the program's place, and judged by the same
comparison against the reference in float64.  It must come out as not
correct; its readings set the upper end of each limit.

    python bench/control.py --workload <name> --seeds <n> [<n> ...]

prints one JSON line a seed: the numbers compared, for the cell's first
window trace under that seed.  The benchmark's own runs do not run it.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from bench.harness import check, registry
    from bench.harness.cell import trace_seed
    from bench.reference import sweep as ref_sweep

    cell = registry.cell(args.workload, ROOT)
    cfg = cell.config
    first = int(cell.mix["warm_sweeps"]) if cell.mix["new_trace_every_sweep"] else 0
    for seed in args.seeds:
        t0 = time.perf_counter()
        cols = cell.generator.generate(trace_seed(seed, first), cfg["generator_args"])
        ref = ref_sweep.sweep(cols, cfg)
        ctl = ref_sweep.sweep(cols, cfg, torch.float32)
        d = check.reference_digest(ctl, len(cfg["schemes"]))
        n_bad, gap = check.compare(d, ref)
        readings = {"bytes_unconserved": check.unconserved(d, ref["total_bytes"]),
                    "int_mismatches": n_bad, "clock_rel_gap": gap}
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": readings,
                          "correct": check.verdict(readings, cfg["limits"]),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
