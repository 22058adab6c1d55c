"""Run one cell of ``BENCHMARK.json`` once on the CUDA card.

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as one JSON object, the
last line of standard output; exits nonzero without a result where there
is no card (or fewer than the cell asks for), where the program is not in
the checkout, or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout (the
    # port's own kernels build into build/kernels/ there already)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import json

    import torch

    chips = next((w.get("chips", 1) for w in json.loads((ROOT / "BENCHMARK.json").read_text())
                  ["workloads"] if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from bench.harness.cell import run_cell

    return run_cell(args.workload, args.seed, args.seconds, bool(args.trace), root=ROOT,
                    device="cuda", t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
