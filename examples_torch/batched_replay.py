"""Batched replay on the port: a million-request trace through both index
backends, scored on the CUDA card.

Builds a random-heavy columnar trace (no per-request Python objects),
scores every stream once with the ``stream_stats`` kernel on the card,
replays it with the default batched engine under `index_backend="numpy"`
(the vectorized ExtentIndex) and `index_backend="avl"` (the paper's AVL
oracle), and shows that the results agree while the numpy backend is
several times faster — then replays a small slice with the per-request
oracle engine to demonstrate full bit-exactness.

    PYTHONPATH=src python examples_torch/batched_replay.py               # the card
    PYTHONPATH=src python examples_torch/batched_replay.py --device cpu --requests 20000
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.core import (  # noqa: E402
    IONodeSimulator,
    TraceBatch,
    compute_stream_scores,
)
from repro_torch.core.workloads import GiB  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def make_trace(n: int, seed: int = 0) -> TraceBatch:
    rng = np.random.default_rng(seed)
    return TraceBatch(
        offsets=rng.integers(0, 1 << 36, size=n).astype(np.int64),
        sizes=np.full(n, 64 << 10, dtype=np.int64),
        file_ids=rng.integers(0, 8, size=n).astype(np.int64),
        app_ids=rng.integers(0, 4, size=n).astype(np.int64),
        times=np.zeros(n),
        gap_positions=np.asarray([n // 2], dtype=np.int64),  # compute phase
        gap_seconds=np.asarray([20.0]),
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--requests", type=int, default=1_000_000,
                    help="requests in the replayed trace")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n = args.requests
    batch = make_trace(n)
    scores = compute_stream_scores(batch, device=dev)  # once; reused by every replay

    print(f"{n:,} requests, {batch.total_bytes / GiB:.0f} GiB logical, "
          f"{len(scores):,} streams\n")
    results, seconds = {}, {}
    for backend in ("numpy", "avl"):
        sim = IONodeSimulator(scheme="ssdup+", ssd_capacity=8 * GiB,
                              index_backend=backend, device=dev)
        t0 = time.perf_counter()
        results[backend] = sim.run(batch, scores=scores)
        dt = seconds[backend] = time.perf_counter() - t0
        r = results[backend]
        print(f"index_backend={backend:6s}  replay {dt:6.2f} s  "
              f"throughput {r.throughput_mbs:7.1f} MB/s  "
              f"ssd_ratio {r.ssd_byte_ratio:.2f}  flushes {r.flushes}")

    a, b = results["numpy"], results["avl"]
    if (a.io_seconds, a.total_seconds, a.bytes_to_ssd) != \
            (b.io_seconds, b.total_seconds, b.bytes_to_ssd):
        raise RuntimeError(f"index backends disagree: {a} != {b}")
    print("\nbackends agree bit-for-bit.")

    # the per-request oracle on a small slice: same answer, slowly
    small = make_trace(32_768, seed=1)
    fast = IONodeSimulator(scheme="ssdup+", ssd_capacity=GiB, device=dev).run(small)
    oracle = IONodeSimulator(scheme="ssdup+", ssd_capacity=GiB, engine="per-request",
                             device=dev).run(small.to_items())
    if fast != oracle:
        raise RuntimeError(f"batched engine {fast} != per-request oracle {oracle}")
    print("batched engine == per-request oracle on the spot-check slice.")
    return {"batch": batch, "scores": scores, "results": results, "seconds": seconds,
            "spot_check": fast}


if __name__ == "__main__":
    main()
