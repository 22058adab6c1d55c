"""One IOR run on a shared file, in the layouts the SSDUP+ paper measures
(arXiv 1902.05746, Sec. 2.2 and 4): each of ``processes`` writes its
segment of ``total_bytes / processes`` bytes in aligned ``request_size``
transfers, each transfer once.  ``segmented-contiguous`` writes the
segment in order; ``segmented-random`` (IOR's ``-z`` on a segment) writes
a permutation of its transfers.  The I/O node sees the processes'
sequences merged with a stationary progress skew of
``skew_per_process * processes * skew_scale`` requests (the port's arrival
model), one request every ``arrival_dt`` seconds, and no compute gaps.

A vectorised copy of the port's ``core.workloads.ior`` (with its
``merge_arrivals``): the same draws in the same order and a stable sort by
(virtual time, process), so the two agree request for request on a seed.
"""

from __future__ import annotations

import numpy as np

PATTERNS = ("segmented-contiguous", "segmented-random")


def generate(seed: int, args: dict) -> dict[str, np.ndarray]:
    pattern = args["pattern"]
    if pattern not in PATTERNS:
        raise ValueError(f"unknown IOR layout {pattern!r}; choose from {PATTERNS}")
    rng = np.random.default_rng(seed)
    nproc, req = int(args["processes"]), int(args["request_size"])
    per = int(args["total_bytes"]) // nproc
    nreq = per // req
    seqs = [np.arange(nreq, dtype=np.int64) * req + p * per for p in range(nproc)]
    if pattern == "segmented-random":
        seqs = [rng.permutation(s) for s in seqs]
    skew = args["skew_per_process"] * nproc * args["skew_scale"]
    base = np.arange(nreq, dtype=np.float64)
    vt = np.empty((nproc, nreq))
    for p in range(nproc):
        vt[p] = base + rng.normal(0.0, skew) + rng.normal(0.0, skew * 0.2, nreq)
        vt[p] += rng.uniform(0, 1)
    proc = np.repeat(np.arange(nproc, dtype=np.int64), nreq)
    order = np.lexsort((proc, vt.ravel()))
    offsets = np.concatenate(seqs)[order]
    n = offsets.size
    return {
        "offsets": offsets,
        "sizes": np.full(n, req, dtype=np.int64),
        "file_ids": np.full(n, int(args["file_id"]), dtype=np.int64),
        "app_ids": np.full(n, int(args["app_id"]), dtype=np.int64),
        "times": np.arange(n) * float(args["arrival_dt"]),
        "gap_positions": np.zeros(0, dtype=np.int64),
        "gap_seconds": np.zeros(0, dtype=np.float64),
    }
