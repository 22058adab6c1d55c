"""Deterministic golden traces.

Each named workload is rebuilt from fixed seeds through the port's
workload generators; a fixture stores only the name and a content
fingerprint of the materialized trace, which is checked before any
replay is compared.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..core.trace import Gap, TraceBatch
from ..core.workloads import MiB, ior, mixed, relabel


def _mixed_burst() -> TraceBatch:
    """Four apps (one sequential, two segmented-random, one strided) in a
    bursty arrival interleave, 256 MiB."""

    per_app = 64 * MiB
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
    return TraceBatch.from_items(mixed(*apps, burst_requests=256).trace)


def _strided_gaps() -> TraceBatch:
    """Strided + random phases separated by compute gaps, a ragged tail
    (37 requests trimmed) and a trailing gap."""

    w1 = relabel(ior("strided", 32, total_bytes=96 * MiB, seed=5),
                 app_id=0, file_id=0)
    w2 = relabel(ior("segmented-random", 8, total_bytes=64 * MiB, seed=6),
                 app_id=1, file_id=1)
    items = list(w1.trace)[:-37]
    items.append(Gap(2.0))
    items.extend(w2.trace)
    items.append(Gap(5.0))
    return TraceBatch.from_items(items)


GOLDEN_WORKLOADS = {
    "mixed-burst": _mixed_burst,
    "strided-gaps": _strided_gaps,
}


def golden_trace(name: str) -> TraceBatch:
    """Materialize a named canonical trace (deterministic)."""

    try:
        build = GOLDEN_WORKLOADS[name]
    except KeyError:
        raise ValueError(
            f"unknown golden workload {name!r}; "
            f"choose from {sorted(GOLDEN_WORKLOADS)}"
        ) from None
    return build()


def trace_fingerprint(batch: TraceBatch) -> dict:
    """Content fingerprint: sha256 over every request column and the gap
    schedule in fixed dtypes, plus counts."""

    h = hashlib.sha256()
    for arr, dtype in (
        (batch.offsets, np.int64),
        (batch.sizes, np.int64),
        (batch.file_ids, np.int64),
        (batch.app_ids, np.int64),
        (batch.gap_positions, np.int64),
        (batch.gap_seconds, np.float64),
    ):
        h.update(np.ascontiguousarray(arr, dtype=dtype).tobytes())
    return {
        "num_requests": int(batch.num_requests),
        "num_gaps": int(len(batch.gap_positions)),
        "total_bytes": int(batch.total_bytes),
        "sha256": h.hexdigest(),
    }


def sweep_trace(n: int = 1_000_000, seed: int = 0) -> TraceBatch:
    """The fleet sweep's trace (the reference's replay benchmark family):
    ``n`` requests of 64 KiB, offsets uniform in [0, 2^38), 16 files, 8
    apps, one 30 s compute gap at mid-trace."""

    rng = np.random.default_rng(seed)
    return TraceBatch(
        offsets=rng.integers(0, 1 << 38, size=n).astype(np.int64),
        sizes=np.full(n, 64 << 10, dtype=np.int64),
        file_ids=rng.integers(0, 16, size=n).astype(np.int64),
        app_ids=rng.integers(0, 8, size=n).astype(np.int64),
        times=np.zeros(n),
        gap_positions=np.asarray([n // 2], dtype=np.int64),
        gap_seconds=np.asarray([30.0]),
    )
