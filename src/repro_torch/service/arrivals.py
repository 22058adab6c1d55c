"""Open-loop arrival processes for the burst-buffer service.

The offline engines ignore request timestamps; the service loop does not:
a window can only start once its last request has *arrived*.  These
helpers compose the :mod:`repro_torch.core.workloads` generators into
timestamped offered loads:

* :func:`poisson_arrivals` — re-stamp any trace with a Poisson arrival
  process of a given aggregate rate (exponential inter-arrivals); the
  request *order* and gap markers are untouched, so offline replay of
  the result is unchanged.
* :func:`zipf_mix` — interleave several app workloads with Zipf-skewed
  popularity (client mixes where a few hot apps dominate, the
  millions-of-clients regime), then Poisson-stamp the merge.
* :func:`checkpoint_arrivals` — checkpoint-burst waves
  (:func:`repro_torch.core.workloads.checkpoint_wave`) as a TraceBatch:
  synchronized write spikes separated by compute gaps, the canonical
  burst-buffer traffic from the Wang et al. paper (PAPERS.md).

All are seeded and pure: same arguments, same offered load.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.trace import TraceBatch
from ..core.workloads import Workload, checkpoint_wave


def poisson_arrivals(
    trace: TraceBatch | Workload,
    rate_rps: float,
    seed: int = 0,
    start: float = 0.0,
) -> TraceBatch:
    """Re-stamp a trace's arrival times with a Poisson process.

    ``rate_rps`` is the aggregate request arrival rate (requests/second);
    inter-arrival gaps are iid exponential.  Only ``times`` changes —
    order, offsets, and gap markers stay, so scoring and offline replay
    are unaffected.
    """

    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    batch = (
        trace if isinstance(trace, TraceBatch)
        else TraceBatch.from_items(trace.trace)
    )
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, batch.num_requests)
    return TraceBatch(
        offsets=batch.offsets,
        sizes=batch.sizes,
        file_ids=batch.file_ids,
        app_ids=batch.app_ids,
        times=start + np.cumsum(gaps),
        gap_positions=batch.gap_positions,
        gap_seconds=batch.gap_seconds,
    )


def zipf_mix(
    apps: Sequence[Workload],
    rate_rps: float,
    s: float = 1.2,
    seed: int = 0,
) -> TraceBatch:
    """Interleave app workloads with Zipf(``s``) popularity weights.

    App ``k`` (0-based, in the given order) is drawn with probability
    proportional to ``(k + 1) ** -s`` at every arrival slot until its
    requests are exhausted; each app's internal request order is
    preserved.  The merged trace is then Poisson-stamped at
    ``rate_rps``.  Gap markers inside the member workloads are dropped
    (a multi-tenant arrival mix has no global compute phase).
    """

    if not apps:
        raise ValueError("zipf_mix needs at least one workload")
    if s < 0:
        raise ValueError(f"zipf exponent must be >= 0, got {s}")
    rng = np.random.default_rng(seed)
    queues = [
        [r for r in w.trace if hasattr(r, "offset")] for w in apps
    ]
    weights = np.array(
        [(k + 1.0) ** -s for k in range(len(apps))], dtype=np.float64
    )
    cursors = [0] * len(apps)
    merged = []
    remaining = sum(len(q) for q in queues)
    while remaining:
        live = np.array(
            [cursors[i] < len(queues[i]) for i in range(len(apps))]
        )
        p = np.where(live, weights, 0.0)
        p = p / p.sum()
        i = int(rng.choice(len(apps), p=p))
        merged.append(queues[i][cursors[i]])
        cursors[i] += 1
        remaining -= 1
    batch = TraceBatch.from_items(merged)
    return poisson_arrivals(batch, rate_rps, seed=seed + 1)


def checkpoint_arrivals(
    nproc: int,
    waves: int = 4,
    compute_seconds: float = 30.0,
    seed: int = 0,
    **kwargs,
) -> TraceBatch:
    """Checkpoint-burst offered load: synchronized write waves separated
    by ``compute_seconds`` gaps (see
    :func:`repro_torch.core.workloads.checkpoint_wave` for the knobs)."""

    wl = checkpoint_wave(
        nproc, waves=waves, compute_seconds=compute_seconds, seed=seed,
        **kwargs,
    )
    return TraceBatch.from_items(wl.trace)
