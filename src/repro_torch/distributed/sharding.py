"""Trace sharding: request -> I/O node assignment for the fleet.

Each policy is a pure function of the trace's columns, so the shards
partition the trace exactly; :func:`reshard_to_survivors` re-policies a
dead node's requests over the survivors.  The port's copy of the
reference's trace policies; the tensor-mesh half of the reference module
belongs to the model stack and is not ported yet.
"""

from __future__ import annotations

import numpy as np


def shard_round_robin_app(offsets, file_ids, app_ids, num_nodes: int) -> np.ndarray:
    """Pin whole applications to nodes round-robin, by first appearance."""

    app_ids = np.asarray(app_ids, dtype=np.int64)
    _, first_pos, inverse = np.unique(app_ids, return_index=True,
                                      return_inverse=True)
    # np.unique sorts by id; re-rank the apps by arrival
    rank_of_sorted = np.argsort(np.argsort(first_pos, kind="stable"),
                                kind="stable")
    return (rank_of_sorted[inverse] % num_nodes).astype(np.int64)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix (SplitMix64 finalizer), vectorized."""

    z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def shard_hash_file(offsets, file_ids, app_ids, num_nodes: int) -> np.ndarray:
    """Hash each file handle to a node."""

    file_ids = np.asarray(file_ids, dtype=np.int64)
    return (_splitmix64(file_ids) % np.uint64(num_nodes)).astype(np.int64)


def shard_range_offset(offsets, file_ids, app_ids, num_nodes: int) -> np.ndarray:
    """Stripe the trace's logical byte range into ``num_nodes`` equal
    extents (Lustre-style range partitioning)."""

    offsets = np.asarray(offsets, dtype=np.int64)
    if offsets.size == 0:
        return np.zeros(0, dtype=np.int64)
    lo = int(offsets.min())
    hi = int(offsets.max())
    extent = max((hi - lo) // num_nodes + 1, 1)
    return np.minimum((offsets - lo) // extent, num_nodes - 1).astype(np.int64)


TRACE_POLICIES = {
    "round-robin-app": shard_round_robin_app,
    "hash-file": shard_hash_file,
    "range-offset": shard_range_offset,
}


def assign_nodes(policy: str, offsets, file_ids, app_ids,
                 num_nodes: int) -> np.ndarray:
    """Per-request node assignment under a named trace-sharding policy."""

    if num_nodes < 1:
        raise ValueError(f"num_nodes must be >= 1, got {num_nodes}")
    try:
        fn = TRACE_POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown trace sharding policy {policy!r}; "
            f"choose from {sorted(TRACE_POLICIES)}"
        ) from None
    out = fn(offsets, file_ids, app_ids, num_nodes)
    if out.shape[0] != np.asarray(offsets).shape[0]:
        raise ValueError(
            f"policy {policy!r} returned {out.shape[0]} assignments for "
            f"{np.asarray(offsets).shape[0]} requests"
        )
    return out


def reshard_to_survivors(policy: str, offsets, file_ids, app_ids,
                         assignment, survivors) -> np.ndarray:
    """Reassign requests stranded on dead nodes onto the survivors.

    Requests whose ``assignment`` already names a survivor stay put; every
    other request is re-policied over the survivor set (the policy runs
    with ``num_nodes = len(survivors)`` and its output indexes the sorted
    survivor list).  Pure and deterministic.
    """

    assignment = np.asarray(assignment, dtype=np.int64)
    surv = np.asarray(sorted(set(int(s) for s in survivors)), dtype=np.int64)
    if surv.size == 0:
        raise ValueError("no surviving nodes to reshard onto")
    out = assignment.copy()
    dead_mask = ~np.isin(assignment, surv)
    if not dead_mask.any():
        return out
    idx = np.nonzero(dead_mask)[0]
    sub = assign_nodes(
        policy,
        np.asarray(offsets)[idx],
        np.asarray(file_ids)[idx],
        np.asarray(app_ids)[idx],
        int(surv.size),
    )
    out[idx] = surv[sub]
    return out
