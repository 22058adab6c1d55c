"""Helpers that hold two runs of the burst-buffer service to each other.

* :func:`service_result_to_dict` — every field of a ``ServiceResult``:
  per-node results, every ``ServiceMetrics`` field and fault record, and
  the latency array;
* :func:`same_service_result` — two results equal in all of them;
* :class:`ReshardCountingService` — the service, counting the failovers
  that reshard pending windows onto survivors (each costs one more
  scoring launch).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..service.loop import BurstBufferService, ServiceResult


def service_result_to_dict(res: ServiceResult) -> dict:
    metrics = dataclasses.asdict(res.metrics)
    metrics.pop("_latency_chunks")
    return {
        "scheme": res.scheme, "policy": res.policy, "num_nodes": res.num_nodes,
        "node_results": [dataclasses.asdict(r) for r in res.node_results],
        "metrics": metrics,
        "latencies": res.metrics.latencies,
    }


def same_service_result(a: ServiceResult, b: ServiceResult) -> bool:
    da, db = service_result_to_dict(a), service_result_to_dict(b)
    la, lb = da.pop("latencies"), db.pop("latencies")
    return da == db and np.array_equal(la, lb)


class ReshardCountingService(BurstBufferService):
    """:class:`BurstBufferService` that counts, in ``reshards``, the
    failovers that move pending windows onto survivors."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.reshards = 0

    def _failover(self, lanes, hid, metrics):
        lane = lanes[hid]
        survivors = [l for l in lanes
                     if l is not lane and l.crash_at is None and not l.declared_dead]
        if not lane.declared_dead and survivors and any(k == "win" for k, _ in lane.queue):
            self.reshards += 1
        return super()._failover(lanes, hid, metrics)
