"""Online burst-buffer service: arrivals, fault injection, failover.

The port's online layer over the offline fleet engines:

* :mod:`repro_torch.service.arrivals` — open-loop offered loads
  (Poisson re-stamping, Zipf client mixes, checkpoint-burst waves).
* :mod:`repro_torch.service.injector` — seeded, scripted fault scenarios
  (crash / slow / ssd_degrade / stall).
* :mod:`repro_torch.service.loop` — the discrete-event service: epoch
  dispatch to per-node simulator sessions, heartbeat-driven failure
  detection (:mod:`repro_torch.distributed.fault_tolerance`), executed
  recovery (reshard, backlog replay, rebalancing, admission control),
  with every window scored by the stream kernel (one launch a run, one
  more a failover).
* :mod:`repro_torch.service.metrics` — tail latency, degraded-mode
  throughput, recovery time, and the byte-conservation ledger.
"""

from .arrivals import checkpoint_arrivals, poisson_arrivals, zipf_mix
from .injector import FAULT_KINDS, FaultEvent, FaultInjector, scripted
from .loop import BurstBufferService, ServiceResult, run_service_schemes
from .metrics import FaultRecord, ServiceMetrics

__all__ = [
    "checkpoint_arrivals",
    "poisson_arrivals",
    "zipf_mix",
    "FAULT_KINDS",
    "FaultEvent",
    "FaultInjector",
    "scripted",
    "BurstBufferService",
    "ServiceResult",
    "run_service_schemes",
    "FaultRecord",
    "ServiceMetrics",
]
