"""SSDUP+ core on PyTorch: trace scoring and the device fleet sweep.

* detection    — :mod:`.random_factor` (Eq. 1 / Eq. 6 per-stream scores)
* policy       — :mod:`.adaptive` (Eq. 2/3 threshold, host side)
* timing model — :mod:`.device_model`
* workloads    — :mod:`.workloads` (IOR/HPIO/MPI-Tile-IO)
* trace batch  — :mod:`.trace` (columnar traces, batched scoring)
* device engine— :mod:`.engine_device` (the replay transition over lanes)
* fleet        — :mod:`.fleet` (``FleetProgram``: the scheme x node sweep)
"""

from .engine_device import DEVICE_TOLERANCES, replay_lanes, simulate_device
from .fleet import FleetProgram, FleetResult
from .random_factor import DEFAULT_STREAM_LEN, Request
from .simulator import SimResult
from .trace import Gap, StreamScores, TraceBatch, compute_stream_scores
from .workloads import KiB, MiB, GiB, Workload, hpio, ior, mixed, mpi_tile_io, relabel

__all__ = [
    "DEFAULT_STREAM_LEN", "DEVICE_TOLERANCES", "FleetProgram", "FleetResult",
    "Gap", "GiB", "KiB", "MiB", "Request", "SimResult", "StreamScores",
    "TraceBatch", "Workload", "compute_stream_scores", "hpio", "ior",
    "mixed", "mpi_tile_io", "relabel", "replay_lanes", "simulate_device",
]
