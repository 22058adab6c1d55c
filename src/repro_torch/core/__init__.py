"""SSDUP+ core on PyTorch: detection, buffering, the replay engines and the
fleet sweeps.

* detection    — :mod:`.random_factor` (Eq. 1 / Eq. 6 per-stream scores)
* policy       — :mod:`.adaptive` (Eq. 2/3 threshold)
* routing      — :mod:`.redirector` (Algorithm 1)
* buffering    — :mod:`.log_store` with two index backends, :mod:`.avl`
                 and :mod:`.extent_index` (Section 2.5)
* pipelining   — :mod:`.pipeline` (two regions, traffic-aware flushing)
* timing model — :mod:`.device_model`, :mod:`.ftl` (page-mapped SSD)
* workloads    — :mod:`.workloads` (IOR/HPIO/MPI-Tile-IO)
* trace batch  — :mod:`.trace` (columnar traces, batched scoring)
* replay       — :mod:`.simulator` (per-request and batched host engines)
                 and :mod:`.engine_device` (the transition over lanes)
* fleet        — :mod:`.fleet` (``FleetSimulator``, ``FleetProgram``)
* real bytes   — :mod:`.burst_buffer` (``BurstBufferWriter``: the same
                 machinery over a fast-tier and a slow-tier directory)
"""

from .adaptive import AdaptiveThreshold, StaticWatermarkThreshold
from .avl import AVLTree, Extent
from .burst_buffer import BurstBufferWriter
from .device_model import (
    STORAGE_BACKENDS,
    HDDModel,
    InterferenceModel,
    SSDModel,
    StorageModel,
    clone_storage,
    make_storage_model,
)
from .engine_device import DEVICE_TOLERANCES, replay_lanes, simulate_device
from .extent_index import INDEX_BACKENDS, ExtentIndex, make_index
from .fleet import FleetProgram, FleetResult, FleetSimulator, run_fleet_schemes
from .ftl import FTLModel
from .log_store import LogRegion, RegionFullError
from .pipeline import FlushState, SingleRegionBuffer, TwoRegionPipeline
from .random_factor import (
    DEFAULT_STREAM_LEN,
    Request,
    StreamGrouper,
    random_factor_batch,
    random_factor_sum,
    random_percentage,
    random_percentage_batch,
    stream_percentage,
)
from .redirector import DataRedirector, Device, RoutedStream
from .simulator import IONodeSimulator, SimResult, run_schemes
from .trace import Gap, StreamScores, TraceBatch, compute_stream_scores
from .workloads import (GiB, KiB, MiB, Workload, checkpoint_wave, hpio, ior, mixed,
                        mpi_tile_io, relabel)

__all__ = [
    "AVLTree", "AdaptiveThreshold", "BurstBufferWriter", "DEFAULT_STREAM_LEN", "DEVICE_TOLERANCES",
    "DataRedirector", "Device", "Extent", "ExtentIndex", "FTLModel",
    "FleetProgram", "FleetResult", "FleetSimulator", "FlushState", "Gap",
    "GiB", "HDDModel", "INDEX_BACKENDS", "IONodeSimulator",
    "InterferenceModel", "KiB", "LogRegion", "MiB", "RegionFullError",
    "Request", "RoutedStream", "SSDModel", "STORAGE_BACKENDS", "SimResult",
    "SingleRegionBuffer", "StaticWatermarkThreshold", "StorageModel",
    "StreamGrouper", "StreamScores", "TraceBatch", "TwoRegionPipeline",
    "Workload", "checkpoint_wave", "clone_storage", "compute_stream_scores", "hpio", "ior",
    "make_index", "make_storage_model", "mixed", "mpi_tile_io",
    "random_factor_batch", "random_factor_sum", "random_percentage",
    "random_percentage_batch", "relabel", "replay_lanes", "run_fleet_schemes",
    "run_schemes", "simulate_device", "stream_percentage",
]
