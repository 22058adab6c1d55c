"""HPC I/O access-pattern generators (paper Sections 2.2, 4.2-4.4).

The port's copy of the reference generators: IOR's segmented-contiguous,
segmented-random and strided patterns, HPIO regions, MPI-Tile-IO tiles,
and mixed multi-app loads.  They consume numpy's seeded generators in the
same order as the reference, so a trace built here is the reference's to
the byte (the golden fixtures' fingerprints check this).

Arrival model: each process issues its own ordered request sequence; the
server-side arrival order merges them with a stationary progress skew that
grows with contention (paper Fig. 2/6).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from .random_factor import Request

KiB = 1024
MiB = 1024 * KiB
GiB = 1024 * MiB

DEFAULT_REQUEST = 256 * KiB


def _segmented_contiguous_offsets(nproc: int, total: int, req: int) -> list[np.ndarray]:
    """Each process writes its 1/n segment of the shared file sequentially."""

    per = total // nproc
    nreq = per // req
    return [np.arange(nreq, dtype=np.int64) * req + p * per for p in range(nproc)]


def _segmented_random_offsets(
    nproc: int, total: int, req: int, rng: np.random.Generator
) -> list[np.ndarray]:
    """Segments as above but each process permutes its request order."""

    seqs = _segmented_contiguous_offsets(nproc, total, req)
    return [rng.permutation(s) for s in seqs]


def _strided_offsets(nproc: int, total: int, req: int) -> list[np.ndarray]:
    """Iteration i, process j touches offset (i*n + j) * req (paper §2.2)."""

    iters = total // (req * nproc)
    return [
        (np.arange(iters, dtype=np.int64) * nproc + j) * req for j in range(nproc)
    ]


def merge_arrivals(
    per_proc: Sequence[np.ndarray],
    req: int,
    rng: np.random.Generator,
    skew: float = 0.0,
    app_id: int = 0,
    file_id: int = 0,
    start_time: float = 0.0,
    dt: float = 1e-4,
) -> list[Request]:
    """Merge per-process sequences into one arrival-ordered trace.

    ``skew`` is the standard deviation (in requests) of each process's
    stationary progress offset; 0 is a perfect round-robin.
    """

    items: list[tuple[float, int, int]] = []  # (virtual time, proc, offset)
    for p, offs in enumerate(per_proc):
        n = len(offs)
        if n == 0:
            continue
        base = np.arange(n, dtype=np.float64)
        if skew > 0:
            base = base + rng.normal(0.0, skew) + rng.normal(0.0, skew * 0.2, n)
        phase = rng.uniform(0, 1) if skew > 0 else p / max(len(per_proc), 1)
        for i in range(n):
            items.append((base[i] + phase, p, int(offs[i])))
    items.sort(key=lambda t: (t[0], t[1]))
    return [
        Request(offset=off, size=req, file_id=file_id, app_id=app_id,
                time=start_time + k * dt)
        for k, (_, _p, off) in enumerate(items)
    ]


def contention_skew(nproc: int, base: float = 0.35) -> float:
    """Progress-drift magnitude as a function of process count."""

    return base * nproc


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    trace: tuple[Request, ...]
    total_bytes: int
    nproc: int

    def __len__(self) -> int:
        return len(self.trace)


def ior(
    pattern: str,
    nproc: int,
    total_bytes: int = 16 * GiB,
    request_size: int = DEFAULT_REQUEST,
    seed: int = 0,
    app_id: int = 0,
    file_id: int = 0,
    skew: float | None = None,
) -> Workload:
    """IOR trace with one of the paper's three access patterns."""

    rng = np.random.default_rng(seed)
    if pattern == "segmented-contiguous":
        eff_skew = (contention_skew(nproc) * 0.25) if skew is None else skew
        seqs = _segmented_contiguous_offsets(nproc, total_bytes, request_size)
    elif pattern == "segmented-random":
        eff_skew = contention_skew(nproc) if skew is None else skew
        seqs = _segmented_random_offsets(nproc, total_bytes, request_size, rng)
    elif pattern == "strided":
        eff_skew = 1.0 if skew is None else skew
        seqs = _strided_offsets(nproc, total_bytes, request_size)
    else:
        raise ValueError(f"unknown IOR pattern: {pattern}")
    trace = merge_arrivals(seqs, request_size, rng, skew=eff_skew,
                           app_id=app_id, file_id=file_id)
    return Workload(f"ior-{pattern}-{nproc}p", tuple(trace),
                    len(trace) * request_size, nproc)


def hpio(
    contiguous: bool,
    nproc: int = 32,
    region_size: int = 64 * KiB,
    region_count: int | None = None,
    region_spacing: int = 0,
    total_bytes: int = 8 * GiB,
    seed: int = 0,
    app_id: int = 0,
    file_id: int = 0,
) -> Workload:
    """HPIO-style trace (paper Section 4.3): contiguous (c-c) or strided
    (c-nc) regions per process."""

    rng = np.random.default_rng(seed)
    if region_count is None:
        region_count = max(total_bytes // (region_size * nproc), 1)
    seqs = []
    for p in range(nproc):
        idx = np.arange(region_count, dtype=np.int64)
        if contiguous:
            base = p * region_count * (region_size + region_spacing)
            offs = base + idx * (region_size + region_spacing)
        else:
            offs = (idx * nproc + p) * (region_size + region_spacing)
        seqs.append(offs)
    skew = contention_skew(nproc) * (0.25 if contiguous else 1.0)
    trace = merge_arrivals(seqs, region_size, rng, skew=skew, app_id=app_id,
                           file_id=file_id)
    return Workload(
        f"hpio-{'cc' if contiguous else 'cnc'}-{region_size//KiB}k",
        tuple(trace), len(trace) * region_size, nproc,
    )


def mpi_tile_io(
    nproc: int,
    one_dimensional: bool,
    element_size: int = 4 * KiB,
    total_bytes: int = 16 * GiB,
    seed: int = 0,
    app_id: int = 0,
    file_id: int = 0,
) -> Workload:
    """MPI-Tile-IO trace (paper Section 4.4): 1-D slabs or 2-D tiles whose
    rows are strided by the global array's row length."""

    rng = np.random.default_rng(seed)
    if one_dimensional:
        px = 1
    else:
        px = int(math.sqrt(nproc))
        while nproc % px:
            px -= 1

    elems_total = total_bytes // element_size
    tile_elems = max(elems_total // nproc, 1)
    tile_x = max(int(math.sqrt(tile_elems)), 1)  # elements per tile row
    tile_y = max(tile_elems // tile_x, 1)
    row_len = px * tile_x * element_size  # global array row in bytes

    seqs = []
    for p in range(nproc):
        gx, gy = p % px, p // px
        rows = np.arange(tile_y, dtype=np.int64)
        offs = (gy * tile_y + rows) * row_len + gx * tile_x * element_size
        seqs.append(offs)
    req = tile_x * element_size
    trace = merge_arrivals(seqs, req, rng, skew=contention_skew(nproc),
                           app_id=app_id, file_id=file_id)
    return Workload(
        f"tileio-{'1d' if one_dimensional else '2d'}-{nproc}p",
        tuple(trace), len(trace) * req, nproc,
    )


def mixed(
    *workloads: Workload, seed: int = 0, burst_requests: int | None = None
) -> Workload:
    """Interleave several app traces into one server-side arrival order:
    by timestamp (``burst_requests=None``) or in jittered bursts of about
    ``burst_requests`` requests per app."""

    if burst_requests is None:
        merged: list[Request] = []
        for w in workloads:
            merged.extend(w.trace)
        merged.sort(key=lambda r: (r.time, r.app_id, r.offset))
    else:
        rng = np.random.default_rng(seed)
        cursors = [0] * len(workloads)
        merged = []
        while any(c < len(w.trace) for c, w in zip(cursors, workloads)):
            for i, w in enumerate(workloads):
                if cursors[i] >= len(w.trace):
                    continue
                k = max(1, int(burst_requests * rng.uniform(0.5, 1.5)))
                merged.extend(w.trace[cursors[i]: cursors[i] + k])
                cursors[i] += k
    name = "+".join(w.name for w in workloads)
    return Workload(
        f"mixed({name})",
        tuple(merged),
        sum(w.total_bytes for w in workloads),
        sum(w.nproc for w in workloads),
    )


def checkpoint_wave(
    nproc: int,
    waves: int = 4,
    bytes_per_wave: int = 2 * GiB,
    compute_seconds: float = 30.0,
    request_size: int = DEFAULT_REQUEST,
    rotate_files: int = 2,
    seed: int = 0,
    app_id: int = 0,
    file_id: int = 0,
) -> Workload:
    """Checkpoint-burst workload: after every ``compute_seconds`` of
    computation all ``nproc`` processes dump their checkpoint segment at
    once (a segmented-contiguous burst), with a :class:`~.trace.Gap`
    compute phase between bursts.  Files rotate over ``rotate_files``
    handles (double-buffered checkpoints), so wave ``w`` overwrites the
    extents wave ``w - rotate_files`` wrote."""

    if waves < 1:
        raise ValueError(f"waves must be >= 1, got {waves}")
    if rotate_files < 1:
        raise ValueError(f"rotate_files must be >= 1, got {rotate_files}")
    from .trace import Gap  # local: keeps this module free of torch

    rng = np.random.default_rng(seed)
    items: list = []
    t = 0.0
    total = 0
    for w in range(waves):
        if w:
            items.append(Gap(compute_seconds))
        seqs = _segmented_contiguous_offsets(nproc, bytes_per_wave, request_size)
        burst = merge_arrivals(
            seqs, request_size, rng,
            skew=contention_skew(nproc) * 0.25,
            app_id=app_id, file_id=file_id + (w % rotate_files),
            start_time=t,
        )
        items.extend(burst)
        total += len(burst) * request_size
        t = (burst[-1].time if burst else t) + compute_seconds
    return Workload(f"ckpt-{nproc}p-{waves}w", tuple(items), total, nproc)


def relabel(w: Workload, app_id: int, file_id: int, start_time: float = 0.0) -> Workload:
    """Retag a workload for use inside a mixed load."""

    trace = tuple(
        dataclasses.replace(r, app_id=app_id, file_id=file_id,
                            time=r.time + start_time)
        for r in w.trace
    )
    return Workload(w.name, trace, w.total_bytes, w.nproc)
