"""The port's buffering structures (``avl``, ``extent_index``, ``log_store``,
``pipeline``, ``redirector``) against the reference's.

Each test drives the same seeded random operation sequence through both
packages' classes and records every observable answer (lookups, in-order
walks, flush orders, append outcomes, counters, routing decisions).  The
port keeps its own copy of this host code, so the records must be equal
(tolerance 0).
"""

import dataclasses
import enum

import numpy as np
import pytest

import repro.core.adaptive as r_adaptive
import repro.core.avl as r_avl
import repro.core.device_model as r_dm
import repro.core.extent_index as r_ext
import repro.core.ftl as r_ftl
import repro.core.log_store as r_log
import repro.core.pipeline as r_pipe
import repro.core.random_factor as r_rf
import repro.core.redirector as r_red
import repro_torch.core.adaptive as p_adaptive
import repro_torch.core.avl as p_avl
import repro_torch.core.device_model as p_dm
import repro_torch.core.extent_index as p_ext
import repro_torch.core.ftl as p_ftl
import repro_torch.core.log_store as p_log
import repro_torch.core.pipeline as p_pipe
import repro_torch.core.random_factor as p_rf
import repro_torch.core.redirector as p_red

REF = dict(avl=r_avl, ext=r_ext, log=r_log, pipe=r_pipe, red=r_red, rf=r_rf,
           adaptive=r_adaptive, ftl=r_ftl, dm=r_dm)
PORT = dict(avl=p_avl, ext=p_ext, log=p_log, pipe=p_pipe, red=p_red, rf=p_rf,
            adaptive=p_adaptive, ftl=p_ftl, dm=p_dm)


def _obs(x):
    """A plain, comparable form of an answer from either package."""

    if isinstance(x, enum.Enum):
        return x.value
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return tuple(_obs(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if isinstance(x, (list, tuple)):
        return tuple(_obs(v) for v in x)
    if isinstance(x, dict):
        return {_obs(k): _obs(v) for k, v in x.items()}
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    return x


def _both(drive, seed):
    ref, port = drive(REF, seed), drive(PORT, seed)
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert _obs(a) == _obs(b), f"step {i}: {a!r} != {b!r}"
    return ref


def _index_ops(m, seed, backend):
    rng = np.random.default_rng(seed)
    idx = m["ext"].make_index(backend)
    out = []
    for step in range(300):
        op = rng.random()
        if op < 0.6:
            off = int(rng.integers(0, 64)) * 4096
            size = int(rng.integers(1, 4)) * 4096
            idx.insert(off, size, step * 8192)
        elif op < 0.75:
            n = int(rng.integers(0, 20))
            offs = rng.integers(0, 64, size=n).astype(np.int64) * 4096
            szs = rng.integers(1, 4, size=n).astype(np.int64) * 4096
            idx.insert_batch(offs, szs, np.arange(n, dtype=np.int64) * 4096 + step)
        elif op < 0.95:
            out.append(idx.lookup(int(rng.integers(0, 64)) * 4096))
        else:
            out.append(list(idx.in_order()))
        out.append((len(idx), idx.min_key(), idx.max_key(), idx.approx_bytes()))
    out.append(list(idx.in_order()))
    out.append(idx.in_order_arrays())
    idx.clear()
    out.append((len(idx), list(idx.in_order())))
    return out


@pytest.mark.parametrize("backend", ["avl", "numpy"])
@pytest.mark.parametrize("seed", range(4))
def test_extent_index_backends_equal_reference(backend, seed):
    _both(lambda m, s: _index_ops(m, s, backend), seed)


@pytest.mark.parametrize("seed", range(3))
def test_avl_tree_equals_reference(seed):
    def drive(m, s):
        rng = np.random.default_rng(s)
        tree = m["avl"].AVLTree()
        out = []
        for step in range(400):
            tree.insert(int(rng.integers(0, 1 << 20)), int(rng.integers(1, 9)), step)
            if step % 37 == 0:
                tree.check_invariants()
                out.append((tree.height, len(tree), tree.min_key(), tree.max_key(),
                            tree.approx_bytes()))
        out.append(list(tree.in_order()))
        out.append(tree.in_order_arrays())
        out.append([tree.lookup(int(k)) for k in rng.integers(0, 1 << 20, size=50)])
        return out

    _both(drive, seed)


def _region_ops(m, seed, backend):
    rng = np.random.default_rng(seed)
    region = m["log"].LogRegion(1 << 20, "R", index_backend=backend)
    out = []
    for _ in range(120):
        fid = int(rng.integers(0, 3))
        if rng.random() < 0.5:
            size = int(rng.integers(1, 5)) * 4096
            try:
                out.append(region.append(fid, int(rng.integers(0, 256)) * 4096, size))
            except m["log"].RegionFullError:
                out.append("full")
        else:
            n = int(rng.integers(1, 12))
            szs = rng.integers(1, 5, size=n).astype(np.int64) * 4096
            if region.fits(int(szs.sum())):
                region.append_batch(np.full(n, fid, dtype=np.int64),
                                    rng.integers(0, 256, size=n).astype(np.int64) * 4096, szs)
            out.append(region.fits(int(szs.sum())))
        out.append((region.used_bytes, region.free_bytes(), region.num_records,
                    region.metadata_bytes()))
    out.append(region.records)
    out.append(region.last_record)
    out.append(list(region.flush_order()))
    out.append(list(region.flush_arrays()))
    out.append((region.flush_bytes(), region.seek_count_if_unsorted(),
                region.seek_count_sorted()))
    region.reset()
    out.append((region.used_bytes, region.num_records, list(region.flush_order())))
    return out


@pytest.mark.parametrize("backend", ["avl", "numpy"])
@pytest.mark.parametrize("seed", range(3))
def test_log_region_equals_reference(backend, seed):
    _both(lambda m, s: _region_ops(m, s, backend), seed)


def _pipeline_ops(m, seed, kind, with_ftl):
    rng = np.random.default_rng(seed)
    pct = {"v": 0.5}
    storage = m["ftl"].FTLModel(logical_bytes=1 << 20) if with_ftl else None
    kw = dict(percentage_source=lambda: pct["v"], storage=storage)
    if kind == "two-region":
        pipe = m["pipe"].TwoRegionPipeline(1 << 19, traffic_aware=True, **kw)
    elif kind == "two-region-device-gate":
        pipe = m["pipe"].TwoRegionPipeline(1 << 19, flush_gate="device",
                                           fg_ssd_source=lambda: pct["v"] > 0.5, **kw)
    else:
        pipe = m["pipe"].SingleRegionBuffer(1 << 20, **kw)
    out = []
    for _ in range(300):
        pct["v"] = float(rng.random())
        op = rng.random()
        if op < 0.6:
            out.append(pipe.append(int(rng.integers(0, 2)), int(rng.integers(0, 64)) * 4096,
                                   int(rng.integers(1, 9)) * 4096))
        elif op < 0.85:
            out.append(pipe.flush_progress(int(rng.integers(0, 1 << 17))))
        elif op < 0.92:
            pipe.note_pause(float(rng.random()))
        elif op < 0.96:
            pipe.force_flush()
        out.append((pipe.flush_state(), pipe.flush_allowed(), pipe.buffered_bytes,
                    pipe.metadata_bytes, pipe.flushes_completed, pipe.total_flushed_bytes,
                    pipe.total_paused_seconds, pipe.blocked_events))
    jobs = pipe.drain()
    hdd = m["dm"].HDDModel()
    out.append([(j.bytes_total, j.seeks, j.bytes_done, j.forced, j.paused_seconds,
                 j.service_seconds(hdd), j.effective_rate(hdd, storage)) for j in jobs])
    if storage is not None:
        out.append(storage.stats())
    return out


@pytest.mark.parametrize("with_ftl", [False, True], ids=["no-storage", "ftl"])
@pytest.mark.parametrize("kind", ["two-region", "two-region-device-gate", "single-region"])
@pytest.mark.parametrize("seed", range(2))
def test_pipelines_equal_reference(kind, with_ftl, seed):
    _both(lambda m, s: _pipeline_ops(m, s, kind, with_ftl), seed)


@pytest.mark.parametrize("policy", ["adaptive", "static"])
@pytest.mark.parametrize("seed", range(3))
def test_redirector_equals_reference(policy, seed):
    def drive(m, s):
        rng = np.random.default_rng(s)
        pol = (m["adaptive"].AdaptiveThreshold(window=16) if policy == "adaptive"
               else m["adaptive"].StaticWatermarkThreshold())
        red = m["red"].DataRedirector(pol, stream_len=16)
        reqs = []
        for i in range(700):
            seq = (i // 100) % 2 == 0
            off = i * 4096 if seq else int(rng.integers(0, 1 << 30))
            reqs.append(m["rf"].Request(offset=off, size=4096, file_id=i % 3, app_id=i % 2))
        out = [(r.device, r.percentage, r.threshold, r.index, r.bytes,
                [(q.offset, q.size) for q in r.stream]) for r in red.route(reqs)]
        tail = red.finish()
        out.append(None if tail is None else (tail.device, tail.percentage, tail.index))
        for nb, p in zip(rng.integers(1, 1 << 20, size=50), rng.random(50)):
            out.append(red.route_scored(int(nb), float(p)))
        out.append((red.ssd_byte_ratio, red.ssd_stream_ratio, red.bytes_to, red.streams_to,
                    red.decisions, pol.threshold))
        red.reset()
        out.append((red.current_device, pol.threshold))
        return out

    _both(drive, seed)


@pytest.mark.parametrize("window", [None, 1, 10, 64])
def test_adaptive_threshold_equals_reference(window):
    def drive(m, s):
        rng = np.random.default_rng(s)
        pol = m["adaptive"].AdaptiveThreshold(window=window)
        pol.seed(list(rng.random(30)))
        out = pol.observe_many(list(rng.random(200)))
        out.append((pol.threshold, pol.avgper, pol.percent_list, pol.observations,
                    [pol.is_random(p) for p in rng.random(20)]))
        return out

    _both(drive, window or 0)


@pytest.mark.parametrize("seed", range(3))
def test_scalar_scorers_equal_reference(seed):
    def drive(m, s):
        rng = np.random.default_rng(s)
        rf = m["rf"]
        out = []
        grouper = rf.StreamGrouper(stream_len=7)
        reqs = [rf.Request(int(o), int(z)) for o, z in
                zip(rng.integers(0, 1 << 16, size=60) * 512, rng.integers(1, 4, size=60) * 512)]
        for stream in grouper.push_many(reqs):
            out.append((rf.stream_percentage(stream), rf.sorted_seek_distance(stream)))
        tail = grouper.flush()
        out.append((grouper.streams_emitted, grouper.pending, len(tail or ())))
        for n in (0, 1, 2, 17, 128):
            offs = rng.integers(-(1 << 40), 1 << 40, size=n)
            szs = rng.integers(0, 1 << 20, size=n)
            out.append((rf.random_factor_sum(offs, szs), rf.random_percentage(offs, szs),
                        rf.seek_distance_np(offs, szs), rf.random_factor_sum(offs, 4096)))
        return out

    _both(drive, seed)
