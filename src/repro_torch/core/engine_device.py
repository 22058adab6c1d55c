"""Device replay engine: the batched engine's per-node transition as torch
tensor code over a batch of lanes.

A *lane* is one (node shard, scheme) pair; a fleet sweep replays every
lane at once (:class:`repro_torch.core.fleet.FleetProgram`).

* **events** — :func:`build_events` lowers one shard's
  (:class:`~repro_torch.core.trace.TraceBatch`,
  :class:`~repro_torch.core.trace.StreamScores`) pair into an event tape
  on the host: one entry per stream or compute gap, in the batched
  engine's firing order, with every timing input precomputed in float64
  (whole-stream HDD time, network time, SSD walls, and the Eq. 6 window,
  prefix, suffix and cross-stream-merge anchors).  :func:`stack_events`
  pads tapes to a shared length with ``valid=False`` entries.
* **state** — :func:`initial_lane_state` builds each lane's state (clocks,
  byte counters, region occupancy, the single in-flight flush job, the
  adaptive-threshold window as a circular buffer, routing hysteresis).
* **transition** — :func:`_event_step` advances every lane by one event:
  stream routing (Eq. 1-3 threshold + Algorithm 1 hysteresis), SSD region
  fills/swaps/blocks in a masked loop, HDD advances with Eq. 7
  interference, flush accounting per Eq. 6, and compute-gap draining.
  All four schemes run the same step, selected per lane by flags.
* **orchestration** — :func:`replay_lanes` moves the tape and lane state
  to the device once (:func:`to_device`), loops over the tape's events,
  drains, and returns per-lane results; :func:`simulate_device` wraps one
  lane into a :class:`~repro_torch.core.simulator.SimResult`.

Lanes are the leading dimension of every state tensor (the adaptive window
is ``(L, W)``).  Clocks and rates are float64, byte counters int64, and
window indices, flush counts and scheme ids int32, so that integer
arithmetic, ``%`` and comparisons act as in the reference.

The region-fill loop computes its body for every lane and keeps the
result only for lanes still filling (``torch.where`` on every carried
field), as a batched while loop does; it runs while any lane is active,
which costs one host synchronisation per iteration.

Accuracy contract (the reference's, vs the request-granular NumPy
engines): the engine is stream-granular.  Region fills stop on
mean-request boundaries, flush quanta accumulate in float64, Eq. 6
residual seeks come from precomputed anchors, and plain-BB overflow
suffixes are interpolated; routing and byte accounting of the orangefs,
ssdup and ssdup+ schemes are exact.  :data:`DEVICE_TOLERANCES` bounds the
rest and is embedded in every golden fixture.  The unbounded adaptive
window is not representable; a finite window is required.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ..analysis import sanitize as _sanitize
from ..device import resolve_device
from .adaptive import DEFAULT_THRESHOLD, AdaptiveThreshold, StaticWatermarkThreshold
from .device_model import HDDModel, IngestLink, InterferenceModel, SSDModel
from .random_factor import DEFAULT_STREAM_LEN

SCHEME_IDS = {"orangefs": 0, "orangefs-bb": 1, "ssdup": 2, "ssdup+": 3}

#: Comparison tolerances of the device engine vs the NumPy engines, per
#: SimResult field: ``field -> (rtol, atol)``; ``(0, 0)`` is exact.
DEVICE_TOLERANCES: dict[str, tuple[float, float]] = {
    "total_bytes": (0.0, 0.0),        # conservation: every byte lands
    "per_app_bytes": (0.0, 0.0),      # host-computed, scheme-independent
    "bytes_to_ssd": (0.0, 4 << 20),   # BB overflow split is timing-coupled
    "bytes_to_hdd_direct": (0.0, 4 << 20),
    "metadata_bytes": (0.0, 0.0),     # both report 0 post-drain
    "flushes": (0.0, 2.0),            # BB flush count is timing-coupled
    "peak_ssd_occupancy": (0.0, 4 << 20),
    "blocked_seconds": (0.05, 1e-6),  # Eq. 6 anchor lerp at block time
    "flush_paused_seconds": (0.05, 1e-6),
    "io_seconds": (0.05, 1e-9),       # suffix/seek anchor lerp dominates
    "total_seconds": (0.02, 1e-9),
}

#: Suffix anchors: stream suffix HDD times at ``round(j * n / A)`` for
#: ``j = 0..A`` (anchor 0 = the whole stream, the last = empty suffix).
SUFFIX_ANCHORS = 16

#: Dyadic window scales for the Eq. 6 region-seek anchors: whole, halves,
#: quarters, eighths (15 windows).
WINDOW_SCALES = 4
N_WINDOWS = (1 << WINDOW_SCALES) - 1

#: Cross-stream merge depth: contiguous pairs a stream forms with each of
#: its ``XMERGE_D`` predecessors, subtracted while both share a region.
XMERGE_D = 4

_EVENT_FIELDS = {
    "valid": np.bool_,
    "is_gap": np.bool_,
    "gap_sec": np.float64,
    "pct": np.float64,
    "nbytes": np.int64,
    "net_t": np.float64,
    "ssd_w": np.float64,
    "mean_sz": np.float64,
    **{f"hddt_{j}": np.float64 for j in range(SUFFIX_ANCHORS + 1)},
    **{f"pf_{j}": np.float64 for j in range(SUFFIX_ANCHORS + 1)},
    **{f"wf_{i}": np.float64 for i in range(N_WINDOWS)},
    **{f"wn_{i}": np.float64 for i in range(N_WINDOWS)},
    **{f"xm_{d}": np.float64 for d in range(1, XMERGE_D + 1)},
}


# ---------------------------------------------------------------------------
# host side: event tapes, lane constants, initial state (NumPy)
# ---------------------------------------------------------------------------


def _cross_stream_merges(batch, bounds: np.ndarray) -> np.ndarray:
    """Per-stream cross-merge counts ``(ns, XMERGE_D)``: ``out[j, d-1]`` =
    contiguous pairs stream ``j`` forms with stream ``j - d`` in the global
    per-file offset sort (each pair assigned to the later stream)."""

    ns = len(bounds) - 1
    out = np.zeros((ns, XMERGE_D), dtype=np.float64)
    if batch.num_requests < 2:
        return out
    sid = np.repeat(np.arange(ns, dtype=np.int64), np.diff(bounds))
    order = np.lexsort((batch.offsets, batch.file_ids))
    so = batch.offsets[order]
    ss = batch.sizes[order]
    sf = batch.file_ids[order]
    ssid = sid[order]
    contig = (sf[1:] == sf[:-1]) & (so[1:] == so[:-1] + ss[:-1])
    d = np.abs(ssid[1:] - ssid[:-1])
    later = np.maximum(ssid[1:], ssid[:-1])
    for k in range(1, XMERGE_D + 1):
        sel = contig & (d == k)
        out[:, k - 1] = np.bincount(later[sel], minlength=ns)
    return out


def _masked_predecessors(mask: np.ndarray) -> np.ndarray:
    """Index of each element's nearest PRECEDING masked element (-1: none),
    so a subset of a sorted sequence is scored without a re-sort."""

    idx = np.arange(mask.shape[0], dtype=np.int64)
    pidx = np.maximum.accumulate(np.where(mask, idx, -1))
    prev = np.empty_like(pidx)
    prev[0] = -1
    prev[1:] = pidx[:-1]
    return prev


def _window_seek_anchors(
    batch, bounds: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Eq. 6 seek anchors of dyadic arrival-windows of every stream:
    ``(wf, wn)`` of shape ``(ns, N_WINDOWS)`` — each window scored alone,
    extent count and distinct-file baseline, scale-major columns."""

    ns = len(bounds) - 1
    lens = np.diff(bounds)
    wf = np.zeros((ns, N_WINDOWS), dtype=np.float64)
    wn = np.zeros((ns, N_WINDOWS), dtype=np.float64)
    if batch.num_requests == 0:
        return wf, wn
    sid = np.repeat(np.arange(ns, dtype=np.int64), lens)
    pos_in = np.arange(batch.num_requests, dtype=np.int64) - np.repeat(
        bounds[:-1], lens
    )
    order = np.lexsort((batch.offsets, batch.file_ids, sid))
    so = batch.offsets[order]
    ss = batch.sizes[order]
    sf = batch.file_ids[order]
    sdi = sid[order]
    spos = pos_in[order]
    slen = lens[sdi]
    col = 0
    for s in range(WINDOW_SCALES):
        w = 1 << s
        # window of position p: boundaries at round(k * len / w), i.e.
        # 2*len*k < (2p+1)*w -- integer-exact
        win = np.minimum(
            ((2 * spos + 1) * w - 1) // np.maximum(2 * slen, 1), w - 1
        )
        for k in range(w):
            m = win == k
            prev = _masked_predecessors(m)
            pc = np.maximum(prev, 0)
            same = m & (prev >= 0) & (sdi[pc] == sdi) & (sf[pc] == sf)
            contig = same & (so == so[pc] + ss[pc])
            wf[:, col + k] = np.bincount(sdi[m & ~contig], minlength=ns)
            wn[:, col + k] = np.bincount(sdi[m & ~same], minlength=ns)
        col += w
    return wf, wn


def _prefix_seek_anchors(batch, bounds: np.ndarray) -> np.ndarray:
    """``(ns, SUFFIX_ANCHORS + 1)`` Eq. 6 seek counts of every stream's
    arrival-order prefix ``[0, round(j * n / A))`` sorted alone."""

    ns = len(bounds) - 1
    out = np.zeros((ns, SUFFIX_ANCHORS + 1), dtype=np.float64)
    if batch.num_requests == 0:
        return out
    lens = np.diff(bounds)
    sid = np.repeat(np.arange(ns, dtype=np.int64), lens)
    pos_in = np.arange(batch.num_requests, dtype=np.int64) - np.repeat(
        bounds[:-1], lens
    )
    order = np.lexsort((batch.offsets, batch.file_ids, sid))
    so = batch.offsets[order]
    ss = batch.sizes[order]
    sf = batch.file_ids[order]
    sdi = sid[order]
    spos = pos_in[order]
    for j in range(1, SUFFIX_ANCHORS + 1):
        k = np.floor(j * lens / SUFFIX_ANCHORS + 0.5).astype(np.int64)
        m = spos < k[sdi]
        prev = _masked_predecessors(m)
        pc = np.maximum(prev, 0)
        same = m & (prev >= 0) & (sdi[pc] == sdi) & (sf[pc] == sf)
        contig = same & (so == so[pc] + ss[pc])
        out[:, j] = np.bincount(sdi[m & ~contig], minlength=ns)
    return out


def _suffix_hdd_anchors(batch, bounds: np.ndarray, hdd) -> np.ndarray:
    """``(ns, SUFFIX_ANCHORS + 1)`` HDD times of every stream's suffix
    starting at request ``round(j * n / A)``, scored like the oracle's
    overflow path (Eq. 1 seeks + sweep distance + sequential time)."""

    ns = len(bounds) - 1
    out = np.zeros((ns, SUFFIX_ANCHORS + 1), dtype=np.float64)
    if batch.num_requests == 0:
        return out
    lens = np.diff(bounds)
    sid = np.repeat(np.arange(ns, dtype=np.int64), lens)
    pos_in = np.arange(batch.num_requests, dtype=np.int64) - np.repeat(
        bounds[:-1], lens
    )
    order = np.lexsort((batch.offsets, sid))
    so = batch.offsets[order]
    ss = batch.sizes[order]
    sdi = sid[order]
    spos = pos_in[order]
    szf = ss.astype(np.float64)
    for j in range(SUFFIX_ANCHORS):
        k = np.floor(j * lens / SUFFIX_ANCHORS + 0.5).astype(np.int64)
        m = spos >= k[sdi]
        prev = _masked_predecessors(m)
        pc = np.maximum(prev, 0)
        pair = m & (prev >= 0) & (sdi[pc] == sdi)
        resid = np.where(pair, so - so[pc] - ss[pc], 0)
        rf = np.bincount(sdi[pair & (resid != 0)], minlength=ns)
        dist = np.bincount(
            sdi, weights=np.abs(resid).astype(np.float64), minlength=ns
        )
        nb = np.bincount(sdi[m], weights=szf[m], minlength=ns)
        # same term order as HDDModel.write_time
        out[:, j] = (
            rf * hdd.seek_time + dist * hdd.seek_dist_coeff + nb / hdd.seq_bw
        )
    return out


def build_events(
    batch,
    scores,
    stream_len: int = DEFAULT_STREAM_LEN,
    hdd: HDDModel | None = None,
    ssd: "SSDModel | object | None" = None,
    link: IngestLink | None = None,
) -> dict[str, np.ndarray]:
    """Lower one shard into its event tape (struct of arrays, length E):
    one event per stream or gap, in the batched engine's firing order."""

    hdd = hdd or HDDModel()
    ssd = ssd or SSDModel()
    link = link or IngestLink()

    bounds = batch.stream_bounds(stream_len)
    ns = len(bounds) - 1 if batch.num_requests else 0
    n_req = np.diff(bounds) if ns else np.zeros(0, dtype=np.int64)

    nb = np.asarray(scores.nbytes, dtype=np.int64)
    rf = np.asarray(scores.rf_sum, dtype=np.float64)
    dist = np.asarray(scores.seek_distance, dtype=np.float64)
    pct = np.asarray(scores.percentage, dtype=np.float64)
    if len(nb) != ns:
        raise ValueError(
            f"scores cover {len(nb)} streams but the trace produced {ns}"
        )
    # same association order as HDDModel.write_time / IngestLink.time
    hdd_t = rf * hdd.seek_time + dist * hdd.seek_dist_coeff + nb / hdd.seq_bw
    net_t = nb / link.bw
    if ns:
        anchors = _suffix_hdd_anchors(batch, bounds, hdd)
        # anchor 0 (whole stream) comes straight from the scores
        anchors[:, 0] = hdd_t
        w = np.maximum(batch.sizes / link.bw, batch.sizes / ssd.write_bw)
        ssd_w = np.add.reduceat(w, bounds[:-1])
        wf, wn = _window_seek_anchors(batch, bounds)
        pf = _prefix_seek_anchors(batch, bounds)
        xm = _cross_stream_merges(batch, bounds)
    else:
        anchors = np.zeros((0, SUFFIX_ANCHORS + 1), dtype=np.float64)
        ssd_w = np.zeros(0, dtype=np.float64)
        wf = np.zeros((0, N_WINDOWS), dtype=np.float64)
        wn = np.zeros((0, N_WINDOWS), dtype=np.float64)
        pf = np.zeros((0, SUFFIX_ANCHORS + 1), dtype=np.float64)
        xm = np.zeros((0, XMERGE_D), dtype=np.float64)
    mean_sz = nb / np.maximum(n_req, 1)

    gap_pos = batch.gap_positions
    ng = len(gap_pos)
    # a full stream fires before any gap at its end boundary; the trailing
    # partial stream fires after ALL remaining gaps
    if ns:
        fire_before = np.where(
            n_req == stream_len, bounds[1:], batch.num_requests + 1
        )
        gaps_before = np.searchsorted(gap_pos, fire_before, side="left")
    else:
        gaps_before = np.zeros(0, dtype=np.int64)

    ev = {k: np.zeros(ns + ng, dtype=dt) for k, dt in _EVENT_FIELDS.items()}
    ev["valid"][:] = True
    s_idx = np.arange(ns) + gaps_before
    g_idx = np.arange(ng) + np.searchsorted(
        gaps_before, np.arange(ng), side="right"
    )
    ev["pct"][s_idx] = pct
    ev["nbytes"][s_idx] = nb
    for j in range(SUFFIX_ANCHORS + 1):
        ev[f"hddt_{j}"][s_idx] = anchors[:, j]
        ev[f"pf_{j}"][s_idx] = pf[:, j]
    for i in range(N_WINDOWS):
        ev[f"wf_{i}"][s_idx] = wf[:, i]
        ev[f"wn_{i}"][s_idx] = wn[:, i]
    for d in range(1, XMERGE_D + 1):
        ev[f"xm_{d}"][s_idx] = xm[:, d - 1]
    ev["net_t"][s_idx] = net_t
    ev["ssd_w"][s_idx] = ssd_w
    ev["mean_sz"][s_idx] = mean_sz
    ev["is_gap"][g_idx] = True
    ev["gap_sec"][g_idx] = batch.gap_seconds
    return ev


def _pad_len(n: int) -> int:
    """Shared tape length: the next power of two, at least 8."""

    p = 8
    while p < n:
        p *= 2
    return p


def stack_events(
    tapes: Sequence[Mapping[str, np.ndarray]], pad_to: int | None = None
) -> dict[str, np.ndarray]:
    """Stack per-lane tapes into ``(S, L)`` arrays, right-padded with
    ``valid=False`` events to ``pad_to`` (default :func:`_pad_len`)."""

    if not tapes:
        raise ValueError("need at least one lane")
    longest = max(len(t["valid"]) for t in tapes)
    s = pad_to if pad_to is not None else _pad_len(longest)
    if s < longest:
        raise ValueError(f"pad_to={s} < longest tape {longest}")
    out = {
        k: np.zeros((s, len(tapes)), dtype=dt)
        for k, dt in _EVENT_FIELDS.items()
    }
    for j, t in enumerate(tapes):
        n = len(t["valid"])
        for k in _EVENT_FIELDS:
            out[k][:n, j] = t[k]
    return out


def lane_consts(
    scheme: str,
    ssd_capacity: int,
    flush_gate: float | str = 0.5,
    ssd: object | None = None,
) -> dict[str, object]:
    """Per-lane constants: scheme id, region capacity, flush gate
    (``"device"`` is the sentinel ``-1.0``), storage geometry.  The FTL
    columns keep their inert defaults (``ftl_on=False``) for the constant
    SSD, which keeps the discarded branch of every select finite."""

    if scheme not in SCHEME_IDS:
        raise ValueError(f"unknown scheme {scheme!r}")
    if isinstance(flush_gate, str):
        if flush_gate != "device":
            raise ValueError(
                f"flush_gate must be a float or 'device', got {flush_gate!r}"
            )
        gate = -1.0
    else:
        gate = float(flush_gate)
    if scheme == "orangefs":
        cap = 0
    elif scheme == "orangefs-bb":
        cap = int(ssd_capacity)
    else:  # two-region pipeline: half the SSD per region
        cap = int(ssd_capacity) // 2
    ftl_on = bool(ssd is not None and getattr(ssd, "stateful", False))
    if ftl_on:
        page = float(ssd.page_size)
        tpp = float(ssd.t_page)
        terase = float(ssd.t_erase / ssd.n_channels)
        ppb = float(ssd.pages_per_block)
        phys = float(ssd.total_pages)
        low = float(ssd.gc_low_blocks * ssd.pages_per_block)
        high = float(ssd.gc_high_blocks * ssd.pages_per_block)
    else:  # inert defaults keep the where()-discarded branch NaN-free
        page, tpp, terase, ppb, phys, low, high = (
            1.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0,
        )
    return {
        "scheme": np.int32(SCHEME_IDS[scheme]),
        "cap": np.int64(cap),
        "gate": np.float64(gate),
        "ftl_on": np.bool_(ftl_on),
        "ftl_page": np.float64(page),
        "ftl_tpp": np.float64(tpp),
        "ftl_terase": np.float64(terase),
        "ftl_ppb": np.float64(ppb),
        "ftl_phys": np.float64(phys),
        "ftl_low": np.float64(low),
        "ftl_high": np.float64(high),
    }


def initial_lane_state(
    scheme: str,
    window: int,
    threshold_warmup: Sequence[float] | None = None,
    ssd: object | None = None,
) -> dict[str, np.ndarray]:
    """One lane's initial state.  ``threshold_warmup`` is replayed through
    the exact host policy and its window/hysteresis state transplanted."""

    if window is None or window < 1:
        raise ValueError(
            "the device engine needs a finite adaptive window "
            f"(got {window!r})"
        )
    win = np.full(window, np.inf, dtype=np.float64)
    win_n = 0
    win_p = 0
    static_rand = False
    if threshold_warmup is not None:
        if scheme == "ssdup+":
            pol = AdaptiveThreshold(window=window)
            pol.seed(threshold_warmup)
            recent = list(pol._recent)  # arrival order, oldest first
            win[: len(recent)] = recent
            win_n = len(recent)
            win_p = len(recent) % window
        elif scheme == "ssdup":
            static_rand = StaticWatermarkThreshold().seed(
                threshold_warmup
            )._last_random
    if ssd is not None and getattr(ssd, "stateful", False):
        ftl_free = float(ssd.free_pages)
        ftl_live = float(ssd.live_pages)
    else:
        ftl_free = 0.0
        ftl_live = 0.0
    return {
        "clock": np.float64(0.0),
        "gap": np.float64(0.0),
        "pause": np.float64(0.0),
        "blocked": np.float64(0.0),
        "b_ssd": np.int64(0),
        "b_hdd": np.int64(0),
        "a_used": np.int64(0),
        "s_used": np.int64(0),
        "peak": np.int64(0),
        "a_fs": np.float64(0.0),
        # fraction of each of the last XMERGE_D streams buffered in the
        # ACTIVE region (newest first): cross-merge partners
        **{f"xf_{d}": np.float64(0.0) for d in range(1, XMERGE_D + 1)},
        "j_left": np.float64(0.0),
        "j_rate": np.float64(1.0),  # >0 so where() divisions stay finite
        "j_alive": np.bool_(False),
        "flushes": np.int32(0),
        "win": win,
        "win_n": np.int32(win_n),
        "win_p": np.int32(win_p),
        "static_rand": np.bool_(static_rand),
        "cur_ssd": np.bool_(False),  # paper: apps start writing the HDD
        "ftl_free": np.float64(ftl_free),
        "ftl_live": np.float64(ftl_live),
        "ftl_reloc": np.float64(0.0),
    }


def _stack_lanes(dicts: Sequence[Mapping[str, np.ndarray]]) -> dict:
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}


def _globals(hdd: HDDModel, interference: InterferenceModel) -> dict[str, float]:
    return {
        "seek_time": float(hdd.seek_time),
        "seq_bw": float(hdd.seq_bw),
        "slowdown": float(interference.foreground_slowdown()),
        "flush_frac": float(interference.flush_rate_fraction()),
        "default_thr": float(DEFAULT_THRESHOLD),
        "static_high": 0.45,
        "static_low": 0.30,
    }


def per_app_bytes(batch) -> dict[int, int]:
    """Per-app byte totals (order-independent, scheme-independent)."""

    if not batch.num_requests:
        return {}
    apps, inverse = np.unique(batch.app_ids, return_inverse=True)
    sums = np.zeros(len(apps), dtype=np.int64)
    np.add.at(sums, inverse, batch.sizes)
    return {int(a): int(s) for a, s in zip(apps, sums)}


def to_device(
    events: Mapping[str, np.ndarray],
    lanes: Mapping[str, np.ndarray],
    state0: Mapping[str, np.ndarray],
    device: "torch.device | str",
) -> tuple[dict, dict, dict]:
    """Move a stacked tape ``(S, L)``, lane constants ``(L,)`` and initial
    state ``(L, ...)`` (NumPy arrays, e.g. another implementation's) to
    ``device`` as tensors of the same dtypes, in one copy each."""

    def move(d):
        return {k: torch.tensor(np.asarray(v), device=device) for k, v in d.items()}

    return move(events), move(lanes), move(state0)


# ---------------------------------------------------------------------------
# device side: the transition over a batch of lanes
# ---------------------------------------------------------------------------

_F64 = torch.float64


def _sel(cond: torch.Tensor, a, b) -> torch.Tensor:
    """``torch.where`` with a per-lane ``cond`` broadcast over trailing
    dimensions (the ``(L, W)`` window)."""

    ref = a if isinstance(a, torch.Tensor) else b
    if isinstance(ref, torch.Tensor) and ref.dim() > cond.dim():
        cond = cond.reshape(cond.shape + (1,) * (ref.dim() - cond.dim()))
    return torch.where(cond, a, b)


def _i32(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int32)


def _observe_and_route(g, lane, st, pct):
    """Threshold observe + Algorithm 1 hysteresis for one stream per lane.

    Returns ``(dev_ssd, allowed, upd)``: the device serving THIS stream,
    whether the traffic-aware gate lets the flusher run during it, and the
    policy-state updates (applied on stream events of threshold schemes).
    """

    scheme = lane["scheme"]
    is_ofs = scheme == 0
    is_bb = scheme == 1
    is_plus = scheme == 3

    # adaptive threshold (Eq. 2/3): avgper over the PRE-insert sorted
    # window, insert over the oldest entry, index floor((1-avgper)*n) into
    # the POST-insert sorted window; +inf pads sort last
    win, win_n, win_p = st["win"], st["win_n"], st["win_p"]
    w = win.shape[1]
    csum = torch.cumsum(torch.sort(win, dim=1).values, dim=1)
    have = win_n > 0
    first_n = torch.gather(csum, 1, torch.clamp_min(win_n - 1, 0).long()[:, None])[:, 0]
    avg = torch.where(have, first_n / torch.clamp_min(win_n, 1), 0.0)
    win2 = win.scatter(1, win_p.long()[:, None], pct[:, None])
    n2 = torch.clamp_max(win_n + 1, w)
    p2 = (win_p + 1) % w
    post_sorted = torch.sort(win2, dim=1).values
    idx = torch.minimum(
        torch.clamp_min(torch.floor((1.0 - avg) * n2).to(torch.int32), 0), n2 - 1
    )
    picked = torch.gather(post_sorted, 1, idx.long()[:, None])[:, 0]
    adap_thr = torch.where(have, picked, g["default_thr"])

    # static watermarks (SSDUP): hysteresis between high and low
    sr2 = (pct > g["static_high"]) | (~(pct < g["static_low"]) & st["static_rand"])
    static_thr = torch.where(sr2, torch.full_like(pct, g["static_low"]),
                             torch.full_like(pct, g["static_high"]))
    thr = torch.where(is_plus, adap_thr, static_thr)

    # Algorithm 1: this stream rides the PREVIOUS decision; the new
    # comparison steers the NEXT stream (equality keeps the device)
    cur = st["cur_ssd"]
    dev_ssd = is_bb | (~is_ofs & cur)
    cur2 = (pct > thr) | (~(pct < thr) & cur)

    # traffic-aware gate (Section 2.4.2): only ssdup+ pauses; gate < 0 is
    # flush_gate="device" (flush exactly while the stream writes the SSD)
    gate = lane["gate"]
    allowed = ~is_plus | torch.where(gate < 0.0, dev_ssd, pct >= gate)

    upd = {"win": win2, "win_n": n2, "win_p": p2, "static_rand": sr2,
           "cur_ssd": cur2}
    return dev_ssd, allowed, upd


_FILL_KEYS = ("clock", "pause", "blocked", "b_ssd", "flushes", "a_used",
              "s_used", "a_fs", "j_left", "j_rate", "j_alive", "ftl_free",
              "ftl_live", "ftl_reloc")


def _fill_body(g, lane, ev, allowed, c):
    """One region fill of every lane (the loop body; see _ssd_fill_loop)."""

    scheme = lane["scheme"]
    is_bb = scheme == 1
    is_tworeg = (scheme == 2) | (scheme == 3)
    cap = lane["cap"]
    nb_f = torch.clamp_min(ev["nbytes"], 1).to(_F64)
    margin = torch.maximum(ev["mean_sz"], torch.div(cap, 256, rounding_mode="floor").to(_F64))

    bb_ovf = is_bb & c["j_alive"]  # BB drains: the whole rest overflows
    room = cap - c["a_used"]
    # plain BB stops at the eager-trigger request: k more requests land
    # before free space drops below the margin (margin >= request size);
    # two-region fills take every request that fits entirely
    room_f = room.to(_F64)
    m = torch.clamp_min(ev["mean_sz"], 1.0)
    k = torch.floor((room_f - margin) / m) + 1.0
    bb_cap = torch.ceil(torch.clamp_min(k, 0.0) * m).to(torch.int64)
    tr_cap = (torch.floor(room_f / m) * m).to(torch.int64)
    fill_cap = torch.where(is_bb, torch.minimum(room, bb_cap), tr_cap)
    fill = torch.where(bb_ovf, 0, torch.minimum(c["rem"], fill_cap))
    frac = fill / nb_f
    # storage-model time of this fill: the pro-rated SSD wall sum for the
    # constant backend; the FTL columns are inert arithmetic until ported
    pages = fill.to(_F64) / lane["ftl_page"]
    free1 = c["ftl_free"] - pages
    live1 = c["ftl_live"] + pages
    gc_on = lane["ftl_on"] & (fill > 0) & (free1 < lane["ftl_low"])
    u = torch.clamp(
        live1 / torch.clamp_min(lane["ftl_phys"] - free1, 1.0), 0.0, 0.97
    )
    need = torch.clamp_min(lane["ftl_high"] - free1, 0.0)
    nblk = need / torch.clamp_min(lane["ftl_ppb"] * (1.0 - u), 1.0)
    reloc = nblk * lane["ftl_ppb"] * u
    gc_t = reloc * lane["ftl_tpp"] + nblk * lane["ftl_terase"]
    seg_dev = pages * lane["ftl_tpp"] + torch.where(gc_on, gc_t, 0.0)
    segw = torch.where(
        lane["ftl_on"],
        torch.maximum(ev["net_t"] * frac, seg_dev),
        ev["ssd_w"] * frac,
    )

    # flush bookkeeping while the foreground writes the SSD: the job
    # drains at its full Eq. 6 rate (no HDD contention)
    progressing = c["j_alive"] & allowed
    prog = c["j_rate"] * segw
    completed = progressing & (prog >= c["j_left"])
    trim_b = torch.where(completed, c["s_used"], 0)
    j_left = torch.where(
        completed, 0.0,
        torch.where(progressing, c["j_left"] - prog, c["j_left"]),
    )
    pause = c["pause"] + torch.where(c["j_alive"] & ~allowed, segw, 0.0)
    flushes = c["flushes"] + _i32(completed)
    s_used = torch.where(completed, 0, c["s_used"])
    j_alive = c["j_alive"] & ~completed

    clock = c["clock"] + segw
    a_used = c["a_used"] + fill
    # Eq. 6 seek accrual against the dyadic window anchors of the nearest
    # scale: per window the distinct-file baseline lands whole with any
    # coverage, only the extent breaks scale with the covered fraction
    a0 = (nb_f - c["rem"].to(_F64)) / nb_f
    wfrac = fill.to(_F64) / nb_f
    a1 = a0 + wfrac
    scale = torch.clamp(
        torch.round(-torch.log2(torch.clamp_min(wfrac, 1e-9))),
        0, WINDOW_SCALES - 1,
    ).to(torch.int32)
    seg_fs = torch.zeros_like(nb_f)
    col = 0
    for s_ in range(WINDOW_SCALES):
        nw = 1 << s_
        acc = torch.zeros_like(nb_f)
        for wj in range(nw):
            lo = wj / nw
            cov = torch.clamp(
                (torch.clamp_max(a1, lo + 1.0 / nw) - torch.clamp_min(a0, lo))
                * nw,
                0.0, 1.0,
            )
            wfv = ev[f"wf_{col}"]
            wnv = ev[f"wn_{col}"]
            acc = acc + torch.where(cov > 0, wnv + (wfv - wnv) * cov, 0.0)
            col += 1
        seg_fs = torch.where(scale == s_, acc, seg_fs)
    # prefix-aligned fills have exact anchors at the request quantiles
    ppos = torch.clamp(a1 * SUFFIX_ANCHORS, 0.0, float(SUFFIX_ANCHORS))
    pj = torch.clamp(torch.floor(ppos), 0.0, float(SUFFIX_ANCHORS - 1)).to(torch.int32)
    plam = ppos - pj.to(_F64)
    pref_fs = torch.zeros_like(nb_f)
    for j in range(SUFFIX_ANCHORS):
        lerp = (1.0 - plam) * ev[f"pf_{j}"] + plam * ev[f"pf_{j + 1}"]
        pref_fs = torch.where(pj == j, lerp, pref_fs)
    seg_fs = torch.where(a0 <= 0.0, pref_fs, seg_fs)
    seg_fs = torch.where(fill > 0, seg_fs, 0.0)
    # cross-stream merges with predecessors still in the active region
    seg_xm = wfrac * sum(
        ev[f"xm_{d}"] * c[f"xf_{d}"] for d in range(1, XMERGE_D + 1)
    )
    a_fs = torch.clamp_min(c["a_fs"] + seg_fs - seg_xm, 0.0)
    b_ssd = c["b_ssd"] + fill
    rem = c["rem"] - fill

    # plain BB eager trigger: free space below max(request, cap/256)
    bb_trig = is_bb & ~bb_ovf & ((room - fill) < margin)
    # two-region swap: the next request does not fit
    swap = is_tworeg & (rem > 0)
    # a live flush on the standby region blocks the writer: drain it at
    # the job's exclusive rate, then swap
    do_block = swap & j_alive
    dtb = torch.where(do_block, j_left / c["j_rate"], 0.0)
    clock = clock + dtb
    blocked = c["blocked"] + dtb
    flushes = flushes + _i32(do_block)
    j_alive = j_alive & ~do_block
    j_left = torch.where(do_block, 0.0, j_left)
    trim_b = trim_b + torch.where(do_block, s_used, 0)
    s_used = torch.where(do_block, 0, s_used)

    # schedule the filled region's flush (Eq. 6 effective rate)
    sched = swap | bb_trig
    jb = a_used
    jb_f = jb.to(_F64)
    service = a_fs * g["seek_time"] + jb_f / g["seq_bw"]
    n_rate = torch.where(jb > 0, jb_f / service, g["seq_bw"])
    j_rate = torch.where(sched, n_rate, c["j_rate"])
    j_left = torch.where(sched, jb_f, j_left)
    j_alive = j_alive | sched
    s_used = torch.where(sched, jb, s_used)
    a_used = torch.where(sched, 0, a_used)
    a_fs = torch.where(sched, 0.0, a_fs)
    # the region's content goes to the flusher: earlier streams leave the
    # active region; only fills after the swap count for this stream
    xf = {f"xf_{d}": torch.where(sched, 0.0, c[f"xf_{d}"])
          for d in range(1, XMERGE_D + 1)}
    cur_xf = torch.where(sched, 0.0, c["cur_xf"] + wfrac)

    ovf = c["ovf"] | bb_ovf | (bb_trig & (rem > 0))
    trim_p = trim_b.to(_F64) / lane["ftl_page"]
    ftl_free = torch.where(
        lane["ftl_on"], torch.where(gc_on, lane["ftl_high"], free1), c["ftl_free"]
    )
    ftl_live = torch.where(lane["ftl_on"], live1 - trim_p, c["ftl_live"])
    ftl_reloc = c["ftl_reloc"] + torch.where(gc_on, reloc, 0.0)
    return {
        "rem": rem, "ovf": ovf, "clock": clock, "pause": pause,
        "blocked": blocked, "b_ssd": b_ssd, "flushes": flushes,
        "a_used": a_used, "s_used": s_used, "a_fs": a_fs,
        "j_left": j_left, "j_rate": j_rate, "j_alive": j_alive,
        "cur_xf": cur_xf, "ftl_free": ftl_free, "ftl_live": ftl_live,
        "ftl_reloc": ftl_reloc, **xf,
    }


def _ssd_fill_loop(g, lane, st, ev, allowed, dev_ssd):
    """SSD-routed stream: fill regions, swap/block/trigger, overflow.

    A masked loop: every iteration computes the body for all lanes and
    keeps it only where a lane is still filling.  HDD-routed streams and
    capacity-less (orangefs) lanes never enter: a ``cap == 0`` lane would
    make no progress.
    """

    c = {
        "rem": torch.where(dev_ssd & (lane["cap"] > 0), ev["nbytes"], 0),
        "ovf": torch.zeros_like(dev_ssd),
        **{k: st[k] for k in _FILL_KEYS},
        "cur_xf": torch.zeros_like(st["a_fs"]),
        **{f"xf_{d}": st[f"xf_{d}"] for d in range(1, XMERGE_D + 1)},
    }
    while True:
        active = (c["rem"] > 0) & ~c["ovf"]
        if not bool(active.any()):  # one host sync per iteration
            return c
        new = _fill_body(g, lane, ev, allowed, c)
        c = {k: torch.where(active, new[k], c[k]) for k in c}


def _hdd_advance(g, lane, c, hdd_b, nb, ev, allowed):
    """Foreground HDD write of ``hdd_b`` bytes (whole stream or BB
    overflow suffix) with Eq. 7 interference from a concurrent flush.

    A suffix's HDD wall is hat-interpolated between the tape's suffix
    anchors; ``hdd_b == nb`` lands exactly on anchor 0, the scored
    whole-stream time."""

    nb_f = torch.clamp_min(nb, 1).to(_F64)
    frac = hdd_b.to(_F64) / nb_f
    pos = (1.0 - frac) * SUFFIX_ANCHORS
    dt = torch.zeros_like(frac)
    for j in range(SUFFIX_ANCHORS + 1):
        w = torch.clamp_min(1.0 - torch.abs(pos - j), 0.0)
        dt = dt + w * ev[f"hddt_{j}"]
    net = ev["net_t"] * frac
    do = hdd_b > 0
    flushing = c["j_alive"]
    adv = flushing & allowed
    wall_alone = torch.maximum(net, dt)
    wall_shared = torch.maximum(net, dt * g["slowdown"])
    wall = torch.where(adv, wall_shared, wall_alone)
    prog = c["j_rate"] * g["flush_frac"] * wall
    completed = do & adv & (prog >= c["j_left"])
    j_left = torch.where(
        completed, 0.0,
        torch.where(do & adv, c["j_left"] - prog, c["j_left"]),
    )
    trim_p = torch.where(completed, c["s_used"], 0).to(_F64) / lane["ftl_page"]
    return {
        **c,
        "clock": c["clock"] + torch.where(do, wall, 0.0),
        "pause": c["pause"] + torch.where(do & flushing & ~adv, wall_alone, 0.0),
        "b_hdd": c["b_hdd"] + hdd_b,
        "flushes": c["flushes"] + _i32(completed),
        "s_used": torch.where(completed, 0, c["s_used"]),
        "j_alive": c["j_alive"] & ~completed,
        "j_left": j_left,
        "ftl_live": torch.where(lane["ftl_on"], c["ftl_live"] - trim_p, c["ftl_live"]),
    }


def _gap_step(lane, st, sec):
    """Compute phase: the flusher has the HDD to itself (Eq. 6 rate)."""

    need = st["j_left"] / st["j_rate"]
    full = st["j_alive"] & (need <= sec)
    partial = st["j_alive"] & ~full
    j_left = torch.where(
        full, 0.0,
        torch.where(partial, st["j_left"] - st["j_rate"] * sec, st["j_left"]),
    )
    trim_p = torch.where(full, st["s_used"], 0).to(_F64) / lane["ftl_page"]
    return {
        **st,
        "clock": st["clock"] + sec,
        "gap": st["gap"] + sec,
        "flushes": st["flushes"] + _i32(full),
        "s_used": torch.where(full, 0, st["s_used"]),
        "j_alive": st["j_alive"] & ~full,
        "j_left": j_left,
        "ftl_live": torch.where(lane["ftl_on"], st["ftl_live"] - trim_p, st["ftl_live"]),
    }


def _stream_step(g, lane, st, ev):
    """One stream event for every lane (all schemes, flag-selected)."""

    scheme = lane["scheme"]
    is_tworeg = (scheme == 2) | (scheme == 3)

    dev_ssd, allowed, upd = _observe_and_route(g, lane, st, ev["pct"])
    c = _ssd_fill_loop(g, lane, st, ev, allowed, dev_ssd)
    # foreground HDD bytes: the whole stream when HDD-routed, the
    # unbuffered suffix when plain BB overflows
    hdd_b = torch.where(dev_ssd, torch.where(c["ovf"], c["rem"], 0), ev["nbytes"])
    base = {k: torch.where(dev_ssd, c[k], st[k]) for k in _FILL_KEYS}
    base["b_hdd"] = st["b_hdd"]
    base["gap"] = st["gap"]
    base["peak"] = st["peak"]

    out = _hdd_advance(g, lane, base, hdd_b, ev["nbytes"], ev, allowed)
    # shift the cross-merge partner window one stream (an HDD-routed
    # stream enters as 0: its bytes never reached the region)
    out["xf_1"] = torch.where(dev_ssd, c["cur_xf"], 0.0)
    for d in range(2, XMERGE_D + 1):
        out[f"xf_{d}"] = torch.where(dev_ssd, c[f"xf_{d - 1}"], st[f"xf_{d - 1}"])
    # occupancy is sampled at the END of the stream, after the overflow's
    # HDD writes (during which the flush may complete)
    out["peak"] = torch.where(
        dev_ssd, torch.maximum(st["peak"], out["a_used"] + out["s_used"]), st["peak"]
    )
    # threshold/routing state evolves on every stream of a threshold scheme
    for k, v in upd.items():
        out[k] = _sel(is_tworeg, v, st[k])
    return out


def _event_step(g, lane, st, ev):
    """The per-lane transition: gap, stream, or padded no-op.  Both
    branches are computed and one is selected per lane."""

    strm = _stream_step(g, lane, st, ev)
    gap = _gap_step(lane, st, ev["gap_sec"])
    valid, is_gap = ev["valid"], ev["is_gap"]
    return {k: _sel(valid, _sel(is_gap, gap[k], strm[k]), st[k]) for k in st}


def _final_drain(g, st):
    """End-of-trace drain: finish the in-flight job, then flush the
    still-buffered active region (Eq. 6)."""

    d1 = torch.where(st["j_alive"], st["j_left"] / st["j_rate"], 0.0)
    has_active = st["a_used"] > 0
    a_f = st["a_used"].to(_F64)
    d2 = torch.where(has_active, st["a_fs"] * g["seek_time"] + a_f / g["seq_bw"], 0.0)
    return {
        "io_seconds": st["clock"] - st["gap"],
        "total_seconds": st["clock"] + d1 + d2,
        "bytes_to_ssd": st["b_ssd"],
        "bytes_to_hdd_direct": st["b_hdd"],
        "flushes": st["flushes"] + _i32(st["j_alive"]) + _i32(has_active),
        "flush_paused_seconds": st["pause"],
        "blocked_seconds": st["blocked"],
        "peak_ssd_occupancy": st["peak"],
        "ftl_reloc_pages": st["ftl_reloc"],
        "ftl_live_pages": st["ftl_live"],
    }


def _check_outputs(out: Mapping[str, torch.Tensor]) -> None:
    """Sanitize-mode guards over the replay's outputs: a NaN/Inf made
    anywhere in the replay reaches an output clock; ledgers are
    non-negative; io time never exceeds total time."""

    for k in ("io_seconds", "total_seconds", "flush_paused_seconds",
              "blocked_seconds"):
        _sanitize.check(bool(torch.isfinite(out[k]).all()),
                        "device replay invariant violated: non-finite %s", k)
        _sanitize.check(bool((out[k] >= 0).all()),
                        "device replay invariant violated: negative %s", k)
    for k in ("bytes_to_ssd", "bytes_to_hdd_direct", "flushes",
              "peak_ssd_occupancy"):
        _sanitize.check(bool((out[k] >= 0).all()),
                        "device replay invariant violated: negative %s", k)
    _sanitize.check(
        bool((out["total_seconds"] >= out["io_seconds"]).all()),
        "device replay invariant violated: io_seconds exceeds total_seconds",
    )


def replay_lanes(
    events: Mapping[str, np.ndarray],
    lanes: Mapping[str, np.ndarray],
    state0: Mapping[str, np.ndarray],
    hdd: HDDModel | None = None,
    interference: InterferenceModel | None = None,
    sanitize: bool | None = None,
    device: "torch.device | str | None" = None,
) -> dict[str, np.ndarray]:
    """Replay every lane on ``device`` (``None``: the CUDA card).

    Accuracy contract: float64 throughout, within the
    :data:`DEVICE_TOLERANCES` tiers of the batched NumPy oracle; lanes
    never interact, so a lane's result does not depend on its batch.

    ``events`` is the stacked ``(S, L)`` tape (:func:`stack_events`),
    ``lanes``/``state0`` the stacked ``(L,)``/``(L, ...)`` structs, all
    NumPy.  Events past the longest tape are all padding and are not
    stepped (a padded event leaves every lane unchanged).  Returns
    per-lane result arrays as NumPy.  With ``sanitize`` on, a violated
    output invariant raises :class:`SanitizerError`.
    """

    dev = resolve_device(device)
    g = _globals(hdd or HDDModel(), interference or InterferenceModel())
    valid_rows = np.nonzero(np.asarray(events["valid"]).any(axis=1))[0]
    steps = int(valid_rows[-1]) + 1 if valid_rows.size else 0
    ev_t, lane_t, st = to_device(events, lanes, state0, dev)
    with torch.no_grad():
        for t in range(steps):
            st = _event_step(g, lane_t, st, {k: v[t] for k, v in ev_t.items()})
        out = _final_drain(g, st)
        if _sanitize.resolve(sanitize):
            _check_outputs(out)
    return {k: v.cpu().numpy() for k, v in out.items()}


def simulate_device(
    batch,
    scores=None,
    scheme: str = "ssdup+",
    ssd_capacity: int = 8 << 30,
    hdd: HDDModel | None = None,
    ssd: "SSDModel | object | None" = None,
    link: IngestLink | None = None,
    interference: InterferenceModel | None = None,
    stream_len: int = DEFAULT_STREAM_LEN,
    flush_gate: float | str = 0.5,
    adaptive_window: int = 64,
    threshold_warmup: Sequence[float] | None = None,
    sanitize: bool | None = None,
    device: "torch.device | str | None" = None,
):
    """Replay one shard on one lane on ``device`` (``None``: the CUDA
    card); ``scores`` default to the kernel backend's on that device.

    Accuracy contract: the module's (:data:`DEVICE_TOLERANCES` vs the
    NumPy engines).  Returns a
    :class:`~repro_torch.core.simulator.SimResult`.
    """

    from .trace import compute_stream_scores

    dev = resolve_device(device)
    if scores is None:
        scores = compute_stream_scores(batch, stream_len, device=dev)
    tape = build_events(
        batch, scores, stream_len=stream_len, hdd=hdd, ssd=ssd, link=link
    )
    out = replay_lanes(
        stack_events([tape]),
        _stack_lanes([lane_consts(scheme, ssd_capacity, flush_gate, ssd=ssd)]),
        _stack_lanes([initial_lane_state(scheme, adaptive_window,
                                         threshold_warmup, ssd=ssd)]),
        hdd=hdd, interference=interference, sanitize=sanitize, device=dev,
    )
    return lane_result(out, 0, scheme, per_app_bytes(batch))


def lane_result(out: Mapping[str, np.ndarray], i: int, scheme: str,
                per_app: dict[int, int]):
    """Lane ``i`` of :func:`replay_lanes`' output as a ``SimResult``."""

    from .simulator import SimResult

    b_ssd = int(out["bytes_to_ssd"][i])
    b_hdd = int(out["bytes_to_hdd_direct"][i])
    return SimResult(
        scheme=scheme,
        io_seconds=float(out["io_seconds"][i]),
        total_seconds=float(out["total_seconds"][i]),
        total_bytes=b_ssd + b_hdd,
        bytes_to_ssd=b_ssd,
        bytes_to_hdd_direct=b_hdd,
        flushes=int(out["flushes"][i]),
        flush_paused_seconds=float(out["flush_paused_seconds"][i]),
        blocked_seconds=float(out["blocked_seconds"][i]),
        peak_ssd_occupancy=int(out["peak_ssd_occupancy"][i]),
        metadata_bytes=0,
        per_app_bytes=per_app,
    )
