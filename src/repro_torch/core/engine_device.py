"""Device replay engine: the batched engine's per-node transition over a
batch of lanes, one launch of the ``replay`` kernel on the card.

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
* **transition** — :mod:`repro_torch.kernels.replay`: on the card one
  launch of a hand-written CUDA kernel (a block a lane: SSDUP+'s
  threshold pass ahead of the lane's chain, the tape staged in shared
  memory) steps every lane through the whole tape and drains it; on the
  CPU its plain torch
  version (:mod:`repro_torch.kernels.replay.ref`: stream routing, SSD
  region fills/swaps/blocks in a masked loop, HDD advances with Eq. 7
  interference, flush accounting per Eq. 6, compute-gap draining).
* **orchestration** — :func:`replay_lanes` packs the tape, lane constants
  and initial state into one buffer on the host, moves it to the device
  in one copy, replays and returns per-lane results;
  :func:`simulate_device` wraps one lane into a
  :class:`~repro_torch.core.simulator.SimResult`.

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
from ..kernels.replay import ops as replay_ops
from ..kernels.replay.ref import N_WINDOWS, SUFFIX_ANCHORS, WINDOW_SCALES, XMERGE_D
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
    ``valid=False`` events to ``pad_to`` (default :func:`_pad_len`).  Each
    is the transposed view of a lane-major ``(L, S)`` array, the layout of
    the replay kernel's packed tape, so stacking writes each lane's field
    in one run and packing copies it in one run."""

    if not tapes:
        raise ValueError("need at least one lane")
    longest = max(len(t["valid"]) for t in tapes)
    s = pad_to if pad_to is not None else _pad_len(longest)
    if s < longest:
        raise ValueError(f"pad_to={s} < longest tape {longest}")
    out = {
        k: np.zeros((len(tapes), s), dtype=dt)
        for k, dt in _EVENT_FIELDS.items()
    }
    for j, t in enumerate(tapes):
        n = len(t["valid"])
        for k in _EVENT_FIELDS:
            out[k][j, :n] = t[k]
    return {k: v.T for k, v in out.items()}


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
    """Replay every lane on ``device`` (``None``: the CUDA card): one launch
    of the ``replay`` kernel on the card, its plain torch version on the
    CPU.

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

    packed, g, steps = replay_inputs(events, lanes, state0, hdd, interference, device)
    with torch.no_grad():
        out = replay_ops.replay_op(packed, g, steps)
        if _sanitize.resolve(sanitize):
            _check_outputs(out)
    return {k: v.cpu().numpy() for k, v in out.items()}


def replay_inputs(
    events: Mapping[str, np.ndarray],
    lanes: Mapping[str, np.ndarray],
    state0: Mapping[str, np.ndarray],
    hdd: HDDModel | None = None,
    interference: InterferenceModel | None = None,
    device: "torch.device | str | None" = None,
) -> tuple[replay_ops.Packed, list[float], int]:
    """What :func:`replay_lanes` hands the replay: the inputs packed on
    ``device`` (``None``: the CUDA card) in one copy, the globals in
    ``replay_ops.GLOBALS`` order, and the number of events stepped (up to
    the last row any lane's tape fills).  Accuracy contract: bit-exact,
    the packing copies every value unchanged."""

    g = _globals(hdd or HDDModel(), interference or InterferenceModel())
    valid_rows = np.nonzero(np.asarray(events["valid"]).any(axis=1))[0]
    steps = int(valid_rows[-1]) + 1 if valid_rows.size else 0
    packed = replay_ops.to_device(events, lanes, state0, resolve_device(device))
    return packed, [g[k] for k in replay_ops.GLOBALS], steps


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
