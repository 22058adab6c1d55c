"""Plain torch version of the ``replay`` kernel: the device engine's
per-node transition over a batch of lanes (the reference's XLA program
``_replay_program``, a ``scan`` over events of a ``vmap`` of one step).

* :func:`_event_step` advances every lane by one event: stream routing
  (Eq. 1-3 threshold + Algorithm 1 hysteresis), SSD region
  fills/swaps/blocks in a masked loop, HDD advances with Eq. 7
  interference, flush accounting per Eq. 6, and compute-gap draining.  All
  four schemes run the same step, selected per lane by flags.
* :func:`_final_drain` finishes the in-flight flush and the active region.
* :func:`replay_ref` runs the first ``steps`` events, then drains.

Lanes are the leading dimension of every state tensor (the adaptive window
is ``(L, W)``).  Clocks and rates are float64, byte counters int64, and
window indices, flush counts and scheme ids int32, so that integer
arithmetic, ``%`` and comparisons act as in the reference.

The region-fill loop computes its body for every lane and keeps the
result only for lanes still filling (``torch.where`` on every carried
field), as a batched while loop does; it runs while any lane is active,
which costs one host synchronisation per iteration.

The tape's geometry (anchors, dyadic windows, merge depth) is defined here
and imported by :mod:`repro_torch.core.engine_device`, which lowers traces
into tapes of that shape.
"""

from __future__ import annotations

import torch

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

#: The replay's outputs, in :func:`_final_drain`'s order.
OUTPUTS = ("io_seconds", "total_seconds", "bytes_to_ssd", "bytes_to_hdd_direct",
           "flushes", "flush_paused_seconds", "blocked_seconds",
           "peak_ssd_occupancy", "ftl_reloc_pages", "ftl_live_pages")

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


def _adaptive_threshold(win, win_n, win_p, pct, default_thr):
    """SSDUP+'s threshold for one stream per lane (Eq. 2/3): avgper over
    the PRE-insert sorted window, insert ``pct`` over the oldest entry,
    index floor((1-avgper)*n) into the POST-insert sorted window; +inf pads
    sort last.  Returns ``(adap_thr, win2, n2, p2)``, the threshold and the
    window after the insert."""

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
    return torch.where(have, picked, default_thr), win2, n2, p2


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

    adap_thr, win2, n2, p2 = _adaptive_threshold(st["win"], st["win_n"], st["win_p"], pct,
                                                 g["default_thr"])

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


def replay_ref(g, lane, st, events, steps: int) -> dict[str, torch.Tensor]:
    """Every lane through the first ``steps`` events of the ``(S, L)``
    tape ``events``, then :func:`_final_drain`.  ``g`` holds the globals
    (``seek_time``, ``seq_bw``, ``slowdown``, ``flush_frac``,
    ``default_thr``, ``static_high``, ``static_low``), ``lane`` the
    ``(L,)`` constants and ``st`` the initial ``(L, ...)`` state."""

    for t in range(steps):
        st = _event_step(g, lane, st, {k: v[t] for k, v in events.items()})
    return _final_drain(g, st)
