"""Plain torch half of the reference: every lane through its event tape,
then drained, on the CPU.

The per-lane transition of the fleet sweep (stream routing by the
threshold of Eq. 1-3 and Algorithm 1's hysteresis, SSD region fills,
swaps and blocks, HDD advances with Eq. 7 interference, flush accounting
per Eq. 6, compute gaps), frozen here.  Clocks run in ``fdt``: float64,
the precision the configurations state, or float32 for the control that
must come out as not correct.  Byte counters stay int64.
"""

from __future__ import annotations

import torch

from .tapes import SUFFIX_ANCHORS, WINDOW_SCALES, XMERGE_D

OUTPUTS = ("io_seconds", "total_seconds", "bytes_to_ssd", "bytes_to_hdd_direct",
           "flushes", "flush_paused_seconds", "blocked_seconds", "peak_ssd_occupancy")


def _sel(cond, a, b):
    ref = a if isinstance(a, torch.Tensor) else b
    if isinstance(ref, torch.Tensor) and ref.dim() > cond.dim():
        cond = cond.reshape(cond.shape + (1,) * (ref.dim() - cond.dim()))
    return torch.where(cond, a, b)


def _i32(b):
    return b.to(torch.int32)


def _adaptive_threshold(win, win_n, win_p, pct, default_thr):
    """SSDUP+'s threshold: avgper over the pre-insert sorted window, the
    insert over the oldest entry, index floor((1-avgper)*n) into the
    post-insert sorted window; +inf pads sort last."""

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
        torch.clamp_min(torch.floor((1.0 - avg) * n2).to(torch.int32), 0), n2 - 1)
    picked = torch.gather(post_sorted, 1, idx.long()[:, None])[:, 0]
    return torch.where(have, picked, default_thr), win2, n2, p2


def _observe_and_route(g, lane, st, pct):
    scheme = lane["scheme"]
    is_ofs, is_bb, is_plus = scheme == 0, scheme == 1, scheme == 3
    adap_thr, win2, n2, p2 = _adaptive_threshold(st["win"], st["win_n"], st["win_p"],
                                                 pct, g["default_thr"])
    sr2 = (pct > g["static_high"]) | (~(pct < g["static_low"]) & st["static_rand"])
    static_thr = torch.where(sr2, torch.full_like(pct, g["static_low"]),
                             torch.full_like(pct, g["static_high"]))
    thr = torch.where(is_plus, adap_thr, static_thr)
    cur = st["cur_ssd"]
    dev_ssd = is_bb | (~is_ofs & cur)
    cur2 = (pct > thr) | (~(pct < thr) & cur)
    gate = lane["gate"]
    allowed = ~is_plus | torch.where(gate < 0.0, dev_ssd, pct >= gate)
    upd = {"win": win2, "win_n": n2, "win_p": p2, "static_rand": sr2, "cur_ssd": cur2}
    return dev_ssd, allowed, upd


_FILL_KEYS = ("clock", "pause", "blocked", "b_ssd", "flushes", "a_used", "s_used",
              "a_fs", "j_left", "j_rate", "j_alive")


def _fill_body(g, lane, ev, allowed, c, F):
    scheme = lane["scheme"]
    is_bb = scheme == 1
    is_tworeg = (scheme == 2) | (scheme == 3)
    cap = lane["cap"]
    nb_f = torch.clamp_min(ev["nbytes"], 1).to(F)
    margin = torch.maximum(ev["mean_sz"], torch.div(cap, 256, rounding_mode="floor").to(F))

    bb_ovf = is_bb & c["j_alive"]
    room = cap - c["a_used"]
    room_f = room.to(F)
    m = torch.clamp_min(ev["mean_sz"], 1.0)
    k = torch.floor((room_f - margin) / m) + 1.0
    bb_cap = torch.ceil(torch.clamp_min(k, 0.0) * m).to(torch.int64)
    tr_cap = (torch.floor(room_f / m) * m).to(torch.int64)
    fill_cap = torch.where(is_bb, torch.minimum(room, bb_cap), tr_cap)
    fill = torch.where(bb_ovf, 0, torch.minimum(c["rem"], fill_cap))
    frac = fill / nb_f
    segw = ev["ssd_w"] * frac

    progressing = c["j_alive"] & allowed
    prog = c["j_rate"] * segw
    completed = progressing & (prog >= c["j_left"])
    j_left = torch.where(completed, 0.0,
                         torch.where(progressing, c["j_left"] - prog, c["j_left"]))
    pause = c["pause"] + torch.where(c["j_alive"] & ~allowed, segw, 0.0)
    flushes = c["flushes"] + _i32(completed)
    s_used = torch.where(completed, 0, c["s_used"])
    j_alive = c["j_alive"] & ~completed

    clock = c["clock"] + segw
    a_used = c["a_used"] + fill
    a0 = (nb_f - c["rem"].to(F)) / nb_f
    wfrac = fill.to(F) / nb_f
    a1 = a0 + wfrac
    scale = torch.clamp(torch.round(-torch.log2(torch.clamp_min(wfrac, 1e-9))),
                        0, WINDOW_SCALES - 1).to(torch.int32)
    seg_fs = torch.zeros_like(nb_f)
    col = 0
    for s_ in range(WINDOW_SCALES):
        nw = 1 << s_
        acc = torch.zeros_like(nb_f)
        for wj in range(nw):
            lo = wj / nw
            cov = torch.clamp(
                (torch.clamp_max(a1, lo + 1.0 / nw) - torch.clamp_min(a0, lo)) * nw,
                0.0, 1.0)
            wfv, wnv = ev[f"wf_{col}"], ev[f"wn_{col}"]
            acc = acc + torch.where(cov > 0, wnv + (wfv - wnv) * cov, 0.0)
            col += 1
        seg_fs = torch.where(scale == s_, acc, seg_fs)
    ppos = torch.clamp(a1 * SUFFIX_ANCHORS, 0.0, float(SUFFIX_ANCHORS))
    pj = torch.clamp(torch.floor(ppos), 0.0, float(SUFFIX_ANCHORS - 1)).to(torch.int32)
    plam = ppos - pj.to(F)
    pref_fs = torch.zeros_like(nb_f)
    for j in range(SUFFIX_ANCHORS):
        lerp = (1.0 - plam) * ev[f"pf_{j}"] + plam * ev[f"pf_{j + 1}"]
        pref_fs = torch.where(pj == j, lerp, pref_fs)
    seg_fs = torch.where(a0 <= 0.0, pref_fs, seg_fs)
    seg_fs = torch.where(fill > 0, seg_fs, 0.0)
    seg_xm = wfrac * sum(ev[f"xm_{d}"] * c[f"xf_{d}"] for d in range(1, XMERGE_D + 1))
    a_fs = torch.clamp_min(c["a_fs"] + seg_fs - seg_xm, 0.0)
    b_ssd = c["b_ssd"] + fill
    rem = c["rem"] - fill

    bb_trig = is_bb & ~bb_ovf & ((room - fill) < margin)
    swap = is_tworeg & (rem > 0)
    do_block = swap & j_alive
    dtb = torch.where(do_block, j_left / c["j_rate"], 0.0)
    clock = clock + dtb
    blocked = c["blocked"] + dtb
    flushes = flushes + _i32(do_block)
    j_alive = j_alive & ~do_block
    j_left = torch.where(do_block, 0.0, j_left)
    s_used = torch.where(do_block, 0, s_used)

    sched = swap | bb_trig
    jb = a_used
    jb_f = jb.to(F)
    service = a_fs * g["seek_time"] + jb_f / g["seq_bw"]
    n_rate = torch.where(jb > 0, jb_f / service, g["seq_bw"])
    j_rate = torch.where(sched, n_rate, c["j_rate"])
    j_left = torch.where(sched, jb_f, j_left)
    j_alive = j_alive | sched
    s_used = torch.where(sched, jb, s_used)
    a_used = torch.where(sched, 0, a_used)
    a_fs = torch.where(sched, 0.0, a_fs)
    xf = {f"xf_{d}": torch.where(sched, 0.0, c[f"xf_{d}"]) for d in range(1, XMERGE_D + 1)}
    cur_xf = torch.where(sched, 0.0, c["cur_xf"] + wfrac)
    ovf = c["ovf"] | bb_ovf | (bb_trig & (rem > 0))
    return {"rem": rem, "ovf": ovf, "clock": clock, "pause": pause, "blocked": blocked,
            "b_ssd": b_ssd, "flushes": flushes, "a_used": a_used, "s_used": s_used,
            "a_fs": a_fs, "j_left": j_left, "j_rate": j_rate, "j_alive": j_alive,
            "cur_xf": cur_xf, **xf}


def _ssd_fill_loop(g, lane, st, ev, allowed, dev_ssd, F):
    c = {"rem": torch.where(dev_ssd & (lane["cap"] > 0), ev["nbytes"], 0),
         "ovf": torch.zeros_like(dev_ssd),
         **{k: st[k] for k in _FILL_KEYS},
         "cur_xf": torch.zeros_like(st["a_fs"]),
         **{f"xf_{d}": st[f"xf_{d}"] for d in range(1, XMERGE_D + 1)}}
    while True:
        active = (c["rem"] > 0) & ~c["ovf"]
        if not bool(active.any()):
            return c
        new = _fill_body(g, lane, ev, allowed, c, F)
        c = {k: torch.where(active, new[k], c[k]) for k in c}


def _hdd_advance(g, c, hdd_b, nb, ev, allowed, F):
    nb_f = torch.clamp_min(nb, 1).to(F)
    frac = hdd_b.to(F) / nb_f
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
    j_left = torch.where(completed, 0.0,
                         torch.where(do & adv, c["j_left"] - prog, c["j_left"]))
    return {**c,
            "clock": c["clock"] + torch.where(do, wall, 0.0),
            "pause": c["pause"] + torch.where(do & flushing & ~adv, wall_alone, 0.0),
            "b_hdd": c["b_hdd"] + hdd_b,
            "flushes": c["flushes"] + _i32(completed),
            "s_used": torch.where(completed, 0, c["s_used"]),
            "j_alive": c["j_alive"] & ~completed,
            "j_left": j_left}


def _gap_step(st, sec):
    need = st["j_left"] / st["j_rate"]
    full = st["j_alive"] & (need <= sec)
    partial = st["j_alive"] & ~full
    j_left = torch.where(full, 0.0,
                         torch.where(partial, st["j_left"] - st["j_rate"] * sec, st["j_left"]))
    return {**st,
            "clock": st["clock"] + sec,
            "gap": st["gap"] + sec,
            "flushes": st["flushes"] + _i32(full),
            "s_used": torch.where(full, 0, st["s_used"]),
            "j_alive": st["j_alive"] & ~full,
            "j_left": j_left}


def _stream_step(g, lane, st, ev, F):
    scheme = lane["scheme"]
    is_tworeg = (scheme == 2) | (scheme == 3)
    dev_ssd, allowed, upd = _observe_and_route(g, lane, st, ev["pct"])
    c = _ssd_fill_loop(g, lane, st, ev, allowed, dev_ssd, F)
    hdd_b = torch.where(dev_ssd, torch.where(c["ovf"], c["rem"], 0), ev["nbytes"])
    base = {k: torch.where(dev_ssd, c[k], st[k]) for k in _FILL_KEYS}
    base["b_hdd"], base["gap"], base["peak"] = st["b_hdd"], st["gap"], st["peak"]
    out = _hdd_advance(g, base, hdd_b, ev["nbytes"], ev, allowed, F)
    out["xf_1"] = torch.where(dev_ssd, c["cur_xf"], 0.0)
    for d in range(2, XMERGE_D + 1):
        out[f"xf_{d}"] = torch.where(dev_ssd, c[f"xf_{d - 1}"], st[f"xf_{d - 1}"])
    out["peak"] = torch.where(
        dev_ssd, torch.maximum(st["peak"], out["a_used"] + out["s_used"]), st["peak"])
    for k, v in upd.items():
        out[k] = _sel(is_tworeg, v, st[k])
    return out


def _event_step(g, lane, st, ev, F):
    strm = _stream_step(g, lane, st, ev, F)
    gap = _gap_step(st, ev["gap_sec"])
    valid, is_gap = ev["valid"], ev["is_gap"]
    return {k: _sel(valid, _sel(is_gap, gap[k], strm[k]), st[k]) for k in st}


def _final_drain(g, st, F):
    d1 = torch.where(st["j_alive"], st["j_left"] / st["j_rate"], 0.0)
    has_active = st["a_used"] > 0
    a_f = st["a_used"].to(F)
    d2 = torch.where(has_active, st["a_fs"] * g["seek_time"] + a_f / g["seq_bw"], 0.0)
    return {"io_seconds": st["clock"] - st["gap"],
            "total_seconds": st["clock"] + d1 + d2,
            "bytes_to_ssd": st["b_ssd"],
            "bytes_to_hdd_direct": st["b_hdd"],
            "flushes": st["flushes"] + _i32(st["j_alive"]) + _i32(has_active),
            "flush_paused_seconds": st["pause"],
            "blocked_seconds": st["blocked"],
            "peak_ssd_occupancy": st["peak"]}


def replay(g: dict, lane: dict, st: dict, events: dict, steps: int,
           fdt: torch.dtype = torch.float64) -> dict[str, torch.Tensor]:
    """Every lane through the first ``steps`` events of the ``(S, L)`` tape
    ``events``, then drained.  Float fields of ``lane``, ``st`` and
    ``events`` are taken in ``fdt``."""

    def cast(d):
        return {k: v.to(fdt) if v.is_floating_point() else v for k, v in d.items()}

    lane, st, events = cast(lane), cast(st), cast(events)
    for t in range(steps):
        st = _event_step(g, lane, st, {k: v[t] for k, v in events.items()}, fdt)
    return _final_drain(g, st, fdt)
