"""A lane-serial mirror of the ``replay`` kernel's algorithm in NumPy.

The CUDA kernel (``kernels/replay/csrc/replay.cu``) runs only on a card.
This module runs the same algorithm on the CPU, statement for statement,
one lane at a time in scalar float64, over the same packed arrays
(:class:`repro_torch.kernels.replay.ops.Packed`, NumPy views), in the
kernel's order: first SSDUP+'s threshold pass (:func:`threshold_pass`: a
chunk of stream events at a time, the chunk's candidates sorted by the
kernel's bitonic network, each event's window walked in that order), then
the chain, which consumes the thresholds, with the kernel's branches (a
gap or a stream, the FTL or the constant SSD, one dyadic scale), its
per-lane region-fill loop, NaN-propagating max/min/clamp, ``rint`` and the
x86 float-to-int conversion.  The CPU tests hold it to the plain torch
version (:func:`repro_torch.core.engine_device.replay_lanes` on the CPU),
and the threshold pass alone to the plain version's, so a change of the
algorithm shows here before it reaches the card.  Slow: for tests at
golden-fixture size.
"""

from __future__ import annotations

from typing import Sequence

import struct

import numpy as np

from ..kernels.replay import ops
from ..kernels.replay.ref import SUFFIX_ANCHORS, WINDOW_SCALES, XMERGE_D

_T = {k: i for i, k in enumerate(ops.TAPE_F64)}
_INT64_MIN = -(1 << 63)
_INT32_MIN = -(1 << 31)


def _max(a: float, b: float) -> float:
    return a + b if a != a or b != b else (b if a < b else a)


def _min(a: float, b: float) -> float:
    return a + b if a != a or b != b else (b if b < a else a)


def _clamp(x: float, lo: float, hi: float) -> float:
    return _min(_max(x, lo), hi)


def _to_i64(x: float) -> int:
    if x != x or x >= 2.0 ** 63 or x < -(2.0 ** 63):
        return _INT64_MIN
    return int(x)


def _to_i32(x: float) -> int:
    if x != x or x >= 2.0 ** 31 or x <= -(2.0 ** 31) - 1.0:
        return _INT32_MIN
    return int(x)


def _before(a: float, b: float) -> bool:
    return a < b or (a == a and b != b)


def _same(a: float, b: float) -> bool:
    return a == b or (a != a and b != b)


def _rint(x: float) -> float:
    return float(np.rint(x))


_SIGN = 1 << 63
_MASK = (1 << 64) - 1
_NAN_KEY = _MASK - 1
_PAD_KEY = _MASK


def _order_key(v: float) -> int:
    """torch.sort's order as an unsigned key (the kernel's ``order_key``)."""

    if v != v:
        return _NAN_KEY
    u = struct.unpack("<Q", struct.pack("<d", v))[0]
    return (~u & _MASK) if u & _SIGN else (u | _SIGN)


def _key_value(k: int) -> float:
    u = (k & ~_SIGN) if k & _SIGN else (~k & _MASK)
    return struct.unpack("<d", struct.pack("<Q", u))[0]


def candidates(w: int) -> int:
    """The candidates a chunk sorts: a power of two ``P >= W + 32``, at
    least 64; a chunk takes ``P - W`` stream events."""

    p = 64
    while p < w + 32:
        p <<= 1
    return p


def _bitonic(cand: list) -> None:
    """The kernel's ``warp_sort``: ascending by key, in place."""

    n = len(cand)
    k = 2
    while k <= n:
        j = k >> 1
        while j > 0:
            for x in range(n // 2):
                lo = ((x & ~(j - 1)) << 1) | (x & (j - 1))
                hi = lo + j
                if (cand[lo][0] > cand[hi][0]) == ((lo & k) == 0):
                    cand[lo], cand[hi] = cand[hi], cand[lo]
            j >>= 1
        k <<= 1


def threshold_pass(pcts, win0, win_n: int, win_p: int, default_thr: float) -> list[float]:
    """SSDUP+'s threshold at each of a lane's stream events (percentages
    ``pcts`` in order), from its initial window ``win0`` (``W`` entries),
    count ``win_n`` and write slot ``win_p``: the plain version's
    ``adap_thr`` event by event, computed as the kernel's
    ``threshold_chunk`` does, a chunk of ``P - W`` events at a time."""

    w = len(win0)
    p_len = candidates(w)
    c_len = p_len - w
    win = [float(v) for v in win0]
    pcts = [float(v) for v in pcts]
    n0, p0, out = win_n, win_p, []
    for k0 in range(0, len(pcts), c_len):
        pct = pcts[k0:k0 + c_len]
        n = len(pct)
        # the window's slots, the chunk's percentages, pads: (key, first, last)
        cand = [(_order_key(win[x]), 0, (x - p0 + w) % w) for x in range(w)]
        cand += [(_order_key(pct[c]), c + 1, c + w) for c in range(n)]
        cand += [(_PAD_KEY, 1 << 31, -1)] * (p_len - w - n)
        for c in range(n):
            if c + w >= n:
                win[(p0 + c) % w] = pct[c]
        _bitonic(cand)
        for c in range(n):
            have = min(n0 + c, w)
            thr = default_thr
            if have > 0:
                total, cnt, x = 0.0, 0, 0
                while cnt < have:
                    key, first, last = cand[x]
                    if first <= c <= last:
                        total = total + _key_value(key)
                        cnt += 1
                    x += 1
                avg = total / float(have)
                n2 = min(have + 1, w)
                idx = min(max(_to_i32(float(np.floor((1.0 - avg) * float(n2)))), 0), n2 - 1)
                cnt, x = 0, 0
                while True:
                    key, first, last = cand[x]
                    if first <= c + 1 <= last:
                        if cnt == idx:
                            thr = _key_value(key)
                            break
                        cnt += 1
                    x += 1
            out.append(thr)
        n0 = min(n0 + n, w)
        p0 = (p0 + n) % w
    return out


def _lane(p: ops.Packed, g: dict, i: int, steps: int) -> dict:
    lf = {k: float(p.lane_f64[j, i]) for j, k in enumerate(ops.LANE_F64)}
    li = {k: int(p.lane_i64[j, i]) for j, k in enumerate(ops.LANE_I64)}
    st = {k: float(p.state_f64[j, i]) for j, k in enumerate(ops.STATE_F64)}
    st.update({k: int(p.state_i64[j, i]) for j, k in enumerate(ops.STATE_I64)})
    for k in ("j_alive", "static_rand", "cur_ssd"):
        st[k] = bool(st[k])
    scheme, cap, ftl_on = li["scheme"], li["cap"], bool(li["ftl_on"])
    xf = [st[f"xf_{d}"] for d in range(1, XMERGE_D + 1)]
    valid, is_gap = (p.tape_u8[f, i, :steps].astype(bool) for f in range(2))
    # the threshold pass, ahead of the chain
    thresholds: list[float] = []
    if scheme == 3:
        rows = np.nonzero(valid & ~is_gap)[0]
        thresholds = threshold_pass(p.tape_f64[_T["pct"], i, rows], p.win[i], st["win_n"],
                                    st["win_p"], g["default_thr"])

    def route(pct: float, thr: float) -> tuple[bool, bool]:
        is_ofs, is_bb, is_plus = scheme == 0, scheme == 1, scheme == 3
        dev_ssd = is_bb or (not is_ofs and st["cur_ssd"])
        allowed = (not is_plus) or (dev_ssd if lf["gate"] < 0.0 else pct >= lf["gate"])
        if scheme == 2:
            sr2 = pct > g["static_high"] or (not (pct < g["static_low"]) and st["static_rand"])
            thr = g["static_low"] if sr2 else g["static_high"]
            st["static_rand"] = sr2
        elif not is_plus:
            return dev_ssd, allowed
        st["cur_ssd"] = pct > thr or (not (pct < thr) and st["cur_ssd"])
        return dev_ssd, allowed

    def fill_once(ev, nbytes: int, allowed: bool, rem: int, ovf: bool,
                  cur_xf: float) -> tuple[int, bool, float]:
        is_bb = scheme == 1
        is_tworeg = scheme in (2, 3)
        nb_f = float(max(nbytes, 1))
        mean_sz = ev("mean_sz")
        margin = _max(mean_sz, float(cap // 256))
        bb_ovf = is_bb and st["j_alive"]
        room = cap - st["a_used"]
        room_f = float(room)
        m = _max(mean_sz, 1.0)
        kreq = float(np.floor((room_f - margin) / m)) + 1.0
        bb_cap = _to_i64(float(np.ceil(_max(kreq, 0.0) * m)))
        tr_cap = _to_i64(float(np.floor(room_f / m)) * m)
        fill_cap = min(room, bb_cap) if is_bb else tr_cap
        fill = 0 if bb_ovf else min(rem, fill_cap)
        frac = float(fill) / nb_f
        free1 = live1 = reloc = 0.0
        gc_on = False
        if ftl_on:
            pages = float(fill) / lf["ftl_page"]
            free1 = st["ftl_free"] - pages
            live1 = st["ftl_live"] + pages
            gc_on = fill > 0 and free1 < lf["ftl_low"]
            u = _clamp(live1 / _max(lf["ftl_phys"] - free1, 1.0), 0.0, 0.97)
            need = _max(lf["ftl_high"] - free1, 0.0)
            nblk = need / _max(lf["ftl_ppb"] * (1.0 - u), 1.0)
            reloc = nblk * lf["ftl_ppb"] * u
            gc_t = reloc * lf["ftl_tpp"] + nblk * lf["ftl_terase"]
            seg_dev = pages * lf["ftl_tpp"] + (gc_t if gc_on else 0.0)
            segw = _max(ev("net_t") * frac, seg_dev)
        else:
            segw = ev("ssd_w") * frac

        progressing = st["j_alive"] and allowed
        prog = st["j_rate"] * segw
        completed = progressing and prog >= st["j_left"]
        trim_b = st["s_used"] if completed else 0
        st["j_left"] = 0.0 if completed else (
            st["j_left"] - prog if progressing else st["j_left"])
        st["pause"] = st["pause"] + (segw if st["j_alive"] and not allowed else 0.0)
        st["flushes"] += int(completed)
        if completed:
            st["s_used"] = 0
        st["j_alive"] = st["j_alive"] and not completed
        st["clock"] = st["clock"] + segw
        st["a_used"] += fill

        a0 = (nb_f - float(rem)) / nb_f
        wfrac = float(fill) / nb_f
        a1 = a0 + wfrac
        scale = _to_i32(_clamp(_rint(-float(np.log2(_max(wfrac, 1e-9)))), 0.0,
                               float(WINDOW_SCALES - 1)))
        seg_fs = 0.0
        col = 0
        for s in range(WINDOW_SCALES):
            nw = 1 << s
            if s == scale:
                acc = 0.0
                for wj in range(nw):
                    lo = float(wj) / float(nw)
                    cov = _clamp((_min(a1, lo + 1.0 / float(nw)) - _max(a0, lo)) * float(nw),
                                 0.0, 1.0)
                    wfv, wnv = ev(f"wf_{col + wj}"), ev(f"wn_{col + wj}")
                    acc = acc + (wnv + (wfv - wnv) * cov if cov > 0.0 else 0.0)
                seg_fs = acc
            col += nw
        ppos = _clamp(a1 * float(SUFFIX_ANCHORS), 0.0, float(SUFFIX_ANCHORS))
        pj = _to_i32(_clamp(float(np.floor(ppos)), 0.0, float(SUFFIX_ANCHORS - 1)))
        plam = ppos - float(pj)
        pref_fs = 0.0
        if 0 <= pj < SUFFIX_ANCHORS:
            pref_fs = (1.0 - plam) * ev(f"pf_{pj}") + plam * ev(f"pf_{pj + 1}")
        if a0 <= 0.0:
            seg_fs = pref_fs
        if not fill > 0:
            seg_fs = 0.0
        xsum = ev("xm_1") * xf[0]
        for d in range(1, XMERGE_D):
            xsum = xsum + ev(f"xm_{d + 1}") * xf[d]
        seg_xm = wfrac * xsum
        st["a_fs"] = _max(st["a_fs"] + seg_fs - seg_xm, 0.0)
        st["b_ssd"] += fill
        rem -= fill

        bb_trig = is_bb and not bb_ovf and float(room - fill) < margin
        swap = is_tworeg and rem > 0
        do_block = swap and st["j_alive"]
        dtb = st["j_left"] / st["j_rate"] if do_block else 0.0
        st["clock"] = st["clock"] + dtb
        st["blocked"] = st["blocked"] + dtb
        st["flushes"] += int(do_block)
        st["j_alive"] = st["j_alive"] and not do_block
        if do_block:
            st["j_left"] = 0.0
        trim_b = trim_b + (st["s_used"] if do_block else 0)
        if do_block:
            st["s_used"] = 0

        sched = swap or bb_trig
        jb = st["a_used"]
        jb_f = float(jb)
        service = st["a_fs"] * g["seek_time"] + jb_f / g["seq_bw"]
        n_rate = jb_f / service if jb > 0 else g["seq_bw"]
        if sched:
            st["j_rate"] = n_rate
            st["j_left"] = jb_f
            st["j_alive"] = True
            st["s_used"] = jb
            st["a_used"] = 0
            st["a_fs"] = 0.0
            xf[:] = [0.0] * XMERGE_D
            cur_xf = 0.0
        else:
            cur_xf = cur_xf + wfrac
        ovf = ovf or bb_ovf or (bb_trig and rem > 0)
        trim_p = float(trim_b) / lf["ftl_page"]
        if ftl_on:
            st["ftl_free"] = lf["ftl_high"] if gc_on else free1
            st["ftl_live"] = live1 - trim_p
        st["ftl_reloc"] = st["ftl_reloc"] + (reloc if gc_on else 0.0)
        return rem, ovf, cur_xf

    def hdd_advance(ev, hdd_b: int, nbytes: int, allowed: bool) -> None:
        nb_f = float(max(nbytes, 1))
        frac = float(hdd_b) / nb_f
        pos = (1.0 - frac) * float(SUFFIX_ANCHORS)
        dt = 0.0
        for j in range(SUFFIX_ANCHORS + 1):
            wgt = _max(1.0 - abs(pos - float(j)), 0.0)
            dt = dt + wgt * ev(f"hddt_{j}")
        net = ev("net_t") * frac
        run = hdd_b > 0
        flushing = st["j_alive"]
        adv = flushing and allowed
        wall_alone = _max(net, dt)
        wall_shared = _max(net, dt * g["slowdown"])
        wall = wall_shared if adv else wall_alone
        prog = st["j_rate"] * g["flush_frac"] * wall
        completed = run and adv and prog >= st["j_left"]
        st["j_left"] = 0.0 if completed else (
            st["j_left"] - prog if run and adv else st["j_left"])
        trim_p = float(st["s_used"] if completed else 0) / lf["ftl_page"]
        st["clock"] = st["clock"] + (wall if run else 0.0)
        st["pause"] = st["pause"] + (wall_alone if run and flushing and not adv else 0.0)
        st["b_hdd"] = st["b_hdd"] + hdd_b
        st["flushes"] += int(completed)
        if completed:
            st["s_used"] = 0
        st["j_alive"] = st["j_alive"] and not completed
        if ftl_on:
            st["ftl_live"] = st["ftl_live"] - trim_p

    def gap_step(sec: float) -> None:
        need = st["j_left"] / st["j_rate"]
        full = st["j_alive"] and need <= sec
        partial = st["j_alive"] and not full
        st["j_left"] = 0.0 if full else (
            st["j_left"] - st["j_rate"] * sec if partial else st["j_left"])
        trim_p = float(st["s_used"] if full else 0) / lf["ftl_page"]
        st["clock"] = st["clock"] + sec
        st["gap"] = st["gap"] + sec
        st["flushes"] += int(full)
        if full:
            st["s_used"] = 0
        st["j_alive"] = st["j_alive"] and not full
        if ftl_on:
            st["ftl_live"] = st["ftl_live"] - trim_p

    status, k = 0, 0
    for t in range(steps):
        if valid[t] and not is_gap[t]:
            col_f = p.tape_f64[:, i, t]

            def ev(name, col_f=col_f):
                return float(col_f[_T[name]])

            nbytes = int(p.tape_i64[0, i, t])
            dev_ssd, allowed = route(ev("pct"), thresholds[k] if scheme == 3 else 0.0)
            k += 1
            rem = nbytes if dev_ssd and cap > 0 else 0
            ovf, cur_xf, fills = False, 0.0, 0
            while rem > 0 and not ovf:
                fills += 1
                if fills > ops.MAX_FILLS:
                    status = 1
                    break
                rem, ovf, cur_xf = fill_once(ev, nbytes, allowed, rem, ovf, cur_xf)
            if status:
                break
            hdd_advance(ev, (rem if ovf else 0) if dev_ssd else nbytes, nbytes, allowed)
            xf[1:] = xf[:-1]
            xf[0] = cur_xf
            if dev_ssd:
                st["peak"] = max(st["peak"], st["a_used"] + st["s_used"])
        elif valid[t]:
            gap_step(float(p.tape_f64[_T["gap_sec"], i, t]))

    d1 = st["j_left"] / st["j_rate"] if st["j_alive"] else 0.0
    has_active = st["a_used"] > 0
    d2 = st["a_fs"] * g["seek_time"] + float(st["a_used"]) / g["seq_bw"] if has_active else 0.0
    return {
        "io_seconds": st["clock"] - st["gap"],
        "total_seconds": st["clock"] + d1 + d2,
        "bytes_to_ssd": st["b_ssd"],
        "bytes_to_hdd_direct": st["b_hdd"],
        "flushes": st["flushes"] + int(st["j_alive"]) + int(has_active),
        "flush_paused_seconds": st["pause"],
        "blocked_seconds": st["blocked"],
        "peak_ssd_occupancy": st["peak"],
        "ftl_reloc_pages": st["ftl_reloc"],
        "ftl_live_pages": st["ftl_live"],
        "status": status,
    }


_OUT_DTYPES = {"bytes_to_ssd": np.int64, "bytes_to_hdd_direct": np.int64,
               "flushes": np.int32, "peak_ssd_occupancy": np.int64}


def replay_serial(p: ops.Packed, g: Sequence[float], steps: int) -> dict[str, np.ndarray]:
    """Every lane of ``p`` (NumPy views, :func:`repro_torch.kernels.replay.
    ops.views`) through its first ``steps`` events, one lane at a time, as
    the kernel computes it; ``g`` the globals in ``ops.GLOBALS`` order.
    Raises ``RuntimeError`` where the kernel would report a lane that
    passed ``MAX_FILLS`` region fills in one event."""

    gd = dict(zip(ops.GLOBALS, (float(v) for v in g)))
    lanes = [_lane(p, gd, i, steps) for i in range(p.win.shape[0])]
    if any(r["status"] for r in lanes):
        raise RuntimeError("a lane's region fills passed MAX_FILLS in one event")
    return {k: np.array([r[k] for r in lanes], dtype=_OUT_DTYPES.get(k, np.float64))
            for k in ("io_seconds", "total_seconds", "bytes_to_ssd", "bytes_to_hdd_direct",
                      "flushes", "flush_paused_seconds", "blocked_seconds",
                      "peak_ssd_occupancy", "ftl_reloc_pages", "ftl_live_pages")}
