"""NumPy half of the reference: a trace, range-offset shards, stream
scores and event tapes.

Frozen from the fleet sweep's definition (the paper's Eq. 1 seek count,
Eq. 6 seek distance, the batched engine's event order and anchors) and
kept here unchanged, so that a later change to the program cannot move
what its results are judged against.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# storage models (bytes/s, s): HDD seek + distance + sequential bandwidth,
# the SSD's write bandwidth, the node's ingest link
HDD_SEQ_BW = 220e6
HDD_SEEK_TIME = 3.56e-3
HDD_SEEK_DIST_COEFF = 5.1e-12
SSD_WRITE_BW = 380e6
LINK_BW = 110e6

# tape geometry: suffix anchors, dyadic window scales, cross-merge depth
SUFFIX_ANCHORS = 16
WINDOW_SCALES = 4
N_WINDOWS = (1 << WINDOW_SCALES) - 1
XMERGE_D = 4

EVENT_FIELDS = {
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


@dataclasses.dataclass(frozen=True, eq=False)
class Trace:
    """Request columns in arrival order, and compute gaps
    (``gap_positions[i]`` is the request index gap ``i`` precedes)."""

    offsets: np.ndarray
    sizes: np.ndarray
    file_ids: np.ndarray
    app_ids: np.ndarray
    gap_positions: np.ndarray
    gap_seconds: np.ndarray

    @classmethod
    def of(cls, cols: dict) -> "Trace":
        """From the generator's columns (copied, so that nothing the
        program holds is shared)."""

        return cls(**{k: np.array(cols[k], dtype=np.float64 if k == "gap_seconds"
                                  else np.int64)
                      for k in ("offsets", "sizes", "file_ids", "app_ids",
                                "gap_positions", "gap_seconds")})

    @property
    def num_requests(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def total_bytes(self) -> int:
        return int(self.sizes.sum())

    def stream_bounds(self, stream_len: int) -> np.ndarray:
        r = self.num_requests
        if r == 0:
            return np.zeros(1, dtype=np.int64)
        return np.append(np.arange(0, r, stream_len, dtype=np.int64), r)

    def select(self, idx: np.ndarray) -> "Trace":
        """The requests at sorted ``idx``; every gap is kept (a compute
        phase idles every node), its position remapped."""

        return Trace(self.offsets[idx], self.sizes[idx], self.file_ids[idx],
                     self.app_ids[idx],
                     np.searchsorted(idx, self.gap_positions, side="left"),
                     self.gap_seconds.copy())


def range_offset(offsets: np.ndarray, nodes: int) -> np.ndarray:
    """Stripe the logical byte range into ``nodes`` equal extents."""

    if offsets.size == 0:
        return np.zeros(0, dtype=np.int64)
    lo, hi = int(offsets.min()), int(offsets.max())
    extent = max((hi - lo) // nodes + 1, 1)
    return np.minimum((offsets - lo) // extent, nodes - 1).astype(np.int64)


POLICIES = {"range-offset": range_offset}


def shard(trace: Trace, policy: str, nodes: int) -> list[Trace]:
    node = POLICIES[policy](trace.offsets, nodes)
    return [trace.select(np.nonzero(node == n)[0]) for n in range(nodes)]


def _stats(offs: np.ndarray, szs: np.ndarray):
    """Eq. 1 seek count, its share of the ``n - 1`` pairs, and the Eq. 6
    sorted seek distance of each ``(M, n)`` row."""

    m, n = offs.shape
    if n <= 1:
        z = np.zeros(m, dtype=np.int64)
        return z, np.zeros(m, dtype=np.float64), z.copy()
    order = np.argsort(offs, axis=-1, kind="stable")
    so = np.take_along_axis(offs, order, axis=-1)
    ss = np.take_along_axis(szs, order, axis=-1)
    resid = so[:, 1:] - so[:, :-1] - ss[:, :-1]
    rf = np.count_nonzero(resid, axis=-1).astype(np.int64)
    return rf, rf / (n - 1), np.abs(resid).sum(axis=-1)


def scores(t: Trace, stream_len: int) -> dict[str, np.ndarray]:
    """Every stream's ``rf``, ``pct``, ``dist`` and ``nbytes`` (full blocks
    of ``stream_len`` requests, then the trailing partial)."""

    m = t.num_requests // stream_len
    full = m * stream_len
    rf, pct, dist = _stats(t.offsets[:full].reshape(m, stream_len),
                           t.sizes[:full].reshape(m, stream_len))
    if full < t.num_requests:
        trf, tpct, tdist = _stats(t.offsets[None, full:], t.sizes[None, full:])
        rf, pct, dist = (np.concatenate(p) for p in ((rf, trf), (pct, tpct), (dist, tdist)))
    starts = t.stream_bounds(stream_len)[:-1]
    nbytes = np.add.reduceat(t.sizes, starts) if len(starts) else np.zeros(0, np.int64)
    return {"rf": rf, "pct": pct, "dist": dist, "nbytes": nbytes}


def _cross_stream_merges(t: Trace, bounds: np.ndarray) -> np.ndarray:
    ns = len(bounds) - 1
    out = np.zeros((ns, XMERGE_D), dtype=np.float64)
    if t.num_requests < 2:
        return out
    sid = np.repeat(np.arange(ns, dtype=np.int64), np.diff(bounds))
    order = np.lexsort((t.offsets, t.file_ids))
    so, ss, sf, ssid = t.offsets[order], t.sizes[order], t.file_ids[order], sid[order]
    contig = (sf[1:] == sf[:-1]) & (so[1:] == so[:-1] + ss[:-1])
    d = np.abs(ssid[1:] - ssid[:-1])
    later = np.maximum(ssid[1:], ssid[:-1])
    for k in range(1, XMERGE_D + 1):
        out[:, k - 1] = np.bincount(later[contig & (d == k)], minlength=ns)
    return out


def _masked_predecessors(mask: np.ndarray) -> np.ndarray:
    idx = np.arange(mask.shape[0], dtype=np.int64)
    pidx = np.maximum.accumulate(np.where(mask, idx, -1))
    prev = np.empty_like(pidx)
    prev[0] = -1
    prev[1:] = pidx[:-1]
    return prev


def _sorted_by_stream(t: Trace, bounds: np.ndarray, with_file: bool):
    lens = np.diff(bounds)
    sid = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    pos_in = np.arange(t.num_requests, dtype=np.int64) - np.repeat(bounds[:-1], lens)
    keys = (t.offsets, t.file_ids, sid) if with_file else (t.offsets, sid)
    order = np.lexsort(keys)
    return (t.offsets[order], t.sizes[order], t.file_ids[order], sid[order],
            pos_in[order], lens)


def _window_seek_anchors(t: Trace, bounds: np.ndarray):
    ns = len(bounds) - 1
    wf = np.zeros((ns, N_WINDOWS), dtype=np.float64)
    wn = np.zeros((ns, N_WINDOWS), dtype=np.float64)
    if t.num_requests == 0:
        return wf, wn
    so, ss, sf, sdi, spos, lens = _sorted_by_stream(t, bounds, True)
    slen = lens[sdi]
    col = 0
    for s in range(WINDOW_SCALES):
        w = 1 << s
        win = np.minimum(((2 * spos + 1) * w - 1) // np.maximum(2 * slen, 1), w - 1)
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


def _prefix_seek_anchors(t: Trace, bounds: np.ndarray) -> np.ndarray:
    ns = len(bounds) - 1
    out = np.zeros((ns, SUFFIX_ANCHORS + 1), dtype=np.float64)
    if t.num_requests == 0:
        return out
    so, ss, sf, sdi, spos, lens = _sorted_by_stream(t, bounds, True)
    for j in range(1, SUFFIX_ANCHORS + 1):
        k = np.floor(j * lens / SUFFIX_ANCHORS + 0.5).astype(np.int64)
        m = spos < k[sdi]
        prev = _masked_predecessors(m)
        pc = np.maximum(prev, 0)
        same = m & (prev >= 0) & (sdi[pc] == sdi) & (sf[pc] == sf)
        contig = same & (so == so[pc] + ss[pc])
        out[:, j] = np.bincount(sdi[m & ~contig], minlength=ns)
    return out


def _suffix_hdd_anchors(t: Trace, bounds: np.ndarray) -> np.ndarray:
    ns = len(bounds) - 1
    out = np.zeros((ns, SUFFIX_ANCHORS + 1), dtype=np.float64)
    if t.num_requests == 0:
        return out
    so, ss, _, sdi, spos, lens = _sorted_by_stream(t, bounds, False)
    szf = ss.astype(np.float64)
    for j in range(SUFFIX_ANCHORS):
        k = np.floor(j * lens / SUFFIX_ANCHORS + 0.5).astype(np.int64)
        m = spos >= k[sdi]
        prev = _masked_predecessors(m)
        pc = np.maximum(prev, 0)
        pair = m & (prev >= 0) & (sdi[pc] == sdi)
        resid = np.where(pair, so - so[pc] - ss[pc], 0)
        rf = np.bincount(sdi[pair & (resid != 0)], minlength=ns)
        dist = np.bincount(sdi, weights=np.abs(resid).astype(np.float64), minlength=ns)
        nb = np.bincount(sdi[m], weights=szf[m], minlength=ns)
        out[:, j] = rf * HDD_SEEK_TIME + dist * HDD_SEEK_DIST_COEFF + nb / HDD_SEQ_BW
    return out


def events(t: Trace, sc: dict[str, np.ndarray], stream_len: int) -> dict[str, np.ndarray]:
    """One shard's event tape: one event per stream or gap, a full stream
    firing before any gap at its end, the trailing partial after all."""

    bounds = t.stream_bounds(stream_len)
    ns = len(bounds) - 1 if t.num_requests else 0
    n_req = np.diff(bounds) if ns else np.zeros(0, dtype=np.int64)
    nb = np.asarray(sc["nbytes"], dtype=np.int64)
    rf = np.asarray(sc["rf"], dtype=np.float64)
    dist = np.asarray(sc["dist"], dtype=np.float64)
    hdd_t = rf * HDD_SEEK_TIME + dist * HDD_SEEK_DIST_COEFF + nb / HDD_SEQ_BW
    net_t = nb / LINK_BW
    if ns:
        anchors = _suffix_hdd_anchors(t, bounds)
        anchors[:, 0] = hdd_t
        w = np.maximum(t.sizes / LINK_BW, t.sizes / SSD_WRITE_BW)
        ssd_w = np.add.reduceat(w, bounds[:-1])
        wf, wn = _window_seek_anchors(t, bounds)
        pf = _prefix_seek_anchors(t, bounds)
        xm = _cross_stream_merges(t, bounds)
    else:
        anchors = pf = np.zeros((0, SUFFIX_ANCHORS + 1))
        ssd_w = np.zeros(0)
        wf = wn = np.zeros((0, N_WINDOWS))
        xm = np.zeros((0, XMERGE_D))
    mean_sz = nb / np.maximum(n_req, 1)

    gap_pos = t.gap_positions
    ng = len(gap_pos)
    if ns:
        fire_before = np.where(n_req == stream_len, bounds[1:], t.num_requests + 1)
        gaps_before = np.searchsorted(gap_pos, fire_before, side="left")
    else:
        gaps_before = np.zeros(0, dtype=np.int64)
    ev = {k: np.zeros(ns + ng, dtype=dt) for k, dt in EVENT_FIELDS.items()}
    ev["valid"][:] = True
    s_idx = np.arange(ns) + gaps_before
    g_idx = np.arange(ng) + np.searchsorted(gaps_before, np.arange(ng), side="right")
    ev["pct"][s_idx] = np.asarray(sc["pct"], dtype=np.float64)
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
    ev["gap_sec"][g_idx] = t.gap_seconds
    return ev


def per_app_bytes(t: Trace) -> dict[int, int]:
    if not t.num_requests:
        return {}
    apps, inverse = np.unique(t.app_ids, return_inverse=True)
    sums = np.zeros(len(apps), dtype=np.int64)
    np.add.at(sums, inverse, t.sizes)
    return {int(a): int(s) for a, s in zip(apps, sums)}
