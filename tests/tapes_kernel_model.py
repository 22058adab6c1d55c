"""The ``tapes`` kernel's algorithm in NumPy, step for step, for the CPU
tests: the CUDA kernel (``src/repro_torch/kernels/tapes/csrc/tapes.cu``)
runs only on a card, so its algorithm is held here, vectorised over
streams and masks, against the plain version
(:mod:`repro_torch.kernels.tapes.ref`), which computes the same columns
another way (an ``add.reduceat``, a lexsort of the shard and a bincount
for each mask):

1. each stream's SSD wall: the first request's, plus NumPy's pairwise sum
   of the rest (:func:`pairwise_sum`, the order ``add.reduceat`` adds in);
2. each stream's positions sorted by (offset, arrival) and by (file,
   offset, arrival): the keys are unique, so any sort gives the network's
   order;
3. one walker a mask goes through its order once, each masked request
   against the previous masked one: a suffix anchor counts seeks and adds
   the float64 |gap| and bytes in that order, a prefix or window anchor
   counts seeks (and a window new files);
4. the shard's (file, offset, arrival) order by merge rounds over the
   sorted runs, each request placed by a binary search of the partner run;
5. each neighbouring pair of that order, contiguous and 1..XMERGE_D
   streams apart, counts for the later stream.
"""

import numpy as np

from repro_torch.kernels.tapes.ref import COLUMNS
from repro_torch.kernels.replay.ref import N_WINDOWS, SUFFIX_ANCHORS, XMERGE_D


def pairwise_sum(a: np.ndarray) -> np.ndarray:
    """NumPy's pairwise float64 sum of each row of ``a``, in its order:
    under 8 one after another from 0; up to 128 in eight interleaved sums,
    combined as ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7)), then the rest one
    after another; above, the two halves (the first a multiple of 8) summed
    apart and added."""

    n = a.shape[1]
    if n < 8:
        res = np.zeros(a.shape[0], dtype=np.float64)
        for i in range(n):
            res = res + a[:, i]
        return res
    if n <= 128:
        r = a[:, :8].copy()
        i = 8
        while i < n - n % 8:
            r = r + a[:, i:i + 8]
            i += 8
        res = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + ((r[:, 4] + r[:, 5])
                                                             + (r[:, 6] + r[:, 7]))
        for j in range(i, n):
            res = res + a[:, j]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return pairwise_sum(a[:, :n2]) + pairwise_sum(a[:, n2:])


def _window_of(p: np.ndarray, w: int, n: np.ndarray) -> np.ndarray:
    """The window of arrival position ``p`` among ``w`` of a stream of
    ``n``: boundaries at round(k * n / w)."""

    return np.minimum(((2 * p + 1) * w - 1) // (2 * n), w - 1)


def _walker_masks(lens: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per walker and stream, the arrival positions ``[lo, hi)`` it masks,
    and whether it walks the (offset) order: suffixes 1..15, prefixes
    1..16, then the windows scale by scale."""

    lo, hi = [], []
    for j in range(1, SUFFIX_ANCHORS):
        lo.append((j * lens + SUFFIX_ANCHORS // 2) // SUFFIX_ANCHORS)
        hi.append(lens)
    for j in range(1, SUFFIX_ANCHORS + 1):
        lo.append(np.zeros_like(lens))
        hi.append((j * lens + SUFFIX_ANCHORS // 2) // SUFFIX_ANCHORS)
    pos = np.arange(int(lens.max()), dtype=np.int64)
    w = 1
    while w - 1 < N_WINDOWS:
        # each position's window, w past the stream: a non-decreasing row,
        # so window k starts at the count of positions before it
        win = np.where(pos[None, :] < lens[:, None],
                       _window_of(pos[None, :], w, lens[:, None]), w)
        for k in range(w):
            lo.append((win < k).sum(axis=1))
            hi.append((win < k + 1).sum(axis=1))
        w *= 2
    by_off = np.arange(len(lo)) < SUFFIX_ANCHORS - 1
    return np.stack(lo), np.stack(hi), by_off


def _merge_rounds(run: np.ndarray, off: np.ndarray, fid: np.ndarray,
                  stream_len: int) -> np.ndarray:
    """The sorted runs of ``stream_len`` requests merged pair by pair into
    the shard's (file, offset, arrival) order."""

    n = len(run)
    t = np.arange(n, dtype=np.int64)
    seg = stream_len
    src = run
    while seg < n:
        g = t // seg
        a0 = (g & ~1) * seg
        odd = (g & 1).astype(bool)
        start = np.where(odd, a0, a0 + seg)
        other = np.where(odd, seg, np.clip(n - (a0 + seg), 0, seg))
        local = np.where(odd, t - a0 - seg, t - a0)
        lo = np.zeros(n, dtype=np.int64)
        hi = other.copy()
        while True:
            active = lo < hi
            if not active.any():
                break
            mid = (lo + hi) >> 1
            x = src[np.minimum(start + mid, n - 1)]
            fx, fm = fid[x], fid[src]
            ox, om = off[x], off[src]
            before = (fx < fm) | ((fx == fm) & ((ox < om) | ((ox == om) & (x < src))))
            lo = np.where(active & before, mid + 1, lo)
            hi = np.where(active & ~before, mid, hi)
        dst = np.empty_like(src)
        dst[a0 + local + lo] = src
        src = dst
        seg *= 2
    return src


def _ssd_walls(siz: np.ndarray, lens: np.ndarray, link_bw: float,
               write_bw: float) -> np.ndarray:
    """Each stream's SSD wall from its ``(streams, stream_len)`` sizes: the
    full streams in one pass, the trailing partial one alone."""

    z = siz.astype(np.float64)
    walls = np.maximum(z / link_bw, z / write_bw)
    out = walls[:, 0].copy()
    for rows in (lens == siz.shape[1], lens < siz.shape[1]):
        if rows.any():
            n = int(lens[rows][0])
            if n > 1:
                out[rows] = walls[rows, 0] + pairwise_sum(walls[rows, 1:n])
    return out


def columns(cols: np.ndarray, stream_len: int, seek_time: float, seek_dist_coeff: float,
            seq_bw: float, link_bw: float, write_bw: float) -> np.ndarray:
    """``(len(COLUMNS), streams)`` float64 columns of the shard ``cols``
    (``(3, n)`` int64, rows ``ref.INPUTS``, arrival order)."""

    offsets, sizes, file_ids = (np.asarray(c, dtype=np.int64) for c in cols)
    n = len(offsets)
    ns = -(-n // stream_len)
    pos = np.arange(stream_len, dtype=np.int64)
    index = np.arange(ns, dtype=np.int64)[:, None] * stream_len + pos[None, :]
    real = index < n
    lens = np.minimum(n - np.arange(ns, dtype=np.int64) * stream_len, stream_len)

    def rows(col):
        out = np.zeros((ns, stream_len), dtype=np.int64)
        out[real] = col
        return out

    off, siz, fid = rows(offsets), rows(sizes), rows(file_ids)
    by_off = np.lexsort((pos[None, :].repeat(ns, 0), off, ~real), axis=-1)
    by_file = np.lexsort((pos[None, :].repeat(ns, 0), off, fid, ~real), axis=-1)

    lo, hi, walks_off = _walker_masks(lens)
    nw = lo.shape[0]
    stream = np.arange(ns)[None, :]
    suffix = walks_off[:, None]
    has = np.zeros((nw, ns), dtype=bool)
    pend = np.zeros((nw, ns), dtype=np.uint64)
    pf = np.zeros((nw, ns), dtype=np.int64)
    seeks = np.zeros((nw, ns), dtype=np.int64)
    new_files = np.zeros((nw, ns), dtype=np.int64)
    rf = np.zeros((nw, ns), dtype=np.int64)
    dist = np.zeros((nw, ns), dtype=np.float64)
    nb = np.zeros((nw, ns), dtype=np.float64)
    for t in range(stream_len):
        i = np.where(suffix, by_off[None, :, t], by_file[None, :, t])
        m = (t < lens)[None, :] & (i >= lo) & (i < hi)
        o, f, z = off[stream, i], fid[stream, i], siz[stream, i]
        same = has & (suffix | (f == pf))
        contig = same & (o.view(np.uint64) == pend)
        seeks += m & ~contig
        new_files += m & ~same
        r = (o.view(np.uint64) - pend).view(np.int64)
        pair = m & has & suffix
        rf += pair & (r != 0)
        dist = np.where(pair, dist + np.abs(r).astype(np.float64), dist)
        nb = np.where(m & suffix, nb + z.astype(np.float64), nb)
        has = has | m
        pf = np.where(m, f, pf)
        pend = np.where(m, o.view(np.uint64) + z.view(np.uint64), pend)

    ns_suf = SUFFIX_ANCHORS - 1
    out = np.zeros((len(COLUMNS), ns), dtype=np.float64)
    out[COLUMNS.index("ssd_w")] = _ssd_walls(siz, lens, link_bw, write_bw)
    # the host's term order: rf * seek_time + dist * coeff + nb / seq_bw
    hddt_at = COLUMNS.index("hddt_1")
    out[hddt_at:hddt_at + ns_suf] = (rf[:ns_suf].astype(np.float64) * seek_time
                                     + dist[:ns_suf] * seek_dist_coeff
                                     + nb[:ns_suf] / seq_bw)
    pf_at = COLUMNS.index("pf_1")
    wf_at, wn_at = COLUMNS.index("wf_0"), COLUMNS.index("wn_0")
    out[pf_at:wf_at] = seeks[ns_suf:ns_suf + SUFFIX_ANCHORS]
    out[wf_at:wn_at] = seeks[ns_suf + SUFFIX_ANCHORS:]
    out[wn_at:wn_at + N_WINDOWS] = new_files[ns_suf + SUFFIX_ANCHORS:]

    run = (index[:, :1] + by_file)[real]  # each stream's sorted run, in stream order
    order = _merge_rounds(run, offsets, file_ids, stream_len)
    a, b = order[:-1], order[1:]
    contig = (file_ids[a] == file_ids[b]) & (
        offsets[b].view(np.uint64) == offsets[a].view(np.uint64) + sizes[a].view(np.uint64))
    sa, sb = a // stream_len, b // stream_len
    d = np.abs(sa - sb)
    later = np.maximum(sa, sb)
    xm_at = COLUMNS.index("xm_1")
    for k in range(1, XMERGE_D + 1):
        out[xm_at + k - 1] = np.bincount(later[contig & (d == k)], minlength=ns)
    return out
