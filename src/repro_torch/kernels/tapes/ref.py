"""Plain NumPy version of the ``tapes`` kernel: the host tape builder's
per-stream columns, as the reference computes them
(``repro.core.engine_device.build_events``).

The SSD walls are an ``add.reduceat``; each anchor is a lexsort of the
shard and, for each of its 47 masks, a pass of masked predecessors and a
bincount.  The CUDA kernel (``csrc/tapes.cu``) computes the same columns
another way (sorted runs a stream, one walker a mask, merge rounds of the
shard's order), bit for bit.
"""

from __future__ import annotations

import numpy as np

from ..replay.ref import N_WINDOWS, SUFFIX_ANCHORS, WINDOW_SCALES, XMERGE_D

INPUTS = ("offsets", "sizes", "file_ids")
#: The tape columns the kernel writes, a row of ``(streams,)`` each.
COLUMNS = (
    "ssd_w",
    *(f"hddt_{j}" for j in range(1, SUFFIX_ANCHORS)),
    *(f"pf_{j}" for j in range(1, SUFFIX_ANCHORS + 1)),
    *(f"wf_{i}" for i in range(N_WINDOWS)),
    *(f"wn_{i}" for i in range(N_WINDOWS)),
    *(f"xm_{d}" for d in range(1, XMERGE_D + 1)),
)
#: The constants the columns take: the HDD model's, the ingest link's and
#: the SSD's bandwidths.
CONSTS = ("seek_time", "seek_dist_coeff", "seq_bw", "link_bw", "write_bw")


def _streams(bounds: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each request's stream and position in it, and the streams' lengths."""

    lens = np.diff(bounds)
    sid = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    pos_in = np.arange(bounds[-1], dtype=np.int64) - np.repeat(bounds[:-1], lens)
    return sid, pos_in, lens


def _cross_stream_merges(off, siz, fid, bounds: np.ndarray) -> np.ndarray:
    """Per-stream cross-merge counts ``(ns, XMERGE_D)``: ``out[j, d-1]`` =
    contiguous pairs stream ``j`` forms with stream ``j - d`` in the global
    per-file offset sort (each pair assigned to the later stream)."""

    ns = len(bounds) - 1
    out = np.zeros((ns, XMERGE_D), dtype=np.float64)
    if len(off) < 2:
        return out
    sid, _, _ = _streams(bounds)
    order = np.lexsort((off, fid))
    so, ss, sf, ssid = off[order], siz[order], fid[order], sid[order]
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


def _by_file(off, siz, fid, bounds: np.ndarray):
    """Each stream's requests sorted by (file, offset), stream after
    stream: offsets, sizes, file ids, streams and positions in that order,
    and the streams' lengths."""

    sid, pos_in, lens = _streams(bounds)
    order = np.lexsort((off, fid, sid))
    return off[order], siz[order], fid[order], sid[order], pos_in[order], lens


def _seeks(m, so, ss, sf, sdi, ns: int) -> tuple[np.ndarray, np.ndarray]:
    """Eq. 6 seek counts and new-file counts a stream of the masked subset
    ``m`` of the (stream, file, offset) order."""

    prev = _masked_predecessors(m)
    pc = np.maximum(prev, 0)
    same = m & (prev >= 0) & (sdi[pc] == sdi) & (sf[pc] == sf)
    contig = same & (so == so[pc] + ss[pc])
    return (np.bincount(sdi[m & ~contig], minlength=ns),
            np.bincount(sdi[m & ~same], minlength=ns))


def _window_seek_anchors(off, siz, fid, bounds: np.ndarray):
    """Eq. 6 seek anchors of dyadic arrival-windows of every stream:
    ``(wf, wn)`` of shape ``(ns, N_WINDOWS)`` — each window scored alone,
    extent count and distinct-file baseline, scale-major columns."""

    ns = len(bounds) - 1
    wf = np.zeros((ns, N_WINDOWS), dtype=np.float64)
    wn = np.zeros((ns, N_WINDOWS), dtype=np.float64)
    so, ss, sf, sdi, spos, lens = _by_file(off, siz, fid, bounds)
    slen = lens[sdi]
    col = 0
    for s in range(WINDOW_SCALES):
        w = 1 << s
        # window of position p: boundaries at round(k * len / w), i.e.
        # 2*len*k < (2p+1)*w -- integer-exact
        win = np.minimum(((2 * spos + 1) * w - 1) // np.maximum(2 * slen, 1), w - 1)
        for k in range(w):
            wf[:, col + k], wn[:, col + k] = _seeks(win == k, so, ss, sf, sdi, ns)
        col += w
    return wf, wn


def _prefix_seek_anchors(off, siz, fid, bounds: np.ndarray) -> np.ndarray:
    """``(ns, SUFFIX_ANCHORS + 1)`` Eq. 6 seek counts of every stream's
    arrival-order prefix ``[0, round(j * n / A))`` sorted alone."""

    ns = len(bounds) - 1
    out = np.zeros((ns, SUFFIX_ANCHORS + 1), dtype=np.float64)
    so, ss, sf, sdi, spos, lens = _by_file(off, siz, fid, bounds)
    for j in range(1, SUFFIX_ANCHORS + 1):
        k = np.floor(j * lens / SUFFIX_ANCHORS + 0.5).astype(np.int64)
        out[:, j] = _seeks(spos < k[sdi], so, ss, sf, sdi, ns)[0]
    return out


def _suffix_hdd_anchors(off, siz, bounds: np.ndarray, seek_time: float,
                        seek_dist_coeff: float, seq_bw: float) -> np.ndarray:
    """``(ns, SUFFIX_ANCHORS + 1)`` HDD times of every stream's suffix
    starting at request ``round(j * n / A)``, ``0 < j < A``, scored like the
    oracle's overflow path (Eq. 1 seeks + sweep distance + sequential
    time); columns 0 and ``A`` stay 0."""

    ns = len(bounds) - 1
    out = np.zeros((ns, SUFFIX_ANCHORS + 1), dtype=np.float64)
    sid, pos_in, lens = _streams(bounds)
    order = np.lexsort((off, sid))
    so, ss, sdi, spos = off[order], siz[order], sid[order], pos_in[order]
    szf = ss.astype(np.float64)
    for j in range(1, SUFFIX_ANCHORS):  # anchor 0 is the whole stream's score
        k = np.floor(j * lens / SUFFIX_ANCHORS + 0.5).astype(np.int64)
        m = spos >= k[sdi]
        prev = _masked_predecessors(m)
        pc = np.maximum(prev, 0)
        pair = m & (prev >= 0) & (sdi[pc] == sdi)
        resid = np.where(pair, so - so[pc] - ss[pc], 0)
        rf = np.bincount(sdi[pair & (resid != 0)], minlength=ns)
        dist = np.bincount(sdi, weights=np.abs(resid).astype(np.float64), minlength=ns)
        nb = np.bincount(sdi[m], weights=szf[m], minlength=ns)
        # same term order as HDDModel.write_time
        out[:, j] = rf * seek_time + dist * seek_dist_coeff + nb / seq_bw
    return out


def columns(cols: np.ndarray, stream_len: int, seek_time: float, seek_dist_coeff: float,
            seq_bw: float, link_bw: float, write_bw: float) -> np.ndarray:
    """``(len(COLUMNS), streams)`` float64 columns of the shard ``cols``
    (``(3, n)`` int64, rows :data:`INPUTS`, arrival order, ``n >= 1``)."""

    off, siz, fid = (np.asarray(c, dtype=np.int64) for c in cols)
    n = len(off)
    bounds = np.append(np.arange(0, n, stream_len, dtype=np.int64), n)
    w = np.maximum(siz / link_bw, siz / write_bw)
    ssd_w = np.add.reduceat(w, bounds[:-1])
    suffix = _suffix_hdd_anchors(off, siz, bounds, seek_time, seek_dist_coeff, seq_bw)
    wf, wn = _window_seek_anchors(off, siz, fid, bounds)
    pf = _prefix_seek_anchors(off, siz, fid, bounds)
    xm = _cross_stream_merges(off, siz, fid, bounds)
    return np.concatenate([ssd_w[None], suffix[:, 1:SUFFIX_ANCHORS].T, pf[:, 1:].T, wf.T,
                           wn.T, xm.T])
