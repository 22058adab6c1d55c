"""Rows of (offsets, sizes) that the stream kernels are held on.

Each kind stresses one part of ``kernels/stream_rf``: ties of differing
sizes (the arrival-order tiebreak), runs and reversed runs, offsets whose
residual sums wrap int64, negative offsets, rows near ``INT64_MIN`` or
``INT64_MAX`` and the whole int64 range.  The kernel sorts a 32-bit key
that drops the low bits of wide spans: ``collide`` rows put pairs of
offsets in one such bucket out of order, which the kernel repairs in
place, ``outlier`` rows (a tight reversed run and one far offset) defeat
it and take the kernel's exact wide branch, and ``mixed`` matrices put
such rows beside ordinary ones in one launch.  Above 1024 requests the
long-row kernel runs the same algorithm over a block of threads;
:func:`long_row_exact` says which rows take its exact branch.  The CPU
tests, the card tests and ``chip_smoke.py`` draw from the same kinds.
"""

from __future__ import annotations

import numpy as np

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1

KINDS = ("random40", "ties", "contiguous", "reversed", "wrap62", "negative",
         "near-min", "near-max", "full-range", "collide", "outlier", "mixed")


def stream_rows(kind: str, m: int, n: int,
                rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """``(offsets, sizes)``, both ``(m, n)`` int64, of one kind."""

    def ints(lo: int, hi: int, shape=(m, n)) -> np.ndarray:
        return rng.integers(lo, hi, size=shape, dtype=np.int64, endpoint=True)

    if kind == "random40":
        return ints(0, (1 << 40) - 1), ints(1, (1 << 20) - 1)
    if kind == "ties":  # duplicate offsets of differing sizes
        return ints(0, 3) * 4096, ints(0, 2) * 4096
    if kind in ("contiguous", "reversed"):
        run = np.arange(n, dtype=np.int64) * 65536 + ints(0, (1 << 40) - 1, (m, 1))
        if kind == "reversed":
            run = run[:, ::-1]
        return np.ascontiguousarray(run), np.full((m, n), 65536, dtype=np.int64)
    if kind == "wrap62":  # residual sums overflow int64 and wrap
        return ints(0, (1 << 62) - 1), ints(0, (1 << 40) - 1)
    if kind == "negative":  # packed spans around zero
        return ints(-(1 << 40), (1 << 40) - 1), ints(0, (1 << 20) - 1)
    if kind == "near-min":  # packed spans at the bottom, ties on INT64_MIN
        offs = INT64_MIN + ints(0, 64) * 4096
        return offs, ints(0, 2) * 4096
    if kind == "near-max":  # packed spans at the top, ties on INT64_MAX
        offs = INT64_MAX - ints(0, 64) * 4096
        return offs, ints(0, 2) * 4096
    if kind == "full-range":  # both extremes in every row
        offs = ints(INT64_MIN, INT64_MAX)
        offs[:, 0], offs[:, -1] = INT64_MAX, INT64_MIN
        return offs, ints(INT64_MIN, INT64_MAX)
    if kind == "collide":  # every odd element 1 byte below the even one before it
        offs, szs = stream_rows("random40", m, n, rng)
        offs[:, 1::2] = offs[:, 0:n - 1:2] - 1
        return offs, szs
    if kind == "outlier":  # a reversed 4 KiB run beside one far offset
        offs = np.arange(n - 1, -1, -1, dtype=np.int64) * 4096 + ints(0, 1 << 30, (m, 1))
        offs[:, n // 2] = np.where(rng.random(m) < 0.5, INT64_MIN, INT64_MAX)
        return offs, ints(0, 2) * 4096
    if kind == "mixed":  # rows of the fast and of the wide branch in one matrix
        offs, szs = stream_rows("random40", m, n, rng)
        wide_o, wide_s = stream_rows("outlier", m, n, rng)
        pick = rng.random(m) < 0.1
        offs[pick], szs[pick] = wide_o[pick], wide_s[pick]
        return offs, szs
    raise ValueError(f"unknown row kind {kind!r}")


def long_row_exact(offs: np.ndarray, lens: np.ndarray | None = None,
                   fix_rounds: int = 2) -> np.ndarray:
    """Which rows of an ``(m, n)`` matrix, 1024 < n <= 8192, the long-row
    kernel scores by its exact branch.  It sorts each row by the 32-bit key
    ((off - min) >> shift << log2 W) | index at the next power-of-two width
    W (every bucket bit set past the true length ``lens[i]``), reads the
    offsets back by index, and puts pairs that a shared bucket left out of
    (offset, index) order right by up to ``fix_rounds`` rounds of odd-even
    transposition (kFixRounds); rows still out of order take the exact
    branch.  Keys are unique, so any sorting network gives this order."""

    m, n = offs.shape
    log_w = (n - 1).bit_length()
    w = 1 << log_w
    length = np.full(m, n) if lens is None else np.clip(lens, 0, n)
    o = np.zeros((m, w), np.int64)
    o[:, :n] = offs
    inert = np.arange(w)[None, :] >= length[:, None]
    lo = np.where(inert, INT64_MAX, o).min(1, keepdims=True)
    hi = np.where(inert, INT64_MIN, o).max(1, keepdims=True)
    span = (hi.view(np.uint64) - lo.view(np.uint64))[:, 0]
    width = np.array([int(x).bit_length() for x in span])
    shift = np.maximum(width - (32 - log_w), 0).astype(np.uint64)[:, None]
    index = np.arange(w, dtype=np.uint64)[None, :]
    bucket = (o.view(np.uint64) - lo.view(np.uint64)) >> shift
    key = np.where(inert, np.uint64(0xFFFFFFFF >> log_w), bucket) << np.uint64(log_w) | index
    ix = (np.sort(key, 1) & np.uint64(w - 1)).astype(np.int64)
    off = np.take_along_axis(np.where(inert, INT64_MAX, o), ix, 1)
    for _ in range(fix_rounds):
        for first in (0, 1):  # (p, p + 1) for even p, then odd p
            a = np.arange(first, w - 1, 2)
            swap = _before(off[:, a + 1], ix[:, a + 1], off[:, a], ix[:, a])
            for arr in (off, ix):
                lo_, hi_ = arr[:, a].copy(), arr[:, a + 1].copy()
                arr[:, a], arr[:, a + 1] = np.where(swap, hi_, lo_), np.where(swap, lo_, hi_)
    return ~_before(off[:, :-1], ix[:, :-1], off[:, 1:], ix[:, 1:]).all(1)


def _before(ao, ai, bo, bi):
    return (ao < bo) | ((ao == bo) & (ai < bi))
