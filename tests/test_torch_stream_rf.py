"""The port's stream scoring (``repro_torch.kernels.stream_rf``) against
the reference.

On the CPU the wrappers run the kernel's plain torch version; the CUDA
kernel itself is held against the same version on the card by
``chip_smoke.py``.  Everything is bit-exact against the int64 NumPy
oracle ``repro.core.random_factor.stream_stats_batch_np``: ties of equal
offsets with differing sizes break by arrival order, and offsets up to
2^62 wrap exactly as NumPy's do.  The Pallas kernel sorts with an
unstable network and sums the distance in float32, so it is compared only
where it is exact: tie-free rows, offsets below 2^31, distance sums below
2^24 (tolerance 0 there).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro.core.random_factor import stream_stats_batch_np
from repro.kernels.stream_rf import ops as pallas_ops
from repro.kernels.stream_rf.ref import threshold_quantile_ref as jnp_quantile
from repro_torch.core.random_factor import stream_stats_batch
from repro_torch.kernels import build
from repro_torch.kernels.stream_rf import kernel, ops, ref
from repro_torch.testing import stream_rows

MS = (1, 3, 8, 37, 300)
NS = (8, 64, 128)
KINDS = ("random40", "ties", "contiguous", "reversed", "wrap62")


def _rows(kind: str, m: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "random40":
        return (rng.integers(0, 1 << 40, size=(m, n)),
                rng.integers(1, 1 << 20, size=(m, n)))
    if kind == "ties":  # duplicate offsets of differing sizes
        return (rng.integers(0, 4, size=(m, n)) * 4096,
                rng.integers(0, 3, size=(m, n)) * 4096)
    if kind == "wrap62":  # residual sums overflow int64 and wrap
        return (rng.integers(0, 1 << 62, size=(m, n)),
                rng.integers(0, 1 << 40, size=(m, n)))
    run = np.arange(n) * 65536 + rng.integers(0, 1 << 40, size=(m, 1))
    if kind == "reversed":
        run = run[:, ::-1]
    return run, np.full((m, n), 65536)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("m", MS)
def test_plain_versions_equal_numpy_oracle(m, n, kind):
    offs, szs = _rows(kind, m, n, seed=m * 1000 + n)
    rf_np, pct_np, dist_np = stream_stats_batch_np(offs, szs)

    rf, dist = ref.stream_stats_ref(_t(offs), _t(szs))
    assert np.array_equal(rf.numpy(), rf_np)
    assert np.array_equal(dist.numpy(), dist_np)
    assert np.array_equal(ref.stream_rf_ref(_t(offs), _t(szs)).numpy(), rf_np)

    rf2, pct2, dist2 = stream_stats_batch(_t(offs), _t(szs))
    assert np.array_equal(rf2.numpy(), rf_np)
    assert np.array_equal(pct2.numpy(), pct_np)
    assert np.array_equal(dist2.numpy(), dist_np)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("m", MS)
def test_ops_on_cpu_tensors_equal_numpy_oracle(m, n, kind):
    offs, szs = _rows(kind, m, n, seed=m * 7 + n)
    rf_np, pct_np, dist_np = stream_stats_batch_np(offs, szs)
    ops.reset_launches()
    rf, pct, dist = ops.stream_stats_op(_t(offs), _t(szs))
    assert rf.dtype == dist.dtype == torch.int64 and pct.dtype == torch.float64
    assert np.array_equal(rf.numpy(), rf_np)
    assert np.array_equal(pct.numpy(), pct_np)
    assert np.array_equal(dist.numpy(), dist_np)
    assert np.array_equal(ops.stream_rf_op(_t(offs), _t(szs)).numpy(), rf_np)
    assert np.array_equal(
        ops.random_percentage_op(_t(offs), _t(szs)).numpy(), pct_np)
    assert ops.launches == {"stream_stats": 0, "stream_rf": 0}


def _tie_free(m: int, n: int, seed: int):
    """Rows where the Pallas kernel is exact: distinct offsets below 2^17
    (so below 2^31), sizes below 4 KiB, distance sums below 2^24."""

    rng = np.random.default_rng(seed)
    offs = np.stack([rng.choice(1 << 17, size=n, replace=False) for _ in range(m)])
    szs = rng.integers(0, 4096, size=(m, n))
    return offs.astype(np.int64), szs.astype(np.int64)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("m", MS)
def test_equals_pallas_kernel_where_it_is_exact(m, n):
    offs, szs = _tie_free(m, n, seed=m + 31 * n)
    rf_pl, pct_pl, dist_pl = pallas_ops.stream_stats_op(
        offs.astype(np.int32), szs.astype(np.int32), interpret=True)
    rf, pct, dist = ops.stream_stats_op(_t(offs), _t(szs))
    assert float(np.max(np.asarray(dist_pl))) < 2 ** 24
    assert np.array_equal(rf.numpy(), np.asarray(rf_pl, dtype=np.int64))
    assert np.array_equal(dist.numpy(), np.asarray(dist_pl).astype(np.int64))
    # the Pallas percentage is float32; the port's float64 rounds to it
    assert np.array_equal(pct.numpy().astype(np.float32), np.asarray(pct_pl))
    rf_only = pallas_ops.stream_rf_op(offs.astype(np.int32),
                                      szs.astype(np.int32), interpret=True)
    assert np.array_equal(ops.stream_rf_op(_t(offs), _t(szs)).numpy(),
                          np.asarray(rf_only, dtype=np.int64))


def test_sizes_broadcast_like_the_oracle():
    offs, _ = _rows("random40", 5, 64, seed=3)
    rf_np, _, dist_np = stream_stats_batch_np(offs, 65536)
    rf, _, dist = ops.stream_stats_op(_t(offs), torch.tensor(65536))
    assert np.array_equal(rf.numpy(), rf_np)
    assert np.array_equal(dist.numpy(), dist_np)


@pytest.mark.parametrize("offsets,sizes,exc", [
    (torch.zeros(4, 8, dtype=torch.int32), torch.zeros(4, 8, dtype=torch.int64), TypeError),
    (torch.zeros(4, 8, dtype=torch.int64), torch.zeros(4, 8, dtype=torch.int32), TypeError),
    (torch.zeros(8, 4, dtype=torch.int64).t(), torch.zeros(4, 8, dtype=torch.int64), ValueError),
    (torch.zeros(2, ops.MAX_STREAM_LEN + 1, dtype=torch.int64),
     torch.zeros(2, ops.MAX_STREAM_LEN + 1, dtype=torch.int64), ValueError),
    (torch.zeros(2, 2 * ops.MAX_STREAM_LEN, dtype=torch.int64),
     torch.zeros(2, 2 * ops.MAX_STREAM_LEN, dtype=torch.int64), ValueError),
    (torch.zeros(4, 1, dtype=torch.int64), torch.zeros(4, 1, dtype=torch.int64), ValueError),
    (torch.zeros(8, dtype=torch.int64), torch.zeros(8, dtype=torch.int64), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(offsets, sizes, exc):
    with pytest.raises(exc):
        ops.stream_stats_op(offsets, sizes)


def test_above_the_limit_the_error_names_it_and_the_numpy_backend():
    n = ops.MAX_STREAM_LEN + 1
    with pytest.raises(ValueError, match=f"{ops.MAX_STREAM_LEN}.*score_backend=\"numpy\""):
        ops.stream_stats_op(torch.zeros(1, n, dtype=torch.int64),
                            torch.zeros(1, n, dtype=torch.int64))


ANY_NS = (2, 3, 17, 96, 1000, 1024, 2048, 3000)


@pytest.mark.parametrize("kind", stream_rows.KINDS)
@pytest.mark.parametrize("n", ANY_NS)
def test_any_width_and_true_lengths_equal_numpy_oracle(n, kind):
    """Every width up to the limit, and rows scored on a shorter true length
    (positions past it inert, INT64_MAX rows included): bit-equal to the
    NumPy oracle on each row's real requests (tolerance 0)."""

    rng = np.random.default_rng(n * 13 + stream_rows.KINDS.index(kind))
    m = 9
    offs, szs = stream_rows.stream_rows(kind, m, n, rng)
    rf_np, pct_np, dist_np = stream_stats_batch_np(offs, szs)
    rf, pct, dist = ops.stream_stats_op(_t(offs), _t(szs))
    assert np.array_equal(rf.numpy(), rf_np) and np.array_equal(dist.numpy(), dist_np)
    assert np.array_equal(pct.numpy(), pct_np)

    lens = rng.integers(0, n + 1, size=m)
    lens[:3] = (0, 1, n)
    want = [stream_stats_batch_np(offs[i:i + 1, :k], szs[i:i + 1, :k]) for i, k in enumerate(lens)]
    rf, pct, dist = ops.stream_stats_op(_t(offs), _t(szs), torch.from_numpy(lens))
    assert np.array_equal(rf.numpy(), [w[0][0] for w in want])
    assert np.array_equal(dist.numpy(), [w[2][0] for w in want])
    assert np.array_equal(pct.numpy(), [w[1][0] if k > 1 else 0.0 for w, k in zip(want, lens)])


def test_unaligned_inputs_are_copied_for_the_kernel():
    """The kernel reads rows in 16-byte chunks; a view 8 bytes off gets an
    aligned copy, an aligned tensor goes as it is."""

    flat = torch.arange(4 * 8 + 1, dtype=torch.int64)
    view = flat[1:].view(4, 8)
    assert view.data_ptr() % 16 == 8
    copy = ops._aligned(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)
    aligned = torch.zeros(4, 8, dtype=torch.int64)
    assert ops._aligned(aligned) is aligned


def test_empty_matrix():
    rf, pct, dist = ops.stream_stats_op(torch.zeros(0, 128, dtype=torch.int64),
                                        torch.zeros(0, 128, dtype=torch.int64))
    assert rf.shape == pct.shape == dist.shape == (0,)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without a CUDA compiler the build raises; it never falls back."""

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()


def test_kernel_source_names_what_it_replaces():
    src = kernel.SOURCE.read_text()
    assert "kernel.py" in src and "stream_stats" in src and "stream_rf" in src
    assert 'extern "C" int stream_stats_launch' in src


def _variants_module():
    spec = importlib.util.spec_from_file_location(
        "chip_stream_variants", pathlib.Path(__file__).resolve().parents[1]
        / "chip_stream_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


VARIANTS = ("as_is", "k8", "k32", "u64", "u64_k8", "nosort", "nocheck", "local", "norelay",
            "noshfl", "nobar")


@pytest.mark.parametrize("name", VARIANTS)
def test_timing_variants_apply_to_todays_source(name):
    """``chip_stream_variants.py`` makes each variant by editing the text of
    ``stream_rf.cu``; every edit must still fit the source (a variant that
    no longer does raises ``SystemExit`` there, on the card)."""

    mod = _variants_module()
    assert set(mod.VARIANTS) == set(VARIANTS)
    text = mod.variant_source(mod.VARIANTS[name])
    assert (text == kernel.SOURCE.read_text()) == (name == "as_is")
    for flag in mod.VARIANTS[name].split():
        if not flag.startswith(("K", "U64")):
            assert f"#define {flag}\n" in text


@pytest.mark.parametrize("w", [1, 7, 64])
def test_threshold_quantile_equals_reference(w):
    rng = np.random.default_rng(w)
    pct = rng.random((16, w))
    avg = rng.random(16)
    want = np.asarray(jnp_quantile(pct.astype(np.float32), avg.astype(np.float32)))
    got = ref.threshold_quantile_ref(torch.from_numpy(pct).float(),
                                     torch.from_numpy(avg).float())
    assert np.array_equal(got.numpy(), want)


# -- the CUDA kernel's algorithm, emulated in NumPy -----------------------

U64 = np.uint64
SIGN = U64(1 << 63)


def _kernel_layout(n: int) -> tuple[int, int]:
    """``(log2 W, log2 K)`` as ``stream_stats_launch`` dispatches them: W the
    next power of two at or above N, K positions per thread (W up to 8, then
    8 up to W = 256, 16 at 512 and 32 at 1024)."""

    log_w = max(n - 1, 1).bit_length()
    return log_w, {512: 4, 1024: 5}.get(1 << log_w, min(log_w, 3))


def _network(log_w: int):
    """The comparator stages of the one-way bitonic sort: ``(m, lower)``
    per stage, partner ``i ^ m``, ``lower[i]`` keeps the smaller key."""

    i = np.arange(1 << log_w)
    for lk in range(1, log_w + 1):
        for lj in range(lk - 1, -1, -1):
            m = (1 << lk) - 1 if lj == lk - 1 else 1 << lj
            yield i ^ m, i < (i ^ m)


FIX_ROUNDS = 2  # kFixRounds in csrc/stream_rf.cu


def _before(ao, ai, bo, bi):
    return (ao < bo) | ((ao == bo) & (ai < bi))


def _wide_network(o: np.ndarray, ix: np.ndarray, log_w: int):
    """The exact branch: the network on (offset, index) keys."""

    for partner, lower in _network(log_w):
        po, pi = o[:, partner], ix[:, partner]
        take = lower == _before(po, pi, o, ix)
        o, ix = np.where(take, po, o), np.where(take, pi, ix)
    return o, ix


def _transposition_round(o: np.ndarray, ix: np.ndarray):
    """Positions (p, p + 1) swap when out of order: even p, then odd p."""

    for first in (0, 1):
        a = np.arange(first, o.shape[1] - 1, 2)
        swap = _before(o[:, a + 1], ix[:, a + 1], o[:, a], ix[:, a])
        for arr in (o, ix):
            lo, hi = arr[:, a].copy(), arr[:, a + 1].copy()
            arr[:, a], arr[:, a + 1] = np.where(swap, hi, lo), np.where(swap, lo, hi)


INT64_MAX = np.iinfo(np.int64).max


def _emulate_kernel(offs: np.ndarray, szs: np.ndarray, lens=None):
    """rf, dist and whether each row's warp kept the fast branch, as the
    kernel computes them: rows of N at the next power-of-two width W, with
    positions from the row's true length L (``lens``, else N) on inert;
    sentinel rows of zeros up to a whole warp; the 32-bit key
    ((off - min) >> shift << log2 W) | index with the shift that makes it
    fit, min and max over real positions only, and every bucket bit set for
    inert ones; the network on positions ``t * K + r`` loaded with element
    ``r * T + t``; offsets read back by index (INT64_MAX for an inert index);
    up to ``FIX_ROUNDS`` rounds of odd-even transposition while any row of
    the warp is out of order, then the exact network for that warp; the
    count and distance over sorted positions below L - 1."""

    m, n = offs.shape
    log_w, log_k = _kernel_layout(n)
    w = 1 << log_w
    k = 1 << log_k
    t_per_row = w // k
    g = 32 // t_per_row
    rows = -(-m // g) * g
    o = np.zeros((rows, w), np.int64)
    s = np.zeros((rows, w), np.int64)
    o[:m, :n], s[:m, :n] = offs, szs
    length = np.full(rows, n)
    if lens is not None:
        length[:m] = np.clip(lens, 0, n)
    pos = np.arange(w)
    inert = pos[None, :] >= length[:, None]
    lo = np.where(inert, INT64_MAX, o).min(1, keepdims=True)
    hi = np.where(inert, np.iinfo(np.int64).min, o).max(1, keepdims=True)
    span = (hi.view(U64) - lo.view(U64))[:, 0]
    width = np.array([int(x).bit_length() for x in span])
    shift = np.maximum(width - (32 - log_w), 0).astype(U64)[:, None]

    elem = np.broadcast_to((pos % k) * t_per_row + pos // k, (rows, w))
    rel = np.take_along_axis(o, elem, 1).view(U64) - lo.view(U64)
    key = (((rel >> shift) << U64(log_w)) | elem.astype(U64))
    key = np.where(np.take_along_axis(inert, elem, 1),
                   (U64(0xFFFFFFFF) << U64(log_w)) & U64(0xFFFFFFFF) | elem.astype(U64), key)
    assert np.all(key < U64(1 << 32))
    key = key.astype(np.uint32)
    for partner, lower in _network(log_w):
        a, b = key, key[:, partner]
        key = np.where(lower, np.minimum(a, b), np.maximum(a, b))
    ix = (key & np.uint32(w - 1)).astype(np.int64)
    o_exact = np.where(inert, INT64_MAX, o)  # the exact key of each element
    off = np.take_along_axis(o_exact, ix, 1)
    for rnd in range(FIX_ROUNDS + 1):
        ordered = _before(off[:, :-1], ix[:, :-1], off[:, 1:], ix[:, 1:]).all(1)
        warp_ok = ordered.reshape(-1, g).all(1).repeat(g)
        if rnd == FIX_ROUNDS or warp_ok.all():
            break
        _transposition_round(off, ix)  # a no-op on rows already in order
    fast = warp_ok
    w_off, w_ix = _wide_network(np.take_along_axis(o_exact, elem, 1), elem.copy(), log_w)
    off = np.where(fast[:, None], off, w_off)
    ix = np.where(fast[:, None], ix, w_ix)
    rf, dist = _residual_sums(off, ix, s, length)
    return rf[:m], dist[:m], fast[:m]


def _residual_sums(off, ix, s, length):
    """Eq. 1 count and Eq. 6 distance over sorted positions below L - 1,
    in unsigned 64-bit arithmetic as the kernel sums them."""

    size = np.take_along_axis(s, ix, 1).view(U64)
    d = off.view(U64)[:, 1:] - off.view(U64)[:, :-1] - size[:, :-1]
    d = np.where(np.arange(d.shape[1])[None, :] < (length - 1)[:, None], d, U64(0))
    rf = (d != 0).sum(1).astype(np.int64)
    dist = np.where(d.view(np.int64) < 0, U64(0) - d, d).sum(1, dtype=U64).view(np.int64)
    return rf, dist


LONG_LOG_K = 4  # long_log_k in csrc/stream_rf.cu: K = 16 positions a thread
LONG_K = 1 << LONG_LOG_K
WARP_LOG = LONG_LOG_K + 5  # log2 of the positions a warp holds


def _merge_bit(j: int) -> int:
    """``merge_bit``: the bit of x = t * K + r that holds bit lk - 1 - j of
    merge lk's coordinate (registers first, then lanes)."""

    return LONG_LOG_K - 1 - j if j < LONG_LOG_K else 2 * LONG_LOG_K + 4 - j


def _merge_position(lk: int, x: np.ndarray) -> np.ndarray:
    """``merge_position``: the position register r of thread t holds
    (x = t * K + r) while merge lk runs its cross-warp stages."""

    c = x.copy()
    for j in range(lk - WARP_LOG):
        hi, lo = lk - 1 - j, _merge_bit(j)
        differ = ((x >> hi) ^ (x >> lo)) & 1
        c ^= (differ << hi) | (differ << lo)
    return np.where((x >> (LONG_LOG_K - 1)) & 1, c ^ ((1 << (lk - 1)) - 1), c)


def _slot(p: np.ndarray) -> np.ndarray:
    """``slot``: the shared-memory word that parks position p."""

    return p ^ ((p >> LONG_LOG_K) & 31)


def _long_network(keys: tuple, log_w: int, less) -> tuple:
    """``long_sort``: the one-way network on keys held at x = t * K + r
    (``keys``: arrays ``(rows, W)``, ``less(a, b)`` their order).  Merges up
    to a warp's positions, and every merge's stages of smaller stride, in
    the plain layout (position x); the next merge's one cross-warp stage,
    its mirror, reads each partner's parked slot; wider merges re-lay the
    row through parked slots into the merge layout first, run their
    cross-warp strides there (register or lane pairs, the smaller key kept
    where the coordinate bit equals the mirror bit, or is 0 for the mirror
    stage) and lay it back."""

    x = np.arange(1 << log_w)

    def exchange(keys, theirs, lower):
        take = lower == less(theirs, keys)
        return tuple(np.where(take, b, a) for a, b in zip(keys, theirs))

    def parked(keys, at):
        out = [np.empty_like(k) for k in keys]
        for k, o in zip(keys, out):
            o[:, _slot(at)] = k
        return out

    for lk in range(1, log_w + 1):
        top = lk - 1
        if lk == WARP_LOG + 1:
            m = (1 << lk) - 1
            theirs = tuple(b[:, _slot(x ^ m)] for b in parked(keys, x))
            keys = exchange(keys, theirs, ((x >> (lk - 1)) & 1) == 0)
            top = WARP_LOG - 1
        elif lk > WARP_LOG:
            pos = _merge_position(lk, x)
            keys = tuple(b[:, _slot(pos)] for b in parked(keys, x))
            for j in range(lk - WARP_LOG):
                s = _merge_bit(j)
                cq = (x >> s) & 1
                lower = cq == (0 if j == 0 else (x >> (LONG_LOG_K - 1)) & 1)
                keys = exchange(keys, tuple(k[:, x ^ (1 << s)] for k in keys), lower)
            keys = tuple(b[:, _slot(x)] for b in parked(keys, pos))
            top = WARP_LOG - 1
        for lj in range(top, -1, -1):
            m = (1 << lk) - 1 if lj == lk - 1 else 1 << lj
            keys = exchange(keys, tuple(k[:, x ^ m] for k in keys), x < (x ^ m))
    return keys


def _textbook_network(o: np.ndarray, ix: np.ndarray, log_w: int):
    """The long-row kernel's exact branch: (offset, index) pairs sorted in
    place by the textbook bitonic network, pair (a, a | j) with a's bit j
    clear, ascending where a's bit k is clear."""

    pos = np.arange(1 << log_w)
    k = 2
    while k <= 1 << log_w:
        j = k >> 1
        while j:
            a = pos[(pos & j) == 0]
            b = a | j
            swap = _before(o[:, b], ix[:, b], o[:, a], ix[:, a]) == ((a & k) == 0)
            for arr in (o, ix):
                lo, hi = arr[:, a].copy(), arr[:, b].copy()
                arr[:, a], arr[:, b] = np.where(swap, hi, lo), np.where(swap, lo, hi)
            j >>= 1
        k <<= 1
    return o, ix


def _emulate_long_rows(offs: np.ndarray, szs: np.ndarray, lens=None):
    """rf, dist and whether each row took the exact branch, as the long-row
    kernel (N > 1024) computes them: one row a block of T = W / K threads at
    the next power-of-two width W; min and max over real elements (index
    below the true length L); element ``r * T + t`` at position
    ``t * K + r``; the 32-bit key ((off - min) >> shift << log2 W) | index
    with the shift that makes it fit, every bucket bit set for inert
    elements; the network of ``_long_network``; offsets read back by index
    (INT64_MAX for an inert one); up to ``FIX_ROUNDS`` rounds of odd-even
    transposition while the row is out of (offset, index) order, then the
    exact branch: ``_textbook_network`` on (offset, index) pairs, inert
    elements at INT64_MAX.  The count and distance run over sorted
    positions below L - 1."""

    m, n = offs.shape
    log_w = (n - 1).bit_length()
    w = 1 << log_w
    t_per_row = w // LONG_K
    length = np.full(m, n) if lens is None else np.clip(lens, 0, n)
    o = np.zeros((m, w), np.int64)
    s = np.zeros((m, w), np.int64)
    o[:, :n], s[:, :n] = offs, szs
    pos = np.arange(w)
    elem = np.broadcast_to((pos % LONG_K) * t_per_row + pos // LONG_K, (m, w))
    inert = elem >= length[:, None]
    held = np.take_along_axis(o, elem, 1)
    lo = np.where(inert, INT64_MAX, held).min(1, keepdims=True)
    hi = np.where(inert, np.iinfo(np.int64).min, held).max(1, keepdims=True)
    width = np.array([int(x).bit_length() for x in (hi.view(U64) - lo.view(U64))[:, 0]])
    shift = np.maximum(width - (32 - log_w), 0).astype(U64)[:, None]

    rel = held.view(U64) - lo.view(U64)
    bucket = np.where(inert, U64(0xFFFFFFFF >> log_w), rel >> shift)
    key = (bucket << U64(log_w) | elem.astype(U64)).astype(np.uint32)
    (key,) = _long_network((key,), log_w, lambda a, b: a[0] < b[0])
    ix = (key & np.uint32(w - 1)).astype(np.int64)
    o_exact = np.where(pos[None, :] >= length[:, None], INT64_MAX, o)
    off = np.take_along_axis(o_exact, ix, 1)
    for rnd in range(FIX_ROUNDS + 1):
        ordered = _before(off[:, :-1], ix[:, :-1], off[:, 1:], ix[:, 1:]).all(1)
        if rnd == FIX_ROUNDS or ordered.all():
            break
        _transposition_round(off, ix)  # a no-op on rows already in order
    exact = ~ordered
    w_off, w_ix = _textbook_network(o_exact.copy(), np.broadcast_to(pos, (m, w)).copy(), log_w)
    off = np.where(exact[:, None], w_off, off)
    ix = np.where(exact[:, None], w_ix, ix)
    rf, dist = _residual_sums(off, ix, s, length)
    return rf, dist, exact


EMU_NS = (2, 3, 4, 8, 16, 17, 32, 64, 96, 128, 256, 512, 1000, 1024)


@pytest.mark.parametrize("kind", stream_rows.KINDS)
@pytest.mark.parametrize("n", EMU_NS)
def test_kernel_algorithm_emulated_equals_numpy_oracle(n, kind):
    rng = np.random.default_rng(n * 31 + stream_rows.KINDS.index(kind))
    m = 37  # not a whole warp of rows at any N: sentinel rows are sorted too
    offs, szs = stream_rows.stream_rows(kind, m, n, rng)
    rf, dist, fast = _emulate_kernel(offs, szs)
    rf_np, _, dist_np = stream_stats_batch_np(offs, szs)
    assert np.array_equal(rf, rf_np)
    assert np.array_equal(dist, dist_np)
    # the same rows on random true lengths: positions past them are inert
    lens = rng.integers(0, n + 1, size=m)
    lens[:2] = (0, 1)
    rf_l, dist_l, _ = _emulate_kernel(offs, szs, lens)
    want = [stream_stats_batch_np(offs[i:i + 1, :k], szs[i:i + 1, :k]) for i, k in enumerate(lens)]
    assert np.array_equal(rf_l, [x[0][0] for x in want])
    assert np.array_equal(dist_l, [x[2][0] for x in want])
    if kind in ("ties", "contiguous", "reversed", "near-min", "near-max", "collide"):
        # spans that need no shift, runs wider than a bucket, or pairs that
        # one transposition round puts right
        assert fast.all()
    if kind == "outlier" and n >= 16:
        # a reversed run in one bucket: more than FIX_ROUNDS rounds to repair
        assert not fast.any()
    if kind == "mixed" and n >= 16:
        assert not fast.all()
    if kind == "mixed" and n >= 128:  # warps of 4 rows or fewer: some keep the fast branch
        assert fast.any()


@pytest.mark.parametrize("kind", stream_rows.KINDS)
@pytest.mark.parametrize("n", (1025, 2048, 3000, 4096, 8192))
def test_long_row_kernel_emulated_equals_numpy_oracle(n, kind):
    rng = np.random.default_rng(n * 17 + stream_rows.KINDS.index(kind))
    m = 3
    offs, szs = stream_rows.stream_rows(kind, m, n, rng)
    rf, dist, exact = _emulate_long_rows(offs, szs)
    rf_np, _, dist_np = stream_stats_batch_np(offs, szs)
    assert np.array_equal(rf, rf_np) and np.array_equal(dist, dist_np)
    lens = np.array([0, 1 + n // 3, n - 1])
    rf_l, dist_l, exact_l = _emulate_long_rows(offs, szs, lens)
    want = [stream_stats_batch_np(offs[i:i + 1, :k], szs[i:i + 1, :k]) for i, k in enumerate(lens)]
    assert np.array_equal(rf_l, [x[0][0] for x in want])
    assert np.array_equal(dist_l, [x[2][0] for x in want])
    # the branch each row takes: the exact one where a shared bucket left
    # the row too far out of order for FIX_ROUNDS rounds to repair (a
    # reversed run beside one far offset), the bucket key with or without
    # repairs elsewhere
    if kind == "outlier":
        assert exact.all()
    if kind == "mixed":  # its outlier rows
        extreme = (offs == stream_rows.INT64_MIN) | (offs == stream_rows.INT64_MAX)
        assert exact[extreme.any(1)].all()
    if kind in ("ties", "contiguous", "reversed", "near-min", "near-max"):
        # spans that need no shift, or runs wider than a bucket
        assert not exact.any() and not exact_l.any()
    assert not exact_l[0]  # a row of no requests
    assert np.array_equal(exact, stream_rows.long_row_exact(offs, fix_rounds=FIX_ROUNDS))
    assert np.array_equal(exact_l, stream_rows.long_row_exact(offs, lens, FIX_ROUNDS))
