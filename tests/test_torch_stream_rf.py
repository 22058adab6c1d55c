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

import numpy as np
import pytest
import torch

from repro.core.random_factor import stream_stats_batch_np
from repro.kernels.stream_rf import ops as pallas_ops
from repro.kernels.stream_rf.ref import threshold_quantile_ref as jnp_quantile
from repro_torch.core.random_factor import stream_stats_batch
from repro_torch.kernels.stream_rf import kernel, ops, ref

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
    (torch.zeros(4, 12, dtype=torch.int64), torch.zeros(4, 12, dtype=torch.int64), ValueError),
    (torch.zeros(4, 2048, dtype=torch.int64), torch.zeros(4, 2048, dtype=torch.int64), ValueError),
    (torch.zeros(4, 1, dtype=torch.int64), torch.zeros(4, 1, dtype=torch.int64), ValueError),
    (torch.zeros(8, dtype=torch.int64), torch.zeros(8, dtype=torch.int64), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(offsets, sizes, exc):
    with pytest.raises(exc):
        ops.stream_stats_op(offsets, sizes)


def test_empty_matrix():
    rf, pct, dist = ops.stream_stats_op(torch.zeros(0, 128, dtype=torch.int64),
                                        torch.zeros(0, 128, dtype=torch.int64))
    assert rf.shape == pct.shape == dist.shape == (0,)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without a CUDA compiler the build raises; it never falls back."""

    monkeypatch.setattr(kernel.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernel.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel._nvcc()


def test_kernel_source_names_what_it_replaces():
    src = kernel.SOURCE.read_text()
    assert "kernel.py" in src and "stream_stats" in src and "stream_rf" in src
    assert 'extern "C" int stream_stats_launch' in src


@pytest.mark.parametrize("w", [1, 7, 64])
def test_threshold_quantile_equals_reference(w):
    rng = np.random.default_rng(w)
    pct = rng.random((16, w))
    avg = rng.random(16)
    want = np.asarray(jnp_quantile(pct.astype(np.float32), avg.astype(np.float32)))
    got = ref.threshold_quantile_ref(torch.from_numpy(pct).float(),
                                     torch.from_numpy(avg).float())
    assert np.array_equal(got.numpy(), want)
