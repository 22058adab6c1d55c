"""The port's ``flash_attention`` wrappers against the reference's Pallas
kernel (interpret mode) and its jnp oracle, on the same numpy-seeded
inputs.

On the CPU the port's wrappers run the kernel's plain torch version; the
CUDA kernel itself is held against that version on the card by
``chip_smoke.py`` and by ``tests/test_torch_on_card.py``.
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.flash_attention.ops import flash_attention_bshd as jax_bshd
from repro.kernels.flash_attention.ops import flash_attention_op as jax_op
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch import tracing
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel, ops, ref

pytestmark = pytest.mark.slow  # interpret-mode Pallas runs, as tests/test_kernels.py

CASES = [  # the grid of tests/test_kernels.py
    (1, 2, 2, 128, 128, 64, True),
    (2, 4, 2, 128, 128, 64, True),   # GQA n_rep=2
    (1, 6, 1, 128, 128, 32, True),   # MQA-ish n_rep=6
    (1, 2, 2, 256, 256, 128, False),
    (1, 2, 2, 64, 192, 64, False),   # sq != sk (cross-ish)
]
HD80_CASES = [  # the head_dim of stablelm-3b and of zamba2-2.7b's shared block
    (1, 4, 4, 128, 128, 80, True),   # MHA, as both models
    (1, 4, 4, 128, 128, 80, False),
    (2, 4, 2, 128, 128, 80, True),   # GQA n_rep=2
    (1, 6, 2, 64, 192, 80, False),   # GQA n_rep=3, sq != sk
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, h, kv, sq, sk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, hd)).astype(np.float32),
            rng.normal(size=(b, kv, sk, hd)).astype(np.float32),
            rng.normal(size=(b, kv, sk, hd)).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal", CASES + HD80_CASES)
def test_vs_pallas_interpret(b, h, kv, sq, sk, hd, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, h, kv, sq, sk, hd, b * 1000 + sq + hd), dtype)
    want = jax_op(jq, jk, jv, causal=causal, block_q=64, block_k=64, interpret=True)
    got = ops.flash_attention_op(tq, tk, tv, causal=causal, block_q=64, block_k=64)
    assert got.dtype == tq.dtype and got.shape == (b, h, sq, hd)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal", CASES + HD80_CASES)
def test_vs_jnp_oracle(b, h, kv, sq, sk, hd, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, h, kv, sq, sk, hd, 7 + sq + sk), dtype)
    want = jax_ref(jq, jk, jv, causal=causal)
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_bshd_vs_pallas(causal):
    """Model layout, (B, S, H, hd), as the model's prefill calls it."""

    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 128, 4, 64)).astype(np.float32)
    k = rng.normal(size=(2, 128, 2, 64)).astype(np.float32)
    v = rng.normal(size=(2, 128, 2, 64)).astype(np.float32)
    want = jax_bshd(q, k, v, causal=causal, scale=0.125, interpret=True)
    got = ops.flash_attention_bshd(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal, scale=0.125)
    assert got.shape == q.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def _emulate_bf16_kernel(q, k, v, causal, scale):
    """The CUDA kernel's bf16 arithmetic in torch, f32 inputs holding bf16
    values: 128-row query tiles against 128-key tiles, S = Q K^T in f32 and
    then scaled by scale * log2(e), exp2, the online softmax in f32, and P
    rounded to bf16 before the P V product (l sums the unrounded P)."""

    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    k = k.repeat_interleave(h // kv, dim=1)
    v = v.repeat_interleave(h // kv, dim=1)
    neg = torch.finfo(torch.float32).min
    out = torch.empty(b, h, sq, hd)
    tile = 128
    for q0 in range(0, sq, tile):
        rows = torch.arange(q0, min(q0 + tile, sq))
        qt = q[:, :, rows]
        m = torch.full((b, h, len(rows), 1), neg)
        l = torch.zeros(b, h, len(rows), 1)
        acc = torch.zeros(b, h, len(rows), hd)
        k_end = min(sk, q0 + tile) if causal else sk
        for k0 in range(0, k_end, tile):
            keys = torch.arange(k0, min(k0 + tile, sk))
            s = (qt @ k[:, :, keys].transpose(-1, -2)) * (scale * math.log2(math.e))
            if causal:
                s = s.masked_fill(rows[:, None] < keys[None, :], neg)
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(s - mx)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.to(torch.bfloat16).float() @ v[:, :, keys]
            m = mx
        out[:, :, rows] = acc / torch.where(l == 0, 1.0, l)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("hd", [128, 80])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_kernel_rounding_fits_the_tolerance(causal, hd):
    """The tensor-core kernel's numerics (P in bf16 for P V, the scale after
    Q K^T) stay within the bf16 tolerance of the Pallas kernel: S 256, GQA,
    hd 128 and 80."""

    arrays = _inputs(2, 4, 2, 256, 256, hd, 21 + causal)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "bfloat16")
    want = jax_op(jq, jk, jv, causal=causal, block_q=128, block_k=128, interpret=True)
    got = _emulate_bf16_kernel(tq.float(), tk.float(), tv.float(), causal, 1 / math.sqrt(hd))
    tol = DTYPES["bfloat16"][2]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    # the emulation is the plain version up to P's rounding
    plain = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(plain), atol=tol, rtol=tol)


def test_block_args_do_not_change_the_result():
    (_, _, _), (q, k, v) = _both(_inputs(1, 2, 2, 256, 256, 64, 3), "float32")
    a = ops.flash_attention_op(q, k, v, causal=True, block_q=64, block_k=64)
    b = ops.flash_attention_op(q, k, v, causal=True, block_q=128, block_k=32)
    assert torch.equal(a, b)


def test_ragged_and_default_scale():
    """Any sequence length works (the JAX kernel needs blocks that divide
    it); the default scale is 1/sqrt(hd)."""

    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, 4, 2, 100, 100, 32, 11), "float32")
    want = jax_ref(jq, jk, jv, causal=True)
    got = ops.flash_attention_op(tq, tk, tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_fully_masked_rows_follow_the_reference_semantics():
    """Causal from position 0 with Sq > Sk: every row still sees key 0."""

    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, 2, 1, 96, 32, 16, 12), "float32")
    want = jax_ref(jq, jk, jv, causal=True)
    got = ops.flash_attention_op(tq, tk, tv, causal=True)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("q,k,v,exc", [
    (_t(1, 2, 8, 16, dtype=torch.float16), _t(1, 2, 8, 16, dtype=torch.float16),
     _t(1, 2, 8, 16, dtype=torch.float16), TypeError),
    (_t(1, 2, 8, 16), _t(1, 2, 8, 16, dtype=torch.bfloat16), _t(1, 2, 8, 16), TypeError),
    (_t(1, 3, 8, 16), _t(1, 2, 8, 16), _t(1, 2, 8, 16), ValueError),
    (_t(1, 2, 8, 16), _t(1, 2, 8, 16), _t(1, 2, 9, 16), ValueError),
    (_t(1, 2, 8, 16), _t(1, 2, 8, 32), _t(1, 2, 8, 32), ValueError),
    (_t(2, 8, 16), _t(2, 8, 16), _t(2, 8, 16), ValueError),
    (_t(1, 2, 16, 8).transpose(2, 3), _t(1, 2, 8, 16), _t(1, 2, 8, 16), ValueError),
    (_t(1, 2, 0, 16), _t(1, 2, 8, 16), _t(1, 2, 8, 16), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(q, k, v, exc):
    with pytest.raises(exc):
        ops.flash_attention_op(q, k, v)


def test_tma_alignment_copies_only_what_tma_cannot_read():
    aligned = torch.zeros(2, 8, 4, 16, dtype=torch.bfloat16)
    assert ops._tma_aligned(aligned) is aligned
    swapped = aligned.transpose(1, 2)  # the model's layout: strides still on 16 bytes
    assert ops._tma_aligned(swapped) is swapped
    odd = torch.zeros(2, 8, 4, 20, dtype=torch.bfloat16)[..., :16]  # strides off 16 bytes
    fixed = ops._tma_aligned(odd)
    assert fixed is not odd and fixed.is_contiguous() and torch.equal(fixed, odd)
    shifted = torch.zeros(2 * 8 * 4 * 16 + 1, dtype=torch.bfloat16)[1:].view(2, 8, 4, 16)
    fixed = ops._tma_aligned(shifted)
    assert fixed is not shifted and fixed.data_ptr() % 16 == 0


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    tracing.reset_counters("launch.")
    q = torch.randn(1, 2, 8, 16)
    ops.flash_attention_op(q, q, q)
    ops.flash_attention_bshd(q, q, q)
    assert tracing.counter("launch.flash_attention") == 0


def test_other_devices_raise():
    q = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        ops.flash_attention_op(q, q, q)


def test_every_head_dim_has_a_kernel_instance():
    """Each head_dim the wrapper admits on the card has a case in the
    launcher's switch and an m64n<hd>k16 product for O += P V (hd 80 was
    refused until it had both)."""

    src = kernel.SOURCE.read_text()
    assert 80 in ops.HEAD_DIMS
    for hd in ops.HEAD_DIMS:
        assert f"case {hd}: return FA_LAUNCH({hd});" in src, hd
        assert f"m64n{hd}k16.f32.bf16.bf16" in src, hd
        # the swizzle span (32, 64 or 128 bytes) divides the row, so the
        # column blocks cover every column
        assert (2 * hd) % 32 == 0


def test_kernel_source_names_what_it_replaces():
    src = kernel.SOURCE.read_text()
    assert "src/repro/kernels/flash_attention/kernel.py" in src and "_fa_kernel" in src
    assert 'extern "C" int flash_attention_launch' in src
    assert kernel.LIBRARY.library_path().parent == build.BUILD_DIR

