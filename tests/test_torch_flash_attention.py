"""The port's ``flash_attention`` wrappers against the reference's Pallas
kernel (interpret mode) and its jnp oracle, on the same numpy-seeded
inputs.

On the CPU the port's wrappers run the kernel's plain torch version; the
CUDA kernel itself is held against that version on the card by
``chip_smoke.py`` and by ``tests/test_torch_on_card.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.flash_attention.ops import flash_attention_bshd as jax_bshd
from repro.kernels.flash_attention.ops import flash_attention_op as jax_op
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
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
@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal", CASES)
def test_vs_pallas_interpret(b, h, kv, sq, sk, hd, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, h, kv, sq, sk, hd, b * 1000 + sq + hd), dtype)
    want = jax_op(jq, jk, jv, causal=causal, block_q=64, block_k=64, interpret=True)
    got = ops.flash_attention_op(tq, tk, tv, causal=causal, block_q=64, block_k=64)
    assert got.dtype == tq.dtype and got.shape == (b, h, sq, hd)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal", CASES)
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


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    ops.reset_launches()
    q = torch.randn(1, 2, 8, 16)
    ops.flash_attention_op(q, q, q)
    ops.flash_attention_bshd(q, q, q)
    assert ops.launches["flash_attention"] == 0


def test_other_devices_raise():
    q = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        ops.flash_attention_op(q, q, q)


def test_kernel_source_names_what_it_replaces():
    src = kernel.SOURCE.read_text()
    assert "src/repro/kernels/flash_attention/kernel.py" in src and "_fa_kernel" in src
    assert 'extern "C" int flash_attention_launch' in src
    assert kernel.LIBRARY.library_path().parent == build.BUILD_DIR

