"""The port's ``ssm_scan`` wrapper against the reference's Pallas kernel
(interpret mode) and its jnp oracle, on the same numpy-seeded inputs.

On the CPU the port's wrapper runs the kernel's plain torch version; the
CUDA kernel itself is held against that version on the card by
``chip_smoke.py`` and by ``tests/test_torch_on_card.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.ssm_scan.ops import ssm_scan_op as jax_op
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ref
from repro_torch import tracing
from repro_torch.kernels.ssm_scan import kernel, ops, ref

pytestmark = pytest.mark.slow  # interpret-mode Pallas runs, as tests/test_kernel_ssm_scan.py

CASES = [  # the grid of tests/test_kernel_ssm_scan.py
    (1, 32, 16, 4, 16, 16),
    (2, 64, 32, 8, 16, 16),    # multiple d-blocks AND chunks
    (1, 128, 64, 16, 64, 32),  # falcon-mamba-like ratios, scaled
    (3, 96, 48, 8, 16, 32),    # odd batch, 3 chunks, 3 d-blocks
]
XDTYPES = {"float32": (np.float32, torch.float32, 1e-4),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def make(b, s, di, n, seed=0):
    rng = np.random.default_rng(seed)
    delta = np.abs(rng.normal(0, 0.1, (b, s, di))).astype(np.float32)
    B = rng.normal(size=(b, s, n)).astype(np.float32)
    C = rng.normal(size=(b, s, n)).astype(np.float32)
    x = rng.normal(size=(b, s, di)).astype(np.float32)
    A = -np.abs(rng.normal(1, 0.3, (di, n))).astype(np.float32)
    return delta, B, C, x, A


def _torch(delta, B, C, x, A, xdtype):
    t = [torch.from_numpy(a) for a in (delta, B, C, x, A)]
    t[3] = t[3].to(XDTYPES[xdtype][1])
    return t


def _x_as_in_jax(x, xdtype):
    """x as the reference sees it: bf16 rounding done by jnp, so both
    packages start from the same bits."""

    return jnp.asarray(x, XDTYPES[xdtype][0])


@pytest.mark.parametrize("xdtype", sorted(XDTYPES))
@pytest.mark.parametrize("b,s,di,n,bd,ck", CASES)
def test_vs_pallas_interpret(b, s, di, n, bd, ck, xdtype):
    delta, B, C, x, A = make(b, s, di, n)
    y_want, h_want = jax_op(delta, B, C, _x_as_in_jax(x, xdtype), A, block_d=bd, chunk=ck,
                            interpret=True)
    y, h = ops.ssm_scan_op(*_torch(delta, B, C, x, A, xdtype), block_d=bd, chunk=ck)
    assert y.dtype == XDTYPES[xdtype][1] and h.dtype == torch.float32
    tol = XDTYPES[xdtype][2]
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_want, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("xdtype", sorted(XDTYPES))
@pytest.mark.parametrize("b,s,di,n,bd,ck", CASES)
def test_vs_jnp_oracle(b, s, di, n, bd, ck, xdtype):
    delta, B, C, x, A = make(b, s, di, n, seed=1)
    y_want, h_want = jax_ref(jnp.asarray(delta), jnp.asarray(B), jnp.asarray(C),
                             _x_as_in_jax(x, xdtype), jnp.asarray(A))
    y, h = ref.ssm_scan_ref(*_torch(delta, B, C, x, A, xdtype))
    tol = XDTYPES[xdtype][2]
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_want, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("bd,ck", [(16, 64), (16, 16), (8, 32), (16, 1)])
def test_chunk_and_block_d_do_not_change_the_result(bd, ck):
    """The reference's ``test_state_carries_across_chunks``: splitting the
    same sequence into more chunks (or d-blocks) changes nothing."""

    args = _torch(*make(1, 64, 16, 4, seed=3), "float32")
    y1, h1 = ops.ssm_scan_op(*args, block_d=16, chunk=64)
    y2, h2 = ops.ssm_scan_op(*args, block_d=bd, chunk=ck)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.parametrize("s,di,bd,ck", [(60, 16, 16, 16), (64, 24, 16, 16)])
def test_raises_where_the_reference_raises(s, di, bd, ck):
    args = _torch(*make(1, s, di, 4), "float32")
    with pytest.raises(ValueError, match="not divisible"):
        ops.ssm_scan_op(*args, block_d=bd, chunk=ck)
    with pytest.raises(ValueError, match="not divisible"):
        jax_op(*make(1, s, di, 4), block_d=bd, chunk=ck, interpret=True)


def _args(**over):
    args = dict(zip(("delta", "B", "C", "x", "A"), _torch(*make(1, 16, 8, 4), "float32")))
    args.update(over)
    return args


@pytest.mark.parametrize("over,exc", [
    ({"delta": torch.zeros(1, 16, 8, dtype=torch.float64)}, TypeError),
    ({"A": torch.zeros(8, 4, dtype=torch.bfloat16)}, TypeError),
    ({"x": torch.zeros(1, 16, 8, dtype=torch.float16)}, TypeError),
    ({"x": torch.zeros(1, 16, 9)}, ValueError),
    ({"B": torch.zeros(1, 4, 16).transpose(1, 2)}, ValueError),
    ({"C": torch.zeros(1, 16, 3)}, ValueError),
    ({"A": torch.zeros(8, 3)}, ValueError),
    ({"delta": torch.zeros(16, 8), "x": torch.zeros(16, 8)}, ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(over, exc):
    a = _args(**over)
    with pytest.raises(exc):
        ops.ssm_scan_op(a["delta"], a["B"], a["C"], a["x"], a["A"], block_d=8, chunk=8)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    tracing.reset_counters("launch.")
    a = _args()
    ops.ssm_scan_op(a["delta"], a["B"], a["C"], a["x"], a["A"])
    assert tracing.counter("launch.ssm_scan") == 0


def test_other_devices_raise():
    a = {k: v.to("meta") for k, v in _args().items()}
    with pytest.raises(ValueError, match="no ssm_scan kernel"):
        ops.ssm_scan_op(a["delta"], a["B"], a["C"], a["x"], a["A"])


def test_kernel_source_names_what_it_replaces():
    src = kernel.SOURCE.read_text()
    assert "src/repro/kernels/ssm_scan/kernel.py" in src and "_ssm_kernel" in src
    assert 'extern "C" int ssm_scan_launch' in src

