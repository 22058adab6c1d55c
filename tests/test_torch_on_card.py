"""The port's CUDA kernels and serve path on a CUDA card.

Every test here needs a card and skips without one; the file imports no
JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest -q -m cuda tests/test_torch_on_card.py

Each kernel is held against its plain torch version on the same inputs,
at the tolerances of the reference's kernel tests.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ref as ssm_ref
from repro_torch.launch.serve import serve

pytestmark = pytest.mark.cuda

FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal", [
    (1, 2, 2, 128, 128, 64, True),
    (2, 4, 2, 128, 128, 64, True),
    (1, 6, 1, 128, 128, 32, True),
    (1, 2, 2, 256, 256, 128, False),
    (1, 2, 2, 64, 192, 64, False),
    (2, 4, 2, 100, 77, 128, True),   # ragged, Sq > Sk
    (1, 4, 4, 33, 33, 16, True),
])
def test_flash_attention_vs_plain(card, b, h, kv, sq, sk, hd, causal, dtype):
    g = torch.Generator(device=card).manual_seed(sq * 7 + hd)
    q = torch.randn(b, h, sq, hd, generator=g, device=card).to(dtype)
    k = torch.randn(b, kv, sk, hd, generator=g, device=card).to(dtype)
    v = torch.randn(b, kv, sk, hd, generator=g, device=card).to(dtype)
    got = fa_ops.flash_attention_op(q, k, v, causal=causal)
    want = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=FA_TOL[dtype],
                               rtol=FA_TOL[dtype])
    got_bshd = fa_ops.flash_attention_bshd(q.transpose(1, 2).contiguous(),
                                           k.transpose(1, 2).contiguous(),
                                           v.transpose(1, 2).contiguous(), causal=causal)
    assert torch.equal(got_bshd.transpose(1, 2), got)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,s,di,n,bd,ck", [
    (1, 32, 16, 4, 16, 16),
    (2, 64, 32, 8, 16, 16),
    (1, 128, 64, 16, 64, 32),
    (3, 96, 48, 8, 16, 32),
    (2, 40, 24, 16, 24, 8),   # DI*N not a multiple of the block
])
def test_ssm_scan_vs_plain(card, b, s, di, n, bd, ck, xdtype):
    rng = np.random.default_rng(s + di)
    delta = torch.from_numpy(np.abs(rng.normal(0, 0.1, (b, s, di))).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(b, s, n)).astype(np.float32))
    C = torch.from_numpy(rng.normal(size=(b, s, n)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(b, s, di)).astype(np.float32)).to(xdtype)
    A = torch.from_numpy(-np.abs(rng.normal(1, 0.3, (di, n))).astype(np.float32))
    args = [t.to(card) for t in (delta, B, C, x, A)]
    y, h = ssm_ops.ssm_scan_op(*args, block_d=bd, chunk=ck)
    yr, hr = ssm_ref.ssm_scan_ref(*args)
    torch.testing.assert_close(y.float(), yr.float(), atol=SSM_TOL[xdtype],
                               rtol=SSM_TOL[xdtype])
    torch.testing.assert_close(h, hr, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "falcon-mamba-7b"])
def test_serve_smoke_config_goes_through_the_kernel(card, arch):
    cfg = get_smoke_config(arch)
    fa_ops.reset_launches()
    ssm_ops.reset_launches()
    res = serve(cfg, batch=2, prompt_len=16, gen=4, seed=0, device=card)
    launched = fa_ops.launches["flash_attention"] + ssm_ops.launches["ssm_scan"]
    assert launched == cfg.n_layers
    plain = serve(dataclasses.replace(cfg, attention_impl="torch", ssm_impl="torch"),
                  batch=2, prompt_len=16, gen=4, seed=0, device=card)
    torch.testing.assert_close(res["prefill_logits"], plain["prefill_logits"],
                               atol=0.08, rtol=0.08)
