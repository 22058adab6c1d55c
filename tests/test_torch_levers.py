"""The reference's perf levers in the port (``matmul_weight_dtype``,
``param_dtype``, ``embed_onehot``, ``mamba_fused_proj``, and
``moe_dispatch_dtype``) against the reference with the same lever on, on
the same weights and inputs, mirroring the cases of
``tests/test_perf_levers.py``.

Weights are drawn by the reference and carried across by
``params_from_jax``; tokens, patch embeddings and frames come from NumPy.
The reference runs its XLA paths, the port its torch paths.  Tolerances:
``TOL`` of ``tests/test_torch_models.py`` (f32 1e-4, bf16 0.08) against the
reference; the reference's own bounds for a lever against the port without
it (``mamba_fused_proj`` 2e-3 on the loss, ``moe_dispatch_dtype`` 0.05);
bit for bit where the values cannot differ (a one-hot embedding, the fp8
round trip) and exactly for MoE routing.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.models.convert import config_from_jax, params_from_jax, tree_from_params
from test_torch_families import extra_inputs
from test_torch_models import TOL, close, f32, jax_layer, activations
from test_torch_moe import reference_routing

pytestmark = pytest.mark.slow  # per-arch reference runs, as tests/test_perf_levers.py

B = 2
FP8 = "float8_e4m3fn"


@functools.lru_cache(maxsize=None)
def _setup(arch: str, dtype: str, levers: tuple):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype, attention_impl="xla",
                               ssm_impl="xla", **dict(levers))
    jparams = jax_get_model(jcfg).init_params(jax.random.PRNGKey(0))
    tcfg = config_from_jax(jcfg)
    return jcfg, jparams, tcfg, params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                                device="cpu")


def setup(arch: str, dtype: str = "bfloat16", **levers):
    """(reference cfg, its params; port cfg, its params) of ``arch``'s smoke
    config in ``dtype`` with ``levers`` on, the port's weights carried from
    the reference's."""

    return _setup(arch, dtype, tuple(sorted(levers.items())))


def with_levers(cfg, **levers):
    return dataclasses.replace(cfg, **levers)


def batches(cfg, dtype: str, seq: int = 16, seed: int = 1):
    """The same train batch for both packages: tokens, their next tokens as
    labels, and the VLM's or encoder-decoder's inputs."""

    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, seq + 1))
    jx, tx = extra_inputs(cfg, dtype)
    jb = dict(jx, tokens=jnp.asarray(toks[:, :-1], jnp.int32),
              labels=jnp.asarray(toks[:, 1:], jnp.int32))
    tb = dict(tx, tokens=torch.from_numpy(toks[:, :-1].copy()),
              labels=torch.from_numpy(toks[:, 1:].copy()))
    return jb, tb


def loss_and_grads(tcfg, tparams, tb):
    tparams.requires_grad_()
    try:
        loss = get_model(tcfg, "cpu").loss_fn(tparams, tb)
        names = [n for n, _ in tparams.named_parameters()]
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss, list(
            tparams.parameters()))))
    finally:
        tparams.requires_grad_(False)


def reference_leaf(tree: dict, name: str):
    parts = name.split(".")
    return tree[name] if len(parts) == 1 else tree[parts[0]][parts[2]][int(parts[1])]


def fp8_bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


# -- mamba_fused_proj -----------------------------------------------------


@pytest.mark.parametrize("seq", [16, 13], ids=["whole-chunks", "ragged"])
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_fused_proj_matches_the_reference(dtype, seq):
    """falcon-mamba's smoke config with the lever: the loss, every gradient
    and the prefill (logits and decode state) equal the reference's with the
    lever; at 13 tokens the last chunk of 8 is padded, so the delta mask is
    what keeps the state right."""

    jcfg, jparams, tcfg, tparams = setup("falcon-mamba-7b", dtype, mamba_fused_proj=True)
    jb, tb = batches(tcfg, dtype, seq)
    jloss, jgrads = jax.value_and_grad(jax_get_model(jcfg).loss_fn)(jparams, jb)
    loss, grads = loss_and_grads(tcfg, tparams, tb)
    close(loss, jloss, dtype)
    for name, g in grads.items():
        np.testing.assert_allclose(f32(g), f32(reference_leaf(jgrads, name)),
                                   atol=TOL[dtype], rtol=TOL[dtype], err_msg=name)
    jlogits, jstate = jax_get_model(jcfg).prefill(jparams, {"tokens": jb["tokens"]})
    with torch.no_grad():
        logits, state = get_model(tcfg, "cpu").prefill(tparams, {"tokens": tb["tokens"]})
    close(logits, jlogits, dtype)
    close(state["h"], jstate["h"], dtype)
    close(state["conv"], jstate["conv"], dtype)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_fused_proj_loss_within_bound_of_unfused(dtype):
    """The reference's bound for the lever (``test_perf_levers.py``: 2e-3),
    on the port alone, at a ragged length."""

    _, _, tcfg, tparams = setup("falcon-mamba-7b", dtype)
    _, tb = batches(tcfg, dtype, 13)
    with torch.no_grad():
        plain = get_model(tcfg, "cpu").loss_fn(tparams, tb)
        fused = get_model(with_levers(tcfg, mamba_fused_proj=True), "cpu").loss_fn(tparams, tb)
    assert abs(float(fused) - float(plain)) < 2e-3


def test_fused_proj_comes_before_the_scan_kernel(monkeypatch):
    """As in the reference, a fused multi-token step never reaches
    ``ssm_scan`` under ``ssm_impl="kernel"``; a decode step (one token)
    takes the unfused step."""

    def refuse(*args, **kw):
        raise AssertionError("the fused prefill reached the scan kernel")

    monkeypatch.setattr(TL, "ssm_scan_op", refuse)
    _, _, tcfg, tparams = setup("falcon-mamba-7b", "float32")
    cfg = with_levers(tcfg, mamba_fused_proj=True, ssm_impl="kernel")
    _, tb = batches(cfg, "float32", 16)
    model, plain = get_model(cfg, "cpu"), get_model(with_levers(tcfg, ssm_impl="torch"), "cpu")
    with torch.no_grad():
        logits, state = model.prefill(tparams, {"tokens": tb["tokens"]})
        want, want_state = plain.prefill(tparams, {"tokens": tb["tokens"]})
        step, _ = model.decode_step(tparams, state, tb["tokens"][:, :1], 16)
        want_step, _ = plain.decode_step(tparams, want_state, tb["tokens"][:, :1], 16)
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(step, want_step, atol=1e-4, rtol=1e-4)


# -- embed_onehot ---------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_embed_onehot_equals_the_gather(dtype):
    """One nonzero a row sums exactly, so the one-hot product is the gather
    bit for bit (an fp8 table's product runs in the activation dtype)."""

    _, _, tcfg, tparams = setup("qwen3-1.7b", dtype)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab_size, (B, 16)))
    emb = tparams.tok_emb
    onehot = with_levers(tcfg, embed_onehot=True)
    got = TL.embed_tokens(onehot, emb, tokens)
    assert got.dtype == getattr(torch, dtype)
    assert torch.equal(got, TL.embed_tokens(tcfg, emb, tokens))
    emb8 = emb.to(torch.float8_e4m3fn)
    assert torch.equal(TL.embed_tokens(onehot, emb8, tokens), TL.embed_tokens(tcfg, emb8, tokens))


def test_embed_onehot_loss_matches_the_reference():
    jcfg, jparams, tcfg, tparams = setup("qwen3-1.7b", embed_onehot=True)
    jb, tb = batches(tcfg, "bfloat16")
    with torch.no_grad():
        got = get_model(tcfg, "cpu").loss_fn(tparams, tb)
    assert abs(float(got) - float(jax_get_model(jcfg).loss_fn(jparams, jb))) < 1e-3


# -- matmul_weight_dtype --------------------------------------------------

# every family: the casts fall at the reference's sites and nowhere else
# (the Mamba blocks and the encoder-decoder's cross K/V and tied head have
# none), which an fp8 rounding at one site too many or too few would show
FP8_ARCHS = ["qwen3-1.7b", "moonshot-v1-16b-a3b", "internvl2-26b", "whisper-tiny",
             "falcon-mamba-7b", "zamba2-2.7b"]


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", FP8_ARCHS)
def test_fp8_matmul_weights_match_the_reference(arch, dtype):
    jcfg, jparams, tcfg, tparams = setup(arch, dtype, matmul_weight_dtype=FP8)
    jb, tb = batches(tcfg, dtype)
    jm, tm = jax_get_model(jcfg), get_model(tcfg, "cpu")
    prompt = {k: v for k, v in jb.items() if k != "labels"}
    jlogits, _ = jm.prefill(jparams, prompt)
    with torch.no_grad():
        logits, _ = tm.prefill(tparams, {k: v for k, v in tb.items() if k != "labels"})
        loss = tm.loss_fn(tparams, tb)
    close(logits, jlogits, dtype)
    close(loss, jm.loss_fn(jparams, jb), dtype)
    # the lever moves the result: the casts are not a no-op
    with torch.no_grad():
        plain, _ = get_model(with_levers(tcfg, matmul_weight_dtype=None), "cpu").prefill(
            tparams, {k: v for k, v in tb.items() if k != "labels"})
    assert not torch.equal(plain, logits)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_fp8_matmul_weights_route_moe_tokens_as_the_reference(dtype):
    """moonshot's router weight is cast too: expert indices and capacity
    slots equal the reference's exactly."""

    jcfg, jparams, tcfg, tparams = setup("moonshot-v1-16b-a3b", dtype, matmul_weight_dtype=FP8)
    jx, tx = activations((B, 32, jcfg.d_model), dtype)
    jw = jax_layer(jparams, 1)
    close(TL.moe_mlp(tcfg, tparams.layers[1], tx), JL.moe_mlp(jcfg, jw, jx), dtype)
    _, idx, slot, cap = TL.moe_routing(tcfg, tparams.layers[1], tx)
    want_idx, want_slot, want_cap = reference_routing(
        jcfg, dict(jw, router=JL.wcast(jcfg, jw["router"])), jx)
    assert cap == want_cap
    assert np.array_equal(idx.numpy(), want_idx)
    assert np.array_equal(slot.numpy(), want_slot)


def test_wcast_is_the_reference_cast():
    """fp8 then the product's dtype; ``None`` only the product's dtype."""

    x = np.random.default_rng(4).normal(0, 0.05, (64, 32)).astype(np.float32)
    jcfg = dataclasses.replace(jax_smoke_config("qwen3-1.7b"), matmul_weight_dtype=FP8)
    want = JL.wcast(jcfg, jnp.asarray(x, jnp.bfloat16))
    got = TL.wcast(config_from_jax(jcfg), torch.from_numpy(x).to(torch.bfloat16), torch.float32)
    assert str(want.dtype) == FP8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.float32))
    w = torch.from_numpy(x)
    assert TL.wcast(get_smoke_config("qwen3-1.7b"), w, torch.float32) is w


# -- param_dtype ----------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_fp8_param_storage(dtype):
    """grok's smoke config stored in fp8 and multiplied in bf16: every leaf
    is fp8 (the port's init and the converted tree alike), the loss is
    finite (the reference's case) and equal to the reference's, and the
    tree goes across and back bit for bit."""

    levers = dict(param_dtype=FP8, matmul_weight_dtype="bfloat16")
    jcfg, jparams, tcfg, tparams = setup("grok-1-314b", dtype, **levers)
    own = get_model(tcfg, "cpu").init_params(0)
    for params in (tparams, own):
        assert {t.dtype for t in params.parameters()} == {torch.float8_e4m3fn}
    assert abs(own.tok_emb.float().std().item() - 0.02) < 2e-3
    jb, tb = batches(tcfg, dtype)
    with torch.no_grad():
        loss = get_model(tcfg, "cpu").loss_fn(tparams, tb)
    assert torch.isfinite(loss)
    close(loss, jax_get_model(jcfg).loss_fn(jparams, jb), dtype)

    tree = jax.tree.map(np.asarray, jparams)
    back = tree_from_params(params_from_jax(tcfg, tree, device="cpu"))
    is_tensor = lambda t: isinstance(t, torch.Tensor)  # noqa: E731
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == len(jax.tree.leaves(back, is_leaf=is_tensor))
    for (path, a), b in zip(leaves, jax.tree.leaves(back, is_leaf=is_tensor)):
        assert a.dtype == ml_dtypes.float8_e4m3fn and b.dtype == torch.float8_e4m3fn, path
        assert np.array_equal(fp8_bits(b), fp8_bits(a)), path


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b", "whisper-tiny"])
def test_param_dtype_refused_where_the_reference_ignores_it(arch):
    cfg = with_levers(get_smoke_config(arch), param_dtype=FP8)
    with pytest.raises(NotImplementedError, match="param_dtype"):
        get_model(cfg, "cpu")


# -- moe_dispatch_dtype ---------------------------------------------------


def test_bf16_moe_dispatch():
    """Within the reference's bound (0.05) of the f32 dispatch, and equal to
    the reference with the same lever."""

    jcfg, jparams, tcfg, tparams = setup("moonshot-v1-16b-a3b", moe_dispatch_dtype="bfloat16")
    jb, tb = batches(tcfg, "bfloat16")
    with torch.no_grad():
        got = get_model(tcfg, "cpu").loss_fn(tparams, tb)
        f32_dispatch = get_model(with_levers(tcfg, moe_dispatch_dtype="float32"),
                                 "cpu").loss_fn(tparams, tb)
    assert abs(float(got) - float(f32_dispatch)) < 0.05
    close(got, jax_get_model(jcfg).loss_fn(jparams, jb), "bfloat16")
