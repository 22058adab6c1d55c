"""The port's model stack (``repro_torch.models``) against the reference
(``repro.models``) on the same weights and inputs.

Weights are drawn by the reference (``init_params(PRNGKey(0))``) and carried
to the port bit for bit by ``params_from_jax``; inputs come from numpy.
The reference runs its Pallas kernels in interpret mode (``"pallas"``) or
its XLA paths (``"xla"``); the port runs the counterparts (``"kernel"``,
whose plain versions run on the CPU, and ``"torch"``).

Tolerances: f32 at 1e-4 (the two frameworks sum in other orders); bf16 at
0.08, the tolerance of ``tests/test_models_smoke.py`` (the two frameworks
round bf16 at other places).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.serve import pad_cache as jax_pad_cache
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.serve import pad_cache, serve
from repro_torch.models import get_model, layers as TL
from repro_torch.models.convert import config_from_jax, params_from_jax, tree_from_params

pytestmark = pytest.mark.slow  # interpret-mode Pallas runs, as tests/test_models_smoke.py

ARCHS = ["qwen3-1.7b", "stablelm-3b", "starcoder2-3b", "phi4-mini-3.8b", "zamba2-2.7b",
         "falcon-mamba-7b"]
TOL = {"float32": 1e-4, "bfloat16": 0.08}
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def setup(arch: str, dtype: str, impl: str, head_dim: int | None = None):
    """(reference cfg, model, params; port cfg, model, params); ``head_dim``
    replaces the smoke config's."""

    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype, attention_impl=impl,
                               ssm_impl=impl)
    if head_dim is not None:
        jcfg = dataclasses.replace(jcfg, head_dim=head_dim)
    jm = jax_get_model(jcfg)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tcfg = config_from_jax(jcfg)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jm, jparams, tcfg, get_model(tcfg, "cpu"), tparams


def tokens(n: int, seed: int = 0, vocab: int = 256) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, n)).astype(np.int32)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, dtype: str) -> None:
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype], rtol=TOL[dtype])


def jax_layer(jparams, i: int = 0, every: int = 0) -> dict:
    """Layer ``i``'s leaves; of the hybrid's Mamba layers (stacked on
    groups x ``every``) when ``every`` is given."""

    if every:
        return {k: v[i // every, i % every] for k, v in jparams["mamba"].items()}
    return {k: v[i] for k, v in jparams["layers"].items()}


def activations(shape, dtype: str, seed: int = 1):
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


# -- config and weights ---------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies(arch):
    for jcfg, tcfg in ((jax_config(arch), get_config(arch)),
                       (jax_smoke_config(arch), get_smoke_config(arch))):
        port = dataclasses.asdict(tcfg)
        ref = dataclasses.asdict(config_from_jax(jcfg))
        assert port == dict(ref, attention_impl="kernel", ssm_impl="kernel")
        assert tcfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_conversion_match(arch):
    jcfg, jm, jparams, tcfg, tm, tparams = setup(arch, "bfloat16", "xla")
    jspecs = jax.tree.map(lambda a: a.shape, jm.abstract_params(),
                          is_leaf=lambda a: isinstance(a, jax.ShapeDtypeStruct))
    tspecs = tm.param_specs()
    assert tspecs == jspecs
    w = jax_layer(jparams, 1, tcfg.shared_attn_every if tcfg.family == "hybrid" else 0)
    for name, t in tparams.layers[1].named_parameters():
        assert np.array_equal(f32(t), f32(w[name])), name
        assert str(t.dtype).split(".")[-1] == str(w[name].dtype)
    if tcfg.family == "hybrid":
        for name, t in tparams.shared.named_parameters():
            assert np.array_equal(f32(t), f32(jparams["shared"][name])), name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_scales(arch):
    cfg = get_smoke_config(arch)
    params = get_model(cfg, "cpu").init_params(0)
    again = get_model(cfg, "cpu").init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), again.parameters()))
    emb = params.tok_emb.float()
    assert abs(emb.std().item() - 0.02) < 2e-3
    assert torch.equal(params.final_norm.float(), torch.ones(cfg.d_model))
    if cfg.family == "ssm":
        assert params.layers[0].A_log.dtype == torch.float32
        assert torch.allclose(-torch.exp(params.layers[0].A_log[0]),
                              -torch.arange(1, cfg.ssm_state + 1, dtype=torch.float32))
    if cfg.family == "hybrid":
        w = params.layers[-1]
        assert w.A_log.dtype == w.dt_bias.dtype == torch.float32
        assert torch.equal(w.A_log, torch.zeros(cfg.mamba_heads))
        assert torch.equal(w.dt_bias, torch.full((cfg.mamba_heads,), -4.6))
        assert torch.equal(w.D.float(), torch.ones(cfg.mamba_heads))
        assert abs(params.shared.wq.float().std().item() - 0.02) < 4e-3


def test_unported_config_raises():
    """The four perf levers build (each is held against the reference in
    ``tests/test_torch_levers.py``); ``param_dtype`` is refused for the
    ssm, hybrid and encdec families, whose reference init ignores it; an
    unknown family or arch, a Mamba version its family does not run, and
    an impl of the reference's names raise."""

    cfg = get_smoke_config("qwen3-1.7b")
    for over in ({"embed_onehot": True}, {"matmul_weight_dtype": "float8_e4m3fn"},
                 {"param_dtype": "float8_e4m3fn"}, {"mamba_fused_proj": True}):
        assert get_model(dataclasses.replace(cfg, **over), "cpu").cfg == \
            dataclasses.replace(cfg, **over)
    get_model(dataclasses.replace(get_smoke_config("falcon-mamba-7b"), mamba_fused_proj=True),
              "cpu")
    for arch in ("falcon-mamba-7b", "zamba2-2.7b", "whisper-tiny"):
        with pytest.raises(NotImplementedError, match="param_dtype"):
            get_model(dataclasses.replace(get_smoke_config(arch), param_dtype="float8_e4m3fn"),
                      "cpu")
    with pytest.raises(ValueError, match="family"):
        get_model(dataclasses.replace(cfg, family="diffusion"), "cpu")
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("llama-7b")
    with pytest.raises(NotImplementedError, match="Mamba-1"):
        get_model(dataclasses.replace(get_smoke_config("falcon-mamba-7b"), mamba_version=2),
                  "cpu")
    with pytest.raises(NotImplementedError, match="Mamba-2"):
        get_model(dataclasses.replace(get_smoke_config("zamba2-2.7b"), mamba_version=1), "cpu")
    with pytest.raises(ValueError, match="attention_impl"):
        get_model(dataclasses.replace(cfg, attention_impl="pallas"), "cpu")
    for arch in ("moonshot-v1-16b-a3b", "grok-1-314b", "internvl2-26b", "whisper-tiny"):
        assert get_model(get_smoke_config(arch), "cpu").cfg.name.startswith(arch)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_conv_state_owns_its_storage(arch):
    """A Mamba block's conv state is a copy of the last K-1 inputs, not a
    view that keeps the whole (B, S+K-1, C) padded input alive."""

    cfg = dataclasses.replace(get_smoke_config(arch), attention_impl="torch", ssm_impl="torch")
    params = get_model(cfg, "cpu").init_params(0)
    block = TL.mamba1_block if cfg.family == "ssm" else TL.mamba2_block
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(B, 64, cfg.d_model)).astype(
        np.float32)).to(TL.dtype_of(cfg))
    with torch.no_grad():
        _, state = block(cfg, params.layers[0], x, None)
    tail = state.conv
    assert tail.shape[1] == cfg.d_conv - 1
    assert tail.untyped_storage().nbytes() == tail.numel() * tail.element_size()
    # the smallest case: a 768-byte tail, which as a view held 525,056 bytes
    x = torch.randn(1, 2048, 64)
    _, small = TL._causal_conv1d(x, torch.randn(4, 64), torch.zeros(64), None)
    assert torch.equal(small, x[:, -3:])
    assert small.untyped_storage().nbytes() == 768


# -- layers ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_attention_prefill_and_decode(impl, dtype):
    jcfg, _, jparams, tcfg, _, tparams = setup("qwen3-1.7b", dtype, impl)
    jx, tx = activations((B, S, jcfg.d_model), dtype)
    jout, (jk, jv) = JL.attention(jcfg, jax_layer(jparams), jx, positions=jnp.arange(S))
    tout, (tk, tv) = TL.attention(tcfg, tparams.layers[0], tx, positions=torch.arange(S))
    for got, want in ((tout, jout), (tk, jk), (tv, jv)):
        close(got, want, dtype)

    # one decode step at position S against the cache padded by one slot
    jx1, tx1 = activations((B, 1, jcfg.d_model), dtype, seed=2)
    pad = [(0, 0), (0, 1), (0, 0), (0, 0)]
    jcache = (jnp.pad(jk, pad), jnp.pad(jv, pad))
    tcache = tuple(torch.cat([t, t.new_zeros(B, 1, *t.shape[2:])], dim=1) for t in (tk, tv))
    jpos = jnp.full((B, 1), S, jnp.int32)
    jout1, (jk1, _) = JL.attention(jcfg, jax_layer(jparams), jx1, positions=jpos,
                                   kv_cache=jcache, cache_position=S)
    tout1, (tk1, _) = TL.attention(tcfg, tparams.layers[0], tx1,
                                   positions=torch.full((B, 1), S), kv_cache=tcache,
                                   cache_position=S)
    close(tout1, jout1, dtype)
    close(tk1, jk1, dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_softmax_statistics(causal):
    """``softmax_dtype="bfloat16"``: exponentials stored in bf16, max and
    sums in f32, as the reference's ``_softmax_lastdim``."""

    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((B, S, 4, 16), (B, S, 2, 16), (B, S, 2, 16)))
    # a NumPy scale, as the reference's attention passes it (1 / np.sqrt(hd))
    want = JL._attend_direct(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), 2,
                             np.float64(0.25), causal, smax=jnp.bfloat16)
    got = TL._attend_direct(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), 2, 0.25,
                            causal, smax=torch.bfloat16)
    close(got, want, "bfloat16")


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "stablelm-3b"], ids=["swiglu", "gelu"])
def test_mlp(arch, dtype):
    """SwiGLU (qwen3) and the tanh-approximate GELU (stablelm), as
    ``jax.nn.gelu``'s default."""

    jcfg, _, jparams, tcfg, _, tparams = setup(arch, dtype, "xla")
    assert tcfg.swiglu == (arch == "qwen3-1.7b")
    jx, tx = activations((B, S, jcfg.d_model), dtype)
    close(TL.mlp(tcfg, tparams.layers[1], tx), JL.mlp(jcfg, jax_layer(jparams, 1), jx), dtype)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_mamba1_block_prefill_and_step(impl, dtype):
    jcfg, _, jparams, tcfg, _, tparams = setup("falcon-mamba-7b", dtype, impl)
    jx, tx = activations((B, S, jcfg.d_model), dtype)
    jout, jst = JL.mamba1_block(jcfg, jax_layer(jparams), jx)
    tout, tst = TL.mamba1_block(tcfg, tparams.layers[0], tx)
    close(tout, jout, dtype)
    close(tst.conv, jst.conv, dtype)
    np.testing.assert_allclose(f32(tst.h), f32(jst.h), atol=1e-3, rtol=1e-3)

    jx1, tx1 = activations((B, 1, jcfg.d_model), dtype, seed=2)
    jout1, jst1 = JL.mamba1_block(jcfg, jax_layer(jparams), jx1, jst)
    tout1, tst1 = TL.mamba1_block(tcfg, tparams.layers[0], tx1, tst)
    close(tout1, jout1, dtype)
    np.testing.assert_allclose(f32(tst1.h), f32(jst1.h), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_mamba2_block_prefill_and_step(impl, dtype):
    """S = 16 over scan chunks of 8 (two chunks), then one decode step."""

    jcfg, _, jparams, tcfg, _, tparams = setup("zamba2-2.7b", dtype, impl)
    e = tcfg.shared_attn_every
    jx, tx = activations((B, S, jcfg.d_model), dtype)
    jout, jst = JL.mamba2_block(jcfg, jax_layer(jparams, 1, e), jx)
    tout, tst = TL.mamba2_block(tcfg, tparams.layers[1], tx)
    close(tout, jout, dtype)
    close(tst.conv, jst.conv, dtype)
    np.testing.assert_allclose(f32(tst.h), f32(jst.h), atol=1e-3, rtol=1e-3)

    jx1, tx1 = activations((B, 1, jcfg.d_model), dtype, seed=2)
    jout1, jst1 = JL.mamba2_block(jcfg, jax_layer(jparams, 1, e), jx1, jst)
    tout1, tst1 = TL.mamba2_block(tcfg, tparams.layers[1], tx1, tst)
    close(tout1, jout1, dtype)
    close(tst1.conv, jst1.conv, dtype)
    np.testing.assert_allclose(f32(tst1.h), f32(jst1.h), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("s", [37, 8])
def test_mamba2_scan_equals_the_reference_scan(s):
    """The per-head scan, padded (S 37 over chunks of 16) or one chunk, on
    random heads of 4 channels: y and the last state in f32."""

    rng = np.random.default_rng(9)
    b, nh, p, n = 2, 3, 4, 8
    delta = np.abs(rng.normal(0, 0.5, (b, s, nh))).astype(np.float32)
    Bm, Cm = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(b, s, nh * p)).astype(np.float32)
    h0 = rng.normal(size=(b, nh * p, n)).astype(np.float32)
    A = -np.abs(rng.normal(1, 0.3, nh)).astype(np.float32)
    args = (delta, Bm, Cm, x, h0)
    yj, hj = JL._ssm_scan(*map(jnp.asarray, args), 16, A_head=jnp.asarray(A), headdim=p)
    yt, ht = TL._ssm_scan(*map(torch.from_numpy, args), 16, A_head=torch.from_numpy(A),
                          headdim=p)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-5, rtol=1e-5)


def test_chunked_scan_equals_the_kernels_plain_version():
    """The ``"torch"`` scan (chunked, padded, associative) and the kernel's
    plain version compute one function."""

    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    rng = np.random.default_rng(5)
    delta = torch.from_numpy(np.abs(rng.normal(0, 0.1, (2, 37, 24))).astype(np.float32))
    Bm = torch.from_numpy(rng.normal(size=(2, 37, 8)).astype(np.float32))
    Cm = torch.from_numpy(rng.normal(size=(2, 37, 8)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 37, 24)).astype(np.float32))
    A = torch.from_numpy(-np.abs(rng.normal(1, 0.3, (24, 8))).astype(np.float32))
    y, h = TL._ssm_scan(delta, Bm, Cm, x, torch.zeros(2, 24, 8), 16, A_full=A)
    yr, hr = ssm_scan_ref(delta, Bm, Cm, x, A)
    torch.testing.assert_close(y, yr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, hr, atol=1e-5, rtol=1e-5)


# -- whole models ---------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_match_the_reference(arch, impl, dtype):
    jcfg, jm, jparams, tcfg, tm, tparams = setup(arch, dtype, impl)
    toks = tokens(S + 1)
    jlogits, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    tlogits, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S]).long()})
    assert tlogits.shape == jlogits.shape == (B, 1, jcfg.padded_vocab)
    assert tlogits.dtype == getattr(torch, dtype)
    close(tlogits, jlogits, dtype)
    assert sorted(tcache) == sorted(jcache)
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape
        close(tcache[key], jcache[key], dtype if key != "h" else "bfloat16")

    jcache, tcache = jax_pad_cache(jcache, 1), pad_cache(tcache, 1)
    jstep, _ = jm.decode_step(jparams, jcache, jnp.asarray(toks[:, S:]), jnp.int32(S))
    tstep, _ = tm.decode_step(tparams, tcache, torch.from_numpy(toks[:, S:]).long(), S)
    close(tstep, jstep, dtype)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, impl):
    """prefill(tokens[:-1]) + decode_step(tokens[-1]) == prefill(tokens) at
    the last position, as tests/test_models_smoke.py (S = 8: the scan
    kernel needs S divisible by min(scan_chunk, S) for both lengths)."""

    cfg = dataclasses.replace(get_smoke_config(arch), attention_impl=impl, ssm_impl=impl)
    m = get_model(cfg, "cpu")
    params = m.init_params(0)
    toks = torch.from_numpy(tokens(8)).long()
    full, _ = m.prefill(params, {"tokens": toks})
    _, cache = m.prefill(params, {"tokens": toks[:, :-1]})
    step, _ = m.decode_step(params, pad_cache(cache, 1), toks[:, -1:], 7)
    a, b = f32(full)[:, 0], f32(step)[:, 0]
    np.testing.assert_allclose(a, b, rtol=0.08, atol=0.08)
    assert (np.argmax(a, -1) == np.argmax(b, -1)).mean() >= 0.5


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_end_to_end_matches_reference_greedy_decode(arch):
    """``serve(device="cpu")`` in f32 on the reference's weights gives the
    tokens of the reference's own prefill + greedy serve steps on the same
    prompts."""

    jcfg, jm, jparams, tcfg, _, tparams = setup(arch, "float32", "pallas")
    gen = 4
    res = serve(tcfg, batch=B, prompt_len=S, gen=gen, seed=0, device="cpu", params=tparams)
    assert res["tokens"].shape == (B, gen) and res["device"] == "cpu"
    assert np.isfinite(res["prefill_logits"].numpy()).all()
    prompts = torch.randint(0, tcfg.vocab_size, (B, S),
                            generator=torch.Generator().manual_seed(1))
    logits, cache = jm.prefill(jparams, {"tokens": jnp.asarray(prompts.numpy(), jnp.int32)})
    cache = jax_pad_cache(cache, gen)
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    out = [np.asarray(tok)]
    step = jax_make_serve_step(jm)
    for i in range(gen - 1):
        tok, _, cache = step(jparams, cache, tok, jnp.int32(S + i))
        out.append(np.asarray(tok))
    assert np.array_equal(res["tokens"].numpy(), np.concatenate(out, axis=1))
    close(res["prefill_logits"], logits[:, -1], "float32")


def test_serve_cli_presets_and_abstract_cache():
    from repro_torch.launch.serve import PRESETS

    res = serve(PRESETS["tiny"], batch=1, prompt_len=8, gen=2, device="cpu")
    assert res["tokens"].shape == (1, 2)
    for arch in ARCHS:
        cfg = get_config(arch)
        cache = get_model(cfg, "cpu").abstract_cache(4, 2048)
        assert all(t.device.type == "meta" for t in cache.values())
        jcache = jax_get_model(jax_config(arch)).abstract_cache(4, 2048)
        assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for k, t in cache.items()} == {k: (t.shape, str(t.dtype))
                                               for k, t in jcache.items()}
    assert tuple(get_model(get_config("qwen3-1.7b"), "cpu").abstract_cache(4, 2048)["k"].shape) \
        == (28, 4, 2048, 8, 128)
    zamba = get_model(get_config("zamba2-2.7b"), "cpu").abstract_cache(4, 2048)
    assert tuple(zamba["h"].shape) == (9, 6, 4, 5120, 64)
    assert tuple(zamba["attn_k"].shape) == (9, 4, 2048, 32, 80)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ["stablelm-3b", "zamba2-2.7b"])
def test_prefill_at_head_dim_80_matches_the_reference(arch, impl, dtype):
    """The smoke configs with the published head_dim of 80 (the smoke
    variant's is 16): prefill logits and caches against the reference."""

    jcfg, jm, jparams, tcfg, tm, tparams = setup(arch, dtype, impl, head_dim=80)
    assert tcfg.head_dim_ == 80
    toks = tokens(S)
    jlogits, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tlogits, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks).long()})
    close(tlogits, jlogits, dtype)
    for key in jcache:
        close(tcache[key], jcache[key], dtype if key != "h" else "bfloat16")


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_hybrid_loss_fn_matches_the_reference(dtype):
    jcfg, jm, jparams, tcfg, tm, tparams = setup("zamba2-2.7b", dtype, "xla")
    toks = tokens(S + 1, seed=4)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1  # padding positions
    want = jm.loss_fn(jparams, {"tokens": jnp.asarray(toks[:, :-1]),
                                "labels": jnp.asarray(labels)})
    with torch.no_grad():
        got = tm.loss_fn(tparams, {"tokens": torch.from_numpy(toks[:, :-1].copy()).long(),
                                   "labels": torch.from_numpy(labels)})
    assert got.dtype == torch.float32 and got.dim() == 0
    close(got, want, dtype)


def test_hybrid_gradients_match_the_reference():
    """f32, ``remat="block"`` (each Mamba-2 layer recomputed): every
    leaf's gradient at atol/rtol 1e-4, as tests/test_torch_train.py."""

    jcfg, jm, jparams, tcfg, tm, _ = setup("zamba2-2.7b", "float32", "xla")
    assert tcfg.remat == "block"
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    toks = tokens(S + 1, seed=5)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(
        jparams, {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])})
    tparams.requires_grad_()
    loss = tm.loss_fn(tparams, {"tokens": torch.from_numpy(toks[:, :-1].copy()).long(),
                                "labels": torch.from_numpy(toks[:, 1:].copy()).long()})
    grads = torch.autograd.grad(loss, list(tparams.parameters()))
    close(loss.detach(), jloss, "float32")
    names = [n for n, _ in tparams.named_parameters()]
    e = tcfg.shared_attn_every
    for name, g in zip(names, grads):
        parts = name.split(".")
        if parts[0] == "layers":
            want = jgrads["mamba"][parts[2]][int(parts[1]) // e, int(parts[1]) % e]
        elif parts[0] == "shared":
            want = jgrads["shared"][parts[1]]
        else:
            want = jgrads[name]
        np.testing.assert_allclose(f32(g), f32(want), atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_hybrid_checkpoint_round_trip(dtype):
    """``tree_from_params(params_from_jax(tree))`` is the reference's tree,
    G x E stacking and the ``shared`` block included, bit for bit."""

    _, _, jparams, tcfg, _, _ = setup("zamba2-2.7b", dtype, "xla")
    tree = jax.tree.map(np.asarray, jparams)
    back = tree_from_params(params_from_jax(tcfg, tree, device="cpu"))
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.tree.map(lambda t: 0, back, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree.leaves(back, is_leaf=lambda t: isinstance(t, torch.Tensor))):
        assert str(b.dtype).removeprefix("torch.") == str(a.dtype), path
        bits = b.view(torch.int16) if b.dtype == torch.bfloat16 else b
        want = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        assert np.array_equal(bits.numpy(), want), path


def test_scan_kernel_refuses_a_state_for_several_tokens():
    """The reference's Pallas path drops a given state for S > 1 (its kernel
    starts from h = 0); the port raises instead."""

    _, _, _, tcfg, _, tparams = setup("falcon-mamba-7b", "float32", "pallas")
    _, tx = activations((B, 4, tcfg.d_model), "float32")
    _, state = TL.mamba1_block(tcfg, tparams.layers[0], tx)
    with pytest.raises(ValueError, match="h = 0"):
        TL.mamba1_block(tcfg, tparams.layers[0], tx[:, :2], state)
    torch_cfg = dataclasses.replace(tcfg, ssm_impl="torch")
    out, _ = TL.mamba1_block(torch_cfg, tparams.layers[0], tx[:, :2], state)
    assert out.shape == (B, 2, tcfg.d_model)
