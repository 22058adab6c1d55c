"""The MoE (moonshot-v1-16b-a3b, grok-1-314b), VLM (internvl2-26b) and
encoder-decoder (whisper-tiny) archs of the port against the reference's,
whole models on the same weights and inputs: configs, parameter trees,
prefill, decode, greedy serve, the loss and its gradients.

Weights are drawn by the reference and carried across by
``params_from_jax``; tokens, patch embeddings and frames come from numpy.
Tolerances are those of ``tests/test_torch_models.py``: f32 at 1e-4, bf16
at 0.08.
"""

import dataclasses

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
from repro.models.registry import input_specs as jax_input_specs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.serve import pad_cache, serve
from repro_torch.models import get_model
from repro_torch.models.convert import config_from_jax, params_from_jax, tree_from_params
from repro_torch.models.registry import input_specs
from test_torch_models import B, S, TOL, close, f32, setup, tokens

pytestmark = pytest.mark.slow  # interpret-mode Pallas runs, as tests/test_models_smoke.py

ARCHS = ["moonshot-v1-16b-a3b", "grok-1-314b", "internvl2-26b", "whisper-tiny"]


def extra_inputs(cfg, dtype: str, seed: int = 3) -> tuple[dict, dict]:
    """The VLM's patch embeddings or the encoder-decoder's frames, the same
    values for both packages (empty for the MoE)."""

    shape = {"vlm": (B, cfg.n_patches, cfg.d_model),
             "encdec": (B, cfg.n_frames, cfg.d_model)}.get(cfg.family)
    if shape is None:
        return {}, {}
    key = "patch_embeds" if cfg.family == "vlm" else "frames"
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return {key: jnp.asarray(x, dtype)}, {key: torch.from_numpy(x).to(getattr(torch, dtype))}


def batches(cfg, dtype: str, toks: np.ndarray) -> tuple[dict, dict]:
    jx, tx = extra_inputs(cfg, dtype)
    return (dict(jx, tokens=jnp.asarray(toks)),
            dict(tx, tokens=torch.from_numpy(np.ascontiguousarray(toks)).long()))


def reference_leaf(tree: dict, name: str):
    """The reference tree's leaf (or gradient) for a port parameter name."""

    parts = name.split(".")
    if len(parts) == 1:
        return tree[name]
    return tree[parts[0]][parts[2]][int(parts[1])]


# -- config and weights ---------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies(arch):
    for jcfg, tcfg in ((jax_config(arch), get_config(arch)),
                       (jax_smoke_config(arch), get_smoke_config(arch))):
        port = dataclasses.asdict(tcfg)
        ref = dataclasses.asdict(config_from_jax(jcfg))
        assert port == dict(ref, attention_impl="kernel", ssm_impl="kernel")
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_conversion_match(arch):
    jcfg, jm, jparams, tcfg, tm, tparams = setup(arch, "bfloat16", "xla")
    jspecs = jax.tree.map(lambda a: a.shape, jm.abstract_params(),
                          is_leaf=lambda a: isinstance(a, jax.ShapeDtypeStruct))
    assert tm.param_specs() == jspecs
    for name, t in tparams.named_parameters():
        want = reference_leaf(jparams, name)
        assert np.array_equal(f32(t), f32(want)), name
        assert str(t.dtype).removeprefix("torch.") == str(want.dtype)
    if tcfg.family == "moe":
        assert tuple(tparams.layers[1].w1.shape) == (tcfg.n_experts, tcfg.d_model, tcfg.d_ff)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trip(arch, dtype):
    """``tree_from_params(params_from_jax(tree))`` is the reference's tree
    (the MoE's (L, E, ...) expert leaves, the encoder and decoder stacks),
    bit for bit."""

    _, _, jparams, tcfg, _, _ = setup(arch, dtype, "xla")
    tree = jax.tree.map(np.asarray, jparams)
    back = tree_from_params(params_from_jax(tcfg, tree, device="cpu"))
    is_tensor = lambda t: isinstance(t, torch.Tensor)  # noqa: E731
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.tree.map(lambda t: 0, back, is_leaf=is_tensor))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree.leaves(back, is_leaf=is_tensor)):
        assert str(b.dtype).removeprefix("torch.") == str(a.dtype), path
        bits = b.view(torch.int16) if b.dtype == torch.bfloat16 else b
        want = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        assert np.array_equal(bits.numpy(), want), path


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_scales(arch):
    """The MoE router at 0.02 like the embeddings; the encoder-decoder's
    norm scales 1, norm biases 0 and every weight at 0.02 (no depth
    scaling)."""

    cfg = get_smoke_config(arch)
    params = get_model(cfg, "cpu").init_params(0)
    again = get_model(cfg, "cpu").init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), again.parameters()))
    assert abs(params.tok_emb.float().std().item() - 0.02) < 2e-3
    if cfg.family == "moe":
        assert abs(params.layers[0].router.float().std().item() - 0.02) < 4e-3
        assert params.layers[0].w1.float().std().item() < 0.012  # 0.02 / sqrt(2 L)
    if cfg.family == "encdec":
        for name, t in params.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("_b"):
                assert torch.equal(t.float(), torch.zeros(t.shape)), name
            elif "norm" in leaf:
                assert torch.equal(t.float(), torch.ones(t.shape)), name
        assert abs(params.decoder[1].cross_wk.float().std().item() - 0.02) < 4e-3


def test_abstract_cache_and_input_specs():
    """Each arch's published config: the cache's and the inputs' shapes as
    the reference's (tokens are int64 in the port)."""

    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_config(arch)
        cache = get_model(cfg, "cpu").abstract_cache(4, 448)
        jcache = jax_get_model(jcfg).abstract_cache(4, 448)
        assert all(t.device.type == "meta" for t in cache.values())
        assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for k, t in cache.items()} == {k: (t.shape, str(t.dtype))
                                               for k, t in jcache.items()}
        for kind in ("train", "prefill", "decode"):
            specs, jspecs = input_specs(cfg, kind, 4, 448), jax_input_specs(jcfg, kind, 4, 448)
            assert {k: tuple(t.shape) for k, t in specs.items()} == \
                {k: t.shape for k, t in jspecs.items()}
            for key in ("patch_embeds", "frames"):
                if key in specs:
                    assert str(specs[key].dtype).removeprefix("torch.") == \
                        str(jspecs[key].dtype)
    whisper = get_model(get_config("whisper-tiny"), "cpu").abstract_cache(4, 448)
    assert tuple(whisper["cross_k"].shape) == (4, 4, 1500, 6, 64)
    with pytest.raises(ValueError):
        input_specs(get_config("whisper-tiny"), "score", 1, 1)


# -- whole models ---------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_match_the_reference(arch, impl, dtype):
    jcfg, jm, jparams, tcfg, tm, tparams = setup(arch, dtype, impl)
    toks = tokens(S + 1)
    jb, tb = batches(tcfg, dtype, toks[:, :S])
    jlogits, jcache = jm.prefill(jparams, jb)
    with torch.no_grad():
        tlogits, tcache = tm.prefill(tparams, tb)
    assert tlogits.shape == jlogits.shape == (B, 1, jcfg.padded_vocab)
    assert tlogits.dtype == getattr(torch, dtype)
    close(tlogits, jlogits, dtype)
    assert sorted(tcache) == sorted(jcache)
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape
        close(tcache[key], jcache[key], dtype)

    jcache, tcache = jax_pad_cache(jcache, 1), pad_cache(tcache, 1)
    jstep, _ = jm.decode_step(jparams, jcache, jnp.asarray(toks[:, S:]), jnp.int32(S))
    with torch.no_grad():
        tstep, _ = tm.decode_step(tparams, tcache, torch.from_numpy(toks[:, S:]).long(), S)
    close(tstep, jstep, dtype)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, impl):
    """prefill(tokens[:-1]) + decode_step(tokens[-1]) == prefill(tokens) at
    the last position, in f32 (8 tokens).  The MoE runs at
    ``moe_group_size=1``: a decode step routes groups of one token, and at
    any larger group a prefill may drop choices past capacity that decode
    keeps, so only there do the two route alike.  The VLM's patches take
    the first 4 positions of both prompts; the encoder-decoder's frames
    feed both."""

    cfg = dataclasses.replace(get_smoke_config(arch), attention_impl=impl, dtype="float32")
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_group_size=1)
    m = get_model(cfg, "cpu")
    params = m.init_params(0)
    _, extra = extra_inputs(cfg, "float32")
    toks = torch.from_numpy(tokens(8)).long()
    with torch.no_grad():
        full, _ = m.prefill(params, dict(extra, tokens=toks))
        _, cache = m.prefill(params, dict(extra, tokens=toks[:, :-1]))
        step, _ = m.decode_step(params, pad_cache(cache, 1), toks[:, -1:], 7)
    np.testing.assert_allclose(f32(step)[:, 0], f32(full)[:, 0], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_end_to_end_matches_reference_greedy_decode(arch):
    """``serve(device="cpu")`` in f32 on the reference's weights, with seeded
    patch embeddings or frames, gives the tokens of the reference's own
    prefill + greedy serve steps on the same prompts and inputs."""

    jcfg, jm, jparams, tcfg, _, tparams = setup(arch, "float32", "pallas")
    gen = 4
    jx, tx = extra_inputs(tcfg, "float32", seed=8)
    res = serve(tcfg, batch=B, prompt_len=S, gen=gen, seed=0, device="cpu", params=tparams,
                **tx)
    assert res["tokens"].shape == (B, gen) and res["device"] == "cpu"
    prompts = torch.randint(0, tcfg.vocab_size, (B, S),
                            generator=torch.Generator().manual_seed(1))
    logits, cache = jm.prefill(jparams, dict(jx, tokens=jnp.asarray(prompts.numpy(), jnp.int32)))
    cache = jax_pad_cache(cache, gen)
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    out = [np.asarray(tok)]
    step = jax_make_serve_step(jm)
    for i in range(gen - 1):
        tok, _, cache = step(jparams, cache, tok, jnp.int32(S + i))
        out.append(np.asarray(tok))
    assert np.array_equal(res["tokens"].numpy(), np.concatenate(out, axis=1))
    close(res["prefill_logits"], logits[:, -1], "float32")


@pytest.mark.parametrize("arch", ["internvl2-26b", "whisper-tiny"])
def test_serve_fills_zero_inputs_as_the_reference_launcher(arch):
    """Without patch embeddings or frames, ``serve`` feeds zeros in the
    model dtype, as the reference's serve launcher does."""

    _, _, _, tcfg, _, tparams = setup(arch, "float32", "xla")
    res = serve(tcfg, batch=B, prompt_len=S, gen=2, device="cpu", params=tparams)
    key = "patch_embeds" if tcfg.family == "vlm" else "frames"
    n = tcfg.n_patches if tcfg.family == "vlm" else tcfg.n_frames
    zeros = serve(tcfg, batch=B, prompt_len=S, gen=2, device="cpu", params=tparams,
                  **{key: torch.zeros(B, n, tcfg.d_model)})
    assert torch.equal(res["tokens"], zeros["tokens"])
    assert torch.equal(res["prefill_logits"], zeros["prefill_logits"])


def test_vlm_needs_its_patches():
    m = get_model(get_smoke_config("internvl2-26b"), "cpu")
    params = m.init_params(0)
    with pytest.raises(ValueError, match="patch_embeds"):
        m.prefill(params, {"tokens": torch.zeros(1, 8, dtype=torch.long)})


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_the_reference(arch, dtype):
    jcfg, jm, jparams, tcfg, tm, tparams = setup(arch, dtype, "xla")
    toks = tokens(S + 1, seed=4)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1  # padding positions
    jb, tb = batches(tcfg, dtype, toks[:, :-1])
    want = jm.loss_fn(jparams, dict(jb, labels=jnp.asarray(labels)))
    with torch.no_grad():
        got = tm.loss_fn(tparams, dict(tb, labels=torch.from_numpy(labels)))
    assert got.dtype == torch.float32 and got.dim() == 0
    close(got, want, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_the_reference(arch):
    """f32, ``remat="block"`` (each block recomputed): every leaf's gradient
    at atol/rtol 1e-4, the MoE's router and expert leaves among them."""

    jcfg, jm, jparams, tcfg, tm, _ = setup(arch, "float32", "xla")
    assert tcfg.remat == "block"
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    toks = tokens(S + 1, seed=5)
    jb, tb = batches(tcfg, "float32", toks[:, :-1])
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(
        jparams, dict(jb, labels=jnp.asarray(toks[:, 1:])))
    tparams.requires_grad_()
    loss = tm.loss_fn(tparams, dict(tb, labels=torch.from_numpy(toks[:, 1:].copy()).long()))
    grads = torch.autograd.grad(loss, list(tparams.parameters()))
    close(loss.detach(), jloss, "float32")
    for (name, _), g in zip(tparams.named_parameters(), grads):
        np.testing.assert_allclose(f32(g), f32(reference_leaf(jgrads, name)), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
