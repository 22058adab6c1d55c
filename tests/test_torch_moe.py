"""The port's MoE layer (``repro_torch.models.layers.moe_mlp``) against the
reference's on the same weights and inputs: the output within the
tolerances of ``tests/test_torch_models.py`` and the routing (expert
indices, capacity slots, the kept choices) equal exactly.

The reference does not return its routing, so :func:`reference_routing`
recomputes it with the reference's own operations (``repro/models/
layers.py::moe_mlp``, from the router product to the capacity positions).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL
from test_torch_models import B, S, TOL, activations, close, jax_layer, setup

pytestmark = pytest.mark.slow  # interpret-mode Pallas runs, as tests/test_models_smoke.py

MOE_ARCHS = ["moonshot-v1-16b-a3b", "grok-1-314b"]


def reference_routing(cfg, w, x):
    """(expert indices, capacity positions, cap) of the reference's
    ``moe_mlp`` over ``x``, by its own operations."""

    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    g = min(cfg.moe_group_size, s)
    ng = s // g
    cap = max(int(np.ceil(g * k / e * cfg.capacity_factor)), 1)
    logits = jnp.einsum("bngd,de->bnge", x.reshape(b, ng, g, d), w["router"],
                        preferred_element_type=jnp.float32)
    _, gate_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.float32)
    flat = onehot.reshape(b, ng, g * k, e)
    pos_in_expert = (jnp.cumsum(flat, axis=2) - flat).reshape(b, ng, g, k, e)
    slot = jnp.sum(pos_in_expert * onehot, axis=-1).astype(jnp.int32)
    return np.asarray(gate_idx), np.asarray(slot), cap


def held(jcfg, tcfg, jw, tw, jx, tx, dtype):
    """The port's output within the tolerance of the reference's and the
    routing equal; returns the port's (gate_idx, slot, cap)."""

    close(TL.moe_mlp(tcfg, tw, tx), JL.moe_mlp(jcfg, jw, jx), dtype)
    _, idx, slot, cap = TL.moe_routing(tcfg, tw, tx)
    want_idx, want_slot, want_cap = reference_routing(jcfg, jw, jx)
    assert cap == want_cap
    assert np.array_equal(idx.numpy(), want_idx)
    assert np.array_equal(slot.numpy(), want_slot)
    assert np.array_equal((slot < cap).numpy(), want_slot < want_cap)
    return idx, slot, cap


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mlp_and_routing_match_the_reference(arch, impl, dtype):
    """moonshot's smoke config (4 experts, top 2 of them, SwiGLU) and
    grok's, over two routing groups of 16 tokens."""

    jcfg, _, jparams, tcfg, _, tparams = setup(arch, dtype, impl)
    jx, tx = activations((B, 2 * S, jcfg.d_model), dtype)
    _, slot, cap = held(jcfg, tcfg, jax_layer(jparams, 1), tparams.layers[1], jx, tx, dtype)
    assert slot.shape == (B, 2, S, tcfg.experts_per_token)
    assert cap == 10  # ceil(16 * 2 / 4 * 1.25)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_ties_go_to_the_lower_expert(dtype):
    """An all-zero row ties every expert (as a zero patch embedding after
    ``rms_norm`` does): both packages take experts 0 and 1, in that order,
    as ``jax.lax.top_k`` does."""

    jcfg, _, jparams, tcfg, _, tparams = setup("moonshot-v1-16b-a3b", dtype, "xla")
    x = np.random.default_rng(3).normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    x[:, ::3] = 0
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    idx, _, _ = held(jcfg, tcfg, jax_layer(jparams), tparams.layers[0], jx, tx, dtype)
    zero_rows = idx.reshape(B, S, -1)[:, ::3]
    assert torch.equal(zero_rows, torch.arange(2).expand_as(zero_rows))


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_choices_past_capacity_are_dropped_as_the_reference_drops_them(dtype):
    """``capacity_factor`` 0.5 leaves 4 slots an expert for 32 choices a
    group: choices are dropped, the same ones in both packages, and a
    token whose choices are all dropped gets a zero MoE output."""

    jcfg, _, jparams, tcfg, _, tparams = setup("moonshot-v1-16b-a3b", dtype, "xla")
    jcfg = dataclasses.replace(jcfg, capacity_factor=0.5)
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.5)
    jx, tx = activations((B, S, jcfg.d_model), dtype, seed=4)
    idx, slot, cap = held(jcfg, tcfg, jax_layer(jparams), tparams.layers[0], jx, tx, dtype)
    assert cap == 4
    kept = slot < cap
    assert int((~kept).sum()) > 0
    per_expert = [int(((idx == e) & kept).sum(dim=(2, 3)).max()) for e in range(4)]
    assert max(per_expert) == cap
    out = TL.moe_mlp(tcfg, tparams.layers[0], tx).reshape(B, 1, S, -1)
    dropped = ~kept.any(dim=-1)
    assert bool(dropped.any()) and bool((out[dropped] == 0).all())


def test_group_size_must_divide_the_sequence():
    jcfg, _, jparams, tcfg, _, tparams = setup("moonshot-v1-16b-a3b", "float32", "xla")
    jx, tx = activations((B, 24, jcfg.d_model), "float32")  # groups of 16
    with pytest.raises(ValueError, match="not divisible by moe group"):
        JL.moe_mlp(jcfg, jax_layer(jparams), jx)
    with pytest.raises(ValueError, match="not divisible by moe group"):
        TL.moe_mlp(tcfg, tparams.layers[0], tx)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_one_token_groups_route_as_decode(dtype):
    """``moe_group_size=1`` (the decode step's grouping, and the one at
    which decode against forward holds): one slot an expert, no choice
    dropped."""

    jcfg, _, jparams, tcfg, _, tparams = setup("moonshot-v1-16b-a3b", dtype, "xla")
    jcfg = dataclasses.replace(jcfg, moe_group_size=1)
    tcfg = dataclasses.replace(tcfg, moe_group_size=1)
    jx, tx = activations((B, S, jcfg.d_model), dtype, seed=5)
    _, slot, cap = held(jcfg, tcfg, jax_layer(jparams), tparams.layers[0], jx, tx, dtype)
    assert cap == 1 and bool((slot == 0).all())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_gradients_match_the_reference(arch):
    """f32: the gradient of a scalar of the MoE output with respect to the
    input, the router and the expert weights, at atol/rtol 1e-4."""

    jcfg, _, jparams, tcfg, _, tparams = setup(arch, "float32", "xla")
    x = np.random.default_rng(6).normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    jw = jax_layer(jparams, 1)
    names = ["router", "w1", "w2", "w3"]

    def jloss(x, *leaves):
        w = dict(jw, **dict(zip(names, leaves)))
        return jnp.sum(JL.moe_mlp(jcfg, w, x) ** 2)

    want = jax.grad(jloss, argnums=tuple(range(5)))(jnp.asarray(x), *(jw[n] for n in names))
    tw = tparams.layers[1]
    tx = torch.from_numpy(x).requires_grad_()
    leaves = [getattr(tw, n) for n in names]
    for t in leaves:
        t.requires_grad_()
    try:
        got = torch.autograd.grad(torch.sum(TL.moe_mlp(tcfg, tw, tx) ** 2), [tx, *leaves])
    finally:
        for t in leaves:
            t.requires_grad_(False)
    for name, a, b in zip(["x", *names], got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4, err_msg=name)
