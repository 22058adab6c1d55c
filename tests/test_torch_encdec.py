"""The port's encoder-decoder pieces (``repro_torch.models.encdec``,
``layers.layer_norm``, cross attention) against the reference's
(``repro.models.encdec``) on the same weights and inputs, at the
tolerances of ``tests/test_torch_models.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serve import pad_cache as jax_pad_cache
from repro.models import encdec as JE
from repro.models import layers as JL
from repro_torch.launch.serve import pad_cache
from repro_torch.models import get_model
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from test_torch_models import B, S, TOL, activations, close, f32, setup, tokens

pytestmark = pytest.mark.slow  # interpret-mode Pallas runs, as tests/test_models_smoke.py

ARCH = "whisper-tiny"


def frames(cfg, dtype: str, seed: int = 2):
    return activations((B, cfg.n_frames, cfg.d_model), dtype, seed=seed)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_layer_norm(dtype):
    """In f32 with the population variance, scale and bias applied in f32;
    rows of a large mean, as the residual stream carries."""

    rng = np.random.default_rng(1)
    x = (rng.normal(size=(B, S, 64)) * 3 + 5).astype(np.float32)
    scale, bias = (rng.normal(size=64).astype(np.float32) for _ in range(2))
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    tdt = getattr(torch, dtype)
    got = TL.layer_norm(tx, torch.from_numpy(scale).to(tdt), torch.from_numpy(bias).to(tdt),
                        1e-5)
    want = JL.layer_norm(jx, jnp.asarray(scale, dtype), jnp.asarray(bias, dtype), 1e-5)
    assert got.dtype == tdt
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_cross_attention(impl, dtype):
    """Decoder queries over the encoder's projected keys and values (12
    frames against 16 tokens): no mask, the direct path under both impls."""

    jcfg, _, jparams, tcfg, _, tparams = setup(ARCH, dtype, impl)
    jw = {k[len("cross_"):]: v[1] for k, v in jparams["decoder"].items()
          if k.startswith("cross_")}
    tw = TE._sub(tparams.decoder[1], "cross_")
    jx, tx = activations((B, S, jcfg.d_model), dtype)
    je, te = frames(jcfg, dtype)
    jk, jv = (jnp.einsum("btd,dhk->bthk", je, jw[n]) for n in ("wk", "wv"))
    tk, tv = (TL._matmul(te, getattr(tw, n)) for n in ("wk", "wv"))
    close(tk, jk, dtype)
    jout, jnone = JL.attention(jcfg, jw, jx, positions=jnp.arange(S), cross_kv=(jk, jv))
    tout, tnone = TL.attention(tcfg, tw, tx, positions=torch.arange(S), cross_kv=(tk, tv))
    assert jnone is None and tnone is None
    close(tout, jout, dtype)


def test_sinusoids_are_the_references():
    """The prefill table (NumPy, f64 cast to f32) bit for bit; the decode
    row (computed in f32) to f32 rounding, at positions across the text
    context."""

    for length, dim in ((1500, 384), (448, 384), (12, 64)):
        assert np.array_equal(TE._sinusoid(length, dim), JE._sinusoid(length, dim))
    for pos in (0, 1, 15, 415, 447):
        np.testing.assert_allclose(TE._sinusoid_at(pos, 384, torch.device("cpu")).numpy(),
                                   np.asarray(JE._sinusoid_at(jnp.int32(pos), 384)),
                                   atol=2e-6, rtol=0)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_encoder_matches_the_reference(impl, dtype):
    """The encoder stack over the frames: sinusoids, non-causal self
    attention (the kernel's plain version under ``"kernel"``), GELU MLP,
    the final LayerNorm."""

    jcfg, _, jparams, tcfg, _, tparams = setup(ARCH, dtype, impl)
    je, te = frames(jcfg, dtype)
    close(TE.encode(tcfg, tparams, te), JE.encode(jcfg, jparams, je), dtype)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_decode_matches_forward_with_the_cross_cache_untouched(impl):
    """prefill(tokens[:-1]) + decode_step(tokens[-1]) == prefill(tokens) at
    the last position; ``pad_cache`` grows the self-attention cache by one
    slot and leaves the cross cache (over the frames) as it was, as the
    reference's ``pad_cache`` does."""

    jcfg, _, _, tcfg, _, tparams = setup(ARCH, "float32", "pallas")
    m = get_model(dataclasses.replace(tcfg, attention_impl=impl), "cpu")
    _, te = frames(jcfg, "float32")
    toks = torch.from_numpy(tokens(8)).long()
    with torch.no_grad():
        full, _ = m.prefill(tparams, {"tokens": toks, "frames": te})
        _, cache = m.prefill(tparams, {"tokens": toks[:, :-1], "frames": te})
        padded = pad_cache(cache, 1)
        jpadded = jax_pad_cache({k: jnp.asarray(v.numpy()) for k, v in cache.items()}, 1)
        for key in cache:
            assert tuple(padded[key].shape) == jpadded[key].shape
        assert padded["cross_k"] is cache["cross_k"] and padded["cross_v"] is cache["cross_v"]
        assert padded["k"].shape[2] == cache["k"].shape[2] + 1
        cross = padded["cross_k"].clone()
        step, after = m.decode_step(tparams, padded, toks[:, -1:], 7)
    assert torch.equal(after["cross_k"], cross)
    np.testing.assert_allclose(f32(step)[:, 0], f32(full)[:, 0], atol=1e-4, rtol=1e-4)
