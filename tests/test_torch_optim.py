"""The port's optimizer substrate (``repro_torch.optim``) against the
reference's (``repro.optim``) on the same inputs, made with NumPy.

Tolerances: the schedules agree to 1e-6 relative (a few f32 ulps: the two
frameworks' ``cos`` differ in the last bit); ``encode``/``decode`` and
``compress_tree`` outside ``jit`` are bit-identical (same f32 operations
in the same order); ``apply_updates`` against the reference's jitted step
agrees to 1e-6 in f32 (XLA contracts ``b1 * m + (1 - b1) * g`` into one
rounding, torch rounds twice: an f32 ulp a step) and to one bf16 ulp
(rtol 2**-7) with bf16 parameters, where such an ulp can round the other
way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as J
from repro_torch import optim as T

SHAPES = {"emb": (16, 8), "layers/wq": (2, 8, 4, 2), "norm": (33,)}


def tree(seed: int, scale: float = 1.0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, scale, s).astype(np.float32) for k, s in SHAPES.items()}


def to_jax(t: dict, dtype=jnp.float32) -> dict:
    return {k: jnp.asarray(v, dtype) for k, v in t.items()}


def to_torch(t: dict, dtype=torch.float32) -> dict:
    # a copy: ``apply_updates`` writes the port's leaves in place, and JAX on
    # the CPU may read the same NumPy buffer for its own, asynchronously
    return {k: torch.from_numpy(v.copy()).to(dtype) for k, v in t.items()}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


SCHEDULES = {
    "constant": (J.constant(), T.constant()),
    "warmup_cosine": (J.linear_warmup_cosine(5, 40), T.linear_warmup_cosine(5, 40)),
    "warmup_cosine_final": (J.linear_warmup_cosine(0, 7, final_frac=0.3),
                            T.linear_warmup_cosine(0, 7, final_frac=0.3)),
    "inverse_sqrt": (J.inverse_sqrt(7), T.inverse_sqrt(7)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_agree_in_f32(name):
    jfn, tfn = SCHEDULES[name]
    for step in range(51):
        want = jfn(jnp.int32(step))
        got = tfn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-6, atol=0, err_msg=str(step))


def _with_ties(bits: int, seed: int) -> np.ndarray:
    """Rows whose max is qmax, so the scale is exactly 1 and x.5 values
    are exact ties of ``round``, mixed with random values."""

    qmax = (1 << (bits - 1)) - 1
    rng = np.random.default_rng(seed)
    x = rng.normal(0, qmax / 3, (6, 10)).astype(np.float32)
    x[:, 0] = qmax
    x[:, 1:8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, qmax - 0.5], np.float32)
    x[5] = 0.0  # an all-zero row: the 1e-12 floor of the scale
    return x


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(6, 10), (60,), (3, 2, 10)])
def test_encode_decode_bit_identical(bits, shape):
    x = _with_ties(bits, bits).reshape(shape)
    jq, js = J.encode(jnp.asarray(x), bits)
    tq, ts = T.encode(torch.from_numpy(x), bits)
    assert tq.dtype == torch.int8 and tq.shape == x.shape
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(T.decode(tq, ts).numpy(), np.asarray(J.decode(jq, js)))
    if x.ndim == 2:  # half to even on the exact ties
        assert tq[0, 1:7].tolist() == [0, 2, 2, 0, -2, -2]


def test_encode_refuses_other_widths():
    with pytest.raises(ValueError, match="bits"):
        T.encode(torch.zeros(4), 3)


@pytest.mark.parametrize("feedback", [True, False])
def test_compress_tree_agrees(feedback):
    g = tree(1, 1e-3)
    err = tree(2, 1e-5)
    jcfg = J.CompressionConfig(enabled=True, error_feedback=feedback)
    tcfg = T.CompressionConfig(enabled=True, error_feedback=feedback)
    for j_err, t_err in ((None, None), (to_jax(err), to_torch(err))):
        jd, je = J.compress_tree(to_jax(g), j_err, jcfg)
        td, te = T.compress_tree(to_torch(g), t_err, tcfg)
        for k in SHAPES:
            assert np.array_equal(td[k].numpy(), np.asarray(jd[k])), k
            assert np.array_equal(te[k].numpy(), np.asarray(je[k])), k
    off = T.CompressionConfig(enabled=False)
    same, none = T.compress_tree(to_torch(g), None, off)
    assert none is None and all(torch.equal(same[k], torch.from_numpy(g[k])) for k in g)
    assert all(torch.equal(e, torch.zeros(SHAPES[k])) for k, e in T.init_error(to_torch(g)).items())


def test_global_norm_and_clip_agree():
    g = tree(3, 2.0)
    jn = J.global_norm(to_jax(g))
    tn = T.global_norm(to_torch(g))
    np.testing.assert_allclose(f32(tn), f32(jn), rtol=1e-6)
    jc, _ = J.clip_by_global_norm(to_jax(g), 1.0)
    tc, tn2 = T.clip_by_global_norm(to_torch(g), 1.0)
    assert torch.equal(tn2, tn)
    for k in SHAPES:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("schedule", [None, "warmup_cosine"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_agrees(dtype, schedule):
    p, g = tree(4), tree(5, 0.5)
    jsch, tsch = SCHEDULES[schedule] if schedule else (None, None)
    jcfg = J.AdamWConfig(lr=1e-2, schedule=jsch)
    tcfg = T.AdamWConfig(lr=1e-2, schedule=tsch)
    jp, jg = to_jax(p, getattr(jnp, dtype)), to_jax(g, getattr(jnp, dtype))
    tp, tg = to_torch(p, getattr(torch, dtype)), to_torch(g, getattr(torch, dtype))
    js, ts = J.init_state(jp), T.init_state(tp)
    step = jax.jit(lambda p, g, s: J.apply_updates(jcfg, p, g, s))
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=2 ** -7, atol=0)
    for i in range(4):
        jp, js, jm = step(jp, jg, js)
        tp, ts, tm = T.apply_updates(tcfg, tp, tg, ts)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        np.testing.assert_allclose(f32(tm["grad_norm"]), f32(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(f32(tm["lr"]), f32(jm["lr"]), rtol=1e-6)
        for k in SHAPES:
            assert tp[k].dtype == getattr(torch, dtype)
            np.testing.assert_allclose(f32(tp[k]), f32(jp[k]), **tol, err_msg=f"{k} step {i}")
            for mom in ("m", "v"):
                assert ts[mom][k].dtype == torch.float32
                np.testing.assert_allclose(f32(ts[mom][k]), f32(js[mom][k]), rtol=1e-6,
                                           atol=1e-9)
