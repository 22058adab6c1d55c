"""The port's training path (``loss_fn``, gradients, ``make_train_step``,
``launch.train``) against the reference's on the same weights and inputs.

Weights are drawn by the reference and carried to the port bit for bit by
``params_from_jax``; tokens come from NumPy.  The reference trains on its
XLA paths (``"xla"``), the port on its torch paths (``"torch"``): the
kernels of neither have a backward pass.

Tolerances: ``loss_fn`` at those of ``tests/test_torch_models.py`` (f32
1e-4, bf16 0.08); every leaf's gradient in f32 at atol/rtol 1e-4 (the two
frameworks sum in other orders); the port with ``remat="block"`` against
itself without at 1e-6; three train steps in f32 on ``loss`` and
``grad_norm`` at rtol 1e-5, ``lr`` at rtol 1e-6, and parameters at atol
1e-5 / rtol 1e-4 (lr 1e-3: Adam normalises each gradient, so an element's
update carries the gradients' relative error), at atol 1e-4 with gradient
compression on (a gradient within rounding of a half step of the
quantization grid rounds to the neighbouring step, which moves that
element's Adam update).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro_torch import optim as TO
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.models.convert import config_from_jax, params_from_jax, tree_from_params

ARCHS = ["qwen3-1.7b", "falcon-mamba-7b"]
TOL = {"float32": 1e-4, "bfloat16": 0.08}
B, S = 4, 16


def configs(arch: str, **kw):
    jcfg = dataclasses.replace(jax_smoke_config(arch), attention_impl="xla", ssm_impl="xla",
                               **kw)
    return jcfg, config_from_jax(jcfg)


@functools.lru_cache(maxsize=None)
def reference_params(arch: str, dtype: str):
    jcfg, _ = configs(arch, dtype=dtype)
    return jax_get_model(jcfg).init_params(jax.random.PRNGKey(0))


def port_params(arch: str, dtype: str, tcfg):
    return params_from_jax(tcfg, jax.tree.map(np.asarray, reference_params(arch, dtype)),
                           device="cpu")


def batch(seed: int, n: int = B, masked: bool = True):
    toks = np.random.default_rng(seed).integers(0, 256, (n, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if masked:
        labels[0, :3] = -1  # padding positions
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks[:, :-1].copy()), "labels": torch.from_numpy(labels)}
    return jb, tb


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def reference_leaf(tree: dict, name: str):
    """The reference leaf of a port parameter name (``layers.3.wq``; the
    hybrid's ``layers.3.in_proj`` is ``tree["mamba"]["in_proj"][3 // E, 3 %
    E]``, its ``shared.wq`` is ``tree["shared"]["wq"]``)."""

    parts = name.split(".")
    if parts[0] == "shared":
        return tree["shared"][parts[1]]
    if parts[0] == "layers" and "mamba" in tree:
        leaf = tree["mamba"][parts[2]]
        return leaf[divmod(int(parts[1]), leaf.shape[1])]
    if parts[0] == "layers":
        return tree["layers"][parts[2]][int(parts[1])]
    return tree[name]


def port_grads(tm, tp, tb) -> dict[str, torch.Tensor]:
    tp.requires_grad_()
    loss = tm.loss_fn(tp, tb)
    names = [n for n, _ in tp.named_parameters()]
    return dict(zip(names, torch.autograd.grad(loss, list(tp.parameters())))), loss


@pytest.fixture
def long_attention(monkeypatch):
    """Query-chunked attention at S = 16 in both packages (chunks of 4), so
    the port's checkpointed chunk body is on the gradient path."""

    monkeypatch.setattr(JL, "ATTN_DIRECT_MAX_SEQ", 8)
    monkeypatch.setattr(TL, "ATTN_DIRECT_MAX_SEQ", 8)
    monkeypatch.setattr(TL, "ATTN_Q_CHUNK", 4)
    with JL.attn_q_chunk(4):
        yield


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_agrees(arch, dtype):
    jcfg, tcfg = configs(arch, dtype=dtype)
    jb, tb = batch(0)
    want = jax_get_model(jcfg).loss_fn(reference_params(arch, dtype), jb)
    with torch.no_grad():
        got = get_model(tcfg, "cpu").loss_fn(port_params(arch, dtype, tcfg), tb)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype], rtol=TOL[dtype])


def test_cross_entropy_agrees_and_masks():
    jcfg, tcfg = configs("qwen3-1.7b")
    logits = np.random.default_rng(3).normal(0, 3, (2, 5, 256)).astype(np.float32)
    labels = np.array([[1, -1, 255, 7, -1], [0, 3, 3, -1, 9]], np.int32)
    want = JL.cross_entropy(jcfg, jnp.asarray(logits), jnp.asarray(labels))
    got = TL.cross_entropy(tcfg, torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-6)
    none = TL.cross_entropy(tcfg, torch.from_numpy(logits), torch.full((2, 5), -1))
    assert float(none) == 0.0


GRAD_CASES = [(arch, remat, False) for arch in ARCHS for remat in ("block", "none")] + [
    ("qwen3-1.7b", remat, True) for remat in ("block", "none")]  # chunking: dense only


@pytest.mark.parametrize("arch,remat,chunked", GRAD_CASES,
                         ids=lambda v: {True: "chunked", False: "direct"}.get(v, v))
def test_gradients_agree_in_f32(arch, remat, chunked, request):
    if chunked:
        request.getfixturevalue("long_attention")
    jcfg, tcfg = configs(arch, dtype="float32", remat=remat)
    jb, tb = batch(1)
    jloss, jgrads = jax.value_and_grad(jax_get_model(jcfg).loss_fn)(
        reference_params(arch, "float32"), jb)
    grads, loss = port_grads(get_model(tcfg, "cpu"), port_params(arch, "float32", tcfg), tb)
    np.testing.assert_allclose(f32(loss), f32(jloss), atol=1e-4, rtol=1e-4)
    for name, g in grads.items():
        want = reference_leaf(jgrads, name)
        assert g.shape == want.shape, name
        np.testing.assert_allclose(f32(g), f32(want), atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_gradient(arch, long_attention):
    out = {}
    for remat in ("block", "none"):
        _, tcfg = configs(arch, dtype="float32", remat=remat)
        _, tb = batch(2)
        out[remat] = port_grads(get_model(tcfg, "cpu"), port_params(arch, "float32", tcfg), tb)
    for name, g in out["block"][0].items():
        torch.testing.assert_close(g, out["none"][0][name], atol=1e-6, rtol=1e-6)


def test_checkpoint_runs_only_under_grad(monkeypatch, long_attention):
    """Serving (no grad) calls every body plainly; training recomputes the
    blocks, the query chunks and the scan chunks."""

    calls, seen = [], set()
    real = TL.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn.__name__)
        seen.add(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(TL, "checkpoint", counting)
    for arch in ARCHS:
        _, tcfg = configs(arch, dtype="float32")
        tm, tp = get_model(tcfg, "cpu"), port_params(arch, "float32", tcfg)
        _, tb = batch(0)
        with torch.inference_mode():
            tm.prefill(tp, {"tokens": tb["tokens"]})
        with torch.no_grad():
            tm.loss_fn(tp, tb)
        assert calls == []
        port_grads(tm, tp, tb)
        assert calls
        calls.clear()
    assert sorted(seen) == ["_attend_direct", "_block", "_layer", "_scan_chunk"]


VARIANTS = {"plain": {}, "compressed": {"compress": True}, "microbatch2": {"microbatch": 2}}
# the hybrid (zamba2 smoke: G = 2 groups of E = 2 layers) with compression,
# whose rows are groups of layers
STEP_CASES = [(arch, variant) for arch in ARCHS for variant in sorted(VARIANTS)] + [
    ("zamba2-2.7b", "compressed")]


@pytest.mark.parametrize("arch,variant", STEP_CASES)
def test_three_train_steps_agree(arch, variant):
    kw = dict(VARIANTS[variant])
    compress = kw.pop("compress", False)
    jcfg, tcfg = configs(arch, dtype="float32", **kw)
    jm, tm = jax_get_model(jcfg), get_model(tcfg, "cpu")
    jparams = reference_params(arch, "float32")
    tparams = port_params(arch, "float32", tcfg)
    jstep = jax.jit(jax_make_train_step(
        jm, JO.AdamWConfig(lr=1e-3, schedule=JO.linear_warmup_cosine(1, 3)),
        JO.CompressionConfig(enabled=compress)))
    tstep = make_train_step(
        tm, TO.AdamWConfig(lr=1e-3, schedule=TO.linear_warmup_cosine(1, 3)),
        TO.CompressionConfig(enabled=compress))
    jstate = JO.init_state(jparams)
    tstate = TO.init_state(dict(tparams.named_parameters()))
    for i in range(3):
        jb, tb = batch(10 + i, masked=False)
        jparams, jstate, jmet = jstep(jparams, jstate, jb)
        tparams, tstate, tmet = tstep(tparams, tstate, tb)
        for key, rtol in (("loss", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-6)):
            np.testing.assert_allclose(f32(tmet[key]), f32(jmet[key]), rtol=rtol,
                                       err_msg=f"{key} at step {i}")
    atol = 1e-4 if compress else 1e-5
    for name, t in tparams.named_parameters():
        np.testing.assert_allclose(f32(t), f32(reference_leaf(jparams, name)), atol=atol,
                                   rtol=1e-4, err_msg=name)
    assert int(tstate["step"]) == 3


@pytest.mark.parametrize("field", ["attention_impl", "ssm_impl"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_refuses_the_kernels(arch, field):
    cfg = dataclasses.replace(get_smoke_config(arch), attention_impl="torch", ssm_impl="torch")
    make_train_step(get_model(cfg, "cpu"))
    with pytest.raises(ValueError, match="no backward pass"):
        make_train_step(get_model(dataclasses.replace(cfg, **{field: "kernel"}), "cpu"))


def test_microbatch_must_divide_the_batch():
    _, tcfg = configs("qwen3-1.7b", dtype="float32", microbatch=3)
    tm = get_model(tcfg, "cpu")
    params = tm.init_params(0)
    _, tb = batch(0)
    with pytest.raises(ValueError, match="not divisible by microbatch"):
        make_train_step(tm)(params, TO.init_state(dict(params.named_parameters())), tb)


def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    args = ["--device", "cpu", "--preset", "tiny", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "10", "--log-every", "5"]
    train.main(args + ["--steps", "25"])
    out = capsys.readouterr().out
    assert "async saves: 3" in out and "resumed" not in out
    first = [float(line.split()[4]) for line in out.splitlines() if "] step" in line]
    assert first[-1] < first[0]
    train.main(args + ["--steps", "30", "--resume"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 25" in out
    assert "done: 5 steps" in out
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000010", "step_00000020", "step_00000025", "step_00000030"]


def test_cli_arch_trains_on_the_torch_paths(tmp_path, capsys):
    train.main(["--device", "cpu", "--arch", "falcon-mamba-7b", "--steps", "3", "--batch", "2",
                "--seq", "16", "--log-every", "1", "--compress-grads"])
    out = capsys.readouterr().out
    assert "attention_impl='torch', ssm_impl='torch'" in out
    assert out.count("] step") == 3


@pytest.mark.parametrize("arch,extra", [
    ("whisper-tiny", []), ("zamba2-2.7b", ["--compress-grads"]), ("internvl2-26b", []),
    ("moonshot-v1-16b-a3b", [])])
def test_cli_trains_every_family(arch, extra, tmp_path, capsys):
    """The encoder-decoder (frames), the hybrid (compressed by groups of
    layers), the VLM (patch embeddings) and the MoE train from the CLI at
    their smoke widths, with a checkpoint and a resume."""

    args = ["--device", "cpu", "--arch", arch, "--batch", "2", "--seq", "16",
            "--log-every", "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", *extra]
    train.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert out.count("] step") == 3
    losses = [float(line.split()[4]) for line in out.splitlines() if "] step" in line]
    assert all(np.isfinite(losses))
    train.main(args + ["--steps", "4", "--resume"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 3" in out and out.count("] step") == 1


def test_tree_from_params_is_the_reference_layout():
    for arch in ARCHS:
        _, tcfg = configs(arch, dtype="float32")
        jtree = reference_params(arch, "float32")
        tree = tree_from_params(port_params(arch, "float32", tcfg))
        assert jax.tree.structure(jax.tree.map(np.asarray, jtree)) == \
            jax.tree.structure(jax.tree.map(lambda t: t.numpy(), tree))
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jtree),
                                jax.tree.leaves(tree)):
            assert np.array_equal(np.asarray(a), b.numpy()), path
