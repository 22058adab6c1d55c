"""The port's user entry points (``examples_torch/``) against the
reference's scripts (``examples/``) on the CPU.

Each reference script is loaded by path and run unedited; where it needs
a smaller size or its results, names in its module namespace are swapped
for recording or cutting wrappers (never its code).  Held:

* ``quickstart``, ``fleet_sim``, ``service_failover`` and
  ``elastic_recovery`` print the reference's lines exactly, and both
  equal the committed texts under ``tests/golden_torch/examples/`` that
  ``chip_smoke.py`` holds the card's output to;
* ``batched_replay`` at 20,000 requests: the trace field for field, both
  index backends' results equal to the reference's ``IONodeSimulator``,
  and the reference's lines with the wall times masked;
* ``serve_batched`` on the reference's weights and prompts (carried over
  by ``params_from_jax``): the generated tokens equal; where a bf16
  near-tie flips a token, the reference's margin between the two tokens
  and the logits up to the flip within the bf16 serve tolerance of
  ``tests/test_torch_models.py`` (0.08);
* ``train_checkpointed`` at 80 steps (the smallest run that saves in phase
  1) on the reference's initial weights: every step's loss through the
  learning-rate warmup within the f32 loss tolerance of
  ``tests/test_torch_train.py`` (1e-4); past it, each step's within twice
  the spread that a one-ulp nudge of one initial weight makes in the
  reference's own losses (measured in the same test, see ``NUDGE_FACTOR``)
  and the mean loss of each 20 steps (the logging cadence) within 2 %; the
  resume at step 40, the reference's lines with the numbers masked, and
  the loss falling.  The port's restore, resumed with a cold optimizer from
  the reference's own step-40 checkpoint, gives steps 40-49 within 1e-4;
* every script but the host-only ``elastic_recovery`` refuses to run
  without a card unless ``--device cpu`` is passed.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import IONodeSimulator as RefSimulator
from repro.core import compute_stream_scores as ref_scores
from repro.core.workloads import GiB
from repro_torch.configs import get_smoke_config
from repro_torch.models.convert import config_from_jax, params_from_jax

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden_torch" / "examples"
HOST_EXAMPLES = ("quickstart", "fleet_sim", "service_failover", "elastic_recovery")
CARD_EXAMPLES = ("quickstart", "fleet_sim", "service_failover", "batched_replay",
                 "serve_batched", "train_checkpointed")
SERVE_TOL = 0.08  # tests/test_torch_models.py, bf16
LOSS_TOL = 1e-4  # tests/test_torch_train.py, f32 loss_fn
# After the warmup the two frameworks' f32 trajectories part: Adam turns
# gradient elements that cancel to rounding into full-size steps, so a
# spiky step's loss can differ by a few percent.  The reference's own
# losses part as far when the first element of its first initial weight
# (final_norm's scale) is moved by one ulp, so the test runs that too and
# holds each step past the warmup within NUDGE_FACTOR times the largest
# relative spread the nudge makes in the same phase (before the crash,
# after the resume).  The 20-step means are held within 2 %.
NUDGE_FACTOR = 2
TRAIN_DRIFT = 2e-2
TRAIN_WARMUP = 10  # the examples' linear_warmup_cosine(10, steps)
RESUMED_STEPS = 10  # steps run from the reference's step-40 checkpoint


def load(path: pathlib.Path) -> types.ModuleType:
    name = "_".join(path.relative_to(REPO).with_suffix("").parts)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference(name: str) -> types.ModuleType:
    return load(REPO / "examples" / f"{name}.py")


def port(name: str) -> types.ModuleType:
    return load(REPO / "examples_torch" / f"{name}.py")


def stdout_of(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


class _Shim:
    """A module stand-in: ``over``'s names, the rest from ``real``."""

    def __init__(self, real, **over):
        self._real = real
        self.__dict__.update(over)

    def __getattr__(self, key):
        return getattr(self._real, key)


@pytest.mark.parametrize("name", HOST_EXAMPLES)
def test_stdout_equals_the_reference_and_the_golden_text(name):
    _, want = stdout_of(reference(name).main)
    assert want == (GOLDEN / f"{name}.txt").read_text()
    argv = [] if name == "elastic_recovery" else ["--device", "cpu"]
    out, got = stdout_of(port(name).main, argv)
    assert got.splitlines() == want.splitlines()
    assert isinstance(out, dict)


def test_quickstart_routes_on_the_kernel_scores():
    out, _ = stdout_of(port("quickstart").main, ["--device", "cpu"])
    assert len(out["routed"]) == len(out["scores"]) == 32
    assert [r.percentage for r in out["routed"]] == out["scores"].percentage.tolist()


def test_fleet_sim_scores_each_run_once(monkeypatch):
    import repro_torch.core.fleet as fleet

    calls = []
    real = fleet._score_shards_kernel
    monkeypatch.setattr(fleet, "_score_shards_kernel",
                        lambda *a: calls.append(len(a[0])) or real(*a))
    out, _ = stdout_of(port("fleet_sim").main, ["--device", "cpu"])
    assert out["fleet_runs"] == 7 and calls == [4, 4, 4, 2, 2, 2, 2]


def test_batched_replay_equals_the_reference_at_20000_requests():
    n = 20_000
    ref = reference("batched_replay")
    ref_trace = ref.make_trace
    ref.make_trace = lambda requests, seed=0: ref_trace(n if requests == 1_000_000 else requests,
                                                         seed)
    _, want = stdout_of(ref.main)
    out, got = stdout_of(port("batched_replay").main, ["--device", "cpu", "--requests", str(n)])

    batch = ref_trace(n)
    assert set(dataclasses.asdict(batch)) == set(dataclasses.asdict(out["batch"]))
    for field, col in dataclasses.asdict(batch).items():
        mine = getattr(out["batch"], field)
        assert mine.dtype == col.dtype and np.array_equal(mine, col), field
    scores = ref_scores(batch)
    for backend in ("numpy", "avl"):
        want_res = RefSimulator(scheme="ssdup+", ssd_capacity=8 * GiB,
                                index_backend=backend).run(batch, scores=scores)
        assert dataclasses.asdict(out["results"][backend]) == dataclasses.asdict(want_res)

    def masked(text):
        return re.sub(r"replay +[0-9.]+ s", "replay <wall> s", text).splitlines()

    want = want.replace("1,000,000 requests", f"{n:,} requests", 1)
    assert masked(got) == masked(want)


def _reference_serve(arch: str):
    """The reference's ``serve(arch)``, run unedited, with its jitted steps
    and its final ``np.concatenate`` recorded: (weights, prompts, tokens,
    each step's last-position logits, printed line)."""

    ref = reference("serve_batched")
    seen = {"logits": []}

    def jit(fn, **kw):
        compiled = jax.jit(fn, **kw)

        def call(*args):
            out = compiled(*args)
            seen["logits"].append(np.asarray(out[0 if len(out) == 2 else 1][:, -1, :],
                                             np.float32))
            return out

        return call

    def concatenate(arrays, axis):
        seen["tokens"] = np.concatenate(arrays, axis=axis)
        return seen["tokens"]

    ref.jax = _Shim(jax, jit=jit)
    ref.np = _Shim(np, concatenate=concatenate)
    _, line = stdout_of(ref.serve, arch)
    cfg = ref.get_smoke_config(arch)
    params = ref.get_model(cfg).init_params(jax.random.PRNGKey(0))
    prompts = jax.random.randint(jax.random.PRNGKey(1), (ref.BATCH, ref.PROMPT), 0,
                                 cfg.vocab_size)
    return cfg, params, np.array(prompts), seen["tokens"], np.stack(seen["logits"], 1), line


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "falcon-mamba-7b"])
def test_serve_batched_generates_the_reference_tokens(arch, record_property):
    jcfg, jparams, prompts, want, want_logits, want_line = _reference_serve(arch)
    tcfg = get_smoke_config(arch)
    # the reference serves on its XLA paths, the port on its kernels
    assert (tcfg.attention_impl, tcfg.ssm_impl) == ("kernel", "kernel")
    assert config_from_jax(jcfg) == dataclasses.replace(tcfg, attention_impl="torch",
                                                        ssm_impl="torch")
    params = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    mod = port("serve_batched")
    out, line = stdout_of(mod.serve, arch, "cpu", params, torch.from_numpy(prompts).long())
    got, got_logits = out["tokens"].numpy(), out["logits"].numpy()
    assert got.shape == want.shape == (mod.BATCH, mod.GEN)

    def masked(text):
        return re.sub(r"in +[0-9.]+s", "in <wall>s", text)

    margins = []
    for b in range(mod.BATCH):
        flips = np.flatnonzero(got[b] != want[b])
        upto = flips[0] + 1 if flips.size else mod.GEN  # the steps fed the same tokens
        np.testing.assert_allclose(got_logits[b, :upto], want_logits[b, :upto],
                                   atol=SERVE_TOL, rtol=SERVE_TOL, err_msg=f"row {b}")
        if flips.size:
            t = flips[0]
            margin = want_logits[b, t, want[b, t]] - want_logits[b, t, got[b, t]]
            margins.append(float(margin))
            assert 0 <= margin <= SERVE_TOL, (b, t, margin)
    record_property("flipped_rows", len(margins))
    record_property("flip_margins", margins)
    if not margins:
        assert masked(line) == masked(want_line)


# The reference's train_checkpointed.py run unedited in a child process, its
# jitted step wrapped to record every step's loss; one thread, as the port's.
# With the argument "nudge", the first element of its first initial weight
# is moved up by one ulp.
_REFERENCE_TRAIN = r"""
import importlib.util, json, sys
import jax
import numpy as np

path = sys.argv[1]
spec = importlib.util.spec_from_file_location("reference_train", path)
ref = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ref)
losses, real_jit = [], jax.jit


class Shim:
    def __init__(self, real, **over):
        self._real = real
        self.__dict__.update(over)

    def __getattr__(self, key):
        return getattr(self._real, key)


def jit(fn, **kw):
    compiled = real_jit(fn, **kw)

    def call(*args):
        out = compiled(*args)
        losses.append(float(out[2]["loss"]))
        return out

    return call


ref.jax = Shim(jax, jit=jit)
if sys.argv[2:] == ["nudge"]:
    real_get_model = ref.get_model

    def get_model(cfg):
        model = real_get_model(cfg)

        def init_params(key):
            leaves, tree = jax.tree.flatten(model.init_params(key))
            first = np.array(leaves[0])
            first.flat[0] = np.nextafter(first.flat[0], first.dtype.type(np.inf))
            leaves[0] = jax.numpy.asarray(first)
            return jax.tree.unflatten(tree, leaves)

        return Shim(model, init_params=init_params)

    ref.get_model = get_model
sys.argv = [path, "--steps", "80"]
ref.main()
print("LOSSES " + json.dumps(losses))
"""
ONE_THREAD = {"XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
              "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _start_reference_train(tmp_path: pathlib.Path, *extra: str) -> subprocess.Popen:
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH=str(REPO / "src"), **ONE_THREAD)
    return subprocess.Popen([sys.executable, "-c", _REFERENCE_TRAIN,
                             str(REPO / "examples" / "train_checkpointed.py"), *extra],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _reference_losses(child: subprocess.Popen) -> tuple[str, list[float]]:
    out, err = child.communicate(timeout=600)
    assert child.returncode == 0, err[-4000:]
    out, losses = out.rsplit("LOSSES ", 1)
    return out, json.loads(losses)


def test_train_checkpointed_follows_the_reference_and_resumes(tmp_path, record_property):
    for d in ("ref", "nudged", "port", "resume"):
        (tmp_path / d).mkdir()
    child = _start_reference_train(tmp_path / "ref")
    nudged_child = _start_reference_train(tmp_path / "nudged", "nudge")
    ref = reference("train_checkpointed")
    mod = port("train_checkpointed")
    cfg = mod.PRESETS["tiny"]
    jparams = ref.get_model(ref.PRESETS["tiny"]).init_params(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # beside the children, and the other test workers
    try:
        out, got = stdout_of(mod.train, 80, "cpu", params, str(tmp_path / "port"))
        want, want_losses = _reference_losses(child)
        _, nudged = _reference_losses(nudged_child)
        assert len(want_losses) == len(nudged) == 80

        # the port's restore and cold-optimizer resume from the reference's
        # own step-40 checkpoint, into the cosine part of the schedule
        (ref_root,) = (tmp_path / "ref").glob("ckpt_example_*")
        shutil.copytree(ref_root / "step_00000040", tmp_path / "resume" / "step_00000040")
        dev = mod.resolve_device("cpu")
        model = mod.get_model(cfg, dev)
        ckpt = mod.Checkpointer(mod.TieredCheckpointStore(str(tmp_path / "resume")))
        start, restored = mod.restore(ckpt, model, cfg, dev)
        resumed = {}
        stdout_of(mod.train_segment, model, restored,
                  mod.init_state(dict(restored.named_parameters())), mod.make_loader(cfg),
                  ckpt, start, start + RESUMED_STEPS, 80, resumed)
        ckpt.close()
    finally:
        torch.set_num_threads(threads)
        for c in (child, nudged_child):
            c.kill()  # a no-op where it has ended
    assert start == 40 and sorted(resumed) == list(range(40, 40 + RESUMED_STEPS))
    np.testing.assert_allclose([resumed[s] for s in sorted(resumed)],
                               want_losses[40:40 + RESUMED_STEPS], rtol=LOSS_TOL, atol=LOSS_TOL)

    assert out["resumed_at"] == 40 and "  resumed at step 40" in got.splitlines()
    got_losses = [out["losses"][step] for step in range(80)]
    np.testing.assert_allclose(got_losses[:TRAIN_WARMUP], want_losses[:TRAIN_WARMUP],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    spread = np.abs(np.subtract(nudged, want_losses)) / np.abs(want_losses)
    drift = np.abs(np.subtract(got_losses, want_losses)) / np.abs(want_losses)
    record_property("nudge_spread", spread.tolist())
    record_property("port_drift", drift.tolist())
    for phase in (slice(TRAIN_WARMUP, 40), slice(40, 80)):  # before the crash, after
        assert drift[phase].max() <= NUDGE_FACTOR * spread[phase].max(), (
            phase, drift[phase].max(), spread[phase].max())
    np.testing.assert_allclose(np.reshape(got_losses, (4, 20)).mean(1),
                               np.reshape(want_losses, (4, 20)).mean(1), rtol=TRAIN_DRIFT)
    assert got_losses[-1] < got_losses[0] and math.isfinite(out["final_loss"])
    assert sorted(p.name for p in (tmp_path / "port").glob("step_*")) == ["step_00000040",
                                                                          "step_00000080"]

    def shape(text):  # the lines, numbers and the checkpoint directory masked
        return [re.sub(r"[0-9.]+", "#", line.split(" in ")[0]) for line in text.splitlines()]

    assert shape(got) == shape(want)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", CARD_EXAMPLES)
def test_examples_run_on_the_card_unless_told(name, no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        port(name).main([])


def test_elastic_recovery_takes_no_device():
    with pytest.raises(SystemExit):
        port("elastic_recovery").main(["--device", "cpu"])


def test_script_runs_as_main(tmp_path):
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, str(REPO / "examples_torch" / "fleet_sim.py"),
                           "--device", "cpu"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout == (GOLDEN / "fleet_sim.txt").read_text()
