"""The port's fault-tolerance state machines against the reference's:
``HostState``, ``HeartbeatTable``, ``ElasticPlan`` and the
``FaultToleranceController``'s action sequences, driven by the same
seeded scripts of registrations, heartbeats, clock steps and ticks.
Tolerance 0: the same verdicts, actions and topologies, step for step."""

import dataclasses

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # fall back to the deterministic stand-in
    from _hypothesis_fallback import given, settings, st

import repro.distributed.fault_tolerance as R
import repro_torch.distributed.fault_tolerance as P


def _script(seed: int, hosts: int, steps: int):
    """A seeded script: per step, a clock advance and each host's chance
    to heartbeat (with or without a step duration, some of them slow)."""

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        dt = float(rng.choice([0.5, 1.0, 2.5, 7.0], p=[0.4, 0.3, 0.2, 0.1]))
        beats = []
        for h in range(hosts):
            u = rng.uniform()
            if u < 0.15:
                continue  # silent this step
            slow = 4.0 if h == seed % hosts and rng.uniform() < 0.7 else 1.0
            beats.append((h, None if u < 0.3 else float(slow * rng.uniform(0.9, 1.1))))
        out.append((dt, beats))
    return out


def _drive(mod, seed: int, hosts: int, steps: int, pods: int, model: int):
    """Run the script through one implementation; returns every
    observable per step."""

    now = [0.0]
    table = mod.HeartbeatTable(timeout=5.0, straggler_factor=1.5, clock=lambda: now[0],
                               step_window=16)
    for h in range(hosts):
        table.register(h)
    ctl = mod.FaultToleranceController(
        table, mod.Topology(pods=pods, data=hosts // (pods * model), model=model))
    trail = []
    for dt, beats in _script(seed, hosts, steps):
        now[0] += dt
        for h, step in beats:
            table.heartbeat(h, step)
        try:
            actions = [(a.kind, a.detail) for a in ctl.tick()]
        except RuntimeError as e:
            actions = [("raised", str(e))]
        trail.append((
            actions, dataclasses.asdict(ctl.topo), table.dead_hosts(), table.stragglers(),
            {h: (s.alive, s.last_heartbeat, list(s.step_durations))
             for h, s in table.hosts.items()},
        ))
    return trail


@pytest.mark.parametrize("hosts,pods,model", [(8, 1, 1), (8, 2, 1), (12, 2, 2), (6, 1, 3)])
@pytest.mark.parametrize("seed", range(5))
def test_controller_action_sequences_equal_reference(seed, hosts, pods, model):
    got = _drive(P, seed, hosts, 40, pods, model)
    want = _drive(R, seed, hosts, 40, pods, model)
    assert got == want
    kinds = {a[0] for step in got for a in step[0]}
    assert kinds  # the script does make the controller act


def test_scripts_cover_every_action_kind():
    kinds = set()
    for seed in range(5):
        for hosts, pods, model in ((8, 1, 1), (8, 2, 1), (12, 2, 2), (6, 1, 3)):
            kinds |= {a[0] for step in _drive(P, seed, hosts, 40, pods, model)
                      for a in step[0]}
    assert {"restart_from_checkpoint", "rejoin", "steal_shard"} <= kinds


@pytest.mark.parametrize("window,init", [(8, None), (4, [1.0, 2.0, 3.0]), (2, (5.0,))])
def test_host_state_equals_reference(window, init):
    a = P.HostState(0, 0.0, window=window, step_durations=None if init is None else list(init))
    b = R.HostState(0, 0.0, window=window, step_durations=None if init is None else list(init))
    for i in range(20):
        a.record_step(float(i))
        b.record_step(float(i))
    assert list(a.step_durations) == list(b.step_durations)
    assert a.step_durations.maxlen == b.step_durations.maxlen == window


def test_revival_and_history_equal_reference():
    out = []
    for mod in (P, R):
        now = [0.0]
        t = mod.HeartbeatTable(timeout=1.0, clock=lambda: now[0])
        t.register(0)
        t.register(1)
        for _ in range(5):
            t.heartbeat(0, 0.25)
        now[0] = 10.0
        t.heartbeat(1)
        dead = t.dead_hosts()
        t.heartbeat(0)
        out.append((dead, t.dead_hosts(), t.hosts[0].alive, list(t.hosts[0].step_durations)))
    assert out[0] == out[1] == ([0], [], True, [0.25] * 5)


@settings(max_examples=100, deadline=None)
@given(
    pods=st.integers(1, 4),
    data=st.integers(1, 6),
    model=st.integers(1, 4),
    seed=st.integers(0, 10_000),
)
def test_replan_idempotent_and_equal_to_reference(pods, data, model, seed):
    """Over random (topology, dead-set) pairs: the port's replan equals the
    reference's, and is a pure, idempotent function of the complete dead
    set, anchored at the original topology."""

    topo = P.Topology(pods=pods, data=data, model=model)
    plan = P.ElasticPlan(topo)
    ref = R.ElasticPlan(R.Topology(pods=pods, data=data, model=model))
    rng = np.random.default_rng(seed)
    n = topo.n_hosts
    dead = sorted(int(h) for h in rng.choice(n, size=int(rng.integers(0, n)), replace=False))
    assert plan.dead_replicas(dead) == ref.dead_replicas(dead)
    if len(plan.dead_replicas(dead)) >= pods * data:
        for p in (plan, ref):
            with pytest.raises(RuntimeError):
                p.replan(dead)
        return
    t1 = plan.replan(dead)
    assert dataclasses.asdict(t1) == dataclasses.asdict(ref.replan(dead))
    assert plan.replan(dead) == t1  # idempotent
    plan.replan(dead[: len(dead) // 2])
    assert plan.replan(dead) == t1  # anchored: never rebased
    assert t1.pods * t1.data == pods * data - len(plan.dead_replicas(dead))
    assert t1.model == model
    assert plan.replan([]) == topo
    assert (t1.n_hosts, t1.global_batch_shards()) == (
        ref.replan(dead).n_hosts, ref.replan(dead).global_batch_shards())
