"""The port's runtime sanitizer (``repro_torch.analysis.sanitize``): the
cases of ``tests/test_sanitize.py`` on the port — enablement plumbing,
the golden fixture matrix bit-exact with every invariant armed, purity —
and its seeded bugs, each injected the same way into both packages, where
both must raise the same error with the same message.  The FTL ledger
leak and the device engine's NaN have their port tests in
``test_torch_ftl.py`` and ``test_torch_engine_device.py``."""

import dataclasses
import types

import numpy as np
import pytest

import repro.analysis.sanitize as ref_sanitize
import repro.core as ref_core
import repro.core.fleet as ref_fleet
import repro.core.simulator as ref_simulator
import repro.service as ref_service
from repro_torch.analysis import SanitizerError, sanitizing
from repro_torch.analysis import sanitize as sanitize_mod
from repro_torch.core import IONodeSimulator, TraceBatch, ior, relabel
from repro_torch.core.fleet import FleetSimulator
from repro_torch.core.simulator import _ReplayState
from repro_torch.core.workloads import MiB
from repro_torch.service import BurstBufferService
from repro_torch.testing import golden

# the two packages, as the seeded bugs see them; the port runs on the CPU
REFERENCE = types.SimpleNamespace(
    IONodeSimulator=ref_core.IONodeSimulator, FleetSimulator=ref_fleet.FleetSimulator,
    ReplayState=ref_simulator._ReplayState, TraceBatch=ref_core.TraceBatch,
    BurstBufferService=ref_service.BurstBufferService, ior=ref_core.ior,
    relabel=ref_core.relabel, SanitizerError=ref_sanitize.SanitizerError, kw={},
)
PORT = types.SimpleNamespace(
    IONodeSimulator=IONodeSimulator, FleetSimulator=FleetSimulator,
    ReplayState=_ReplayState, TraceBatch=TraceBatch,
    BurstBufferService=BurstBufferService, ior=ior, relabel=relabel,
    SanitizerError=SanitizerError, kw={"device": "cpu"},
)
PACKAGES = {"reference": REFERENCE, "port": PORT}


def small_batch(pkg=PORT, seed: int = 0, total: int = 32 * MiB):
    items = list(
        pkg.relabel(pkg.ior("segmented-random", 8, total_bytes=total, seed=seed),
                    app_id=0, file_id=0).trace
    )
    return pkg.TraceBatch.from_items(items)


def same_error(run, match: str, error: str = "SanitizerError") -> str:
    """``run(pkg)`` raises ``error`` in both packages, with one message."""

    messages = {}
    for name, pkg in PACKAGES.items():
        exc = getattr(pkg, error) if error == "SanitizerError" else ValueError
        with pytest.raises(exc, match=match) as info:
            run(pkg)
        messages[name] = str(info.value)
    assert messages["port"] == messages["reference"]
    return messages["port"]


# -- enablement plumbing -------------------------------------------------


class TestEnablement:
    def test_default_off(self, monkeypatch):
        monkeypatch.delenv(sanitize_mod.ENV_VAR, raising=False)
        assert not sanitize_mod.enabled()

    @pytest.mark.parametrize("value", ["1", "true", "YES", " on "])
    def test_env_var_truthy(self, monkeypatch, value):
        monkeypatch.setenv(sanitize_mod.ENV_VAR, value)
        assert sanitize_mod.enabled()

    def test_env_var_falsy(self, monkeypatch):
        monkeypatch.setenv(sanitize_mod.ENV_VAR, "0")
        assert not sanitize_mod.enabled()

    def test_context_overrides_env(self, monkeypatch):
        monkeypatch.setenv(sanitize_mod.ENV_VAR, "1")
        with sanitizing(False):
            assert not sanitize_mod.enabled()
        assert sanitize_mod.enabled()

    def test_context_nests_and_restores(self):
        with sanitizing():
            assert sanitize_mod.enabled()
            with sanitizing(False):
                assert not sanitize_mod.enabled()
            assert sanitize_mod.enabled()
        assert not sanitize_mod.enabled()

    def test_explicit_arg_beats_override(self):
        with sanitizing():
            assert not IONodeSimulator(sanitize=False, device="cpu").sanitize
        assert IONodeSimulator(sanitize=True, device="cpu").sanitize
        assert not IONodeSimulator(device="cpu").sanitize

    def test_check_raises_with_formatting(self):
        sanitize_mod.check(True, "never raised")
        with pytest.raises(SanitizerError, match="got 3"):
            sanitize_mod.check(False, "got %d", 3)


def test_switch_is_the_ports_own(monkeypatch):
    """The port's override and the reference's are separate switches; the
    environment variable is one name for both."""

    monkeypatch.delenv(sanitize_mod.ENV_VAR, raising=False)
    assert sanitize_mod.ENV_VAR == ref_sanitize.ENV_VAR
    with sanitizing():
        assert sanitize_mod.enabled() and not ref_sanitize.enabled()
    with ref_sanitize.sanitizing():
        assert ref_sanitize.enabled() and not sanitize_mod.enabled()


# -- the smoke test: golden matrix bit-exact with checks armed -----------


class TestGoldenMatrixSanitized:
    @pytest.mark.parametrize(
        "scheme", golden.FIXTURE_SCHEMES, ids=str
    )
    def test_fixture_replay_bit_exact_under_sanitize(self, scheme):
        for workload in golden.FIXTURE_WORKLOADS:
            for policy in golden.FIXTURE_POLICIES:
                path = golden.fixture_path(scheme, workload, policy)
                payload = golden.load_fixture(path)
                with sanitizing():
                    result = golden.replay_fixture(payload, device="cpu")
                diffs = golden.check_fixture(payload, result)
                assert diffs == [], diffs[0]


class TestSanitizeIsPure:
    @pytest.mark.parametrize("scheme", ["orangefs-bb", "ssdup+"])
    def test_results_identical_with_and_without(self, scheme):
        batch = small_batch()
        base = IONodeSimulator(
            scheme=scheme, ssd_capacity=8 * MiB, device="cpu"
        ).run(batch)
        san = IONodeSimulator(
            scheme=scheme, ssd_capacity=8 * MiB, sanitize=True, device="cpu"
        ).run(batch)
        ref = REFERENCE.IONodeSimulator(
            scheme=scheme, ssd_capacity=8 * MiB, sanitize=True
        ).run(small_batch(REFERENCE))
        for f in dataclasses.fields(base):
            assert getattr(base, f.name) == getattr(san, f.name), f.name
            assert getattr(san, f.name) == getattr(ref, f.name), f.name


# -- seeded bugs: every wired layer must catch its violation class, with
# the reference's message -------------------------------------------------


class TestCatchesInjectedBugs:
    def test_backwards_clock_caught(self, monkeypatch):
        def warp(impl):
            def warped(self, st, *args, **kwargs):
                before = st.clock
                impl(self, st, *args, **kwargs)
                st.clock = before - 1.0  # simulated accounting bug
            return warped

        for pkg in PACKAGES.values():
            monkeypatch.setattr(pkg.IONodeSimulator, "_replay_stream_impl",
                                warp(pkg.IONodeSimulator._replay_stream_impl))
        same_error(lambda pkg: pkg.IONodeSimulator(
            scheme="ssdup+", sanitize=True, **pkg.kw).run(small_batch(pkg)), "backwards")

    def test_score_trace_mismatch_caught(self):
        def run(pkg):
            sim = pkg.IONodeSimulator(scheme="ssdup+", sanitize=True, **pkg.kw)
            sim._replay_stream(
                pkg.ReplayState(),
                np.array([0], dtype=np.int64),
                np.array([1024], dtype=np.int64),
                np.array([0], dtype=np.int64),
                nbytes=4096,  # wrong: scores from a different trace
                pct=0.5, seeks=1, dist=0,
            )

        same_error(run, "disagrees")

    def test_negative_gap_caught(self):
        def run(pkg):
            sim = pkg.IONodeSimulator(scheme="ssdup+", sanitize=True, **pkg.kw)
            sim.begin_session()
            sim.feed_gap(-1.0)

        same_error(run, "non-negative")

    def test_invalid_trace_rejected(self):
        def run(pkg):
            batch = small_batch(pkg)
            bad = dataclasses.replace(batch, sizes=batch.sizes * np.int64(-1))
            pkg.IONodeSimulator(scheme="orangefs", sanitize=True, **pkg.kw).run(bad)

        same_error(run, "negative request size", error="ValueError")

    def test_fleet_shard_loss_caught(self, monkeypatch):
        def lossy(self, batch):
            assignment = np.arange(batch.num_requests, dtype=np.int64) % 2
            shard0, shard1 = batch.shard(assignment, 2)
            return [shard0, shard1.shard(  # silently drop node 1's work
                np.full(shard1.num_requests, 1, dtype=np.int64), 2)[0]]

        for pkg in PACKAGES.values():
            monkeypatch.setattr(pkg.FleetSimulator, "shard", lossy)
        same_error(lambda pkg: pkg.FleetSimulator(
            num_nodes=2, scheme="orangefs", sanitize=True, **pkg.kw).run(small_batch(pkg)),
            "sharding dropped")

    def test_service_ledger_violation_caught(self, monkeypatch):
        def tamper(original):
            def tampered(self, sim, res, outstanding, metrics):
                original(self, sim, res, outstanding, metrics)
                metrics.written_ssd_bytes += 4096  # phantom SSD bytes
            return tampered

        for pkg in PACKAGES.values():
            monkeypatch.setattr(pkg.BurstBufferService, "_account_session",
                                tamper(pkg.BurstBufferService._account_session))
        same_error(lambda pkg: pkg.BurstBufferService(
            scheme="ssdup+", num_nodes=2, sanitize=True, **pkg.kw).run(small_batch(pkg)),
            "ledger")
        # without sanitize the same bug sails through silently (the
        # violation is still *recorded*, proving the ledger math saw it)
        result = BurstBufferService(scheme="ssdup+", num_nodes=2, device="cpu").run(small_batch())
        assert result.metrics.conservation_violations()
