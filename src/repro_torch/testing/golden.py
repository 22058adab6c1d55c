"""Golden fixtures: write, replay and compare them.

A fixture (``tests/golden/<scheme>__<workload>__<policy>__batched.json``)
pins one 4-node fleet replay of the batched NumPy engine: the trace is
rebuilt from :mod:`repro_torch.testing.traces` and checked against the
stored fingerprint, the expected ``FleetResult`` is stored field by
field, and ``device_tolerance`` holds the tiers a device replay is held
to (``field -> [rtol, atol]``, ``[0, 0]`` = exact).  The anomaly fixture
(``anomaly_16n_straggler.json``) stores one literal 512-request shard and
its expected results under four scheme/gate settings.

Divergences are reported in causal order (routing before bytes before
flush counts before clocks), so the first line names the causally earliest
field.  Python floats round-trip exactly through JSON, so a fixture
compares bit for bit.

The writer half (:func:`make_fixture`, :func:`generate_all`, ``--write
DIR``) runs the port's batched engine (``FleetSimulator``, on ``device``)
and writes into the directory its caller names; ``--check`` replays the
committed fixtures.  Run it as ``python -m repro_torch.testing.golden``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
from typing import Sequence

from ..analysis import sanitize as _sanitize
from ..core.fleet import FleetResult, FleetSimulator
from ..core.simulator import SimResult
from ..core.trace import TraceBatch
from .traces import golden_trace, trace_fingerprint

SCHEMA = "golden-fixture/v1"

# repo-root/tests/golden (this file lives at src/repro_torch/testing/)
GOLDEN_DIR = pathlib.Path(__file__).resolve().parents[3] / "tests" / "golden"
ANOMALY_FIXTURE = GOLDEN_DIR / "anomaly_16n_straggler.json"

CAUSAL_FIELD_ORDER = (
    "scheme",
    "total_bytes",
    "per_app_bytes",
    "bytes_to_ssd",
    "bytes_to_hdd_direct",
    "metadata_bytes",
    "flushes",
    "peak_ssd_occupancy",
    "blocked_seconds",
    "flush_paused_seconds",
    "io_seconds",
    "total_seconds",
)

FIXTURE_SCHEMES = ("orangefs", "orangefs-bb", "ssdup", "ssdup+")
FIXTURE_WORKLOADS = ("mixed-burst", "strided-gaps")
FIXTURE_POLICIES = ("range-offset", "round-robin-app")
FIXTURE_NODES = 4

#: Routing and byte fields the device engine reproduces exactly for the
#: orangefs/ssdup/ssdup+ schemes (plain BB's split is timing-coupled).
ROUTING_FIELDS = ("total_bytes", "bytes_to_ssd", "bytes_to_hdd_direct",
                  "flushes", "peak_ssd_occupancy")

#: The anomaly fixture's expected runs: ``(key, scheme, flush_gate)``.
ANOMALY_RUNS = (
    ("orangefs", "orangefs", 0.5),
    ("ssdup+_gate0.5", "ssdup+", 0.5),
    ("ssdup+_gate0.75", "ssdup+", 0.75),
    ("ssdup+_gate-device", "ssdup+", "device"),
)


class GoldenTraceMismatch(AssertionError):
    """The rebuilt trace does not match the fixture's fingerprint: the trace
    protocol drifted (RNG stream, workload generator), not the engine."""


class GoldenStorageMismatch(AssertionError):
    """The replay's storage-model configuration is not the one the fixture
    was recorded under, so comparing results would be meaningless."""


def sim_result_to_dict(r: SimResult) -> dict:
    return {
        "scheme": r.scheme,
        "total_bytes": int(r.total_bytes),
        "per_app_bytes": {str(k): int(v)
                          for k, v in sorted(r.per_app_bytes.items())},
        "bytes_to_ssd": int(r.bytes_to_ssd),
        "bytes_to_hdd_direct": int(r.bytes_to_hdd_direct),
        "metadata_bytes": int(r.metadata_bytes),
        "flushes": int(r.flushes),
        "peak_ssd_occupancy": int(r.peak_ssd_occupancy),
        "blocked_seconds": float(r.blocked_seconds),
        "flush_paused_seconds": float(r.flush_paused_seconds),
        "io_seconds": float(r.io_seconds),
        "total_seconds": float(r.total_seconds),
    }


def fleet_result_to_dict(fr: FleetResult) -> dict:
    return {
        "scheme": fr.scheme,
        "policy": fr.policy,
        "num_nodes": int(fr.num_nodes),
        "nodes": [sim_result_to_dict(r) for r in fr.node_results],
    }


def _normalize(field: str, value):
    if field == "per_app_bytes":
        return {str(k): int(v) for k, v in dict(value).items()}
    return value


def _within(e, a, rtol: float, atol: float) -> bool:
    """One value within ``max(rtol*|e|, atol)``; dicts compare per key."""

    if isinstance(e, dict) or isinstance(a, dict):
        if not isinstance(e, dict) or not isinstance(a, dict):
            return False
        if e.keys() != a.keys():
            return False
        return all(_within(e[k], a[k], rtol, atol) for k in e)
    if isinstance(e, str) or isinstance(a, str):
        return e == a
    return abs(a - e) <= max(rtol * abs(e), atol)


def _field_matches(field: str, e, a, tolerances) -> bool:
    """Exact unless ``tolerances`` carries a tier for this field."""

    if not tolerances or field not in tolerances:
        return e == a
    rtol, atol = tolerances[field]
    return _within(e, a, float(rtol), float(atol))


def diff_sim(expected: dict, actual: dict, prefix: str = "",
             tolerances: dict | None = None) -> list[str]:
    """All diverging SimResult fields, causally ordered."""

    out = []
    for field in CAUSAL_FIELD_ORDER:
        e = _normalize(field, expected[field])
        a = _normalize(field, actual[field])
        if not _field_matches(field, e, a, tolerances):
            out.append(f"{prefix}{field}: expected {e!r}, got {a!r}")
    return out


def diff_fleet(expected: dict, actual: dict,
               tolerances: dict | None = None) -> list[str]:
    """Diverging fields across a fleet snapshot, field-major, causally
    ordered."""

    out = []
    for field in ("scheme", "policy", "num_nodes"):
        if expected[field] != actual[field]:
            out.append(f"{field}: expected {expected[field]!r}, "
                       f"got {actual[field]!r}")
    exp_nodes, act_nodes = expected["nodes"], actual["nodes"]
    if len(exp_nodes) != len(act_nodes):
        out.append(f"nodes: expected {len(exp_nodes)} results, "
                   f"got {len(act_nodes)}")
        return out
    for field in CAUSAL_FIELD_ORDER:
        for i, (e, a) in enumerate(zip(exp_nodes, act_nodes)):
            ef, af = _normalize(field, e[field]), _normalize(field, a[field])
            if not _field_matches(field, ef, af, tolerances):
                out.append(f"node[{i}].{field}: expected {ef!r}, got {af!r}")
    return out


def first_divergence(expected: dict, actual: dict) -> str | None:
    """The causally first diverging field of a fleet snapshot, or None."""

    diffs = diff_fleet(expected, actual)
    return diffs[0] if diffs else None


def diff_routing(expected: dict, actual: dict) -> list[str]:
    """Per-node divergences of :data:`ROUTING_FIELDS`, held exactly."""

    return [
        f"node[{i}].{f}: expected {e[f]}, got {a[f]}"
        for i, (e, a) in enumerate(zip(expected["nodes"], actual["nodes"]))
        for f in ROUTING_FIELDS if e[f] != a[f]
    ]


def fixture_name(scheme: str, workload: str, policy: str,
                 engine: str = "batched") -> str:
    return f"{scheme}__{workload}__{policy}__{engine}.json"


def fixture_path(scheme: str, workload: str, policy: str,
                 engine: str = "batched",
                 directory: pathlib.Path | None = None) -> pathlib.Path:
    return (directory or GOLDEN_DIR) / fixture_name(scheme, workload, policy, engine)


def _node_capacity(total_bytes: int) -> int:
    """The fixtures' per-node SSD capacity: half the per-node share of the
    trace, which forces region swaps, writer blocking and eager flushes."""

    return total_bytes // FIXTURE_NODES // 2


def load_fixture(path: pathlib.Path) -> dict:
    with open(path) as f:
        payload = json.load(f)
    if payload.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: schema {payload.get('schema')!r}, expected {SCHEMA!r}"
        )
    return payload


def check_fixture(payload: dict, result: FleetResult,
                  tolerances: dict | None = None) -> list[str]:
    """Causally ordered divergences of ``result`` vs the stored snapshot;
    pass ``tolerances=payload["device_tolerance"]`` for a device replay."""

    return diff_fleet(payload["result"], fleet_result_to_dict(result),
                      tolerances=tolerances)


def load_anomaly_fixture() -> tuple[dict, TraceBatch]:
    """The anomaly fixture's payload and its literal shard."""

    with open(ANOMALY_FIXTURE) as f:
        payload = json.load(f)
    t = payload["trace"]
    return payload, TraceBatch.from_numpy(
        offsets=t["offsets"], sizes=t["sizes"], file_ids=t["file_ids"],
        app_ids=t["app_ids"],
    )


def device_tolerance_metadata() -> dict[str, list[float]]:
    """The device engine's tolerance table, JSON-shaped, as every fixture
    embeds it."""

    from ..core.engine_device import DEVICE_TOLERANCES

    return {f: [float(r), float(a)] for f, (r, a) in DEVICE_TOLERANCES.items()}


def storage_model_metadata(ssd=None, capacity: int = 0) -> dict:
    """Config fingerprint of the storage model a replay would use."""

    from ..core.device_model import make_storage_model

    return dict(make_storage_model(ssd, logical_bytes=capacity).config_fingerprint())


def _run(batch: TraceBatch, scheme: str, policy: str, engine: str,
         index_backend: str = "numpy", ssd=None, device=None) -> FleetResult:
    return FleetSimulator(
        num_nodes=FIXTURE_NODES, scheme=scheme, policy=policy,
        ssd_capacity=_node_capacity(batch.total_bytes), engine=engine,
        index_backend=index_backend, ssd=ssd, device=device,
    ).run(batch)


def make_fixture(scheme: str, workload: str, policy: str,
                 engine: str = "batched", ssd=None, device=None) -> dict:
    """Run one fixture configuration on ``device`` (``None``: the card) and
    build its JSON payload."""

    batch = golden_trace(workload)
    capacity = _node_capacity(batch.total_bytes)
    fr = _run(batch, scheme, policy, engine, ssd=ssd, device=device)
    return {
        "schema": SCHEMA,
        "key": {
            "scheme": scheme,
            "workload": workload,
            "policy": policy,
            "engine": engine,
            "num_nodes": FIXTURE_NODES,
            "ssd_capacity": capacity,
        },
        "trace": trace_fingerprint(batch),
        "result": fleet_result_to_dict(fr),
        "device_tolerance": device_tolerance_metadata(),
        "storage_model": storage_model_metadata(ssd, capacity),
    }


def replay_fixture(payload: dict, engine: str | None = None,
                   index_backend: str = "numpy", ssd=None,
                   device=None) -> FleetResult:
    """Rebuild the fixture's trace and replay its configuration on
    ``device``; ``engine``/``index_backend`` may override the fixture's.
    Raises :class:`GoldenTraceMismatch` if the rebuilt trace does not match
    the stored fingerprint and :class:`GoldenStorageMismatch` if ``ssd``
    resolves to another storage model than the recorded one."""

    key = payload["key"]
    batch = golden_trace(key["workload"])
    fp = trace_fingerprint(batch)
    if fp != payload["trace"]:
        raise GoldenTraceMismatch(
            f"golden trace {key['workload']!r} drifted: rebuilt fingerprint "
            f"{fp} != stored {payload['trace']}"
        )
    stored = payload.get("storage_model")
    if stored is not None:
        actual = storage_model_metadata(ssd, key["ssd_capacity"])
        if actual != stored:
            raise GoldenStorageMismatch(
                f"storage backend mismatch: fixture recorded {stored}, "
                f"replay would use {actual}"
            )
    return _run(batch, key["scheme"], key["policy"], engine or key["engine"],
                index_backend, ssd=ssd, device=device)


def generate_all(directory: pathlib.Path,
                 schemes: Sequence[str] = FIXTURE_SCHEMES,
                 workloads: Sequence[str] = FIXTURE_WORKLOADS,
                 policies: Sequence[str] = FIXTURE_POLICIES,
                 device=None) -> list[pathlib.Path]:
    """Write every fixture of the matrix into ``directory``."""

    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    written = []
    for workload in workloads:
        for scheme in schemes:
            for policy in policies:
                payload = make_fixture(scheme, workload, policy, device=device)
                path = directory / fixture_name(scheme, workload, policy)
                path.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
                written.append(path)
    return written


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="golden fixtures: write or verify")
    ap.add_argument("--write", metavar="DIR", type=pathlib.Path,
                    help="write every fixture of the matrix into DIR")
    ap.add_argument("--check", action="store_true",
                    help="replay the committed fixtures; nonzero on divergence")
    ap.add_argument("--sanitize", action="store_true",
                    help="replay with the runtime invariant checks armed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run here)")
    args = ap.parse_args(argv)
    with contextlib.ExitStack() as stack:
        if args.sanitize:
            stack.enter_context(_sanitize.sanitizing())
        if args.write:
            for path in generate_all(args.write, device=args.device):
                print(f"wrote {path}")
            return 0
        if args.check:
            bad = 0
            for path in sorted(GOLDEN_DIR.glob("*__*.json")):
                payload = load_fixture(path)
                diffs = check_fixture(payload, replay_fixture(payload, device=args.device))
                print(f"{path.name}: {diffs[0] if diffs else 'ok'}")
                bad += bool(diffs)
            return 1 if bad else 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
