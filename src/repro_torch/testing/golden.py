"""Reading and comparing the committed golden fixtures.

A fixture (``tests/golden/<scheme>__<workload>__<policy>__batched.json``)
pins one 4-node fleet replay of the batched NumPy engine: the trace is
rebuilt from :mod:`repro_torch.testing.traces` and checked against the
stored fingerprint, the expected ``FleetResult`` is stored field by
field, and ``device_tolerance`` holds the tiers a device replay is held
to (``field -> [rtol, atol]``, ``[0, 0]`` = exact).  The anomaly fixture
(``anomaly_16n_straggler.json``) stores one literal 512-request shard and
its expected results under four scheme/gate settings.

This module only reads the fixtures; it never writes them.  Divergences
are reported in causal order (routing before bytes before flush counts
before clocks), so the first line names the causally earliest field.
"""

from __future__ import annotations

import json
import pathlib

from ..core.fleet import FleetResult
from ..core.simulator import SimResult
from ..core.trace import TraceBatch

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
