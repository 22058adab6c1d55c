"""BENCH perf-trajectory artifact + regression gate (the port's copy).

The reference's bench runner (``python -m benchmarks.run``) emits
``experiments/BENCH_<n>.json`` (one ``n`` per PR) through the reference's
copy of this module, so every PR carries its performance trajectory
against the previous anchor.  This copy writes and reads the same schema,
byte for byte, so a port-side runner's artifacts and the reference's
stay one trajectory.  The port has no runner that calls it yet: its
suites wait until ``BENCHMARK.json`` names the cells they measure, and
the reference's ``benchmarks/`` package is not ported.  The payload:

.. code-block:: json

    {
      "schema": "bench-trajectory/v1",
      "index": 6,
      "anchor": "BENCH_5.json",            // null on the first emission
      "regression_threshold": 0.15,
      "suites": {
        "fleet": {
          "us_per_call": 41605782.1,       // sum over the suite's rows
          "rows": {"fleet_ssdup+_8n": 2612733.4, ...},
          "matched_rows": 24,              // rows shared with the anchor
          "speedup_vs_anchor": 1.03,       // anchor_us / current_us
          "regression": false              // speedup < 1 - threshold
        }, ...
      },
      "any_regression": false
    }

Speedups are computed over the rows *shared* with the anchor (renamed or
new rows never poison the ratio); a suite absent from the anchor gets
``speedup_vs_anchor: null``.  ``--check`` exits nonzero iff any suite
regresses by more than the threshold (default +/-15%).  Partial runs
(``--only``) merge into the existing artifact instead of truncating it,
and every file write here is atomic (temp file + ``os.replace``), so an
interrupted run can never leave a half-written artifact behind.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import tempfile
from typing import Mapping, Sequence

SCHEMA = "bench-trajectory/v1"
CURRENT_INDEX = 8  # bump per PR; the previous artifact becomes the anchor
REGRESSION_THRESHOLD = 0.15

_BENCH_RE = re.compile(r"^BENCH_(\d+)\.json$")


def bench_filename(index: int) -> str:
    return f"BENCH_{index}.json"


def atomic_write_text(path: str | os.PathLike, text: str) -> None:
    """Write ``text`` to ``path`` via temp file + rename (same directory,
    so the replace is atomic); an interrupted writer leaves the previous
    file contents untouched."""

    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=path.parent, prefix=f".{path.name}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def find_anchor(directory: str | os.PathLike,
                index: int) -> tuple[int, pathlib.Path] | None:
    """Highest-numbered ``BENCH_k.json`` with ``k < index``, if any."""

    best = None
    for p in pathlib.Path(directory).glob("BENCH_*.json"):
        m = _BENCH_RE.match(p.name)
        if m and int(m.group(1)) < index:
            k = int(m.group(1))
            if best is None or k > best[0]:
                best = (k, p)
    return best


def build_trajectory(
    rows_by_suite: Mapping[str, Mapping[str, float]],
    index: int = CURRENT_INDEX,
    anchor_payload: Mapping | None = None,
    anchor_name: str | None = None,
    threshold: float = REGRESSION_THRESHOLD,
) -> dict:
    """Assemble the trajectory payload from per-suite ``{row: us}`` maps."""

    anchor_suites = (anchor_payload or {}).get("suites", {})
    suites = {}
    for name, rows in rows_by_suite.items():
        rows = {k: float(v) for k, v in rows.items()}
        anchor_rows = anchor_suites.get(name, {}).get("rows", {})
        matched = sorted(set(rows) & set(anchor_rows))
        speedup = None
        if matched:
            cur = sum(rows[k] for k in matched)
            anc = sum(float(anchor_rows[k]) for k in matched)
            speedup = anc / cur if cur > 0 else None
        suites[name] = {
            "us_per_call": sum(rows.values()),
            "rows": rows,
            "matched_rows": len(matched),
            "speedup_vs_anchor": speedup,
            "regression": speedup is not None and speedup < 1.0 - threshold,
        }
    return {
        "schema": SCHEMA,
        "index": index,
        "anchor": anchor_name,
        "regression_threshold": threshold,
        "suites": suites,
        "any_regression": any(s["regression"] for s in suites.values()),
    }


def emit_trajectory(
    rows_by_suite: Mapping[str, Mapping[str, float]],
    directory: str | os.PathLike = "experiments",
    index: int = CURRENT_INDEX,
    threshold: float = REGRESSION_THRESHOLD,
) -> tuple[pathlib.Path, dict]:
    """Build and atomically write ``BENCH_<index>.json``.

    Suites from an existing same-index artifact that were *not* run this
    time are carried over verbatim, so a partial ``--only`` run refreshes
    its suites without truncating the rest.
    """

    directory = pathlib.Path(directory)
    anchor = find_anchor(directory, index)
    anchor_payload = None
    anchor_name = None
    if anchor is not None:
        anchor_name = anchor[1].name
        with open(anchor[1]) as f:
            anchor_payload = json.load(f)

    payload = build_trajectory(
        rows_by_suite, index, anchor_payload, anchor_name, threshold)

    out = directory / bench_filename(index)
    if out.exists():
        with open(out) as f:
            previous = json.load(f)
        for name, entry in previous.get("suites", {}).items():
            payload["suites"].setdefault(name, entry)
        payload["any_regression"] = any(
            s["regression"] for s in payload["suites"].values())

    atomic_write_text(out, json.dumps(payload, indent=1, sort_keys=True) + "\n")
    return out, payload


def check_trajectory(payload: Mapping) -> list[str]:
    """Human-readable regression findings; empty list == gate passes."""

    problems = []
    for name in sorted(payload.get("suites", {})):
        s = payload["suites"][name]
        if s.get("regression"):
            problems.append(
                f"suite {name!r} regressed: speedup_vs_anchor="
                f"{s['speedup_vs_anchor']:.3f} over {s['matched_rows']} "
                f"matched rows (threshold "
                f"{payload.get('regression_threshold')})"
            )
    return problems


def format_trajectory(payload: Mapping) -> str:
    """Compact per-suite table for stdout."""

    lines = [f"{'suite':18s} {'us_per_call':>14s} {'vs anchor':>10s}"]
    for name in sorted(payload.get("suites", {})):
        s = payload["suites"][name]
        speedup = s.get("speedup_vs_anchor")
        vs = f"{speedup:9.2f}x" if speedup is not None else "        --"
        flag = "  REGRESSION" if s.get("regression") else ""
        lines.append(f"{name:18s} {s['us_per_call']:14.1f} {vs}{flag}")
    return "\n".join(lines)


def merge_csv(existing_text: str | None,
              rows: Sequence) -> str:
    """Merge bench ``Row``s into existing CSV text by row name.

    Rows measured this run replace same-named rows in place; rows from
    suites not run this time are preserved; genuinely new rows append.
    This keeps ``--only`` runs from truncating the committed results.
    """

    header = "name,us_per_call,derived"
    order: list[str] = []
    lines: dict[str, str] = {}
    if existing_text:
        for line in existing_text.splitlines():
            line = line.strip()
            if not line or line == header:
                continue
            name = line.split(",", 1)[0]
            if name not in lines:
                order.append(name)
            lines[name] = line
    for r in rows:
        if r.name not in lines:
            order.append(r.name)
        lines[r.name] = r.csv()
    return "\n".join([header] + [lines[n] for n in order]) + "\n"
