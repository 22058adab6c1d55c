"""Baseline files — park known findings, burn them down over time.

A baseline is a JSON multiset of finding fingerprints
(``rule::path::code`` — line-number independent, so unrelated edits that
shift a finding do not churn the file).  ``--baseline FILE`` subtracts
the baseline from the current findings; ``--write-baseline`` snapshots
the current state.  The diff also reports *stale* entries (baselined
findings that no longer occur) so the file shrinks as violations are
fixed.

The schema and layout are the reference's (``simlint-baseline/v1``), so a
file written by either package's linter reads the same in the other's.
"""

from __future__ import annotations

import collections
import json
import pathlib
from typing import Sequence

from .engine import Finding

SCHEMA = "simlint-baseline/v1"


def write_baseline(path: pathlib.Path, findings: Sequence[Finding]) -> None:
    """Snapshot ``findings`` as a fingerprint multiset at ``path``."""

    counts = collections.Counter(f.fingerprint for f in findings)
    payload = {
        "schema": SCHEMA,
        "fingerprints": {fp: counts[fp] for fp in sorted(counts)},
    }
    path.write_text(json.dumps(payload, indent=2) + "\n")


def load_baseline(path: pathlib.Path) -> collections.Counter[str]:
    """Load a baseline written by :func:`write_baseline`."""

    payload = json.loads(path.read_text())
    if payload.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: unknown baseline schema {payload.get('schema')!r} "
            f"(expected {SCHEMA!r})"
        )
    fingerprints = payload.get("fingerprints", {})
    if not isinstance(fingerprints, dict):
        raise ValueError(f"{path}: 'fingerprints' must be an object")
    counts: collections.Counter[str] = collections.Counter()
    for fp, n in fingerprints.items():
        if not isinstance(n, int) or n < 1:
            raise ValueError(f"{path}: bad count {n!r} for {fp!r}")
        counts[fp] = n
    return counts


def diff_baseline(
    findings: Sequence[Finding], baseline: collections.Counter[str]
) -> tuple[list[Finding], list[str]]:
    """Split findings against a baseline.

    Returns ``(new, stale)``: findings not covered by the baseline, and
    baselined fingerprints that no longer occur (candidates for removal).
    """

    budget = collections.Counter(baseline)
    new: list[Finding] = []
    for f in findings:
        if budget[f.fingerprint] > 0:
            budget[f.fingerprint] -= 1
        else:
            new.append(f)
    stale = sorted(fp for fp, n in budget.items() if n > 0)
    return new, stale
