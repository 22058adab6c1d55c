"""``python -m repro_torch.analysis`` — the simlint command line.

Exit status is 0 when no unbaselined findings remain (or a baseline was
written), 1 when findings or stale baseline entries remain and 2 on a
usage error, so CI can gate on it directly::

    python -m repro_torch.analysis --check src/repro_torch chip_smoke.py chip_memory_probe.py
    python -m repro_torch.analysis --check src/repro_torch --baseline simlint.json
    python -m repro_torch.analysis --check src/repro_torch --write-baseline simlint.json
    python -m repro_torch.analysis --check src/repro_torch --rules SL101,SL106 --root src
    python -m repro_torch.analysis --list-rules

The options and messages are the reference's; ``--rules`` knows only the
port's rules (SL102 and SL103 match JAX APIs and are left out).
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import Sequence

from . import baseline as baseline_mod
from .engine import check_paths
from .rules import all_rules, rules_by_id


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="simlint: simulator-invariant static checker",
    )
    parser.add_argument(
        "--check", nargs="+", metavar="PATH", default=None,
        help="files or directories to scan (e.g. src/repro_torch)",
    )
    parser.add_argument(
        "--baseline", metavar="FILE", default=None,
        help="subtract this baseline file from the findings",
    )
    parser.add_argument(
        "--write-baseline", metavar="FILE", default=None,
        help="snapshot current findings to FILE and exit 0",
    )
    parser.add_argument(
        "--rules", metavar="IDS", default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--root", metavar="DIR", default=None,
        help="directory paths are reported relative to (default: cwd)",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule registry and exit",
    )
    return parser


def main(argv: Sequence[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id} [{rule.name}]")
            print(f"    {rule.description}")
        return 0

    if not args.check:
        print("error: --check PATH... is required (or --list-rules)",
              file=sys.stderr)
        return 2

    rules = (
        rules_by_id(args.rules.split(",")) if args.rules else None
    )
    root = pathlib.Path(args.root) if args.root else None
    findings = check_paths(args.check, rules=rules, root=root)

    if args.write_baseline:
        path = pathlib.Path(args.write_baseline)
        baseline_mod.write_baseline(path, findings)
        print(f"simlint: wrote {len(findings)} finding(s) to {path}")
        return 0

    stale: list[str] = []
    if args.baseline:
        counts = baseline_mod.load_baseline(pathlib.Path(args.baseline))
        findings, stale = baseline_mod.diff_baseline(findings, counts)

    for f in findings:
        print(f.render())
    for fp in stale:
        print(f"stale baseline entry (fixed — remove it): {fp}")

    n = len(findings)
    if n or stale:
        label = "new " if args.baseline else ""
        print(
            f"simlint: {n} {label}finding(s)"
            + (f", {len(stale)} stale baseline entr(y/ies)" if stale else "")
        )
        return 1
    print("simlint: clean")
    return 0
