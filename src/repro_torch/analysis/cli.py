"""``python -m repro_torch.analysis`` — the simlint command line.

Exit status is 0 when the scanned files are clean, 1 when any finding
remains and 2 on a usage error, so CI can gate on it directly::

    python -m repro_torch.analysis --check src/repro_torch chip_smoke.py chip_memory_probe.py
    python -m repro_torch.analysis --list-rules

The reference's baseline file and its ``--baseline``/``--write-baseline``/
``--rules``/``--root`` options are not ported: the port fixes a finding
(or suppresses it inline, with the reason on its line) rather than
parking it.
"""

from __future__ import annotations

import argparse
import sys
from typing import Sequence

from .engine import check_paths
from .rules import all_rules


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

    findings = check_paths(args.check)
    for f in findings:
        print(f.render())
    if findings:
        print(f"simlint: {len(findings)} finding(s)")
        return 1
    print("simlint: clean")
    return 0
