"""simlint — AST-based simulator-invariant checker (rule engine).

The port's claims rest on invariants its tests can only spot-check: the
host engines bit-identical to the reference's, Eq. 6 seek charging on
every drain path, byte-conservation ledgers, traces and weights that are
pure functions of their seed.  The hazard classes that break them are
*visible in the source* — a draw from NumPy's or torch's hidden global
generator, an in-place store into a frozen trace column, a load-bearing
``assert`` that ``python -O`` strips.  This module is the engine that
hunts them: it parses every file once, hands the shared
:class:`ModuleContext` to each registered :class:`Rule`, and collects
:class:`Finding`\\ s.

Rules live in :mod:`repro_torch.analysis.rules`; the CLI is
``python -m repro_torch.analysis --check src/repro_torch`` (see
:mod:`repro_torch.analysis.cli`).

Inline suppression: append ``# simlint: disable=SL106`` (comma-separated
ids, or ``all``) to the offending line.  Suppressions are deliberate,
reviewable exemptions — prefer fixing the code.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
from typing import Iterable, Sequence

_SUPPRESS_RE = re.compile(r"#\s*simlint:\s*disable=([A-Za-z0-9_,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str  # rule id, e.g. "SL106"
    name: str  # rule slug, e.g. "load-bearing-assert"
    path: str  # posix path as scanned (fingerprint component)
    line: int  # 1-indexed
    message: str
    code: str  # stripped source line (fingerprint component)

    @property
    def fingerprint(self) -> str:
        """Line-number-independent identity, the reference's baseline
        key: a finding keeps it through unrelated edits that only shift it."""

        return f"{self.rule}::{self.path}::{self.code}"

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: {self.rule} [{self.name}] "
            f"{self.message}\n    {self.code}"
        )


class Rule:
    """Base class for simlint rules.

    Subclasses set ``id``/``name``/``description`` and implement
    :meth:`check`, yielding findings via ``ctx.finding``.
    """

    id: str = "SL000"
    name: str = "abstract-rule"
    description: str = ""

    def check(self, ctx: "ModuleContext") -> Iterable[Finding]:
        raise NotImplementedError


class ModuleContext:
    """One parsed module, shared by every rule (parse once, check many)."""

    def __init__(self, path: pathlib.Path, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.tree = ast.parse(source, filename=str(path))
        self.lines = source.splitlines()
        self._suppressed: dict[int, set[str]] | None = None

    def code_at(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def _suppressions(self) -> dict[int, set[str]]:
        if self._suppressed is None:
            table: dict[int, set[str]] = {}
            for i, text in enumerate(self.lines, start=1):
                m = _SUPPRESS_RE.search(text)
                if m:
                    table[i] = {
                        t.strip().upper()
                        for t in m.group(1).split(",") if t.strip()
                    }
            self._suppressed = table
        return self._suppressed

    def suppressed(self, line: int, rule_id: str) -> bool:
        ids = self._suppressions().get(line)
        return bool(ids) and (rule_id.upper() in ids or "ALL" in ids)

    # -- finding constructor -------------------------------------------
    def finding(
        self, rule: Rule, node: ast.AST, message: str
    ) -> Finding | None:
        """Build a finding at ``node`` unless suppressed inline."""

        line = getattr(node, "lineno", 0)
        if self.suppressed(line, rule.id):
            return None
        return Finding(
            rule=rule.id,
            name=rule.name,
            path=self.rel,
            line=line,
            message=message,
            code=self.code_at(line),
        )


def iter_py_files(paths: Sequence[pathlib.Path]) -> list[pathlib.Path]:
    """Expand files/directories into a sorted, de-duplicated .py list."""

    out: set[pathlib.Path] = set()
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            out.update(p.rglob("*.py"))
        elif p.suffix == ".py":
            out.add(p)
        else:
            raise ValueError(f"{p}: not a .py file or directory")
    return sorted(out)


def _rel(path: pathlib.Path, root: pathlib.Path | None) -> str:
    base = root or pathlib.Path.cwd()
    try:
        return path.resolve().relative_to(base.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def check_paths(
    paths: Sequence[pathlib.Path | str],
    rules: Sequence[Rule] | None = None,
    root: pathlib.Path | None = None,
) -> list[Finding]:
    """Run ``rules`` (default: the full registry) over every .py file
    under ``paths``; findings are ordered by (path, line, rule)."""

    from .rules import all_rules

    active = list(rules) if rules is not None else all_rules()
    findings: list[Finding] = []
    for path in iter_py_files([pathlib.Path(p) for p in paths]):
        source = path.read_text()
        ctx = ModuleContext(path, _rel(path, root), source)
        for rule in active:
            findings.extend(f for f in rule.check(ctx) if f is not None)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def check_source(
    source: str,
    rules: Sequence[Rule] | None = None,
    rel: str = "core/snippet.py",
) -> list[Finding]:
    """Check an in-memory snippet (the per-rule unit tests' entry point).

    ``rel`` is the pretend path — rules that scope by location (the
    engine-contract rule keys on a ``core/`` component, which covers
    ``src/repro_torch/core/``) see it as the module's address.
    """

    from .rules import all_rules

    active = list(rules) if rules is not None else all_rules()
    ctx = ModuleContext(pathlib.Path(rel), rel, source)
    findings = [
        f for rule in active for f in rule.check(ctx) if f is not None
    ]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
