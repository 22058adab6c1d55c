"""simlint rule set — simulator hazard classes, in NumPy and torch form.

Each rule targets a failure mode the simulator has been bitten by (or is
one hand-audit away from): nondeterministic RNG, unordered iteration
feeding simulation state, in-place mutation of frozen trace/tape columns,
``assert``-guarded accounting that ``python -O`` strips, unit-suffix
mix-ups, undocumented engine accuracy contracts, shared mutable defaults,
swallowed exceptions, and per-instance-leaking method caches.  Rule ids,
names and messages are the reference linter's, so a finding reads the
same in either package.

Where a rule's hazard has a torch form, the rule matches it too, with the
same meaning: SL101 flags draws from torch's global generator (a
``torch.rand``/``randn``/``randint``/... call, an in-place draw such as
``w.normal_()`` or a random ``torch.nn.init`` initialiser, each without
``generator=``, and ``torch.manual_seed``/``torch.cuda.manual_seed[_all]``,
but not ``torch.Generator(...).manual_seed(...)``, the port's way to seed);
SL105 flags in-place torch methods (``.fill_()``, ``.copy_()``, any name
ending in ``_``) on a column; SL109 counts ``torch.tensor``/``zeros``/
``ones``/``empty`` among the mutable constructors.

Absent on purpose: SL102 (global ``jax_enable_x64`` toggles) and SL103
(Python branches on traced values inside ``jit``/``scan``/``vmap``
bodies).  Both match only JAX APIs, which the port never calls, so
``rules_by_id(["SL102"])`` raises as for an unknown id.

Rules are intentionally syntactic and conservative: they flag the
*pattern*, and an inline ``# simlint: disable=SLxxx`` records a reviewed
exemption.  See :mod:`repro_torch.analysis.engine` for the engine and
``tests/test_torch_analysis.py`` for a known-bad snippet per rule.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .engine import Finding, ModuleContext, Rule

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression (``torch.cuda.manual_seed``
    -> ``"torch.cuda.manual_seed"``; non-name parts collapse to ``""``)."""

    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


# ---------------------------------------------------------------------------
# SL101 — unseeded legacy numpy RNG / torch's global generator
# ---------------------------------------------------------------------------


class UnseededRandomRule(Rule):
    id = "SL101"
    name = "unseeded-random"
    description = (
        "legacy np.random.* module-level calls, and torch draws without "
        "generator=, use hidden global state; traces and weights stop "
        "being a pure function of their seed. Use "
        "np.random.default_rng(seed) or torch.Generator().manual_seed(seed)."
    )

    _ALLOWED = frozenset({
        "default_rng", "SeedSequence", "Generator", "BitGenerator",
        "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937",
    })
    # torch draws that take ``generator=``; without it they use the global one
    _TORCH_DRAWS = frozenset(
        f"torch.{f}" for f in (
            "rand", "rand_like", "randn", "randn_like", "randint",
            "randperm", "normal", "bernoulli", "multinomial",
            "randint_like", "poisson",
        )
    )
    # in-place tensor draws (``w.normal_()``) and the random initialisers
    # of ``torch.nn.init``; both take ``generator=`` too
    _TORCH_INPLACE_DRAWS = frozenset({
        "normal_", "uniform_", "random_", "bernoulli_", "exponential_",
        "cauchy_", "log_normal_", "geometric_",
    })
    _TORCH_INIT_DRAWS = frozenset({
        "uniform_", "normal_", "trunc_normal_", "xavier_uniform_",
        "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
        "orthogonal_", "sparse_",
    })
    _TORCH_SEEDS = frozenset({
        "torch.manual_seed", "torch.cuda.manual_seed",
        "torch.cuda.manual_seed_all",
    })

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            func = node.func
            callee = _dotted(func)
            is_init = (callee.startswith(("torch.nn.init.", "nn.init."))
                       and func.attr in self._TORCH_INIT_DRAWS)
            if (callee in self._TORCH_DRAWS or is_init
                    or func.attr in self._TORCH_INPLACE_DRAWS):
                if any(kw.arg == "generator" for kw in node.keywords):
                    continue
                message = (
                    f"{callee}() without generator= draws from torch's "
                    "global generator; pass "
                    "generator=torch.Generator(...).manual_seed(seed)"
                )
            elif callee in self._TORCH_SEEDS:
                message = (
                    f"{callee}() reseeds torch's hidden global generator; "
                    "seed a torch.Generator(...).manual_seed(seed) instead"
                )
            elif (func.attr not in self._ALLOWED
                    and _dotted(func.value) in ("np.random", "numpy.random")):
                message = (
                    f"np.random.{func.attr}() uses the hidden global RNG; "
                    "draw from np.random.default_rng(seed) instead"
                )
            else:
                continue
            f = ctx.finding(self, node, message)
            if f:
                yield f


# ---------------------------------------------------------------------------
# SL104 — iteration over unordered sets feeding simulation state
# ---------------------------------------------------------------------------


class UnorderedIterationRule(Rule):
    id = "SL104"
    name = "unordered-iteration"
    description = (
        "iterating a set feeds hash-order nondeterminism into whatever "
        "consumes it; wrap in sorted() to pin the order."
    )

    _CONSUMERS = frozenset({"list", "tuple", "enumerate", "sum", "min", "max"})

    def _is_set_expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Set) or isinstance(node, ast.SetComp):
            return True
        if isinstance(node, ast.Call):
            return _dotted(node.func) in ("set", "frozenset")
        return False

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        iters: list[ast.AST] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters.append(node.iter)
            elif isinstance(node, ast.comprehension):
                iters.append(node.iter)
            elif (isinstance(node, ast.Call)
                    and _dotted(node.func) in self._CONSUMERS and node.args):
                iters.append(node.args[0])
        for it in iters:
            if self._is_set_expr(it):
                f = ctx.finding(
                    self, it,
                    "iteration over a set is hash-ordered "
                    "(nondeterministic across runs/versions); "
                    "wrap in sorted()",
                )
                if f:
                    yield f


# ---------------------------------------------------------------------------
# SL105 — in-place mutation of frozen trace/tape columns
# ---------------------------------------------------------------------------


class TapeColumnMutationRule(Rule):
    id = "SL105"
    name = "tape-column-mutation"
    description = (
        "TraceBatch/StreamScores columns are shared, frozen-by-contract "
        "arrays (fixtures, tape caches, shards alias them); in-place "
        "stores corrupt every aliasing view. Copy, then mutate."
    )

    # the columnar fields of TraceBatch / StreamScores (core/trace.py)
    COLUMNS = frozenset({
        "offsets", "sizes", "file_ids", "app_ids", "times",
        "gap_positions", "gap_seconds",
        "rf_sum", "percentage", "seek_distance", "nbytes", "offset_sum",
    })
    _MUTATORS = frozenset({"sort", "fill", "resize", "partition", "put"})

    @classmethod
    def _mutates(cls, method: str) -> bool:
        """A NumPy in-place method, or a torch one (``fill_``, ``copy_``,
        ``index_put_``: a trailing ``_``, dunders aside)."""

        return method in cls._MUTATORS or (
            method.endswith("_") and not method.startswith("__"))

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            targets: list[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            for t in targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Attribute)
                        and t.value.attr in self.COLUMNS):
                    f = ctx.finding(
                        self, node,
                        f"in-place store into `.{t.value.attr}[...]` — "
                        "trace/tape columns are frozen by contract; "
                        "build a new array instead",
                    )
                    if f:
                        yield f
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and self._mutates(node.func.attr)
                    and isinstance(node.func.value, ast.Attribute)
                    and node.func.value.attr in self.COLUMNS):
                f = ctx.finding(
                    self, node,
                    f"in-place `.{node.func.attr}()` on column "
                    f"`.{node.func.value.attr}` — trace/tape columns are "
                    "frozen by contract (use np.sort(...) etc.)",
                )
                if f:
                    yield f


# ---------------------------------------------------------------------------
# SL106 — load-bearing assert in library code
# ---------------------------------------------------------------------------


class LoadBearingAssertRule(Rule):
    id = "SL106"
    name = "load-bearing-assert"
    description = (
        "`assert` in library code vanishes under `python -O`; accounting "
        "and state-machine invariants must raise ValueError/RuntimeError "
        "(or go through the sanitizer) so optimization cannot disable "
        "them."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assert):
                f = ctx.finding(
                    self, node,
                    "assert is stripped under python -O; raise "
                    "ValueError/RuntimeError or use repro_torch.analysis."
                    "sanitize.check",
                )
                if f:
                    yield f


# ---------------------------------------------------------------------------
# SL107 — unit-suffix mismatches
# ---------------------------------------------------------------------------


_SUFFIX_FAMILIES: dict[str, str] = {}
for _fam, _sufs in (
    ("bytes", ("_bytes",)),
    ("megabytes", ("_mb", "_mbs", "_mib")),
    ("seconds", ("_seconds", "_secs", "_sec")),
    ("milliseconds", ("_ms",)),
    ("microseconds", ("_us",)),
):
    for _s in _sufs:
        _SUFFIX_FAMILIES[_s] = _fam


def _unit_family(node: ast.AST) -> str | None:
    if isinstance(node, ast.Name):
        name = node.id
    elif isinstance(node, ast.Attribute):
        name = node.attr
    else:
        return None
    lowered = name.lower()
    for suffix, family in _SUFFIX_FAMILIES.items():
        if lowered.endswith(suffix):
            return family
    return None


class UnitSuffixRule(Rule):
    id = "SL107"
    name = "unit-suffix-mismatch"
    description = (
        "a `*_bytes` name bound to (or added against) a `*_seconds`/"
        "`*_mb`/`*_us` name with no conversion is a unit bug waiting in "
        "the accounting."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tf = _unit_family(node.targets[0])
                vf = _unit_family(node.value)
                if tf and vf and tf != vf:
                    f = ctx.finding(
                        self, node,
                        f"{tf} name assigned directly from a {vf} name "
                        "with no conversion",
                    )
                    if f:
                        yield f
            elif (isinstance(node, ast.AugAssign)
                    and isinstance(node.op, (ast.Add, ast.Sub))):
                tf = _unit_family(node.target)
                vf = _unit_family(node.value)
                if tf and vf and tf != vf:
                    f = ctx.finding(
                        self, node,
                        f"{tf} name incremented by a {vf} name "
                        "with no conversion",
                    )
                    if f:
                        yield f
            elif (isinstance(node, ast.BinOp)
                    and isinstance(node.op, (ast.Add, ast.Sub))):
                lf = _unit_family(node.left)
                rf = _unit_family(node.right)
                if lf and rf and lf != rf:
                    f = ctx.finding(
                        self, node,
                        f"{lf} name added/subtracted against a {rf} name "
                        "with no conversion",
                    )
                    if f:
                        yield f


# ---------------------------------------------------------------------------
# SL108 — public engine entry points must state their accuracy contract
# ---------------------------------------------------------------------------


class EngineContractRule(Rule):
    id = "SL108"
    name = "missing-engine-contract"
    description = (
        "public run*/simulate*/replay* entry points in repro_torch.core "
        "must say what accuracy they promise (bit-exact vs the oracle, or a "
        "documented tolerance tier) — that contract is what the golden "
        "fixtures enforce."
    )

    _PREFIXES = ("run", "simulate", "replay")
    _TOKENS = (
        "exact", "oracle", "tolerance", "accuracy contract",
        "bit-identical",
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        parts = ctx.rel.split("/")
        if "core" not in parts[:-1]:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            name = node.name
            if name.startswith("_") or not name.startswith(self._PREFIXES):
                continue
            doc = (ast.get_docstring(node) or "").lower()
            if not any(tok in doc for tok in self._TOKENS):
                f = ctx.finding(
                    self, node,
                    f"`{name}` is a public engine entry point but its "
                    "docstring states no accuracy contract "
                    "(bit-exact / oracle / tolerance)",
                )
                if f:
                    yield f


# ---------------------------------------------------------------------------
# SL109 — shared mutable default arguments
# ---------------------------------------------------------------------------


class MutableDefaultRule(Rule):
    id = "SL109"
    name = "mutable-default-arg"
    description = (
        "a mutable default is one object shared across every call — "
        "state leaks between runs; default to None and construct inside."
    )

    _CTORS = frozenset({
        "list", "dict", "set", "deque", "collections.deque",
        "np.array", "numpy.array", "np.zeros", "np.empty", "np.ones",
        "torch.tensor", "torch.zeros", "torch.ones", "torch.empty",
    })

    def _is_mutable(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set)):
            return True
        return (isinstance(node, ast.Call)
                and _dotted(node.func) in self._CTORS)

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                continue
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None
            ]
            for d in defaults:
                if self._is_mutable(d):
                    f = ctx.finding(
                        self, d,
                        "mutable default argument is shared across calls; "
                        "use None and construct in the body",
                    )
                    if f:
                        yield f


# ---------------------------------------------------------------------------
# SL110 — silently swallowed exceptions
# ---------------------------------------------------------------------------


class SilentExceptionRule(Rule):
    id = "SL110"
    name = "silent-exception"
    description = (
        "a bare `except:` (or `except Exception: pass`) hides the "
        "accounting bug it catches; catch the specific error or at "
        "least record it."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                f = ctx.finding(
                    self, node,
                    "bare `except:` also swallows KeyboardInterrupt/"
                    "SystemExit; name the exception",
                )
                if f:
                    yield f
                continue
            broad = _dotted(node.type) in ("Exception", "BaseException")
            silent = all(
                isinstance(s, (ast.Pass, ast.Continue)) for s in node.body
            )
            if broad and silent:
                f = ctx.finding(
                    self, node,
                    "`except Exception` with an empty body silently "
                    "swallows every bug; narrow it or handle it",
                )
                if f:
                    yield f


# ---------------------------------------------------------------------------
# SL111 — lru_cache on methods leaks instances
# ---------------------------------------------------------------------------


class MethodLruCacheRule(Rule):
    id = "SL111"
    name = "method-lru-cache"
    description = (
        "functools.lru_cache on a method keys the cache on `self`: "
        "instances never free, and two simulators with equal args share "
        "nothing; cache at module level or on frozen keys."
    )

    _CACHES = frozenset({
        "lru_cache", "cache", "functools.lru_cache", "functools.cache",
    })

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for node in cls.body:
                if not isinstance(node, ast.FunctionDef):
                    continue
                args = node.args.posonlyargs + node.args.args
                if not args or args[0].arg not in ("self", "cls"):
                    continue
                for dec in node.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    if _dotted(target) in self._CACHES:
                        f = ctx.finding(
                            self, dec,
                            f"lru_cache on method `{node.name}` pins every "
                            "instance in the cache key",
                        )
                        if f:
                            yield f


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


_REGISTRY: tuple[Rule, ...] = (
    UnseededRandomRule(),
    UnorderedIterationRule(),
    TapeColumnMutationRule(),
    LoadBearingAssertRule(),
    UnitSuffixRule(),
    EngineContractRule(),
    MutableDefaultRule(),
    SilentExceptionRule(),
    MethodLruCacheRule(),
)


def all_rules() -> tuple[Rule, ...]:
    """The full registry, id-ordered."""

    return _REGISTRY


def rules_by_id(ids: Iterable[str]) -> tuple[Rule, ...]:
    wanted = {i.strip().upper() for i in ids}
    known = {r.id for r in _REGISTRY}
    unknown = sorted(wanted - known)
    if unknown:
        raise ValueError(f"unknown rule id(s) {unknown}; known: {sorted(known)}")
    return tuple(r for r in _REGISTRY if r.id in wanted)
