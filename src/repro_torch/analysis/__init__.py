"""repro_torch.analysis — static checker (simlint) + runtime sanitizer.

Two halves of one contract, the port's own copies of the reference's:

- **simlint** (:mod:`.engine`, :mod:`.rules`, :mod:`.cli`) statically
  checks the source for simulator-invariant hazards, in NumPy and torch
  form — run it with ``python -m repro_torch.analysis --check
  src/repro_torch chip_smoke.py chip_memory_probe.py``;
- **sanitize mode** (:mod:`.sanitize`) arms runtime invariant checks in
  the engines, service loop, and golden harness — enable with
  ``REPRO_SANITIZE=1`` or the :func:`sanitizing` context manager.
"""

from .engine import Finding, ModuleContext, Rule, check_paths, check_source
from .rules import all_rules, rules_by_id
from .sanitize import SanitizerError, enabled, resolve, sanitizing

__all__ = [
    "Finding",
    "ModuleContext",
    "Rule",
    "SanitizerError",
    "all_rules",
    "check_paths",
    "check_source",
    "enabled",
    "resolve",
    "rules_by_id",
    "sanitizing",
]
