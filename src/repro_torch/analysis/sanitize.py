"""Runtime sanitizer mode (the port's own copy of the reference's switch).

Carries the invariants that are only visible at run time: non-negative
byte ledgers, finite clocks, sharding conservation.  The engines run
these checks **only when sanitize mode is on**, so the default replay
stays at full speed.

Enablement, in precedence order:

1. :func:`sanitizing` — a context manager / explicit override, used by
   tests and the ``--sanitize`` flags of the golden CLI;
2. a ``sanitize=`` constructor argument on the engines (``True``/``False``
   pins the instance, ``None`` defers);
3. the ``REPRO_SANITIZE`` environment variable (``1``/``true``/``yes``
   /``on``), read at engine construction — ``REPRO_SANITIZE=1 pytest``
   replays the whole suite with checks on.

A failed check raises :class:`SanitizerError` naming the violated
invariant — never an ``assert``, so ``python -O`` cannot strip it.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

ENV_VAR = "REPRO_SANITIZE"

_TRUTHY = ("1", "true", "yes", "on")

# Explicit override; None = fall back to the environment variable.
_override: bool | None = None


class SanitizerError(RuntimeError):
    """A runtime simulator invariant was violated (sanitize mode)."""


def enabled() -> bool:
    """Is sanitize mode on (override first, then ``REPRO_SANITIZE``)?"""

    if _override is not None:
        return _override
    return os.environ.get(ENV_VAR, "").strip().lower() in _TRUTHY


def resolve(sanitize: bool | None) -> bool:
    """Resolve an engine's ``sanitize=`` argument: explicit wins, ``None``
    defers to :func:`enabled`."""

    return enabled() if sanitize is None else bool(sanitize)


@contextlib.contextmanager
def sanitizing(on: bool = True) -> Iterator[None]:
    """Force sanitize mode on (or off) for the dynamic extent of the
    ``with`` block, overriding the environment variable."""

    global _override
    prev = _override
    _override = bool(on)
    try:
        yield
    finally:
        _override = prev


def check(cond: bool, message: str, *args: object) -> None:
    """Raise :class:`SanitizerError` with ``message % args`` unless
    ``cond``.  Callers gate the *computation* of expensive conditions on
    their own ``sanitize`` flag; this helper only formats and raises."""

    if not cond:
        raise SanitizerError(message % args if args else message)
