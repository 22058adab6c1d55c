"""Spans around calls into the program's layers, installed from the
benchmark's own files by module attribute.

A probe is named by a key:

* ``"pkg.module:Name"`` or ``"pkg.module:Class.method"`` -- a host span:
  the attribute is replaced by a wrapper that synchronises the device,
  reads the host clock, calls through, synchronises and reads it again.
  Spans nest: each records the span it was called inside.
* ``"pkg.module:load().entry"`` -- a launch span: the module's ``load()``
  (which returns a kernel library bound by ``ctypes``) is wrapped so that
  its ``entry`` records a CUDA event on the current stream before and
  after the launch: the kernel's own time, without the wrapper's host
  work around it, for the kernel's roofline.  The start event is queued
  behind a short device spin (:data:`GATE_CYCLES`), so that it fires once
  the host has issued the launch and the interval is the kernel's own time,
  not the host's launch latency; the profiler's rows of the spin
  (:data:`GATE_KERNEL`) are not device work of the program.

The attribute is looked up where the program looks it up (a name a module
imported from another is that module's attribute), so the wrapper is
called in its place.  A key whose module or attribute does not exist is
reported as missing, never read as 0.
"""

from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Callable

_ABSENT = object()

#: Device cycles the start event of a launch span waits (about 0.2 ms at
#: the H100's 1.98 GHz), longer than the host takes to issue the launch.
GATE_CYCLES = 400_000
#: The spin's kernel, as the profiler names it (``torch.cuda._sleep``).
GATE_KERNEL = "spin_kernel"


@dataclasses.dataclass
class Span:
    key: str
    t0: float
    t1: float
    parent: int  # index of the enclosing span, -1 at the top


class Recorder:
    """Spans and launch events of one window, kept in memory."""

    def __init__(self, sync: Callable[[], None]):
        self.sync = sync
        self.spans: list[Span] = []
        self.launches: dict[str, list] = {}
        self._open: list[int] = []

    def host(self, key: str, fn: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            self.sync()
            i = len(self.spans)
            self.spans.append(Span(key, time.perf_counter(), 0.0,
                                   self._open[-1] if self._open else -1))
            self._open.append(i)
            try:
                return fn(*args, **kwargs)
            finally:
                self.sync()
                self.spans[i].t1 = time.perf_counter()
                self._open.pop()

        wrapper.__wrapped__ = fn
        return wrapper

    def launch(self, key: str, fn: Callable) -> Callable:
        import torch

        events = self.launches.setdefault(key, [])

        def wrapper(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(GATE_CYCLES)
            start.record()
            try:
                return fn(*args)
            finally:
                end.record()
                events.append((start, end))

        return wrapper

    def launch_seconds(self, key: str) -> list[float]:
        """Each recorded launch's device time (call after a synchronise)."""

        return [s.elapsed_time(e) / 1e3 for s, e in self.launches.get(key, [])]


class _Library:
    """A loaded kernel library whose ``entry`` is wrapped; every other
    attribute passes through."""

    def __init__(self, lib, entry: str, wrapped: Callable):
        self._lib = lib
        self._entry = entry
        self._wrapped = wrapped

    def __getattr__(self, name):
        return self._wrapped if name == self._entry else getattr(self._lib, name)


def _resolve(key: str):
    """``(owner, attribute name, launch entry or None)`` of a probe key;
    raises ``LookupError`` saying what is missing."""

    module, _, path = key.partition(":")
    entry = None
    if "()." in path:
        path, _, entry = path.partition("().")
    try:
        owner = importlib.import_module(module)
    except ImportError as err:
        raise LookupError(f"module {module} cannot be imported: {err}") from None
    parts = path.split(".")
    for part in parts[:-1]:
        if not hasattr(owner, part):
            raise LookupError(f"{module} has no attribute {part}")
        owner = getattr(owner, part)
    if not callable(getattr(owner, parts[-1], None)):
        raise LookupError(f"{key}: no callable {parts[-1]}")
    return owner, parts[-1], entry


def install(rec: Recorder, keys) -> tuple[Callable[[], None], dict[str, str]]:
    """Wrap every key's attribute; returns a function that puts every
    original back, and the keys that could not be found with the reason."""

    undo, missing = [], {}
    for key in dict.fromkeys(keys):
        try:
            owner, name, entry = _resolve(key)
        except LookupError as err:
            missing[key] = str(err)
            continue
        orig_static = vars(owner).get(name, _ABSENT) if hasattr(owner, "__dict__") else _ABSENT
        orig = getattr(owner, name)
        if entry is None:
            new = rec.host(key, orig)
        else:
            def new(*a, _orig=orig, _entry=entry, _key=key, **kw):
                lib = _orig(*a, **kw)
                return _Library(lib, _entry, rec.launch(_key, getattr(lib, _entry)))

        setattr(owner, name, new)
        undo.append((owner, name, orig_static))

    def restore() -> None:
        for owner, name, orig in reversed(undo):
            if orig is _ABSENT:
                delattr(owner, name)
            else:
                setattr(owner, name, orig)

    return restore, missing
