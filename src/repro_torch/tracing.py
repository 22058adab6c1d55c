"""The port's tracer: spans at the fleet sweep's layer boundaries, and
counters of launches, host waits and copied bytes.

**Spans** are recorded while a torch profiler is recording, and never
otherwise: the switch is the flag torch's own ``record_function``
consults (``torch.autograd.profiler._is_profiler_enabled``).  There is no
other setting.  Off, :func:`span` costs one flag read and returns a
shared no-op.  On, each span records its name, the id of the sweep it
belongs to (the id of the outermost span open on its thread, so every
span of one ``FleetProgram.run`` shares the ``sweep`` span's id), its
parent, its start and end on ``time.perf_counter_ns()`` and the counters'
increments while it was open.  A span opened with none open (a root, such
as ``sweep``) also records the thread's CPU time at both ends
(``time.thread_time_ns()``) and the offset from ``perf_counter_ns`` to the
clock the profiler stamps its events with (Unix time in nanoseconds), so
that device intervals from the profiler can be laid over the spans
(:func:`idle_by_span`).  Only roots read the CPU clock: on some hosts each
read is a system call of tens of µs that ticks in 10 ms steps, so per-layer
reads would cost more than the layers they time and resolve none of them.
Spans add no ``record_function`` or NVTX range: the profiler's rows stay
the program's device work alone.

Spans are kept in memory in the order they closed: :func:`records` reads
them, :func:`take` reads and clears them, :func:`summary` gives each
name's totals a sweep.  The operator's use::

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        for _ in range(10):
            prog.run(batch)
    print(tracing.summary(tracing.take()))

**Counters** are always on, a dict add each: ``launch.<kernel>`` (each
hand-written kernel's launches), ``host_syncs`` and ``d2h_bytes`` (every
read-back, through :func:`to_host`), ``h2d_bytes`` (every copy to the
device, through :func:`to_device`), ``tape_cache.hit`` and
``tape_cache.miss`` (``FleetProgram``'s tapes), ``kernel.build.<source>``
(an ``nvcc`` run) and ``kernel.load.<source>`` (a library loaded).
Read-backs and copies are counted at their call sites whatever the device,
so a CPU run counts what the card's run does.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

_counts: dict[str, int] = {}
_records: list["Span"] = []
_ids = itertools.count(1)
_local = threading.local()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""

    _counts[name] = _counts.get(name, 0) + n


def counter(name: str) -> int:
    """The counter ``name`` (0 if never counted since its reset)."""

    return _counts.get(name, 0)


def counters(prefix: str = "") -> dict[str, int]:
    """Every counter whose name starts with ``prefix``."""

    return {k: v for k, v in _counts.items() if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    """Zero every counter whose name starts with ``prefix`` (all of them
    without one)."""

    for k in [k for k in _counts if k.startswith(prefix)]:
        del _counts[k]


class Span:
    """One closed span.  Times in nanoseconds: ``t0_ns``/``t1_ns`` on
    ``perf_counter_ns``; ``parent`` is the enclosing span's ``id`` (``None``
    at a root); ``counts`` the counters' increments while it was open; at a
    root only (``None`` elsewhere), ``cpu0_ns``/``cpu1_ns`` on the thread's
    CPU clock and ``clock_offset_ns``, the profiler's clock less
    ``perf_counter_ns``."""

    __slots__ = ("name", "id", "sweep", "parent", "t0_ns", "t1_ns", "cpu0_ns", "cpu1_ns",
                 "counts", "clock_offset_ns")

    def __init__(self, name: str, parent: "Span | None"):
        self.name = name
        self.id = next(_ids)
        self.counts: dict[str, int] = {}
        self.t1_ns = 0
        if parent is None:
            self.sweep, self.parent = self.id, None
            self.clock_offset_ns = _clock_offset()
            self.cpu1_ns = 0
            self.cpu0_ns = time.thread_time_ns()
        else:
            self.sweep, self.parent = parent.sweep, parent.id
            self.clock_offset_ns = self.cpu0_ns = self.cpu1_ns = None
        self.t0_ns = time.perf_counter_ns()

    @property
    def wall_ns(self) -> int:
        return self.t1_ns - self.t0_ns

    @property
    def cpu_ns(self) -> int | None:
        return None if self.cpu0_ns is None else self.cpu1_ns - self.cpu0_ns


def _clock_offset() -> int:
    """``time.time_ns()`` less ``perf_counter_ns()``, from the tightest of
    three bracketed reads."""

    best = None
    for _ in range(3):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Open:
    """Opens a :class:`Span` on entry, closes and keeps it on exit."""

    __slots__ = ("name", "span", "before")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Span:
        stack = _stack()
        self.before = dict(_counts)
        self.span = Span(self.name, stack[-1] if stack else None)
        stack.append(self.span)
        return self.span

    def __exit__(self, *exc) -> None:
        s = self.span
        s.t1_ns = time.perf_counter_ns()
        if s.cpu0_ns is not None:
            s.cpu1_ns = time.thread_time_ns()
        before = self.before
        s.counts = {k: v - before.get(k, 0) for k, v in _counts.items()
                    if v != before.get(k, 0)}
        stack = _stack()
        if stack and stack[-1] is s:
            stack.pop()
        _records.append(s)


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager timing the block as a span named ``name`` while a
    torch profiler records; a shared no-op otherwise."""

    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Open(name)


def records() -> list[Span]:
    """The closed spans kept so far, in the order they closed."""

    return list(_records)


def take() -> list[Span]:
    """The closed spans kept so far; the tracer keeps none after."""

    out = list(_records)
    del _records[:len(out)]
    return out


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: the one way the program reads a device tensor
    back.  Counts ``host_syncs`` and ``d2h_bytes``; while spans are
    recorded, the copy is a ``wait`` span inside the open one."""

    count("host_syncs")
    count("d2h_bytes", t.numel() * t.element_size())
    if not _profiler._is_profiler_enabled:
        return t.cpu()
    with _Open("wait"):
        return t.cpu()


def to_device(t: torch.Tensor, device, non_blocking: bool = False) -> torch.Tensor:
    """``t`` copied to ``device``, counted in ``h2d_bytes``; with
    ``non_blocking`` a pinned ``t`` is copied on the current stream without
    waiting (the caller leaves it unchanged until the stream has read it)."""

    count("h2d_bytes", t.numel() * t.element_size())
    return t.to(device, non_blocking=non_blocking)


def summary(spans: list[Span] | None = None) -> dict[str, dict]:
    """Each span name's totals a sweep over ``spans`` (default: the kept
    records), divided by the number of ``sweep`` spans among them (by 1
    where there is none): ``count``, ``wall_ms``, ``self_ms`` (the wall
    less its children's), ``cpu_ms`` (``None`` for a name no root span
    had) and ``counts`` (the counters' increments inside those spans)."""

    spans = records() if spans is None else spans
    per = max(sum(s.name == "sweep" for s in spans), 1)
    children: dict[int, int] = {}
    for s in spans:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0) + s.wall_ns
    out: dict[str, dict] = {}
    for s in spans:
        row = out.setdefault(s.name, {"count": 0.0, "wall_ms": 0.0, "cpu_ms": None,
                                      "self_ms": 0.0, "counts": {}})
        row["count"] += 1 / per
        row["wall_ms"] += s.wall_ns / 1e6 / per
        if s.cpu_ns is not None:
            row["cpu_ms"] = (row["cpu_ms"] or 0.0) + s.cpu_ns / 1e6 / per
        row["self_ms"] += (s.wall_ns - children.get(s.id, 0)) / 1e6 / per
        for k, v in s.counts.items():
            row["counts"][k] = row["counts"].get(k, 0) + v / per
    return out


def _merged(intervals) -> tuple[list[int], list[int], list[int]]:
    """Sorted, merged ``(start, end)`` intervals as starts, ends and the
    running total of busy time before each."""

    starts, ends = [], []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    before = [0]
    for a, b in zip(starts, ends):
        before.append(before[-1] + b - a)
    return starts, ends, before


def _busy(merged, a: int, b: int) -> int:
    """Busy time of ``merged`` inside ``[a, b)``."""

    starts, ends, before = merged

    def upto(t: int) -> int:  # busy time before t
        i = bisect.bisect_right(starts, t)
        if i == 0:
            return 0
        return before[i - 1] + min(t, ends[i - 1]) - starts[i - 1]

    return upto(b) - upto(a)


def idle_by_span(busy_intervals, spans: list[Span] | None = None) -> dict[int, dict[str, int]]:
    """The device's idle time in each sweep, put down to the innermost span
    open during it.  ``busy_intervals`` are ``(start_ns, end_ns)`` on the
    profiler's clock (:func:`device_intervals`); ``spans`` default to the
    kept records.  Returns ``{sweep id: {span name: idle ns}}``, one entry
    per root span."""

    spans = records() if spans is None else spans
    merged = _merged(busy_intervals)
    by_sweep: dict[int, list[Span]] = {}
    for s in spans:
        by_sweep.setdefault(s.sweep, []).append(s)
    out: dict[int, dict[str, int]] = {}
    for sid, group in by_sweep.items():
        root = next((s for s in group if s.id == sid), None)
        if root is None:  # taken before its sweep closed
            continue
        off = root.clock_offset_ns
        group = [s for s in group if s.wall_ns > 0]
        # boundaries in time order; at one instant ends come before starts
        events = sorted([(s.t0_ns, 1, -s.wall_ns, s) for s in group]
                        + [(s.t1_ns, 0, 0, s) for s in group],
                        key=lambda e: e[:3])
        idle: dict[str, int] = {}
        stack: list[Span] = []
        prev = 0
        for t, is_start, _, s in events:
            if stack and t > prev:
                gap = (t - prev) - _busy(merged, prev + off, t + off)
                if gap:
                    name = stack[-1].name
                    idle[name] = idle.get(name, 0) + gap
            prev = t
            if is_start:
                stack.append(s)
            else:
                stack.remove(s)
        out[sid] = idle
    return out


def device_intervals(prof) -> list[tuple[int, int]]:
    """``(start_ns, end_ns)`` of every device activity (kernels, copies,
    sets) a finished ``torch.profiler.profile`` recorded, on its clock."""

    device = torch.autograd.DeviceType.CUDA
    return sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                  if e.device_type() == device)
