"""The program's own spans and counters, as the per-layer metrics that
read them see them: the records ``repro_torch.tracing`` kept over the
traced window (it records while the window's profiler does).

Each reader returns ``None`` where there is nothing to read: a program
without the tracer, or records that do not hold one ``sweep`` span for
each of the window's sweeps.
"""

from __future__ import annotations


def sweep_spans(w) -> list | None:
    """The window's spans, or ``None`` (see the module's note)."""

    try:
        from repro_torch import tracing
    except ImportError:
        return None
    spans = tracing.records()
    if not w.sweeps or sum(s.name == "sweep" for s in spans) != w.sweeps:
        return None
    return spans


def wall_ms(w, *names: str) -> float | None:
    """Summed wall time of the spans named ``names``, a sweep (``None``
    where none ran)."""

    spans = sweep_spans(w)
    if spans is None:
        return None
    walls = [s.t1_ns - s.t0_ns for s in spans if s.name in names]
    return sum(walls) / 1e6 / w.sweeps if walls else None


def cpu_ms(w, name: str) -> float | None:
    """Summed thread CPU time of the spans named ``name``, a sweep."""

    spans = sweep_spans(w)
    if spans is None:
        return None
    cpu = [s.cpu1_ns - s.cpu0_ns for s in spans if s.name == name and s.cpu0_ns is not None]
    return sum(cpu) / 1e6 / w.sweeps if cpu else None


def sweep_count(w, *keys: str) -> float | None:
    """The counters ``keys`` summed over the ``sweep`` spans' increments,
    a sweep."""

    spans = sweep_spans(w)
    if spans is None:
        return None
    return sum(s.counts.get(k, 0) for s in spans if s.name == "sweep" for k in keys) / w.sweeps
