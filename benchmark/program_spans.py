"""The program's own spans (``lecturemath_tpu_torch/core/timing.py``) in a
traced run, and the arithmetic of the readers that read them
(``metrics/<name>.py``).

The program records its spans while a torch profiler traces the process, so
the window of ``--trace 1`` records them and a run with ``--trace 0`` does
not. They are taken once a run and cached on ``run``. A run without spans
(``--trace 0``, or a program that records none) reads None everywhere here,
and the metric is left out.

A span's ends are ``time.time_ns()``, the clock of the profiler's own
events. The trace's events are in µs from its ``baseTimeNanoseconds``; the
trace can be exported only once, and ``trace.TraceView`` has done so, so the
base is read off the earliest device event instead: its start in the
profiler's results less its ``ts`` in the trace."""

from __future__ import annotations

import bisect
from typing import List, Optional


def spans(run) -> Optional[list]:
    """The run's program spans (``SpanRecord``s of the program's
    ``take_spans``), taken once and cached on ``run``."""
    if not hasattr(run, "program_spans"):
        run.program_spans = _take(run)
    return run.program_spans


def _take(run) -> Optional[list]:
    if run.trace is None:
        return None
    try:
        from lecturemath_tpu_torch.core.timing import take_spans
    except ImportError:  # a program that records no spans
        return None
    records, dropped = take_spans()
    return records if records and not dropped else None


def trace_base_ns(run) -> Optional[int]:
    """The trace's ``baseTimeNanoseconds``, cached on ``run``: the earliest
    device event's start in the profiler's results (``time.time_ns``'s
    clock) less its ``ts`` in the trace. None where the results hold no
    event of its name, or where the profiler's results (private to torch)
    are not laid out as this torch build has them."""
    if not hasattr(run, "trace_base"):
        run.trace_base = None
        if run.trace is not None and run.trace.device:
            ts, _, _, name, _ = run.trace.device[0]
            try:
                events = run.ctx.profile.profiler.kineto_results.events()
                starts = [e.start_ns() for e in events if e.name() == name]
            except (AttributeError, TypeError):
                starts = []
            if starts:
                run.trace_base = min(starts) - round(ts * 1e3)
    return run.trace_base


def named(run, name: str) -> list:
    return [s for s in spans(run) or () if s.name == name]


def total_ms(run, name: str) -> Optional[float]:
    """The summed length of the spans ``name``, in ms; None without one."""
    found = named(run, name)
    return sum(s.end_ns - s.start_ns for s in found) / 1e6 if found else None


def per(total: Optional[float], count) -> Optional[float]:
    return None if total is None or not count else total / count


def per_frame_ms(run, name: str) -> Optional[float]:
    return per(total_ms(run, name), run.counters.get("frames"))


def per_span_ms(run, name: str, unit: str) -> Optional[float]:
    """The spans ``name`` summed over the count of the spans ``unit`` (a
    batch's ``data.batch``, a step's ``train.step``)."""
    return per(total_ms(run, name), len(named(run, unit)))


def cpu_share(run, name: str) -> Optional[float]:
    """The thread's CPU time over the wall of the spans ``name``, in %;
    None where a span holds no CPU time."""
    found = named(run, name)
    if any(s.cpu_ns is None for s in found):
        return None
    wall = sum(s.end_ns - s.start_ns for s in found)
    return 100.0 * sum(s.cpu_ns for s in found) / wall if wall else None


def busy_intervals(device) -> List[tuple]:
    """The union of the device's (start, end, ...) spans, merged and in
    order."""
    merged: List[list] = []
    for start, end, *_ in sorted(device):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [tuple(b) for b in merged]


def idle_within(busy: List[tuple], starts: List[float], start: float,
                end: float) -> float:
    """The part of [start, end] that no busy interval covers."""
    covered = 0.0
    k = max(0, bisect.bisect_right(starts, start) - 1)
    while k < len(busy) and busy[k][0] < end:
        covered += max(0.0, min(end, busy[k][1]) - max(start, busy[k][0]))
        k += 1
    return (end - start) - covered


def idle_under_ms(run, name: str, thread_of: str) -> Optional[float]:
    """The device's idle time, in ms, while a thread that runs the spans
    ``thread_of`` is in the spans ``name``."""
    threads = {s.thread for s in named(run, thread_of)}
    found = [s for s in named(run, name) if s.thread in threads]
    base = trace_base_ns(run) if found else None
    if base is None:
        return None
    busy = busy_intervals(run.trace.device)
    starts = [b[0] for b in busy]
    return sum(idle_within(busy, starts, (s.start_ns - base) / 1e3,
                           (s.end_ns - base) / 1e3) for s in found) / 1e3


def idle_per_frame_ms(run, name: str, thread_of: str) -> Optional[float]:
    return per(idle_under_ms(run, name, thread_of), run.counters.get("frames"))
