"""Per-stage wall-clock accounting (reference: AM_CommonTools/util/time_helper.py),
spans at the port's layer boundaries, and torch profiler trace capture.

A ``span`` adds its seconds to a caller's stats where one is given (as
``Binarizer.stream_stats``), and while a torch profiler traces the process it
is recorded too: its name, OS thread, start and end on the wall clock
(``time.time_ns``: a chrome trace event's ``ts`` plus the trace's
``baseTimeNanoseconds`` reads the same clock), the thread's CPU time over it,
the enclosing span on the same thread and an optional tag. The thread's CPU
clock is a system call, and a system call can cost the host work after it
far more than itself (on one H100 host, four reads a frame slowed stage
02's tracking by a tenth): spans a frame or a sample long pass ``cpu=False``
and leave the CPU time to the span that encloses them. ``take_spans``
hands the recorded spans over; ``torch_trace`` writes them into its trace
beside the kernels. Recording never calls ``record_function``: that drops
spans of threads other than the profiler's and costs far more.

``torch_trace(dir)`` serves ``-trace <dir>`` (``PipelineDriver.trace``: the
stage loop of ``PipelineDriver.run`` and the lecture loop of
``cli.run_pipeline``); it writes ``dir/trace.json`` with the spans as
``"ph": "X"`` events of ``cat`` "program_span", one ``tid`` per thread.

The spans, by thread:

- the lecture's (``pipeline/express.py run_lecture``): ``lecture`` over the
  call; ``stage02.track`` a drained batch, with ``stage02.extract`` and
  ``stage02.match`` a frame under it (``CCTracker.add_frame``; no CPU
  time; ``data/cc.py extract_stats`` counts the frames labelled by runs
  and by the scipy fallback);
  ``stage03``, ``stage04``, ``stage05``.
- the stage-01 stream's consumer (``pipeline/binarize.py stream_source``):
  ``stage01.source``, ``stage01.downscale``, ``stage01.dispatch`` and
  ``stage01.wait`` (blocked on the drain's results), each tagged with the
  batch number; their seconds are ``Binarizer.stream_stats``.
- ``lm-stream-drain`` (inline where the drain is synchronous):
  ``stage01.drain``, tagged likewise.
- ``lm-batch-prefetch`` (``train/dataset.py``, ``train/trainer.py``):
  ``data.batch``; ``data.decode``, ``data.augment``, ``data.masks`` a
  sample (no CPU time) around what the host does of it (the pair, the
  crop choice and the generator's draws), ``data.decode`` tagged with the
  form the pair was preloaded in, ``"pixels"`` (kept decoded) or ``"png"``
  (decoded again), and untagged where the dataset reads its files;
  ``data.pixels`` once a batch inside ``data.batch``, after its samples,
  where the batch's colour chain and targets are made, tagged with the
  route: ``"cuda"`` (staging, one upload and one launch of kernel K5) or
  ``"host"`` (K5's plain version) (no CPU time); ``data.median`` once a
  batch after it, where the batch's median targets are made (the
  reconstruction phase), tagged ``"cuda"`` (kernel K4, one launch a batch
  on K5's crops), ``"native"`` or ``"numpy"`` (a crop at a time on the
  host) (no CPU time); ``train.upload``. Its counter is
  ``LectureNetDataset.data_stats``: ``pairs_pixels``, ``pairs_png`` and
  ``bytes_kept`` as ``preload`` left them, ``from_pixels`` and
  ``from_png`` the samples served from each form, ``median_card`` and
  ``median_host`` the samples whose median target each route made,
  ``pixels_card`` and ``pixels_host`` the samples whose colour chain each
  route made.
- the trainer's: ``train.wait`` (``PrefetchIterator.__next__``) and
  ``train.step`` (``Trainer.step``), with ``train.forward`` (tagged with
  the phase), ``train.backward`` and ``train.update`` under it (no CPU
  time).
"""

from __future__ import annotations

import contextlib
import itertools
import sys
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

# the most spans the buffer holds between two takes; more are counted, not kept
MAX_SPANS = 1 << 20


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = {}
        self._starts: Dict[str, float] = {}

    def start(self, name: str = "total") -> None:
        self._starts[name] = time.perf_counter()

    def stop(self, name: str = "total") -> float:
        elapsed = time.perf_counter() - self._starts.pop(name)
        self.totals[name] = self.totals.get(name, 0.0) + elapsed
        return elapsed

    @contextlib.contextmanager
    def measure(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)


class SpanRecord(NamedTuple):
    """One recorded span. ``seq`` numbers the spans opened while recording;
    ``parent`` is the ``seq`` of the span enclosing this one on its thread
    (None at a thread's top)."""
    seq: int
    name: str
    thread: int            # threading.get_native_id()
    start_ns: int          # time.time_ns()
    end_ns: int
    cpu_ns: Optional[int]  # the thread's CPU time over it (None: not read)
    parent: Optional[int]
    tag: Union[int, str, None]


class _SpanBuffer:
    """The recorded spans of the process; appending is thread-safe. Each
    thread keeps its stack of open spans and its id in ``_local``."""

    def __init__(self, limit: int = MAX_SPANS):
        self.limit = limit
        self._lock = threading.Lock()
        self._records: List[tuple] = []
        self._dropped = 0
        self._seq = itertools.count()
        self._local = threading.local()

    def open(self, cpu: bool = True
             ) -> Tuple[int, Optional[int], Optional[int], int]:
        local = self._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            local.thread = threading.get_native_id()
        seq = next(self._seq)
        parent = stack[-1] if stack else None
        stack.append(seq)
        return (seq, parent, time.thread_time_ns() if cpu else None,
                time.time_ns())

    def close(self, name: str, tag: Union[int, str, None],
              opened: Tuple[int, Optional[int], Optional[int], int]) -> None:
        end = time.time_ns()
        seq, parent, cpu0, start = opened
        cpu = None if cpu0 is None else time.thread_time_ns() - cpu0
        local = self._local
        stack = local.stack
        if stack[-1] == seq:
            stack.pop()
        elif seq in stack:
            stack.remove(seq)
        record = (seq, name, local.thread, start, end, cpu, parent, tag)
        with self._lock:
            if len(self._records) < self.limit:
                self._records.append(record)
            else:
                self._dropped += 1

    def take(self) -> Tuple[List[SpanRecord], int]:
        with self._lock:
            records, self._records = self._records, []
            dropped, self._dropped = self._dropped, 0
        return [SpanRecord._make(r) for r in records], dropped


_SPANS = _SpanBuffer()


def recording() -> bool:
    """Whether a torch profiler traces the process (its global flag; a
    process that has not imported torch has none running)."""
    profiler = sys.modules.get("torch.autograd.profiler")
    return profiler is not None and profiler._is_profiler_enabled


class span:
    """``with span(name, stats, key, tag, cpu):`` — adds the block's
    ``perf_counter`` seconds to ``stats[key]`` where ``stats`` is given, and
    records the block while a torch profiler traces the process. ``tag`` is
    an optional integer that links spans of one item across threads (the
    stage-01 stream's batch number) or a string that names a case of the
    span (``data.decode``'s form), and may be set inside the block;
    ``cpu=False`` records no CPU time."""

    __slots__ = ("name", "stats", "key", "tag", "cpu", "_opened", "_t0")

    def __init__(self, name: str, stats: Optional[dict] = None,
                 key: Optional[str] = None,
                 tag: Union[int, str, None] = None,
                 cpu: bool = True):
        self.name, self.stats, self.key, self.tag = name, stats, key, tag
        self.cpu = cpu
        self._opened = None

    def __enter__(self) -> "span":
        if recording():
            self._opened = _SPANS.open(self.cpu)
        if self.stats is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc_info) -> None:
        if self.stats is not None:
            self.stats[self.key] += time.perf_counter() - self._t0
        if self._opened is not None:
            _SPANS.close(self.name, self.tag, self._opened)


def take_spans() -> Tuple[List[SpanRecord], int]:
    """The spans recorded since the last take, in the order they closed,
    and how many were dropped beyond ``MAX_SPANS``; empties the buffer."""
    return _SPANS.take()


def spans_as_trace_events(records: List[SpanRecord], base_ns: int,
                          pid: int) -> List[dict]:
    """Complete (``"ph": "X"``) chrome trace events of ``records`` on the
    clock of a trace whose ``baseTimeNanoseconds`` is ``base_ns``, each
    under its thread's id."""
    return [{"ph": "X", "cat": "program_span", "name": r.name, "pid": pid,
             "tid": r.thread, "ts": (r.start_ns - base_ns) / 1e3,
             "dur": (r.end_ns - r.start_ns) / 1e3,
             "args": {"seq": r.seq, "parent": r.parent, "tag": r.tag,
                      "cpu_us": None if r.cpu_ns is None
                      else r.cpu_ns / 1e3}}
            for r in records]


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str]):
    """Capture a torch profiler trace (host ops and, when a card is present,
    its kernels) into ``log_dir/trace.json`` when a log dir is given, else
    no-op. The port's spans recorded meanwhile are written into the same
    trace, on its clock, under their threads."""
    if log_dir is None:
        yield
        return
    import json
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    take_spans()  # what an earlier trace left untaken is not this one's
    with profile(activities=activities) as prof:
        yield
    records, _ = take_spans()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(spans_as_trace_events(
        records, int(trace.get("baseTimeNanoseconds", 0)), os.getpid()))
    with open(path, "w") as f:
        json.dump(trace, f)
