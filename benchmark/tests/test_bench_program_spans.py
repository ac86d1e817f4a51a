"""The readers of the program's spans (``program_spans.py`` and the
metrics that use it): their arithmetic on a made-up run of spans and device
intervals, None where a run has no spans, and the spans of a real profile
put on its trace's clock (CPU)."""

import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import pytest

from benchmark import program_spans
from benchmark.harness import HERE
from lecturemath_tpu_torch.core.timing import SpanRecord

LECTURE, DRAIN = 11, 12


def Span(name, thread, start_us, end_us, cpu_us):
    """A program span given in µs of the trace's clock, whose base the runs
    below put at 0."""
    return SpanRecord(0, name, thread, int(start_us * 1e3), int(end_us * 1e3),
                      int(cpu_us * 1e3), None, None)


def reader(metric):
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def run_of(spans, device=(), frames=10):
    """A run whose program spans are ``spans`` (µs) and whose device ran
    ``device`` (start, end) spans."""
    trace = SimpleNamespace(device=[(s, e, "kernel", "k", {})
                                    for s, e in device])
    return SimpleNamespace(trace=trace, counters={"frames": frames},
                           program_spans=list(spans), trace_base=0)


EXPRESS = [
    Span("lecture", LECTURE, 0.0, 10_000.0, 9_000.0),
    # two sources: device busy 1000-1500 inside the first, idle under the
    # second but for 3900-4000
    Span("stage01.source", LECTURE, 1_000.0, 2_000.0, 900.0),
    Span("stage01.source", LECTURE, 3_000.0, 4_000.0, 900.0),
    Span("stage01.wait", LECTURE, 5_000.0, 6_000.0, 10.0),
    # the same name on another thread is not the lecture's
    Span("stage01.source", DRAIN, 7_000.0, 9_000.0, 100.0),
    Span("stage02.track", LECTURE, 6_000.0, 8_000.0, 1_500.0),
    Span("stage02.extract", LECTURE, 6_000.0, 7_000.0, 800.0),
    Span("stage02.extract", LECTURE, 7_000.0, 7_500.0, 400.0),
    Span("stage02.match", LECTURE, 7_500.0, 8_000.0, 300.0),
]
DEVICE = [(1_000.0, 1_200.0), (1_100.0, 1_500.0), (3_900.0, 4_100.0),
          (5_500.0, 5_600.0), (5_550.0, 5_650.0)]


def test_idle_under_the_lecture_threads_spans():
    run = run_of(EXPRESS, DEVICE)
    # source: (1000 - 500) + (1000 - 100) µs over 10 frames
    assert reader("express.idle_source_ms")(run) == pytest.approx(0.14)
    # wait: 1000 - 150 (two overlapping kernels merged) µs over 10 frames
    assert reader("express.idle_drain_wait_ms")(run) == pytest.approx(0.085)


def test_per_frame_sums_and_cpu_share():
    run = run_of(EXPRESS, DEVICE)
    assert reader("express.cc_extract_ms")(run) == pytest.approx(0.15)
    assert reader("express.cc_match_ms")(run) == pytest.approx(0.05)
    assert reader("express.stage02_cpu_share")(run) == pytest.approx(75.0)
    assert reader("stage01.wait_ms")(run_of(EXPRESS, frames=4)) == \
        pytest.approx(0.25)


def test_per_batch_and_per_step():
    spans = [Span("data.batch", DRAIN, 0.0, 100.0, 90.0),
             Span("data.batch", DRAIN, 100.0, 300.0, 190.0)]
    for k in range(4):  # two samples a batch
        base = 75.0 * k
        spans += [Span("data.decode", DRAIN, base, base + 10.0, 10.0),
                  Span("data.augment", DRAIN, base + 10.0, base + 40.0, 30.0),
                  Span("data.masks", DRAIN, base + 40.0, base + 70.0, 30.0)]
    spans += [Span("train.step", LECTURE, 400.0 * k, 400.0 * k + 20.0, 20.0)
              for k in range(3)]
    spans += [Span("train.wait", LECTURE, 0.0, 300.0, 1.0),
              Span("train.wait", LECTURE, 320.0, 330.0, 1.0),
              Span("train.wait", LECTURE, 420.0, 440.0, 1.0),
              Span("train.wait", LECTURE, 820.0, 850.0, 1.0)]
    run = run_of(spans)
    assert reader("train.decode_ms")(run) == pytest.approx(0.02)
    assert reader("train.augment_ms")(run) == pytest.approx(0.06)
    assert reader("train.masks_ms")(run) == pytest.approx(0.06)
    # 360 µs of waits (the last finds the epoch's end) over 3 steps
    assert reader("train.wait_ms")(run) == pytest.approx(0.12)


NEW_METRICS = ["express.cc_extract_ms", "express.cc_match_ms",
               "express.stage02_cpu_share", "express.idle_source_ms",
               "express.idle_drain_wait_ms", "stage01.wait_ms",
               "train.decode_ms", "train.augment_ms", "train.masks_ms",
               "train.wait_ms"]


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_none_without_spans(metric, monkeypatch):
    """An untraced run, a traced run of a program that records no spans,
    and a traced run whose spans lack the metric's all read None."""
    untraced = SimpleNamespace(trace=None, counters={"frames": 10})
    assert reader(metric)(untraced) is None
    monkeypatch.setitem(sys.modules, "lecturemath_tpu_torch.core.timing",
                        SimpleNamespace())
    older = SimpleNamespace(trace=SimpleNamespace(device=[(0.0, 1.0)]),
                            counters={"frames": 10})
    assert reader(metric)(older) is None
    assert reader(metric)(run_of([Span("other", 1, 0.0, 1.0, 1.0)],
                                 DEVICE)) is None


def test_spans_of_a_profile_land_on_its_trace_clock(tmp_path):
    """On the CPU: spans recorded in a profile are taken once and cached,
    the trace's base is read off its earliest event in the profiler's
    results (a host event stands in for the device's here), and a span
    opened with a record_function marker lies under it within 1 ms."""
    import time

    from torch.profiler import ProfilerActivity, profile, record_function

    from lecturemath_tpu_torch.core.timing import span, take_spans

    take_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            pass
        with record_function("marker"), span("probe"):
            time.sleep(0.002)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    marker = next(ev for ev in trace["traceEvents"]
                  if ev.get("name") == "marker" and ev.get("ph") == "X")
    start, dur = float(marker["ts"]), float(marker["dur"])
    run = SimpleNamespace(
        trace=SimpleNamespace(device=[(start, start + dur, "kernel", "marker",
                                       {})]),
        ctx=SimpleNamespace(profile=prof), counters={"frames": 1})
    [probe] = program_spans.spans(run)
    assert program_spans.spans(run) == [probe]
    assert take_spans() == ([], 0)
    assert probe.name == "probe" and probe.thread == marker["tid"]
    base = program_spans.trace_base_ns(run)
    assert abs(base - int(trace["baseTimeNanoseconds"])) < 1000
    assert abs((probe.start_ns - base) / 1e3 - start) < 1000.0
    assert abs((probe.end_ns - base) / 1e3 - start - dur) < 1000.0
    # the marker is the only "device" event: the probe is idle only where
    # it sticks out of it
    idle = program_spans.idle_under_ms(run, "probe", "probe")
    assert 0.0 <= idle < 1.0


@pytest.mark.parametrize("profile", [
    SimpleNamespace(),                                  # no .profiler
    SimpleNamespace(profiler=SimpleNamespace(kineto_results=None)),
    SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: None))),
])
def test_no_trace_base_where_the_profilers_results_differ(profile):
    """A torch build whose profiler keeps its results otherwise gives no
    base, and the idle readers read None, instead of failing the run."""
    run = SimpleNamespace(
        trace=SimpleNamespace(device=[(5.0, 6.0, "kernel", "k", {})]),
        ctx=SimpleNamespace(profile=profile), counters={"frames": 10},
        program_spans=list(EXPRESS))
    assert program_spans.trace_base_ns(run) is None
    assert reader("express.idle_source_ms")(run) is None


def test_no_cpu_share_where_a_span_holds_no_cpu_time():
    """A span recorded with ``cpu=False`` holds no CPU time: the share of
    its spans reads None, and the wall sums still read."""
    frame = Span("stage02.track", LECTURE, 6_000.0, 8_000.0, 0.0)._replace(
        cpu_ns=None)
    run = run_of(EXPRESS[:5] + [frame] + EXPRESS[6:], DEVICE)
    assert reader("express.stage02_cpu_share")(run) is None
    assert reader("express.cc_extract_ms")(run) == pytest.approx(0.15)
