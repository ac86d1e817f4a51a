"""The port's spans (lecturemath_tpu_torch/core/timing.py): recorded only
while a torch profiler traces the process, on every thread, on the exported
trace's clock; ``Binarizer.stream_stats`` as one output of the stage-01
spans; the spans of an express lecture, of a training epoch and of a
training step, on the CPU at tiny widths; and the spans in ``-trace``'s
trace.json."""

import json
import os
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cli_workspace import build_cli_workspace
from lecturemath_tpu_torch.cli import run_pipeline
from lecturemath_tpu_torch.core import timing
from lecturemath_tpu_torch.core.config import Config
from lecturemath_tpu_torch.core.metadata import LectureInfo
from lecturemath_tpu_torch.models import fcn_lecturenet as tfcn
from lecturemath_tpu_torch.pipeline import binarize
from lecturemath_tpu_torch.pipeline.binarize import Binarizer
from lecturemath_tpu_torch.pipeline.driver import PipelineDriver
from lecturemath_tpu_torch.pipeline.express import run_lecture
from lecturemath_tpu_torch.pipeline.video import ArraySource, VideoFrameSource
from lecturemath_tpu_torch.train.dataset import LectureNetDataset
from lecturemath_tpu_torch.train.prefetch import PrefetchIterator
from lecturemath_tpu_torch.train.trainer import Trainer
from lecturemath_tpu_torch.utils.png import encode_png
from lecturemath_tpu_torch.utils.synthetic import (
    synthetic_rgb_lecture, threshold_binarizer_variables)

torch.set_num_threads(1)

TINY = dict(down_filters=(2, 3, 4, 5, 6), mid_filters=6,
            upsample_filters=(2, 3, 4, 5, 6), up_filters=(2, 3, 4, 5, 6),
            pixel_features=(4, 3), kernel_size=3, pixel_kernel_size=3)
STREAM_KEYS = {"source_s", "dispatch_s", "drain_s", "downscale_s"}
# the spans inside a training step, in their order
STEP_PARTS = ("train.forward", "train.backward", "train.update")
# stream_stats key -> the span whose seconds it sums
STREAM_SPANS = {"source_s": "stage01.source", "dispatch_s": "stage01.dispatch",
                "drain_s": "stage01.drain"}
EXPRESS_KEYS = {
    "CC_STABILITY_MIN_RECALL": 0.85, "CC_STABILITY_MIN_PRECISION": 0.85,
    "CC_STABILITY_MAX_GAP": 10, "CC_STABILITY_MIN_TIMES": 3,
    "CC_GROUPING_MIN_IMAGE_THRESHOLD": 0.5, "CC_GROUPING_TEMPORAL_WINDOW": 5,
    "CC_GROUPING_MIN_RECALL": 0.5, "VIDEO_SEGMENTATION_METHOD": 3,
    "VIDEO_SEGMENTATION_DEL_EVENT_MIN_LENGTH": 3,
    "VIDEO_SEGMENTATION_DEL_EVENT_ADD_THRESHOLD": 0.00005,
    "VIDEO_SEGMENTATION_DEL_EVENT_THRESHOLD": 0.0008}


@pytest.fixture(autouse=True)
def empty_buffer():
    timing.take_spans()
    yield
    timing.take_spans()


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def counts(records):
    return Counter(r.name for r in records)


def taken():
    records, dropped = timing.take_spans()
    assert dropped == 0
    return records


def test_recording_follows_the_profilers_global_flag():
    """The flag ``recording`` reads is torch's own: off, on inside a
    profile, off after it."""
    import torch.autograd.profiler as autograd_profiler

    assert autograd_profiler._is_profiler_enabled is False
    assert not timing.recording()
    with traced():
        assert autograd_profiler._is_profiler_enabled is True
        assert timing.recording()
    assert not timing.recording()


def test_spans_without_a_profiler_only_add_to_stats():
    stats = {"k": 0.0}
    with timing.span("a", stats, "k", tag=1):
        time.sleep(0.002)
    with timing.span("b"):
        pass
    assert stats["k"] >= 0.002
    assert timing.take_spans() == ([], 0)


def test_the_buffer_is_capped_and_counts_the_dropped():
    buffer = timing._SpanBuffer(limit=2)
    for _ in range(5):
        buffer.close("x", None, buffer.open())
    records, dropped = buffer.take()
    assert [r.name for r in records] == ["x", "x"] and dropped == 3
    assert buffer.take() == ([], 0)


def _collect(binarizer, source):
    return [(list(t), list(i), [f.copy() for f in frames])
            for t, i, frames in binarizer.stream_source(source)]


@pytest.fixture(scope="module")
def stream_workspace(tmp_path_factory):
    root = build_cli_workspace(tmp_path_factory.mktemp("tracing"), "stream",
                               n_frames=12)
    return root, Config.from_file(str(root / "test.conf"))


@pytest.mark.parametrize("async_drain", [False, True], ids=["sync", "async"])
def test_stream_stats_are_the_stage01_spans_seconds(stream_workspace,
                                                    async_drain,
                                                    monkeypatch):
    """Untraced, the stream records nothing and stream_stats keeps its
    keys; traced, each key is its spans' seconds (the recorded span holds
    the timed block), the outputs alike."""
    root, config = stream_workspace
    source = lambda: VideoFrameSource([str(root / "videos" / "synth01.avi")],
                                      sampling_fps=1.0)
    if not async_drain:
        # the stream drains inline in a world of more than one process
        monkeypatch.setattr(binarize, "process_count", lambda: 2)
    binarizer = Binarizer.from_config(config, batch_size=4, device="cpu")
    plain = _collect(binarizer, source())
    stats = dict(binarizer.stream_stats)
    assert set(stats) == STREAM_KEYS
    assert min(stats[key] for key in STREAM_SPANS) > 0.0
    assert stats["downscale_s"] == 0.0
    assert timing.take_spans() == ([], 0)

    with traced():
        again = _collect(binarizer, source())
    records = taken()
    stats = binarizer.stream_stats
    assert len(again) == len(plain) == 3
    for (t0, i0, f0), (t1, i1, f1) in zip(plain, again):
        assert t0 == t1 and i0 == i1
        for a, b in zip(f0, f1):
            np.testing.assert_array_equal(a, b)
    for key, name in STREAM_SPANS.items():
        spans = [r for r in records if r.name == name]
        recorded = sum(r.end_ns - r.start_ns for r in spans) / 1e9
        assert stats[key] <= recorded <= stats[key] + 1e-3 * len(spans)
    assert sorted(r.tag for r in records if r.name == "stage01.drain") == \
        [0, 1, 2]


def test_spans_are_recorded_on_every_thread_with_their_parents(
        stream_workspace):
    """The main thread, the stage-01 drain thread, a prefetch thread, and a
    thread started before the profile: each span under its thread's native
    id, a nested span under its parent."""
    root, config = stream_workspace
    binarizer = Binarizer.from_config(config, batch_size=4, device="cpu")
    go, early_done = threading.Event(), []

    def early():
        go.wait(10)
        with timing.span("early.outer"):
            with timing.span("early.inner"):
                pass
        early_done.append(threading.get_native_id())

    def items():
        for k in range(3):
            with timing.span("item.outer", tag=k):
                with timing.span("item.inner"):
                    time.sleep(0.001)
            yield k

    before = threading.Thread(target=early)
    before.start()
    with traced():
        with timing.span("main"):
            go.set()
            before.join(10)
            _collect(binarizer, VideoFrameSource(
                [str(root / "videos" / "synth01.avi")], sampling_fps=1.0))
            with PrefetchIterator(items(), depth=1) as prefetched:
                assert list(prefetched) == [0, 1, 2]
    assert not before.is_alive() and early_done
    records = taken()
    seq = {r.seq: r for r in records}
    [main] = [r for r in records if r.name == "main"]
    assert main.parent is None and main.thread == threading.get_native_id()

    drains = [r for r in records if r.name == "stage01.drain"]
    sources = [r for r in records if r.name == "stage01.source"]
    assert len(drains) == 3
    assert {r.thread for r in drains} != {main.thread}
    assert all(r.parent is None for r in drains)
    assert all(r.thread == main.thread and r.parent == main.seq
               for r in sources)

    outer = [r for r in records if r.name == "item.outer"]
    inner = [r for r in records if r.name == "item.inner"]
    assert [r.tag for r in outer] == [0, 1, 2] and len(inner) == 3
    assert len({r.thread for r in outer}) == 1
    assert outer[0].thread not in (main.thread, drains[0].thread)
    assert all(seq[r.parent].name == "item.outer" and
               seq[r.parent].thread == r.thread for r in inner)

    [early_inner] = [r for r in records if r.name == "early.inner"]
    assert early_inner.thread == early_done[0] != main.thread
    assert seq[early_inner.parent].name == "early.outer"
    assert all(r.cpu_ns >= 0 and r.end_ns >= r.start_ns for r in records)


def test_span_without_cpu_time_reads_no_cpu_clock(monkeypatch):
    """``cpu=False`` records the span with no CPU time and never reads the
    thread's CPU clock (a system call); its trace event says so too."""
    class Clocks:
        time_ns = staticmethod(time.time_ns)
        perf_counter = staticmethod(time.perf_counter)

        @staticmethod
        def thread_time_ns():
            raise AssertionError("the thread's CPU clock was read")

    monkeypatch.setattr(timing, "time", Clocks)
    stats = {"s": 0.0}
    with traced():
        with timing.span("frame", stats, "s", tag=3, cpu=False):
            time.sleep(0.001)
    [record] = taken()
    assert (record.name, record.tag, record.cpu_ns) == ("frame", 3, None)
    assert record.end_ns - record.start_ns >= 1_000_000 and stats["s"] > 0
    [event] = timing.spans_as_trace_events([record], record.start_ns, 1)
    assert event["args"]["cpu_us"] is None and event["ts"] == 0.0


def test_spans_share_the_exported_traces_clock(tmp_path):
    """A span opened with a record_function marker lands within 1 ms of it
    on the exported trace's clock (ts + baseTimeNanoseconds)."""
    with traced() as prof:
        with record_function("warm-up"):
            pass
        with record_function("marker"), timing.span("probe"):
            time.sleep(0.002)
    records = taken()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    marker = next(ev for ev in trace["traceEvents"]
                  if ev.get("name") == "marker" and ev.get("ph") == "X")
    [event] = timing.spans_as_trace_events(
        records, int(trace["baseTimeNanoseconds"]), os.getpid())
    assert abs(event["ts"] - float(marker["ts"])) < 1000.0
    assert abs(event["ts"] + event["dur"] - float(marker["ts"])
               - float(marker["dur"])) < 1000.0
    assert event["tid"] == marker["tid"]


def _tiny_binarizer():
    net = tfcn.FCNConfig(**TINY)
    model = tfcn.FCNLectureNet(net)
    model.load_state_dict(threshold_binarizer_variables(net, seed=1))
    return Binarizer(model, batch_size=4, device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("async_drain", [False, True], ids=["sync", "async"])
def test_express_lecture_spans(async_drain, monkeypatch):
    """Ten frames in batches of 4, 4 and 2: an extract and a match a frame
    under the batch's track, a drain (and, async, a wait) a batch, each of
    stages 03-05 once under the lecture."""
    frames = synthetic_rgb_lecture(seed=11, n_frames=10, height=96,
                                   width=128, n_boards=2,
                                   glyphs_per_board=5)[0]
    driver = PipelineDriver(Config(dict(EXPRESS_KEYS)), {}, None, None)
    if not async_drain:
        # the stream drains inline in a world of more than one process
        monkeypatch.setattr(binarize, "process_count", lambda: 2)
    with traced():
        run_lecture(driver, LectureInfo(id="t", title="t"),
                    _tiny_binarizer(), source=ArraySource(frames),
                    export=False)
    records = taken()
    seq = {r.seq: r for r in records}
    n = counts(records)
    assert n["lecture"] == 1
    assert n["stage02.extract"] == n["stage02.match"] == 10
    assert n["stage02.track"] == n["stage01.drain"] == 3
    assert n["stage01.wait"] == (3 if async_drain else 0)
    assert n["stage03"] == n["stage04"] == n["stage05"] == 1
    [lecture] = [r for r in records if r.name == "lecture"]
    for r in records:
        if r.name in ("stage02.extract", "stage02.match"):
            assert seq[r.parent].name == "stage02.track"
            assert r.cpu_ns is None   # a frame's spans leave it to track
        else:
            assert r.cpu_ns >= 0
        if r.name in ("stage02.track", "stage03", "stage04", "stage05",
                      "stage01.source", "stage01.dispatch", "stage01.wait"):
            assert r.parent == lecture.seq
    assert sorted(r.tag for r in records if r.name == "stage02.track") == \
        [0, 1, 2]


def test_training_epoch_spans(tmp_path):
    """Four samples in two batches through train_epoch with prefetch: the
    three data spans a sample and the pixels' span a batch (tagged with
    its route, the host's here) under its batch, and the upload, on the
    prefetch thread; a step and a wait a step on the trainer's thread, and
    one more wait that finds the epoch's end."""
    rgb, binary, _, _ = synthetic_rgb_lecture(seed=0, n_frames=4, height=48,
                                              width=64)
    images, truths = [], []
    for k in range(4):
        images.append(str(tmp_path / f"img_{k}.png"))
        truths.append(str(tmp_path / f"gt_{k}.png"))
        with open(images[-1], "wb") as f:
            f.write(encode_png(np.ascontiguousarray(rgb[k][:, :, ::-1])))
        with open(truths[-1], "wb") as f:
            f.write(encode_png(np.ascontiguousarray(255 - binary[k])))
    dataset = LectureNetDataset(images, truths, crop_size=(32, 32),
                                flip_chance=0.5, gaussian_noise_chance=0.5,
                                weight_expansion=2, text_mask_expansion=3,
                                seed=0)
    model = tfcn.init_weights(tfcn.FCNLectureNet(tfcn.FCNConfig(**TINY)),
                              torch.Generator().manual_seed(0))
    trainer = Trainer(model, 0.05, phase="binarizer", prefetch_depth=2,
                      device="cpu")
    with traced():
        trainer.train_epoch(dataset, 2)
    records = taken()
    seq = {r.seq: r for r in records}
    n = counts(records)
    assert n["data.decode"] == n["data.augment"] == n["data.masks"] == 4
    assert n["data.batch"] == n["train.upload"] == n["train.step"] == 2
    assert n["data.pixels"] == 2
    assert n["train.wait"] == 3
    main = threading.get_native_id()
    for r in records:
        if r.name.startswith("data.") or r.name == "train.upload":
            assert r.thread != main
        else:
            assert r.thread == main
        if r.name == "data.pixels":
            assert r.tag == "host"
        if r.name in ("data.decode", "data.augment", "data.masks",
                      "data.pixels"):
            assert seq[r.parent].name == "data.batch"
            assert r.cpu_ns is None   # a sample's spans leave it to batch
        elif r.name in STEP_PARTS:
            assert seq[r.parent].name == "train.step"
            assert r.cpu_ns is None   # a step's parts leave it to the step
        else:
            assert r.cpu_ns >= 0


@pytest.mark.parametrize("phase", ["text_detector", "reconstruction"])
def test_a_step_records_its_forward_backward_and_update(phase):
    """One CPU step under the profiler: ``train.forward`` (tagged with the
    phase), ``train.backward`` and ``train.update``, once each, in that
    order inside ``train.step`` on the trainer's thread, none reading the
    CPU clock; none without a profiler."""
    rng = np.random.default_rng(0)
    batch = {"image": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
             "median": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)}
    batch["target"] = (rng.random((2, 32, 32, 1)) < 0.2).astype(np.float32)
    batch["text_mask"] = 1.0 - batch["target"]
    reconstruction = phase == "reconstruction"
    model = tfcn.init_weights(
        tfcn.FCNLectureNet(tfcn.FCNConfig(**TINY),
                           reconstruction_mode=reconstruction),
        torch.Generator().manual_seed(0))
    trainer = Trainer(model, 0.01, phase=phase, freeze_bn=not reconstruction,
                      fold_frozen_bn=not reconstruction, prefetch_depth=0,
                      device="cpu")
    batch = trainer.to_device(batch)
    trainer.step(batch)
    assert taken() == []
    with traced():
        trainer.step(batch)
    records = taken()
    assert [r.name for r in records] == [*STEP_PARTS, "train.step"]
    seq = {r.seq: r for r in records}
    step = records[-1]
    main = threading.get_native_id()
    for r in records[:-1]:
        assert r.parent == step.seq and seq[r.parent].name == "train.step"
        assert r.thread == main and r.cpu_ns is None
        assert step.start_ns <= r.start_ns <= r.end_ns <= step.end_ns
        assert r.tag == (phase if r.name == "train.forward" else None)
    assert records[0].end_ns <= records[1].start_ns
    assert records[1].end_ns <= records[2].start_ns


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_median_span_a_sample_only_where_the_median_is_made(
        tmp_path, monkeypatch, route):
    """``data.median``: once a batch, inside its ``data.batch`` and beside
    its samples' ``data.masks``, tagged with the route that made the
    medians, and only while a profiler runs; a sample drawn on its own
    makes its median in a span of its own; a binarizer-phase dataset (no
    median target) records none."""
    from lecturemath_tpu_torch import native
    from lecturemath_tpu_torch.utils.image import median_route

    if route == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    assert median_route() == route
    rgb, binary, _, _ = synthetic_rgb_lecture(seed=0, n_frames=4, height=48,
                                              width=64)
    images, truths = [], []
    for k in range(4):
        images.append(str(tmp_path / f"img_{k}.png"))
        truths.append(str(tmp_path / f"gt_{k}.png"))
        with open(images[-1], "wb") as f:
            f.write(encode_png(np.ascontiguousarray(rgb[k][:, :, ::-1])))
        with open(truths[-1], "wb") as f:
            f.write(encode_png(np.ascontiguousarray(255 - binary[k])))
    reconstruction = LectureNetDataset(images, None, reconstruction_mode=True,
                                       crop_size=(32, 32), flip_chance=0.5,
                                       reconstruct_median=True,
                                       reconstruct_median_k=5, seed=0)
    list(reconstruction.batches(2))
    assert taken() == []
    with traced():
        list(reconstruction.batches(2))
    records = taken()
    seq = {r.seq: r for r in records}
    medians = [r for r in records if r.name == "data.median"]
    assert counts(records)["data.masks"] == 4
    assert len(medians) == counts(records)["data.batch"] == 2
    for r in medians:
        assert seq[r.parent].name == "data.batch"
        assert r.tag == route and r.cpu_ns is None
    with traced():
        reconstruction.sample(0)
    n = counts(taken())
    assert n["data.masks"] == n["data.median"] == 1
    binarizer = LectureNetDataset(images, truths, crop_size=(32, 32),
                                  text_mask_expansion=3, seed=0)
    with traced():
        list(binarizer.batches(2))
    n = counts(taken())
    assert n["data.masks"] == 4 and n["data.median"] == 0


def test_run_pipeline_trace_holds_the_spans(stream_workspace, tmp_path):
    """``-trace <dir>`` on the express CLI: trace.json holds the port's
    spans as complete events on the trace's clock, the drain thread's
    beside the lecture's."""
    root, _ = stream_workspace
    trace_dir = tmp_path / "trace"
    run_pipeline.main(["run_pipeline", str(root / "test.conf"), "-device",
                       "cpu", "-trace", str(trace_dir)])
    with open(trace_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [ev for ev in events if ev.get("cat") == "program_span"]
    names = Counter(ev["name"] for ev in spans)
    assert names["lecture"] == 1 and names["stage02.extract"] == 12
    assert names["stage03"] == names["stage04"] == names["stage05"] == 1
    lecture = next(ev for ev in spans if ev["name"] == "lecture")
    drains = [ev for ev in spans if ev["name"] == "stage01.drain"]
    assert drains and all(ev["tid"] != lecture["tid"] for ev in drains)
    assert all(ev["ph"] == "X" and ev["pid"] == os.getpid() for ev in spans)
    convs = [ev for ev in events if ev.get("ph") == "X"
             and str(ev.get("name", "")).startswith("aten::conv")]
    assert convs and all(
        lecture["ts"] <= float(ev["ts"]) and float(ev["ts"]) + float(
            ev["dur"]) <= lecture["ts"] + lecture["dur"] for ev in convs)
