"""express-1080p: whole lectures through the port's express pipeline
(``pipeline/express.py run_lecture``: stage 01 on the card, stages 02-05 on
the host), back to back for the window, fed from memory.

End to end: ``express_fps``, the frames of every lecture completed over
their wall (the lecture in flight when the window closes finishes and
counts). Correct: the sampled frames' stage-01 logits and K1 bits against
the plain reference, and every lecture's summary: its segment ends against
the lecture's boards, and each keyframe's binary against the reference's
decision for the frame the summary names.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from benchmark.drivers._lecture import (THRESHOLD_LOGIT, Sampler,
                                        judge_stage01, make_binarizer,
                                        make_lecture, sample_frames)
from benchmark.harness import Context


class Probe:
    """Stands in for the binarizer in ``run_lecture``: yields the real
    stream's batches and times how long the caller holds each (stage 02 on
    the host) and, from the stream's end to the call's return, stages
    03-05."""

    def __init__(self, binarizer, ctx: Context, sampler: Sampler):
        self.binarizer, self.ctx, self.sampler = binarizer, ctx, sampler
        self.end_tail = None

    def __getattr__(self, name):
        return getattr(self.binarizer, name)

    def stream_source(self, source, frames_limit: int = 0,
                      invert: bool = True):
        stream = self.binarizer.stream_source(source, frames_limit, invert)
        while True:
            with self.ctx.span("stage01_wait"):
                item = next(stream, None)
            if item is None:
                break
            self.sampler.take(item[1], item[2])
            with self.ctx.span("track"):
                yield item
        self.end_tail = self.ctx.begin("tail")


def pipeline_config(ctx: Context):
    """The configuration's stage 01-05 settings, with any the cell's
    traffic sets instead."""
    from lecturemath_tpu_torch.core.config import Config

    return Config(dict(ctx.config["pipeline"],
                       **ctx.traffic.get("pipeline", {})))


def reference_ink(ctx: Context, state, lecture, frames) -> dict:
    """The plain f32 reference's ink decision (bool [H, W]) for each of
    ``frames``, one frame at a time."""
    import torch

    from benchmark.reference.fcn import Reference, model_input, no_tf32
    from benchmark.traffic.weights import net_widths

    no_tf32()
    reference = Reference(state, net_widths(ctx.config))
    h, w = lecture.height, lecture.width
    ink = {}
    for t in sorted(set(frames)):
        rgb = torch.from_numpy(np.ascontiguousarray(lecture.frames[t][None]))
        with torch.no_grad():
            logits = reference(model_input(rgb.to(ctx.device)))[0]
        ink[t] = (logits[0, 0, :h, :w] < THRESHOLD_LOGIT).cpu().numpy()
    return ink


def summary_checks(ctx: Context, lecture, state, results) -> None:
    """Every lecture's summary. ``era_split_off``: how far, in frames, the
    keyframe of each board lies from the board's last frame (the lecture's
    length where the count of keyframes is wrong). ``keyframe_gap``: one
    less the overlap (intersection over union) of each keyframe's ink with
    the reference's decision for the frame the summary names, the worst
    keyframe (1 where a lecture has none)."""
    ends = [t - 1 for t in lecture.erase_times] + [lecture.n_frames - 1]
    named = [int(i) for indices, _, _ in results for i in indices]
    ink = reference_ink(ctx, state, lecture,
                        [t for t in named if 0 <= t < lecture.n_frames])
    split, gap = 0.0, 0.0
    for indices, _, keyframes in results:
        if len(indices) != len(ends) or len(keyframes) != len(ends):
            split = float(lecture.n_frames)
        else:
            split = max(split, max(abs(int(i) - e)
                                   for i, e in zip(indices, ends)))
        if not len(keyframes):
            gap = 1.0
        for t, keyframe in zip(indices, keyframes):
            ours = np.asarray(keyframe)[..., 0] < 128   # black ink on white
            theirs = ink.get(int(t))
            if theirs is None or ours.shape != theirs.shape:
                gap = 1.0
                continue
            union = int((ours | theirs).sum())
            if union:
                gap = max(gap, 1.0 - int((ours & theirs).sum()) / union)
    ctx.check("era_split_off", split)
    ctx.check("keyframe_gap", gap)


def run(ctx: Context) -> None:
    from lecturemath_tpu_torch.core.metadata import LectureInfo
    from lecturemath_tpu_torch.pipeline.driver import PipelineDriver
    from lecturemath_tpu_torch.pipeline.express import run_lecture
    from lecturemath_tpu_torch.pipeline.video import ArraySource

    lecture = make_lecture(ctx)
    binarizer, state = make_binarizer(ctx)
    driver = PipelineDriver(pipeline_config(ctx), {}, None, None)
    info = LectureInfo(id="bench", title="bench")
    # warm-up: the stream's one batch shape (the last batch is padded to
    # it) through every kernel, and the host library stage 02 loads
    warm = ArraySource(lecture.frames)
    for _ in binarizer.stream_source(warm, ctx.traffic["warmup_frames"]):
        pass
    from lecturemath_tpu_torch import native

    native.get_lib()

    sampler = Sampler(binarizer, sample_frames(ctx, lecture.n_frames,
                                               ctx.traffic["sampled_frames"]),
                      lecture.height, lecture.width)
    probe = Probe(binarizer, ctx, sampler)
    frames = 0
    stats = {"source_s": 0.0, "dispatch_s": 0.0, "drain_s": 0.0}
    results, walls = [], []
    with ctx.window():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            started = time.perf_counter()
            results.append(run_lecture(driver, info, probe,
                                       source=ArraySource(lecture.frames),
                                       export=False))
            probe.end_tail()
            walls.append(time.perf_counter() - started)
            frames += lecture.n_frames
            for key in stats:
                stats[key] += binarizer.stream_stats.get(key, 0.0)
        wall = time.perf_counter() - t0
    ctx.read_memory_peak()
    ctx.metrics["express_fps"] = frames / wall
    ctx.attempted = frames
    ctx.counters.update(stats, frames=frames, lectures=len(results),
                        batch=binarizer.batch_size, wall_s=wall)
    spent = {name: round(sum(v), 3) for name, v in ctx.spans.items()}
    print(f"express: {len(results)} lectures of {lecture.n_frames} frames, "
          f"batch {binarizer.batch_size}, seconds each "
          f"{[round(w, 3) for w in walls]}, host spans {spent}",
          file=sys.stderr)
    sampler.close()
    del probe, binarizer, driver
    ctx.free()
    judge_stage01(ctx, lecture, state, sampler)
    summary_checks(ctx, lecture, state, results)
