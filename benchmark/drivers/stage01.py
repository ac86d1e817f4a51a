"""stage01-1080p: the lecture through the port's stage-01 stream
(``Binarizer.stream_source``) alone, the drained frames only collected, back
to back for the window.

End to end: ``stage01_fps``, the frames of every pass completed over their
wall (the pass in flight when the window closes finishes and counts).
Correct: the sampled frames' logits and K1 bits against the plain
reference.
"""

from __future__ import annotations

import time

from benchmark.drivers._lecture import (Sampler, judge_stage01,
                                        make_binarizer, make_lecture,
                                        sample_frames)
from benchmark.harness import Context


def run(ctx: Context) -> None:
    from lecturemath_tpu_torch.pipeline.video import ArraySource

    lecture = make_lecture(ctx)
    binarizer, state = make_binarizer(ctx)
    warm = ArraySource(lecture.frames)
    for _ in binarizer.stream_source(warm, ctx.traffic["warmup_frames"]):
        pass
    sampler = Sampler(binarizer, sample_frames(ctx, lecture.n_frames,
                                               ctx.traffic["sampled_frames"]),
                      lecture.height, lecture.width)
    frames = passes = 0
    stats = {"source_s": 0.0, "dispatch_s": 0.0, "drain_s": 0.0}
    with ctx.window():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            collected = []
            stream = binarizer.stream_source(ArraySource(lecture.frames))
            while True:
                with ctx.span("stage01_wait"):
                    item = next(stream, None)
                if item is None:
                    break
                sampler.take(item[1], item[2])
                collected.extend(item[2])
            frames += len(collected)
            passes += 1
            for key in stats:
                stats[key] += binarizer.stream_stats.get(key, 0.0)
        wall = time.perf_counter() - t0
    ctx.read_memory_peak()
    ctx.metrics["stage01_fps"] = frames / wall
    ctx.attempted = passes * lecture.n_frames
    ctx.failed = ctx.attempted - frames
    ctx.counters.update(stats, frames=frames, passes=passes,
                        batch=binarizer.batch_size, wall_s=wall)
    sampler.close()
    del binarizer, collected
    ctx.free()
    judge_stage01(ctx, lecture, state, sampler)
