"""Readings of the controls that the limits of ``correct`` are set from: the
plain reference put in the program's place at the precision below the one
the configuration states, at a cell's own sizes, on the inputs a run of
each seed makes. One JSON line a seed.

    python benchmark/control.py --workload stage01-1080p --seeds 1 2 3

Lecture cells: the reference in fp8 (e4m3, one scale a tensor) against the
f32 reference on the sampled frames (``logit_gap``), and the widest margin
by which its K1 decision lies on the wrong side of the f32 reference's
(``bit_gap``); express also runs whole with each of ``SUMMARY_FAULTS``
planted in the program (its checks of the summary); training:
``train_control``. Each also reads the faults the cell's tests plant, where
the control's reading leaves a number without an upper one. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lecture_control(ctx) -> dict:
    import torch

    from benchmark.drivers._lecture import (THRESHOLD_LOGIT, make_lecture,
                                            sample_frames)
    from benchmark.harness import seed_for
    from benchmark.reference.fcn import (Reference, fp8_round, model_input,
                                         no_tf32)
    from benchmark.traffic.weights import make_state, net_widths

    no_tf32()
    net = net_widths(ctx.config)
    lecture = make_lecture(ctx)
    state = make_state(net, seed_for(ctx.seed, "weights"), ctx.device)
    reference = Reference(state, net)
    control = Reference(state, net, fp8_round)
    h, w = ctx.config["frame_height"], ctx.config["frame_width"]
    logit_gap = bit_gap = flipped = 0.0
    sampled = sample_frames(ctx, lecture.n_frames,
                            ctx.traffic["sampled_frames"])
    for t in sampled:
        rgb = torch.from_numpy(lecture.frames[t][None].copy()).to(ctx.device)
        with torch.no_grad():
            x = model_input(rgb)
            ref = reference(x)[0][0, 0, :h, :w]
            low = control(x)[0][0, 0, :h, :w]
        scale = float(ref.abs().max())
        logit_gap = max(logit_gap, float((low - ref).abs().max()) / scale)
        wrong = (low >= THRESHOLD_LOGIT) != (ref >= THRESHOLD_LOGIT)
        if bool(wrong.any()):
            bit_gap = max(bit_gap, float((ref - THRESHOLD_LOGIT).abs()[wrong]
                                         .max()) / scale)
        # the fault of an answer altered where it is produced: K1's first
        # eight rows flipped
        flipped = max(flipped, float((ref[:8] - THRESHOLD_LOGIT).abs().max())
                      / scale)
    return {"logit_gap": logit_gap, "bit_gap": bit_gap,
            "fault_flipped_rows": {"bit_gap": flipped}}


def _shift_boundaries(frames: int):
    """Every boundary between two segments moved ``frames`` later (earlier
    where negative); the lecture's own ends stay."""
    from lecturemath_tpu_torch.pipeline import segmentation

    real = segmentation.segments_from_deletion_events

    def shifted(*args, **kwargs):
        intervals = real(*args, **kwargs)
        last = len(intervals) - 1
        return [(s + (frames if k else 0), e + (frames if k < last else 0))
                for k, (s, e) in enumerate(intervals)]

    return segmentation, "segments_from_deletion_events", shifted


def _keyframe_early():
    """Each keyframe rendered a quarter into its segment, not at its end
    (the summary still names the segment's end)."""
    from lecturemath_tpu_torch.pipeline import express

    real = express.extract_keyframes

    def early(st3d, intervals, *args, **kwargs):
        return real(st3d, [(s, s + (e - s) // 4) for s, e in intervals],
                    *args, **kwargs)

    return express, "extract_keyframes", early


# faults of the express summary: each gives (module, name, replacement)
SUMMARY_FAULTS = {"boundary_2_earlier": lambda: _shift_boundaries(-2),
                  "boundary_2_later": lambda: _shift_boundaries(2),
                  "keyframe_early": _keyframe_early}


@contextlib.contextmanager
def planted(fault: str):
    """Plant ``SUMMARY_FAULTS[fault]`` in the program for the block."""
    module, name, replacement = SUMMARY_FAULTS[fault]()
    real = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, real)


def express_control(ctx) -> dict:
    """``lecture_control``, and the checks of a whole express run of the
    seed (one lecture) with each summary fault planted."""
    from benchmark.harness import execute

    readings = lecture_control(ctx)
    for fault in SUMMARY_FAULTS:
        with planted(fault):
            result = execute(ctx.cell, ctx.seed, 0.1, False, ctx.device)
        readings[f"fault_{fault}"] = {k: c["value"] for k, c
                                      in result["checks"].items()}
    return readings


def train_control(ctx) -> dict:
    """The bf16 reference's three steps (``torch.autocast``: every conv's
    operands and output in bf16, forward and backward), and the f32
    reference's on half of each batch (the mean over the rest), against the
    f32 reference's on the seed's batches."""
    import torch

    from benchmark.drivers.train import CHECKED_STEPS
    from benchmark.harness import seed_for
    from benchmark.reference import augment, fcn, train
    from benchmark.traffic.lecture import keyframes
    from benchmark.traffic.weights import make_state, net_widths

    fcn.no_tf32()
    cfg = ctx.config
    net = net_widths(cfg)
    images, truths = keyframes(seed_for(ctx.seed, "keyframes"),
                               cfg["keyframes"], cfg["keyframe_height"],
                               cfg["keyframe_width"],
                               glyphs=ctx.traffic["glyphs"],
                               glyph_size=tuple(ctx.traffic["glyph_size"]))
    batches = augment.first_batches(images, truths, cfg,
                                    seed_for(ctx.seed, "data"), CHECKED_STEPS)
    state = make_state(net, seed_for(ctx.seed, "weights"), ctx.device)
    lr = cfg["learning_rate"]
    ref_losses, ref_after = train.steps(state, net, batches, lr)
    halves = [{k: v[:len(v) // 2] for k, v in b.items()} for b in batches]
    readings = {}
    for name, (losses, after) in (
            ("bf16", train.steps(state, net, batches, lr, torch.bfloat16)),
            ("half_batch", train.steps(state, net, halves, lr))):
        readings[name] = train.gaps(state, lr, losses, after[0], after[-1],
                                    ref_losses, ref_after)
    return readings


CONTROLS = {"express": express_control, "stage01": lecture_control,
            "train": train_control}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import make_context

    for seed in args.seeds:
        ctx = make_context(args.workload, seed, 0.0, False, args.device)
        readings = CONTROLS[ctx.workload["driver"]](ctx)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
