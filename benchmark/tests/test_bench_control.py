"""The controls (the plain reference in the program's place, at the
precision below the configuration's) fail the cells' limits: at sizes the
CPU holds here, and at the cells' own sizes on the card."""

import pytest

from benchmark import control
from benchmark.harness import make_context

SEED = 2 ** 32 + 3
SMALL = {
    "stage01-1080p": {"config": {"frame_height": 160, "frame_width": 256,
                                 "lecture_frames": 12},
                      "traffic": {"glyphs_per_board": 12,
                                  "glyph_size": [30, 40]}},
    "train-bin-b8": {"config": {"keyframe_height": 300, "keyframe_width": 400,
                                "keyframes": 24},
                     "traffic": {"glyphs": 30}},
}


def readings(cell, device="cpu", overrides=None):
    ctx = make_context(cell, SEED, 0.0, False, device, overrides)
    return ctx, control.CONTROLS[ctx.workload["driver"]](ctx)


def fails(ctx, values):
    return [k for k, limit in ctx.workload["limits"].items()
            if k in values and values[k] > limit]


def test_inference_control_fails_small():
    ctx, values = readings("stage01-1080p", overrides=SMALL["stage01-1080p"])
    assert fails(ctx, values), values


def test_training_control_and_fault_fail_small():
    ctx, values = readings("train-bin-b8", overrides=SMALL["train-bin-b8"])
    assert fails(ctx, values["bf16"]), values
    assert fails(ctx, values["half_batch"]), values


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["stage01-1080p", "express-1080p",
                                  "train-bin-b8"])
def test_control_fails_at_cell_size(card, cell):
    ctx, values = readings(cell, device="cuda")
    if cell == "train-bin-b8":
        found = [values["bf16"], values["half_batch"]]
    else:
        found = [values] + [values[f"fault_{fault}"]
                            for fault in control.SUMMARY_FAULTS
                            if f"fault_{fault}" in values]
    for each in found:
        assert fails(ctx, each), each
