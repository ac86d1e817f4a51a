"""Whole runs of each cell on the CPU at tiny sizes (the harness's look for a
card skipped), sound and with the timed path broken underneath: a sound run
comes out correct, and each fault the cell can have makes ``correct``
false."""

import pytest
import torch

from benchmark.control import SUMMARY_FAULTS, planted
from benchmark.harness import execute
from benchmark.tests.conftest import TINY

SEED = 2 ** 33 + 17
SIZES = {
    "stage01-1080p": {"config": dict(TINY, frame_height=270, frame_width=480,
                                     lecture_frames=90),
                      "traffic": {"glyphs_per_board": 20,
                                  "glyph_size": [20, 30], "warmup_frames": 8}},
    "express-1080p": {"config": dict(TINY, frame_height=540, frame_width=960,
                                     lecture_frames=90),
                      "traffic": {"glyphs_per_board": 60,
                                  "glyph_size": [40, 60], "warmup_frames": 8}},
    "train-bin-b8": {"config": dict(TINY, keyframe_height=300,
                                    keyframe_width=400, keyframes=24),
                     "traffic": {"glyphs": 30}},
}


def run(cell, **driver):
    overrides = dict(SIZES[cell], driver=driver)
    return execute(cell, SEED, 0.1, False, device="cpu", overrides=overrides)


def failed(result):
    return [name for name, c in result["checks"].items()
            if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("cell", list(SIZES))
def test_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checks"]
    assert result["metrics"]["setup_s"]["value"] > 0
    assert result["attempted"] > 0 and result["failed"] == 0


def _flip_k1(monkeypatch):
    """An answer altered where it is produced: K1's bits of the first rows
    flipped."""
    from lecturemath_tpu_torch.models import fcn_lecturenet

    real = fcn_lecturenet.threshold_pack

    def flipped(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[:, :8] ^= 0xFF
        return out

    monkeypatch.setattr(fcn_lecturenet, "threshold_pack", flipped)


def _half_batch(monkeypatch):
    """Half of the batch left out: the second half's frames get the first
    half's outputs."""
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNLectureNet

    real = FCNLectureNet.forward

    def half(self, x0, mode="full"):
        keep = (x0.shape[0] + 1) // 2
        out = real(self, x0[:keep], mode)
        index = torch.arange(x0.shape[0]) % keep
        return tuple(o[index] for o in out)

    monkeypatch.setattr(FCNLectureNet, "forward", half)


@pytest.mark.parametrize("cell", ["stage01-1080p", "express-1080p"])
@pytest.mark.parametrize("fault", [_flip_k1, _half_batch])
def test_lecture_faults(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = run(cell)
    assert not result["correct"]
    assert failed(result)


@pytest.mark.parametrize("fault", list(SUMMARY_FAULTS))
def test_summary_faults(fault):
    """A segment boundary moved two frames either way, or keyframes taken
    from the wrong frame, fail the summary's checks."""
    with planted(fault):
        result = run("express-1080p")
    assert not result["correct"]
    assert failed(result) and set(failed(result)) <= {"era_split_off",
                                                      "keyframe_gap"}


def _unchanged(trainer):
    """A step that returns its state unchanged."""
    trainer.optimizer.step = lambda *args, **kwargs: None


def _half_rows(trainer):
    """Half of the batch left out, the mean taken over the rest."""
    upload = trainer.to_device

    def half(batch):
        return upload({k: v[:len(v) // 2] for k, v in batch.items()})

    trainer.to_device = half


@pytest.mark.parametrize("fault", [_unchanged, _half_rows])
def test_train_faults(fault):
    result = run("train-bin-b8", fault=fault)
    assert not result["correct"]
    assert failed(result)
