"""What the lecture cells share: the seeded lecture, the seeded model in the
port's stage-01 binarizer, a sample of the timed path's outputs, and their
comparison with the plain reference."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from benchmark.harness import Context, seed_for
from benchmark.traffic.lecture import Lecture
from benchmark.traffic.weights import make_state, net_widths

# the binary decision of K1: floor(sigmoid(x) * 255) >= 128
THRESHOLD_LOGIT = math.log(128.0 / 127.0)


def make_lecture(ctx: Context) -> Lecture:
    cfg, traffic = ctx.config, ctx.traffic
    return Lecture(seed_for(ctx.seed, "lecture"),
                   n_frames=cfg["lecture_frames"],
                   height=cfg["frame_height"], width=cfg["frame_width"],
                   n_boards=traffic["boards"],
                   glyphs_per_board=traffic["glyphs_per_board"],
                   glyph_size=tuple(traffic["glyph_size"]))


def make_binarizer(ctx: Context):
    """(the port's stage-01 Binarizer over the seeded weights, the f32
    state dict it was given). As stage 01 runs it: BN folded, bf16,
    channels_last, K2 on the heads, K1 on the tail, batch from the card's
    free memory."""
    import torch

    from lecturemath_tpu_torch.models.fcn_lecturenet import (FCNConfig,
                                                             FCNLectureNet)
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer

    net = net_widths(ctx.config)
    state = make_state(net, seed_for(ctx.seed, "weights"), ctx.device)
    model = FCNLectureNet(FCNConfig(**{k: tuple(v) if isinstance(v, list)
                                       else v for k, v in net.items()}))
    model = model.to(ctx.device)
    model.load_state_dict(state)
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[
        ctx.config["precision"]]
    binarizer = Binarizer(model, dtype=dtype, device=ctx.device,
                          max_model_pixels=ctx.config["max_model_pixels"])
    return binarizer, state


class Sampler:
    """Keeps the logits of sampled frames of the first lecture as the
    binarizer's model returns them (a forward hook: the program is not
    touched) and the binaries the stream yields for them."""

    def __init__(self, binarizer, frames: List[int], height: int, width: int):
        self.frames = sorted(set(frames))
        self.height, self.width = height, width
        self.binarizer = binarizer
        self.calls = 0
        self.logits: Dict[int, object] = {}
        self.binaries: Dict[int, np.ndarray] = {}
        self._handle = binarizer.model.register_forward_hook(self._hook)

    def _hook(self, module, inputs, output):
        batch = self.binarizer.batch_size
        first = self.calls * batch
        self.calls += 1
        for t in self.frames:
            if first <= t < first + batch and t not in self.logits:
                self.logits[t] = output[0][t - first, 0, :self.height,
                                           :self.width].float().clone()

    def take(self, indices, frames) -> None:
        for t, frame in zip(indices, frames):
            if t in self.logits and t not in self.binaries:
                self.binaries[t] = frame

    def close(self) -> None:
        self._handle.remove()
        self.binarizer = None
        self.logits = {t: v.cpu() for t, v in self.logits.items()}


def sample_frames(ctx: Context, n_frames: int, count: int) -> List[int]:
    """``count`` frames drawn from the seed, and the last frame (it rides
    the padded last batch)."""
    rng = np.random.default_rng(seed_for(ctx.seed, "sample"))
    picks = rng.choice(n_frames - 1, size=count - 1, replace=False)
    return sorted(int(t) for t in picks) + [n_frames - 1]


def judge_stage01(ctx: Context, lecture: Lecture, state, sampler: Sampler):
    """The sampled frames through the plain f32 reference (TF32 off, one
    frame at a time): the widest logit gap, and the widest margin by which
    a K1 bit lies on the wrong side of the reference's threshold, each over
    the reference's largest |logit|."""
    import torch

    from benchmark.reference.fcn import Reference, model_input, no_tf32

    no_tf32()
    net = net_widths(ctx.config)
    reference = Reference(state, net)
    h, w = ctx.config["frame_height"], ctx.config["frame_width"]
    logit_gap, bit_gap = 0.0, 0.0
    missing = [t for t in sampler.frames
               if t not in sampler.logits or t not in sampler.binaries]
    for t in sampler.frames:
        if t in missing:
            continue
        rgb = torch.from_numpy(np.ascontiguousarray(lecture.frames[t][None]))
        with torch.no_grad():
            ref = reference(model_input(rgb.to(ctx.device)))[0][0, 0, :h, :w]
        ref = ref.float().cpu()
        scale = float(ref.abs().max())
        ours = sampler.logits[t]
        logit_gap = max(logit_gap, float((ours - ref).abs().max()) / scale)
        # the stream yields the stage-01 artifact polarity: ink 255
        board = torch.from_numpy(sampler.binaries[t] == 0)
        wrong = board != (ref >= THRESHOLD_LOGIT)
        if bool(wrong.any()):
            margin = float((ref - THRESHOLD_LOGIT).abs()[wrong].max())
            bit_gap = max(bit_gap, margin / scale)
        del ref
    if missing:
        # a sampled frame the timed path never produced
        logit_gap = bit_gap = float("inf")
    ctx.check("logit_gap", logit_gap)
    ctx.check("bit_gap", bit_gap)
