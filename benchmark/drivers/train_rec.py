"""train-rec-b8: the port's reconstruction phase (Med-PT), built as
``run_phase`` builds a phase without a warm start: ``FCNLectureNet`` in
reconstruction mode, fp32, ``init_weights`` drawn from the seed;
``Trainer`` with live BatchNorm, SGD at the phase's rate, prefetch 2; the
dataset of ``cli/train_reconstruction.py``, median targets at k = 35,
preloaded. It trains over the 300 frames of one seeded 1080p lecture,
whole epochs of ``Trainer.train_epoch`` back to back for the window.

The convs run in the configuration's precision, float32: the run turns
TF32 off first (PyTorch leaves cuDNN free to round a conv's operands to
TF32), so the nearest precision below, TF32, is what ``correct`` tells
apart from it.

Set-up builds the trainer once and drives its first three steps through
``train_epoch`` on three batches of the first epoch; the window goes on
from the fourth. End to end: ``train_img_s``, the images stepped over the
epochs' wall (the epoch in flight when the window closes finishes and
counts). Correct: the three steps' losses, the first gradient and the
parameters' change over those three steps (``reference/train.py gaps``),
and the BatchNorm running buffers after them (``stat_gap``), against the
plain float32 reference on its own batches.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

from benchmark.drivers.train import Feed, params_of
from benchmark.harness import Context, seed_for
from benchmark.reference.rec_train import BUFFERS
from benchmark.traffic import pngio
from benchmark.traffic.lecture import Lecture
from benchmark.traffic.weights import net_widths

CHECKED_STEPS = 3


def render(ctx: Context):
    """The frames of the seeded lecture (a list of uint8 RGB arrays; the
    frames of one content segment are one array)."""
    cfg, traffic = ctx.config, ctx.traffic
    lecture = Lecture(seed_for(ctx.seed, "lecture"), n_frames=cfg["frames"],
                      height=cfg["frame_height"], width=cfg["frame_width"],
                      n_boards=traffic["boards"],
                      glyphs_per_board=traffic["glyphs_per_board"],
                      glyph_size=tuple(traffic["glyph_size"]))
    return lecture.frames


def write_frames(frames, directory: str):
    """A PNG file a frame (the dataset reads files): each distinct frame
    encoded once by a few threads (zlib lets go of the interpreter), the
    files of its repeats linked to it."""
    first = {}
    for k, frame in enumerate(frames):
        first.setdefault(id(frame), k)
    paths = [os.path.join(directory, f"{k:03d}.png")
             for k in range(len(frames))]

    def write(k):
        with open(paths[k], "wb") as f:
            f.write(pngio.encode(frames[k]))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, first.values()))
    for k, frame in enumerate(frames):
        if first[id(frame)] != k:
            os.link(paths[first[id(frame)]], paths[k])
    return paths


def make_dataset(ctx: Context, frames):
    from lecturemath_tpu_torch.train.dataset import LectureNetDataset

    cfg = ctx.config
    directory = tempfile.mkdtemp(prefix="bench_frames_")
    try:
        dataset = LectureNetDataset(
            write_frames(frames, directory), None, reconstruction_mode=True,
            crop_size=tuple(cfg["crop_size"]),
            flip_chance=cfg["flip_chance"],
            color_invert_chance=cfg["color_invert_chance"],
            color_change_chance=cfg["color_change_chance"],
            gaussian_noise_chance=cfg["gaussian_noise_chance"],
            gaussian_noise_level=cfg["gaussian_noise_level"],
            reconstruct_median=cfg["reconstruct_median"],
            reconstruct_median_k=cfg["median_k"],
            seed=seed_for(ctx.seed, "data"))
        dataset.preload()
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return dataset


def make_model(ctx: Context):
    """(the port's model, ``init_weights`` drawn from the seed; its f32
    state dict, on the device)."""
    import torch

    from lecturemath_tpu_torch.models.fcn_lecturenet import (
        FCNConfig, FCNLectureNet, init_weights)

    cfg = ctx.config
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[cfg["precision"]]
    net = net_widths(cfg)
    model = FCNLectureNet(FCNConfig(**{k: tuple(v) if isinstance(v, list)
                                       else v for k, v in net.items()}),
                          reconstruction_mode=cfg["reconstruction_mode"],
                          compute_dtype=dtype, bn_dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(
        seed_for(ctx.seed, "weights")))
    state = {k: v.detach().clone().to(ctx.device)
             for k, v in model.state_dict().items()}
    return model, state


def make_trainer(ctx: Context, model):
    from lecturemath_tpu_torch.train.trainer import Trainer

    cfg = ctx.config
    return Trainer(model, cfg["learning_rate"], momentum=cfg["momentum"],
                   phase=cfg["phase"], freeze_bn=cfg["freeze_bn"],
                   fold_frozen_bn=cfg["fold_frozen_bn"],
                   prefetch_depth=cfg["prefetch_batches"], device=ctx.device)


def buffers_of(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.named_buffers()
            if k.endswith(BUFFERS)}


def run(ctx: Context, fault=None) -> None:
    import torch

    from benchmark.reference import fcn

    if ctx.config["precision"] == "fp32":
        fcn.no_tf32()
    frames = render(ctx)
    dataset = make_dataset(ctx, frames)
    model, state = make_model(ctx)
    trainer = make_trainer(ctx, model)
    if fault is not None:
        fault(trainer)
    size = ctx.config["batch_size"]
    # the first steps: set-up, through the window's own call and feed, on
    # the first batches of one epoch
    first_epoch = dataset.batches(size)
    losses, snapshots = [], [params_of(trainer)]
    for _ in range(CHECKED_STEPS):
        metrics = trainer.train_epoch(Feed(dataset, ctx, source=first_epoch,
                                           limit=1), size)
        losses.append(metrics["total"])
        snapshots.append(params_of(trainer) if len(snapshots) < 2 else None)
    after, buffers = params_of(trainer), buffers_of(trainer)
    first_epoch.close()

    images_done = epochs = 0
    per_epoch = len(dataset) // size * size
    step = trainer.step

    def timed_step(batch):
        with ctx.span("step"):
            return step(batch)

    trainer.step = timed_step
    with ctx.window():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            with ctx.span("train_epoch"):
                trainer.train_epoch(Feed(dataset, ctx), size)
            images_done += per_epoch
            epochs += 1
        wall = time.perf_counter() - t0
    ctx.read_memory_peak()
    ctx.metrics["train_img_s"] = images_done / wall
    ctx.attempted = images_done // size
    ctx.counters.update(images=images_done, steps=images_done // size,
                        epochs=epochs, wall_s=wall, batch=size,
                        tf32=float(torch.backends.cudnn.allow_tf32))
    del trainer, dataset
    ctx.free()
    judge(ctx, frames, state, losses, snapshots[1], after, buffers)


def judge(ctx: Context, frames, state, losses, p1, p3, buffers) -> None:
    from benchmark.reference import fcn, rec_data, rec_train, train

    fcn.no_tf32()
    cfg = ctx.config
    batches = rec_data.first_batches(frames, cfg, seed_for(ctx.seed, "data"),
                                     CHECKED_STEPS, ctx.device)
    ref_losses, ref_after, ref_buffers = rec_train.steps(
        state, net_widths(cfg), batches, cfg["learning_rate"])
    found = train.gaps(state, cfg["learning_rate"], losses, p1, p3,
                       ref_losses, ref_after)
    stats = rec_train.buffer_gaps(buffers, ref_buffers)
    worst_buffer = max(stats, key=stats.get)
    found["stat_gap"] = stats[worst_buffer]
    ctx.counters["left_out_leaves"] = found.pop("left_out_leaves")
    worst = found.pop("grad_gap_worst")
    print(f"train-rec: worst leaf's first-gradient gap {worst!r} "
          f"(not compared); "
          f"{ctx.counters['left_out_leaves']} leaves left out of the change; "
          f"worst buffer {worst_buffer}", file=sys.stderr)
    for name, value in found.items():
        ctx.check(name, value)
