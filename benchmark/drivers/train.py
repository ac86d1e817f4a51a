"""train-bin-b8: the port's binarizer phase (``train/trainer.py Trainer``,
as ``run_phase`` sets it up for a warm start: BN frozen and folded in the
step, fp32, SGD, prefetch 2) over 96 preloaded 1080p keyframes
(``train/dataset.py LectureNetDataset``), whole epochs of
``Trainer.train_epoch`` back to back for the window.

Set-up builds the trainer once and drives its first three steps through
``train_epoch`` on three batches of the first epoch; the window goes on
from the fourth. End to end: ``train_img_s``, the images stepped over the
epochs' wall (the epoch in flight when the window closes finishes and
counts). Correct: those three steps' losses, the first gradient (from the
parameters' change over step one) and the parameters' change over the three,
against the plain reference on its own batches.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

from benchmark.harness import Context, seed_for
from benchmark.traffic import pngio
from benchmark.traffic.lecture import keyframes
from benchmark.traffic.weights import make_state, net_widths

CHECKED_STEPS = 3


class Feed:
    """The dataset as ``train_epoch`` sees it: yields the real dataset's
    batches (from ``source`` where given, at most ``limit``), timing how
    long each takes to build on the prefetch thread."""

    def __init__(self, dataset, ctx: Context, source=None, limit=None,
                 keep=None):
        self.dataset, self.ctx = dataset, ctx
        self.source, self.limit, self.keep = source, limit, keep

    def batches(self, batch_size: int, shuffle: bool = True):
        stream = self.source or self.dataset.batches(batch_size, shuffle)
        made = 0
        while self.limit is None or made < self.limit:
            with self.ctx.span("batch_build"):
                batch = next(stream, None)
            if batch is None:
                return
            if self.keep is not None:
                self.keep.append(batch)
            made += 1
            yield batch


def write_keyframes(images, truths, directory: str):
    """The keyframes and their ground truth as PNG files (the dataset reads
    files), written by a few threads (zlib lets go of the interpreter)."""
    def write(item):
        k, (img, gt) = item
        paths = (os.path.join(directory, f"{k:03d}.png"),
                 os.path.join(directory, f"{k:03d}_gt.png"))
        for path, array in zip(paths, (img, gt)):
            with open(path, "wb") as f:
                f.write(pngio.encode(array))
        return paths

    with ThreadPoolExecutor(8) as pool:
        pairs = list(pool.map(write, enumerate(zip(images, truths))))
    return [p for p, _ in pairs], [g for _, g in pairs]


def make_trainer(ctx: Context, state):
    import torch

    from lecturemath_tpu_torch.models.fcn_lecturenet import (FCNConfig,
                                                             FCNLectureNet)
    from lecturemath_tpu_torch.train.trainer import Trainer

    cfg = ctx.config
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[cfg["precision"]]
    net = net_widths(cfg)
    model = FCNLectureNet(FCNConfig(**{k: tuple(v) if isinstance(v, list)
                                       else v for k, v in net.items()}),
                          compute_dtype=dtype, bn_dtype=torch.float32)
    model.load_state_dict(state)
    return Trainer(model, cfg["learning_rate"], momentum=cfg["momentum"],
                   phase=cfg["phase"], freeze_bn=cfg["freeze_bn"],
                   fold_frozen_bn=cfg["fold_frozen_bn"],
                   prefetch_depth=cfg["prefetch_batches"], device=ctx.device)


def make_dataset(ctx: Context, images, truths):
    from lecturemath_tpu_torch.train.dataset import LectureNetDataset

    cfg = ctx.config
    directory = tempfile.mkdtemp(prefix="bench_keyframes_")
    try:
        image_paths, truth_paths = write_keyframes(images, truths, directory)
        dataset = LectureNetDataset(
            image_paths, truth_paths, reconstruction_mode=False,
            crop_size=tuple(cfg["crop_size"]),
            crop_min_fg_prc=cfg["crop_min_foreground"],
            flip_chance=cfg["flip_chance"],
            color_invert_chance=cfg["color_invert_chance"],
            color_change_chance=cfg["color_change_chance"],
            gaussian_noise_chance=cfg["gaussian_noise_chance"],
            gaussian_noise_level=cfg["gaussian_noise_level"],
            weight_expansion=cfg["weight_expansion"],
            text_mask_expansion=cfg["text_mask_expansion"],
            seed=seed_for(ctx.seed, "data"))
        dataset.preload()
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return dataset


def params_of(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.named_parameters()}


def run(ctx: Context, fault=None) -> None:
    import torch

    cfg = ctx.config
    images, truths = keyframes(seed_for(ctx.seed, "keyframes"),
                               cfg["keyframes"], cfg["keyframe_height"],
                               cfg["keyframe_width"],
                               glyphs=ctx.traffic["glyphs"],
                               glyph_size=tuple(ctx.traffic["glyph_size"]))
    dataset = make_dataset(ctx, images, truths)
    state = make_state(net_widths(cfg), seed_for(ctx.seed, "weights"),
                       ctx.device)
    trainer = make_trainer(ctx, state)
    if fault is not None:
        fault(trainer)
    size = cfg["batch_size"]
    # the first steps: set-up, through the window's own call and feed, on
    # the first batches of one epoch (rows that all differ)
    first_epoch = dataset.batches(size)
    losses, snapshots = [], [params_of(trainer)]
    for _ in range(CHECKED_STEPS):
        metrics = trainer.train_epoch(Feed(dataset, ctx, source=first_epoch,
                                           limit=1), size)
        losses.append(metrics["total"])
        snapshots.append(params_of(trainer) if len(snapshots) < 2 else None)
    after = params_of(trainer)
    first_epoch.close()

    images_done = epochs = 0
    per_epoch = len(dataset) // size * size
    step = trainer.step

    def timed_step(batch):
        # a host span around each step, so the trace tells the device's
        # idle time inside a step from the wait for the next batch
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
    judge(ctx, images, truths, state, losses, snapshots[0], snapshots[1],
          after)


def judge(ctx: Context, images, truths, state, losses, p0, p1, p3) -> None:
    from benchmark.reference import augment, fcn, train

    fcn.no_tf32()
    cfg = ctx.config
    batches = augment.first_batches(images, truths, cfg,
                                    seed_for(ctx.seed, "data"), CHECKED_STEPS)
    ref_losses, ref_after = train.steps(state, net_widths(cfg), batches,
                                        cfg["learning_rate"])
    found = train.gaps(state, cfg["learning_rate"], losses, p1, p3,
                       ref_losses, ref_after)
    ctx.counters["left_out_leaves"] = found.pop("left_out_leaves")
    worst = found.pop("grad_gap_worst")
    print(f"train: worst leaf's first-gradient gap {worst!r} (not compared); "
          f"{ctx.counters['left_out_leaves']} leaves left out of the change",
          file=sys.stderr)
    for name, value in found.items():
        ctx.check(name, value)
