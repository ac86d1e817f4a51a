"""train-text-b8: the port's text-detector phase (TD-PT), built as
``run_phase`` builds it for a warm start from the reconstruction phase's
checkpoint: the program's ``reset_main_branches`` on a seeded state, and
``FCNLectureNet`` in full mode, fp32, on that state with its heads drawn
afresh here, the reference's start too; ``Trainer`` with
BatchNorm frozen and folded in the step, SGD at the phase's rate, prefetch
2; the dataset of ``cli/train_text_detector.py``, ground truth and median
targets at k = 35, routed to the trainer's device and preloaded. It
trains over 2,048 seeded scene images in COCO-Text's shape
(``traffic/scenes.py``), whole epochs of ``Trainer.train_epoch`` back to
back for the window.

The convs run as the port's CLI leaves them: float32 tensors, with cuDNN
free to use TF32, as in train-bin-b8.

Set-up builds the trainer once and drives its first three steps through
``train_epoch`` on three batches of the first epoch; the window goes on
from the fourth. End to end: ``train_img_s``, the images stepped over the
epochs' wall (the epoch in flight when the window closes finishes and
counts). Correct: the three steps' losses, the first gradient and the
parameters' change over the three (``reference/train.py gaps``) against
the plain float32 reference (``reference/text_train.py``) on its own
batches (``reference/text_data.py``) from the same start; and the
program's head reset (``redraw_gaps``): the trunk kept, each head drawn
afresh.
"""

from __future__ import annotations

import math
import shutil
import sys
import tempfile
import time

from benchmark.drivers.train import (CHECKED_STEPS, Feed, make_trainer,
                                     params_of)
from benchmark.harness import Context, seed_for
from benchmark.traffic import scenes
from benchmark.traffic.weights import make_state, net_widths


def text_dataset(ctx: Context, image_paths, mask_paths):
    """The dataset of ``cli/train_text_detector.py`` over the files, with
    the configuration's recipe and the run's data seed, routed to the
    run's device as ``run_phase`` routes it to the trainer's."""
    from lecturemath_tpu_torch.train.dataset import LectureNetDataset

    cfg = ctx.config
    dataset = LectureNetDataset(
        image_paths, mask_paths, reconstruction_mode=False,
        crop_size=tuple(cfg["crop_size"]),
        crop_min_fg_prc=cfg["crop_min_foreground"],
        flip_chance=cfg["flip_chance"],
        color_invert_chance=cfg["color_invert_chance"],
        color_change_chance=cfg["color_change_chance"],
        gaussian_noise_chance=cfg["gaussian_noise_chance"],
        gaussian_noise_level=cfg["gaussian_noise_level"],
        weight_expansion=cfg["weight_expansion"],
        text_mask_expansion=cfg["text_mask_expansion"],
        reconstruct_median=cfg["reconstruct_median"],
        reconstruct_median_k=cfg["median_k"],
        seed=seed_for(ctx.seed, "data"))
    dataset.route(ctx.device)
    return dataset


def make_dataset(ctx: Context):
    """The run's scenes written as files and preloaded by the dataset."""
    directory = tempfile.mkdtemp(prefix="bench_scenes_")
    try:
        dataset = text_dataset(ctx, *scenes.write(
            seed_for(ctx.seed, "scenes"), ctx.config["images"], ctx.traffic,
            directory))
        dataset.preload()
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return dataset


# the heads that the warm start from the reconstruction phase draws afresh
# (FCN_lecturenet.py:203-211, reset_main_branches): the text mask's and the
# binary's; the trunk and ``conv_reconstruct`` are kept
HEADS = ("conv_text_mask_out", "conv_pixels_1", "conv_pixels_2", "conv_out")
# a fresh head as the port and the JAX package draw it: xavier-normal conv
# weights (``<head>.0.weight``), zero biases, BatchNorm at identity
FRESH = {"0.bias": 0.0, "1.weight": 1.0, "1.bias": 0.0,
         "1.running_mean": 0.0, "1.running_var": 1.0,
         "1.num_batches_tracked": 0}
WHOLE = 1.0


def head_part(key: str):
    """``key``'s part within its head (``0.weight`` ...), or None outside
    the heads."""
    head, _, part = key.partition(".")
    return part if head in HEADS else None


def xavier_std(shape) -> float:
    return math.sqrt(2.0 / ((shape[0] + shape[1]) * math.prod(shape[2:])))


def start_state(net, seed: int, device):
    """The state that the port and the reference both start from, made
    here: the seeded state of ``traffic/weights.py`` standing in for the
    reconstruction checkpoint, with the heads drawn afresh from a seed of
    their own. Returns (that state, the checkpoint's)."""
    import torch

    checkpoint = make_state(net, seed_for(seed, "weights"), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_for(seed, "heads") % (2 ** 63))
    start = dict(checkpoint)
    for key in sorted(checkpoint):
        part, value = head_part(key), checkpoint[key]
        if part == "0.weight":
            start[key] = torch.randn(value.shape, generator=gen,
                                     device=device) * xavier_std(value.shape)
        elif part is not None:
            start[key] = torch.full_like(value, FRESH[part])
    return start, checkpoint


def redraw_gaps(before, after) -> dict:
    """How far the program's head reset (``after``, from ``before``) is
    from what the warm start asks of it:

      * ``reset_kept_gap``: the largest change of a value outside the heads;
      * ``reset_fresh_gap``: the largest gap of a head from a fresh draw:
        a conv weight's std from xavier's, as a share of it, and a bias's or
        a BatchNorm value's distance from its fresh value.

    A key added or missing, a shape changed or a head's weight left as it
    was reads ``WHOLE``, past either limit."""
    import torch

    if set(before) != set(after):
        return {"reset_kept_gap": WHOLE, "reset_fresh_gap": WHOLE}
    kept = fresh = 0.0
    for key in sorted(before):
        old = before[key].float()
        new = after[key].to(old.device).float()
        part = head_part(key)
        if part is None:
            kept = max(kept, WHOLE if new.shape != old.shape
                       else float((new - old).abs().max()))
        elif new.shape != old.shape:
            fresh = max(fresh, WHOLE)
        elif part == "0.weight":
            fresh = max(fresh, WHOLE if torch.equal(new, old) else
                        abs(float(new.std()) / xavier_std(new.shape) - 1.0))
        else:
            fresh = max(fresh, float((new - FRESH[part]).abs().max()))
    return {"reset_kept_gap": kept, "reset_fresh_gap": fresh}


def program_reset(ctx: Context, checkpoint):
    """The port's ``reset_main_branches`` on the checkpoint's state, with a
    generator seeded from the run's seed, as ``run_phase`` warm-starts."""
    import torch

    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig
    from lecturemath_tpu_torch.train.trainer import reset_main_branches

    config = FCNConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in net_widths(ctx.config).items()})
    generator = torch.Generator().manual_seed(seed_for(ctx.seed, "reset"))
    return reset_main_branches(checkpoint, config, generator)


def first_steps(ctx: Context, dataset, trainer):
    """The first steps: set-up, through the window's own call and feed, on
    the first batches of one epoch. Returns (their losses, the parameters
    after the first and after the last)."""
    size = ctx.config["batch_size"]
    first_epoch = dataset.batches(size)
    losses, snapshots = [], []
    for _ in range(CHECKED_STEPS):
        metrics = trainer.train_epoch(Feed(dataset, ctx, source=first_epoch,
                                           limit=1), size)
        losses.append(metrics["total"])
        if not snapshots:
            snapshots.append(params_of(trainer))
    first_epoch.close()
    return losses, snapshots[0], params_of(trainer)


def run(ctx: Context, fault=None) -> None:
    import torch

    cfg = ctx.config
    dataset = make_dataset(ctx)
    state, checkpoint = start_state(net_widths(cfg), ctx.seed, ctx.device)
    reset = redraw_gaps(checkpoint, program_reset(ctx, checkpoint))
    del checkpoint
    trainer = make_trainer(ctx, state)
    if fault is not None:
        fault(trainer)
    size = cfg["batch_size"]
    losses, after_first, after = first_steps(ctx, dataset, trainer)

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
    ctx.counters.update(dataset.data_stats)
    print("train-text: data_stats " + ", ".join(
        f"{key} {value}" for key, value in dataset.data_stats.items()),
        file=sys.stderr)
    del trainer, dataset
    ctx.free()
    judge(ctx, state, losses, after_first, after)
    for name, value in reset.items():
        ctx.check(name, value)


def judge(ctx: Context, state, losses, p1, p3) -> None:
    from benchmark.reference import fcn, text_data, text_train, train

    fcn.no_tf32()
    cfg = ctx.config
    # the scenes the reference's batches draw, rendered again
    made = scenes.Scenes(seed_for(ctx.seed, "scenes"), cfg["images"],
                         ctx.traffic)
    batches = text_data.first_batches(made.images, made.masks, cfg,
                                      seed_for(ctx.seed, "data"),
                                      CHECKED_STEPS, ctx.device)
    ref_losses, ref_after = text_train.steps(state, net_widths(cfg), batches,
                                             cfg["learning_rate"])
    found = train.gaps(state, cfg["learning_rate"], losses, p1, p3,
                       ref_losses, ref_after)
    ctx.counters["left_out_leaves"] = found.pop("left_out_leaves")
    worst = found.pop("grad_gap_worst")
    print(f"train-text: worst leaf's first-gradient gap {worst!r} "
          f"(not compared); {ctx.counters['left_out_leaves']} leaves left "
          f"out of the change", file=sys.stderr)
    for name, value in found.items():
        ctx.check(name, value)
