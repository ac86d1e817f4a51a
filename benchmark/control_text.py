"""Readings that the limits of ``train-text-b8``'s ``correct`` are set from,
at the cell's own sizes, on the scenes and batches a run of each seed
makes. One JSON line a seed.

    python benchmark/control_text.py --seeds 1 2 3

Under ``control``, each reading is the cell's numbers (``loss_gap``,
``grad_gap``, ``change_gap``) of one side against the f32 reference's
three steps from the same state (``drivers/train_text.py start_state``):

  * ``port``: the program's three steps, as the cell's set-up drives them
    (TF32 as the cell leaves it), on a dataset of the few scenes that the
    first batches draw, read from their files (no preload: the same
    samples); a sound reading;
  * ``bf16``: the reference under bf16 autocast (every conv's operands and
    output, forward and backward), the control;
  * ``no_mse``: the reference without the reconstruction's MSE term;
  * ``crop_median``: the reference with each median target replaced by its
    crop;
  * ``half_batch``: the reference on half of each batch.

Under ``reset``, each reading is the cell's ``reset_kept_gap`` and
``reset_fresh_gap`` (``drivers/train_text.py redraw_gaps``) of a head reset
of the seeded checkpoint:

  * ``port``: the program's ``reset_main_branches``; a sound reading;
  * ``left``: the heads left as they were;
  * ``torch_init``: the heads of a model that PyTorch's own init drew
    (kaiming-uniform weights, uniform biases);
  * ``reconstruct_too``: ``conv_reconstruct`` drawn afresh as well;
  * ``head_kept``: ``conv_pixels_2`` left as it was.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_steps(ctx, made, state):
    """The program's first steps on the scenes that its first batches draw
    (``made``, a ``traffic/scenes.py Scenes``), written as PNG files (the
    others are never read)."""
    import numpy as np

    from benchmark.drivers.train import CHECKED_STEPS
    from benchmark.drivers.train_text import (first_steps, make_trainer,
                                              text_dataset)
    from benchmark.harness import seed_for
    from benchmark.traffic import pngio

    cfg = ctx.config
    order = np.arange(made.count)
    np.random.default_rng(seed_for(ctx.seed, "data")).shuffle(order)
    drawn = order[:CHECKED_STEPS * cfg["batch_size"]]
    directory = tempfile.mkdtemp(prefix="bench_scenes_")
    try:
        paths = [[os.path.join(directory, "absent.png")] * made.count
                 for _ in range(2)]
        for k in drawn:
            for part, files in enumerate(paths):
                files[k] = os.path.join(directory, f"{k}_{part}.png")
                with open(files[k], "wb") as f:
                    f.write(pngio.encode(made.pair(k)[part], level=0))
        trainer = make_trainer(ctx, state)
        return first_steps(ctx, text_dataset(ctx, *paths), trainer)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def readings(ctx) -> dict:
    import torch

    from benchmark.drivers.train import CHECKED_STEPS
    from benchmark.drivers.train_text import start_state
    from benchmark.harness import seed_for
    from benchmark.reference import fcn, text_data, text_train, train
    from benchmark.traffic import scenes
    from benchmark.traffic.weights import net_widths

    cfg = ctx.config
    net, lr = net_widths(cfg), cfg["learning_rate"]
    made = scenes.Scenes(seed_for(ctx.seed, "scenes"), cfg["images"],
                         ctx.traffic)
    state = start_state(net, ctx.seed, ctx.device)[0]
    losses, after_first, after = port_steps(ctx, made, state)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    fcn.no_tf32()
    try:
        batches = text_data.first_batches(made.images, made.masks, cfg,
                                          seed_for(ctx.seed, "data"),
                                          CHECKED_STEPS, ctx.device)
        ref_losses, ref_after = text_train.steps(state, net, batches, lr)
        halves = [{k: v[:len(v) // 2] for k, v in b.items()}
                  for b in batches]
        crops = [dict(b, median=b["image"]) for b in batches]
        sides = {"port": (losses, [after_first, after]),
                 "bf16": text_train.steps(state, net, batches, lr,
                                          torch.bfloat16),
                 "no_mse": text_train.steps(state, net, batches, lr,
                                            terms=("text_bce", "bin_bce")),
                 "crop_median": text_train.steps(state, net, crops, lr),
                 "half_batch": text_train.steps(state, net, halves, lr)}
    finally:
        # the next seed's program steps run as the cell leaves TF32
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    out = {}
    for name, (side_losses, side_after) in sides.items():
        out[name] = train.gaps(state, lr, side_losses, side_after[0],
                               side_after[-1], ref_losses, ref_after)
    return out


def reset_readings(ctx) -> dict:
    from benchmark.drivers.train_text import (head_part, program_reset,
                                              redraw_gaps, start_state)
    from benchmark.traffic.weights import net_widths
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNLectureNet
    from lecturemath_tpu_torch.train import trainer

    real = trainer.reset_main_branches

    def torch_init(state, config, generator):
        fresh = FCNLectureNet(config).state_dict()
        return dict(state, **{key: value for key, value in fresh.items()
                              if head_part(key) is not None})

    def reconstruct_too(state, config, generator):
        fresh = trainer.init_variables_for(config, generator)
        return dict(real(state, config, generator),
                    **{key: value for key, value in fresh.items()
                       if key.startswith("conv_reconstruct.")})

    def head_kept(state, config, generator):
        return dict(real(state, config, generator),
                    **{key: value for key, value in state.items()
                       if key.startswith("conv_pixels_2.")})

    resets = {"port": real, "left": lambda state, *_: dict(state),
              "torch_init": torch_init, "reconstruct_too": reconstruct_too,
              "head_kept": head_kept}
    checkpoint = start_state(net_widths(ctx.config), ctx.seed, ctx.device)[1]
    out = {}
    for name, reset in resets.items():
        trainer.reset_main_branches = reset
        try:
            out[name] = redraw_gaps(checkpoint,
                                    program_reset(ctx, checkpoint))
        finally:
            trainer.reset_main_branches = real
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import make_context

    for seed in args.seeds:
        ctx = make_context("train-text-b8", seed, 0.0, False, args.device)
        print(json.dumps({"workload": "train-text-b8", "seed": seed,
                          "control": readings(ctx),
                          "reset": reset_readings(ctx)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
