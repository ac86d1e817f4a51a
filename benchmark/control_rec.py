"""Readings of the control and the planted faults that the limits of
``train-rec-b8``'s ``correct`` are set from, at the cell's own sizes, on the
frames and batches a run of each seed makes. One JSON line a seed.

    python benchmark/control_rec.py --seeds 1 2 3

Each reading is the cell's numbers (``loss_gap``, ``grad_gap``,
``change_gap``, ``stat_gap``) of one side against the f32 reference's three
steps from the same state:

  * ``tf32``: the reference with cuDNN and cuBLAS free to use TF32, the
    precision below the configuration's float32 (on a card; a CPU has no
    TF32 and reads 0);
  * ``bf16``: the reference under bf16 autocast (every conv's operands and
    output, forward and backward);
  * ``eval_bn``: the reference with BatchNorm on its running statistics;
  * ``half_batch``: the f32 reference on half of each batch;
  * ``unchanged``: steps that leave the parameters as they were (the
    BatchNorms still move their running buffers).

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def tf32():
    """cuDNN's and cuBLAS's TF32 on inside, as PyTorch leaves them."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def readings(ctx) -> dict:
    from benchmark.drivers.train_rec import CHECKED_STEPS, make_model, render
    from benchmark.harness import seed_for
    from benchmark.reference import fcn, rec_data, rec_train, train
    from benchmark.traffic.weights import net_widths

    fcn.no_tf32()
    cfg = ctx.config
    net, lr = net_widths(cfg), cfg["learning_rate"]
    frames = render(ctx)
    batches = rec_data.first_batches(frames, cfg, seed_for(ctx.seed, "data"),
                                     CHECKED_STEPS, ctx.device)
    _, state = make_model(ctx)
    ref_losses, ref_after, ref_buffers = rec_train.steps(state, net, batches,
                                                         lr)
    halves = [{k: v[:len(v) // 2] for k, v in b.items()} for b in batches]
    with tf32():
        sides = {"tf32": rec_train.steps(state, net, batches, lr)}
    sides["bf16"] = rec_train.steps(state, net, batches, lr, torch.bfloat16)
    sides["eval_bn"] = rec_train.steps(state, net, batches, lr, live_bn=False)
    sides["half_batch"] = rec_train.steps(state, net, halves, lr)
    losses, _, buffers = rec_train.steps(state, net, batches, 0.0)
    kept = {k: state[k] for k in train.trainable(state)}
    sides["unchanged"] = (losses, [kept] * CHECKED_STEPS, buffers)
    out = {}
    for name, (losses, after, buffers) in sides.items():
        found = train.gaps(state, lr, losses, after[0], after[-1],
                           ref_losses, ref_after)
        found["stat_gap"] = rec_train.stat_gap(buffers, ref_buffers)
        out[name] = found
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import make_context

    for seed in args.seeds:
        ctx = make_context("train-rec-b8", seed, 0.0, False)
        print(json.dumps({"workload": "train-rec-b8", "seed": seed,
                          "control": readings(ctx)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
