"""Three SGD steps of the text-detector phase in plain PyTorch: the
reference of the text-detector cell. BatchNorm is frozen at its running
statistics (the phase warm-starts from the reconstruction phase), every
conv and BatchNorm affine trains, and the loss is the phase's three terms
(lecturenet_train_01:171-182): the text logits' BCE against the raw mask,
the binary logits' BCE against the text mask, and the reconstruction's
mean squared error against the median target. Float32 with TF32 off, or
under autocast (the control). It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference.fcn import Reference
from benchmark.reference.train import bce, trainable

TERMS = ("text_bce", "bin_bce", "rec_mse")


def losses_of(outputs, batch: Dict[str, torch.Tensor],
              terms: Sequence[str] = TERMS) -> torch.Tensor:
    """The sum of the phase's ``terms`` over the forward's (binary logits,
    text logits, reconstruction) and the NCHW ``batch``."""
    logits, text, rec = outputs
    found = {"text_bce": lambda: bce(text, batch["target"]),
             "bin_bce": lambda: bce(logits, batch["text_mask"]),
             "rec_mse": lambda: torch.mean(torch.square(
                 rec.float() - batch["median"]))}
    return sum(found[term]() for term in terms)


def steps(state: Dict[str, torch.Tensor], net: Dict, batches: List[Dict],
          lr: float, autocast: Optional[torch.dtype] = None,
          terms: Sequence[str] = TERMS):
    """SGD (momentum 0) over ``batches`` (``text_data.first_batches``), the
    update in float32. Returns (each step's loss, the parameters after each
    step). ``autocast``: every conv's operands and output in that type,
    forward and backward (the control); ``terms``: the loss's terms (a
    fault leaves one out)."""
    params = {k: state[k].detach().clone() for k in trainable(state)}
    device = next(iter(params.values())).device
    losses, after = [], []
    for batch in batches:
        live = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        sd = dict(state, **live)
        nchw = {key: torch.from_numpy(np.ascontiguousarray(value)).to(
            device).permute(0, 3, 1, 2) for key, value in batch.items()}
        with torch.autocast(device.type, dtype=autocast or torch.float32,
                            enabled=autocast is not None):
            outputs = Reference(sd, net)(nchw["image"])
        loss = losses_of(outputs, nchw, terms)
        grads = torch.autograd.grad(loss, list(live.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            params = {k: (v - lr * g).detach() for (k, v), g
                      in zip(live.items(), grads)}
        after.append(params)
    return losses, after
