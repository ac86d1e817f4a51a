"""Three SGD steps of the binarizer phase in plain PyTorch: the reference of
the training cell. BatchNorm is frozen at its running statistics (the phase
warm-starts), every conv and BatchNorm affine trains, and the loss is the
phase's: the binary logits' BCE against the ground truth plus the text
logits' BCE against the text mask (lecturenet_train_02). Float32 with TF32
off, or under autocast (the control)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.fcn import Reference


def trainable(state: Dict[str, torch.Tensor]) -> List[str]:
    """Every conv weight and bias and every BatchNorm affine."""
    return [k for k in state if k.endswith((".weight", ".bias"))]


def bce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    x = logits.float()
    return torch.mean(-target * F.logsigmoid(x)
                      - (1.0 - target) * F.logsigmoid(-x))


def steps(state: Dict[str, torch.Tensor], net: Dict, batches: List[Dict],
          lr: float, autocast: Optional[torch.dtype] = None):
    """SGD (momentum 0) over ``batches``, the update in float32. Returns
    (each step's loss, the parameters after each step). ``autocast``: the
    forward and backward in that type (``torch.autocast``: every conv's
    operands and output), the control."""
    params = {k: state[k].detach().clone() for k in trainable(state)}
    losses, after = [], []
    for batch in batches:
        live = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        sd = dict(state, **live)
        device = next(iter(params.values())).device
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            device).permute(0, 3, 1, 2)
        with torch.autocast(device.type, dtype=autocast or torch.float32,
                            enabled=autocast is not None):
            logits, text, _ = Reference(sd, net)(to(batch["image"]))
        loss = (bce(logits, to(batch["target"]))
                + bce(text, to(batch["text_mask"])))
        grads = torch.autograd.grad(loss, list(live.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            params = {k: (v - lr * g).detach() for (k, v), g
                      in zip(live.items(), grads)}
        after.append(params)
    return losses, after


def leaf_gaps(ours: Dict[str, torch.Tensor], theirs: Dict[str, torch.Tensor],
              keep: Optional[List[str]] = None) -> List[float]:
    """Each leaf's gap between the two sides' norms, over the larger of the
    reference's norm of that leaf and its median leaf's."""
    names = keep if keep is not None else list(theirs)
    norms = {k: float(theirs[k].norm()) for k in names}
    median = float(np.median(list(norms.values())))
    return [abs(float(ours[k].norm()) - norms[k]) / max(norms[k], median)
            for k in names]


def gaps(state: Dict[str, torch.Tensor], lr: float, losses: List[float],
         after_first: Dict[str, torch.Tensor],
         after_last: Dict[str, torch.Tensor], ref_losses: List[float],
         ref_after: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """The training cell's numbers for one side (its losses and its
    parameters after the first and the last step) against the reference's
    (``steps``' result) from the same ``state``:

      * ``loss_gap``: the largest relative gap of a step's loss;
      * ``grad_gap``: the median leaf's gap (``leaf_gaps``) of the first
        gradient as SGD applied it, the change over step one over the
        learning rate. The worst leaf's (``grad_gap_worst``, not compared)
        is the noise of single leaves: a BatchNorm scale near 1, whose
        update is a few float32 steps of it, and the one-element scale of
        the text head, a sum over every pixel that mostly cancels;
      * ``change_gap``: the worst leaf's gap of the change over all the
        steps, leaving out the leaves whose reference gradient is under a
        thousandth of the median leaf's (they move by round-off alone).
    """
    names = trainable(state)
    grad = {k: (state[k] - after_first[k]) / lr for k in names}
    ref_grad = {k: (state[k] - ref_after[0][k]) / lr for k in names}
    norms = {k: float(ref_grad[k].norm()) for k in names}
    median = float(np.median(list(norms.values())))
    moving = [k for k in names if norms[k] >= 1e-3 * median]
    change = {k: after_last[k] - state[k] for k in names}
    ref_change = {k: ref_after[-1][k] - state[k] for k in names}
    grad_gaps = leaf_gaps(grad, ref_grad)
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, ref_losses)),
            "grad_gap": float(np.median(grad_gaps)),
            "change_gap": max(leaf_gaps(change, ref_change, moving)),
            "grad_gap_worst": max(grad_gaps),
            "left_out_leaves": len(names) - len(moving)}
