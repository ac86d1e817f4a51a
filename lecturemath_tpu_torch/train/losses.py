"""Training losses for the three-phase curriculum.

Phase losses match the reference trainers:
  * Med-PT  — MSE(reconstruction, median/raw target)
    (reference: lecturenet_train_00_pretrain_reconstruction.py:144-156)
  * TD-PT   — BCE(text logits, text mask) + BCE(binary logits, eroded text
    region) + MSE(reconstruction, median), summed
    (reference: lecturenet_train_01_pretrain_text_detector.py:171-182)
  * Final   — BCE(binary logits, GT binary) + BCE(text logits, text mask)
    (reference: lecturenet_train_02_train_binarizer.py:235-241)

Optional per-pixel weighting implements the reference's (defined but unused)
weighted variants (train_02:51-60). Every term is computed in f32, whatever
the compute dtype of the outputs. Tensors are NCHW, as the model's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def weighted_mean(loss: torch.Tensor, weights: Optional[torch.Tensor],
                  group=None) -> torch.Tensor:
    """mean(loss), or sum(w*l) / max(sum(w), 1). With a process ``group``
    the weighted ratio is over the GLOBAL batch: the numerator and the
    denominator are all-reduced (autograd-aware, so every rank's gradient
    is the global loss's times the world size, which the trainer's
    gradient average divides back out). The plain mean stays local: equal
    row counts make the average of the ranks' means the global mean."""
    if weights is None:
        return loss.mean()
    parts = torch.stack([(loss * weights).sum(), weights.sum()])
    if group is not None:
        from ..parallel.sync_norm import all_reduce_sum

        parts = all_reduce_sum(parts, group)
    return parts[0] / torch.clamp(parts[1], min=1.0)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    weights: Optional[torch.Tensor] = None,
                    group=None) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy`` in f32, -t log σ(x) -
    (1 - t) log σ(-x), mean or weighted mean (``weighted_mean``)."""
    x = logits.float()
    t = targets.float()
    loss = -t * F.logsigmoid(x) - (1.0 - t) * F.logsigmoid(-x)
    return weighted_mean(loss, weights, group)


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               weights: Optional[torch.Tensor] = None,
               group=None) -> torch.Tensor:
    err = torch.square(pred.float() - target.float())
    return weighted_mean(err, weights, group)


def phase_losses(phase: str, outputs, batch: Dict[str, torch.Tensor],
                 use_weights: bool = False,
                 group=None) -> Dict[str, torch.Tensor]:
    """Compute the per-term loss dict for a training phase.

    ``outputs`` is the model output: reconstruction for phase 'reconstruction',
    (bin_logits, text_logits, rec) otherwise. ``group``: the process group
    of a data-parallel run, over whose global batch weighted terms are
    taken (``weighted_mean``).
    """
    weights = batch.get("weights") if use_weights else None

    if phase == "reconstruction":
        rec = outputs
        target = batch.get("median", batch["target"])
        return {"mse": masked_mse(rec, target, weights, group)}

    bin_logits, text_logits, rec = outputs
    terms: Dict[str, torch.Tensor] = {}

    if phase == "text_detector":
        # text head learns the RAW GT mask; binary head the eroded
        # text-region mask (reference: lecturenet_train_01:171-182 —
        # mask_loss uses `labels`, binary_loss uses `text_mask`)
        terms["text_bce"] = bce_with_logits(text_logits, batch["target"],
                                            weights, group)
        terms["bin_bce"] = bce_with_logits(bin_logits, batch["text_mask"],
                                           weights, group)
        if "median" in batch:
            terms["rec_mse"] = masked_mse(rec, batch["median"], weights,
                                          group)
    elif phase == "binarizer":
        terms["bin_bce"] = bce_with_logits(bin_logits, batch["target"],
                                           weights, group)
        if "text_mask" in batch:
            terms["text_bce"] = bce_with_logits(text_logits,
                                                batch["text_mask"], weights,
                                                group)
    else:
        raise ValueError(f"unknown phase: {phase}")

    return terms
