"""Three SGD steps of the reconstruction phase in plain PyTorch: the reference
of the reconstruction cell. The network is FCN-LectureNet in reconstruction
mode (the trunk and ``conv_reconstruct``'s tanh, no heads), trained from
scratch with BatchNorm in training mode: each BatchNorm normalises with its
batch's mean and biased variance and moves its running mean and unbiased
variance by momentum 0.1 (eps 1e-5), as ``torch.nn.BatchNorm2d`` documents.
The loss is the mean squared error of the reconstruction against the
median target (lecturenet_train_00). Every conv and BatchNorm affine
trains. Float32 with TF32 off, or under autocast (the control). It imports
nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.fcn import EPS, Reference
from benchmark.reference.train import trainable

MOMENTUM = 0.1
BUFFERS = (".running_mean", ".running_var")


class LiveReference(Reference):
    """The network over ``sd`` with every BatchNorm on its batch's
    statistics, in float32 whatever the convs run in, moving the running
    buffers in ``buffers`` (name -> tensor, replaced at each call)."""

    def __init__(self, sd: Dict[str, torch.Tensor], net: Dict,
                 buffers: Dict[str, torch.Tensor]):
        super().__init__(sd, net)
        self.buffers = buffers

    def _bn(self, name: str, y: torch.Tensor) -> torch.Tensor:
        y = y.float()
        mean = y.mean(dim=(0, 2, 3))
        var = y.var(dim=(0, 2, 3), unbiased=False)
        n = y.numel() // y.shape[1]
        with torch.no_grad():
            for key, value in (("running_mean", mean),
                               ("running_var", var * n / (n - 1))):
                old = self.buffers[f"{name}.{key}"]
                self.buffers[f"{name}.{key}"] = ((1.0 - MOMENTUM) * old
                                                 + MOMENTUM * value.detach())
        scale = self.sd[f"{name}.weight"] / torch.sqrt(var + EPS)
        return ((y - mean[:, None, None]) * scale[:, None, None]
                + self.sd[f"{name}.bias"][:, None, None])


def steps(state: Dict[str, torch.Tensor], net: Dict, batches: List[Dict],
          lr: float, autocast: Optional[torch.dtype] = None,
          live_bn: bool = True):
    """SGD (momentum 0) over ``batches`` (``rec_data.first_batches``), the
    update in float32. Returns (each step's loss, the parameters after each
    step, the running buffers after the last). ``autocast``: every conv's
    operands and output in that type, forward and backward (the control);
    ``live_bn`` False: BatchNorm from its running statistics (a fault)."""
    params = {k: state[k].detach().clone() for k in trainable(state)}
    buffers = {k: state[k].detach().clone() for k in state
               if k.endswith(BUFFERS)}
    device = next(iter(params.values())).device
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        device).permute(0, 3, 1, 2)
    losses, after = [], []
    for batch in batches:
        live = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        sd = dict(state, **buffers, **live)
        model = (LiveReference(sd, net, buffers) if live_bn
                 else Reference(sd, net))
        with torch.autocast(device.type, dtype=autocast or torch.float32,
                            enabled=autocast is not None):
            _, rec = model.features(to(batch["image"]))
        loss = torch.mean(torch.square(rec.float() - to(batch["median"])))
        grads = torch.autograd.grad(loss, list(live.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            params = {k: (v - lr * g).detach() for (k, v), g
                      in zip(live.items(), grads)}
        after.append(params)
        if live_bn:
            buffers = model.buffers
    return losses, after, buffers


def buffer_gaps(buffers: Dict[str, torch.Tensor],
                ref_buffers: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each running buffer's relative gap after the steps: |ours -
    reference| over |reference| (2-norms over the buffer)."""
    return {k: float((buffers[k].float() - ref).norm() / ref.norm())
            for k, ref in ref_buffers.items()}


def stat_gap(buffers: Dict[str, torch.Tensor],
             ref_buffers: Dict[str, torch.Tensor]) -> float:
    """The cell's ``stat_gap``: the worst buffer's ``buffer_gaps``."""
    return max(buffer_gaps(buffers, ref_buffers).values())
