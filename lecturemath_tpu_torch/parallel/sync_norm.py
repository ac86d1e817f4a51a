"""Cross-replica BatchNorm: training-mode BatchNorm2d over the GLOBAL batch
of a data-parallel world, on the CPU (gloo) and on the card (NCCL) alike.

The JAX package's ``TorchBatchNorm`` (``models/fcn_lecturenet.py``) under a
data-sharded jit normalizes with the statistics of the whole global batch.
Here each process holds its rows, so the per-channel statistics are
all-reduced: the sum and the element count, then the sum of squared
deviations from the global mean (two passes, never E[x^2] - E[x]^2). The
output is normalized by the biased variance; ``running_var`` takes the
unbiased one at n = the global B*H*W, with torch's momentum. The backward
all-reduces the two per-channel gradient sums that the input gradient
needs, and leaves the scale and shift gradients local: the trainer's
gradient all-reduce sums those with every other parameter's.

The statistics and the gradients run in f32 whatever the input dtype (bf16
under ``TRAIN_BN_DTYPE = bf16``); the normalization is one pass of
inference-mode ``F.batch_norm`` with the global statistics, so the output
takes the input's dtype, as ``nn.BatchNorm2d`` computes a bf16 input.

``all_reduce_sum`` is the differentiable sum over the processes that the
weighted loss terms of train/losses.py take their global ratio with.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

_AXES = (0, 2, 3)


def _all_reduce(tensor: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(tensor, group=group)
    return tensor


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the gradients alike."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return _all_reduce(tensor.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``tensor`` over the processes of ``group`` (None: the
    default world), differentiable: each process's gradient of its result
    is summed into every process's gradient of its input."""
    return _AllReduceSum.apply(tensor, group)


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


class _CrossReplicaBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xf = x.float()
        local = torch.cat([xf.sum(_AXES),
                           xf.new_full((1,), xf.numel() // xf.shape[1])])
        total = _all_reduce(local, group)
        count = total[-1]
        mean = total[:-1] / count
        centered = xf - _channel(mean)
        var = _all_reduce((centered * centered).sum(_AXES), group) / count
        # the normalization itself: one fused pass of inference-mode batch
        # norm with the global statistics, in the input's dtype
        y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.count, ctx.group = count, group
        ctx.mark_non_differentiable(mean, var, count)
        return y, mean, var, count

    @staticmethod
    def backward(ctx, dy, _mean, _var, _count):
        x, weight, mean, invstd = ctx.saved_tensors
        dyf = dy.float()
        centered = x.float() - _channel(mean)
        sums = torch.stack([dyf.sum(_AXES), (dyf * centered).sum(_AXES)])
        grad_weight = grad_bias = None
        if weight is not None:
            grad_weight = (sums[1] * invstd).to(weight.dtype)
            grad_bias = sums[0].to(weight.dtype)
        means = _all_reduce(sums.clone(), ctx.group) / ctx.count
        # dx = w * invstd * (dy - mean(dy) - xhat * mean(dy * xhat)), with
        # xhat = centered * invstd, in two fused passes
        scale = invstd if weight is None else invstd * weight.float()
        dx = torch.addcmul(_channel(-scale * means[0]), dyf, _channel(scale))
        dx.addcmul_(centered, _channel(-scale * invstd * invstd * means[1]))
        return dx.to(x.dtype), grad_weight, grad_bias, None, None


def cross_replica_batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor,
                             group=None) -> torch.Tensor:
    """``bn`` in training mode over the global batch of ``group`` (None:
    the default world): normalizes ``x`` (N, C, H, W) with the global
    statistics and updates ``bn``'s running buffers with them. Call it only
    where ``bn.training``; every process of the group must call it in the
    same order."""
    y, mean, var, count = _CrossReplicaBatchNorm.apply(
        x, bn.weight, bn.bias, bn.eps, group)
    if bn.track_running_stats:
        with torch.no_grad():
            # on the device: no host sync a layer
            unbiased = var * (count / torch.clamp(count - 1.0, min=1.0))
            bn.running_mean.lerp_(mean.to(bn.running_mean.dtype),
                                  bn.momentum)
            bn.running_var.lerp_(unbiased.to(bn.running_var.dtype),
                                 bn.momentum)
            bn.num_batches_tracked.add_(1)
    return y
