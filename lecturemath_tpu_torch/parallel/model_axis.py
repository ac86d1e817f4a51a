"""The mesh's 'model' axis: the collectives GSPMD inserts in the JAX
package (``lecturemath_tpu/parallel/inference.py`` for inference, its
``train/trainer.py`` sharded state for training), written out.

The axis is used in one of two ways, as there:

  * channels (``forward_channel_sharded``): each shard holds the slice of
    every tensor that ``params_pspec_tree`` shards (``shard_params``) and
    runs its slice of each conv block, transposed conv and head through the
    model's own ``_block``, ``_deconv`` / ``_up_act`` and ``_head`` (kernel
    K2 on the card for the heads, on channel slices of their weights).
    After a sharded layer the output channels are gathered in model-index
    order. The transposed convs shard on their INPUT channels, as the JAX
    package lays them out, so their shards' partial products are summed
    before the bias. Replicated layers run whole on every shard, and every
    shard ends with the same logits. Training runs this path too
    (``ChannelShards``; ``fold_shards`` for the frozen-BN fold).
  * height (``forward_height_sharded``): every shard holds the whole model
    and a slab of rows. Slabs split at multiples of 32 rows, so every 2x2
    pool and stride-2 transposed conv stays inside one. Before each k x k
    conv a shard receives k // 2 halo rows from its neighbours; zero padding
    stays at the image's true top and bottom only. The trunk's convs read
    the halo rows and pad only the width (``_block(..., halo=True)``), so
    every slab stays a dense channels_last tensor: a cropped, strided one
    sends ``torch.cat`` to its slow generic kernel. A shard may hold no rows
    (two 32-row units over four shards), and then computes nothing. As in
    the JAX package, this use is for inference only.

A model group is one data position's M shards. The shards this process
holds run in turn in this thread. Where the group spans processes, its
``torch.distributed`` group (``Mesh.model_group``) joins them: channel
slices and halo rows travel by all_gather, partial products by all_reduce,
and every process of the group meets these collectives in the same order,
so none can deadlock. ``FCNLectureNet.network`` is the one description of
the network that both paths run.

Gradients. Every collective here is differentiable, and its backward is
its adjoint: a gather's backward sums the gradient of the gathered tensor
over every shard of the group that received it and keeps each shard's own
channels (a reduce-scatter; in one process autograd sums the shards'
copies itself), and the partial products' sum sends each shard the sum of
the group's gradients of the result (an all_reduce). The loss convention
that makes the gradients the meshless ones: each process computes the loss
once, from its first local shard's logits (every shard's logits are the
same), and weights it by its share of the group's shards (``n_local /
M``; 1 where a process holds the whole group). Then the loss the group
differentiates is the meshless loss, so a sharded tensor's gradient is the
meshless gradient of its slice as autograd leaves it, and a replicated
tensor's meshless gradient is the SUM of its copies' gradients over the
group (a copy feeds only its own shard's replicated layers): the trainer
sums them and gives every copy the sum (``train/trainer.py``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.fcn_lecturenet import FCNLectureNet, fold_batch_norms
from ..ops.postprocess import threshold_pack, threshold_pack_plain
from .sync_norm import all_reduce_sum

UNIT = 32   # rows of a slab unit: five 2x2 pools divide it


class _AllGather(torch.autograd.Function):
    """``local`` (this process's parts, stacked) from every process of
    ``group``, concatenated in group order. The backward is the adjoint, a
    reduce-scatter: the gradient summed over the group, this process's
    rows kept."""

    @staticmethod
    def forward(ctx, local, group):
        import torch.distributed as dist

        ctx.group, ctx.rank = group, dist.get_rank(group)
        received = [torch.empty_like(local)
                    for _ in range(dist.get_world_size(group))]
        dist.all_gather(received, local.contiguous(), group=group)
        return torch.cat(received)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        total = grad.contiguous().clone()
        dist.all_reduce(total, group=ctx.group)
        rows = total.shape[0] // dist.get_world_size(ctx.group)
        return total[ctx.rank * rows:(ctx.rank + 1) * rows], None


class ModelGroup:
    """The shards of one model group that this process holds, in model
    order (each carries ``model_index`` and ``model_size``; a lone model is
    shard 0 of 1), and the process group that joins them to the group's
    other shards (None: every shard is here)."""

    def __init__(self, shards: Sequence[FCNLectureNet], group=None):
        self.shards = list(shards)
        self.indices = [getattr(s, "model_index", 0) for s in self.shards]
        self.size = getattr(self.shards[0], "model_size", 1)
        self.group = group
        self.devices = [s.mid_block[0].weight.device for s in self.shards]
        if group is None and self.indices != list(range(self.size)):
            raise ValueError(f"model group of {self.size} shards holds "
                             f"{self.indices} and no process group")

    def _everyone(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard's part (equal shapes on every process), in model
        order: this process's own, or all of the group's gathered."""
        if self.group is None:
            return parts
        local = torch.stack([p.to(self.devices[0]) for p in parts])
        return list(_AllGather.apply(local, self.group).unbind(0))

    def all_gather(self, parts: List[torch.Tensor]
                   ) -> List[List[torch.Tensor]]:
        """Every shard's part in model order, on each local shard's
        device."""
        everyone = self._everyone(parts)
        return [[p.to(device) for p in everyone] for device in self.devices]

    def all_sum(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """The sum of every shard's part, on each local shard's device."""
        total = parts[0].to(self.devices[0])
        for part in parts[1:]:
            total = total + part.to(self.devices[0])
        if self.group is not None:
            total = all_reduce_sum(total, self.group)
        return [total.to(device) for device in self.devices]

    def gather_rows(self, parts: List[torch.Tensor], rows: Sequence[int],
                    dim: int) -> torch.Tensor:
        """Every shard's slab (``rows[m]`` rows along ``dim`` for shard m),
        concatenated in model order on the first local shard's device."""
        if self.group is not None:
            most = max(rows)
            padded = []
            for part in parts:
                gap = list(part.shape)
                gap[dim] = most - part.shape[dim]
                padded.append(torch.cat([part, part.new_zeros(gap)], dim))
            parts = [p.narrow(dim, 0, rows[m])
                     for m, p in enumerate(self._everyone(padded))]
        return torch.cat([p.to(self.devices[0]) for p in parts], dim)


def _channels(x: torch.Tensor, index: int, size: int) -> torch.Tensor:
    """Shard ``index``'s slice of ``size`` of the channels of ``x``."""
    width = x.shape[1] // size
    return x[:, index * width:(index + 1) * width]


class ChannelLayers:
    """The network's layers with channels sharded over a model group; a
    value is the list of the local shards' (replicated) tensors."""

    def __init__(self, group: ModelGroup):
        self.group = group
        self.shards = group.shards
        self.specs = self.shards[0].model_specs

    @staticmethod
    def _map(fn, *xs):
        return [fn(*args) for args in zip(*xs)]

    @staticmethod
    def _pool(xs):
        return [F.max_pool2d(x, 2, 2) for x in xs]

    def _gathered(self, key: str, parts: List[torch.Tensor]):
        """``parts`` as they are where ``key`` is replicated, else the
        channels of every shard gathered in model order."""
        if not self.specs[key]:
            return parts
        return [torch.cat(p, dim=1) for p in self.group.all_gather(parts)]

    def _block(self, name: str, xs):
        return self._gathered(f"{name}.0.weight", [
            shard._block(name, x) for shard, x in zip(self.shards, xs)])

    def _head(self, name: str, xs, gelu: bool, out_dtype: torch.dtype,
              x2s=None):
        x2s = x2s or [None] * len(xs)
        return self._gathered(f"{name}.0.weight", [
            shard._head(name, x, gelu, out_dtype, x2)
            for shard, x, x2 in zip(self.shards, xs, x2s)])

    def _up(self, level: int, xs):
        name = f"transposed_conv_{level}"
        split_in = bool(self.specs[f"{name}.weight"])
        split_out = bool(self.specs[f"{name}.bias"])
        if not (split_in or split_out):
            return [shard._up(level, x) for shard, x in zip(self.shards, xs)]
        size, indices = self.group.size, self.group.indices
        ys = [shard._deconv(level, _channels(x, index, size) if split_in
                            else x, bias=False)
              for shard, index, x in zip(self.shards, indices, xs)]
        if split_in:   # partial products over the input channels
            ys = self.group.all_sum(ys)
        if split_out:
            ys = [_channels(y, index, size) for y, index in zip(ys, indices)]
        return self._gathered(f"{name}.bias", [
            shard._up_act(level, y, bias=True)
            for shard, y in zip(self.shards, ys)])


def forward_channel_sharded(shards: Sequence[FCNLectureNet],
                            x: torch.Tensor, group=None):
    """The model's output on the model input ``x`` (B, 3, H, W):
    (bin_logits, text_logits, rec), or rec alone for a reconstruction-mode
    model, computed by the channel shards of one model group
    (``shard_params``; this process's, joined by ``group`` to the rest) and
    taken from the first local shard, on its device. Differentiable: see
    the module's note on gradients."""
    model_group = ModelGroup(shards, group)
    xs = [x.to(device) for device in model_group.devices]
    outputs = shards[0].network(ChannelLayers(model_group), xs)
    if isinstance(outputs, list):   # rec of each shard
        return outputs[0]
    return tuple(each[0] for each in outputs)


class ChannelShards(nn.Module):
    """The channel shards this process holds of one model group, as one
    module whose forward is ``forward_channel_sharded`` (``group``: the
    model group's process group, None where every shard is here). The
    trainer runs it on the live shards, and through
    ``torch.func.functional_call`` on structures of ``fold_bn`` shards
    with the weights ``fold_shards`` folds."""

    def __init__(self, shards: Sequence[FCNLectureNet], group=None):
        super().__init__()
        self.shards = nn.ModuleList(shards)
        self.group = group

    def forward(self, x: torch.Tensor):
        return forward_channel_sharded(list(self.shards), x, self.group)


def fold_shards(shards: Sequence[FCNLectureNet], group=None,
                eps: float = 1e-5) -> List[Dict[str, torch.Tensor]]:
    """The frozen BatchNorms of each local shard folded into its convs,
    with the autograd graph (``fold_batch_norms(differentiable=True)``):
    one state dict of a ``fold_bn`` model a shard. A conv block folds
    locally, its BN cut on the conv's output channels alike. A transposed
    conv's weight is cut on its INPUT channels and holds all its outputs,
    so the scale of its BN, cut on the outputs, is gathered over the model
    group (with gradient) before it scales the shard's weight; the folded
    bias a * bias + shift stays local (both cut on the outputs)."""
    model_group = ModelGroup(shards, group)
    specs = shards[0].model_specs
    states = []
    for shard in shards:
        state = dict(shard.named_parameters())
        state.update(shard.named_buffers())
        states.append(state)
    scales: List[Dict[str, torch.Tensor]] = [{} for _ in shards]
    for level in range(1, 6):
        bn = f"upsample_block_{level}.0"
        if not specs[f"{bn}.weight"]:
            continue
        parts = [s[f"{bn}.weight"].float() / torch.sqrt(
            s[f"{bn}.running_var"].float() + eps) for s in states]
        for scale, gathered in zip(scales, model_group.all_gather(parts)):
            scale[f"transposed_conv_{level}"] = torch.cat(gathered)
    return [fold_batch_norms(state, eps, differentiable=True,
                             deconv_scales=scale)
            for state, scale in zip(states, scales)]


def slab_rows(height: int, size: int) -> List[int]:
    """Rows of each of ``size`` shards' slabs of a frame of ``height`` rows
    (a multiple of 32): whole 32-row units, the first ``units % size``
    shards one more than the others."""
    units = height // UNIT
    return [UNIT * (units // size + (m < units % size))
            for m in range(size)]


def _starts(rows: Sequence[int]) -> List[int]:
    starts, total = [], 0
    for count in rows:
        starts.append(total)
        total += count
    return starts


def _zeros(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``rows`` zero rows beside slab ``x``."""
    return x.new_zeros(x.shape[0], x.shape[1], rows, x.shape[3])


def _cat_rows(parts: List[torch.Tensor]) -> torch.Tensor:
    """``parts`` (B, C, rows, W) concatenated along the rows, as one dense
    channels_last tensor: the concat runs on their NHWC views, where
    ``torch.cat`` takes its fast contiguous kernel (along H of
    channels_last tensors it takes a generic one, ~20x slower)."""
    return torch.cat([p.permute(0, 2, 3, 1).contiguous() for p in parts],
                     dim=1).permute(0, 3, 1, 2)


class HeightLayers:
    """The network's layers with the height sharded over a model group; a
    value is the list of the local shards' slabs (B, C, rows, W), empty for
    a shard without rows. ``rows``: every shard's rows at full resolution,
    ``width``: the full-resolution width."""

    def __init__(self, group: ModelGroup, rows: Sequence[int], width: int):
        self.group = group
        self.shards = group.shards
        self.rows = list(rows)
        self.width = width

    @staticmethod
    def _map(fn, *xs):
        return [fn(*args) for args in zip(*xs)]

    @staticmethod
    def _pool(xs):
        return [F.max_pool2d(x, 2, 2) if x.shape[2] else x[:, :, :, ::2]
                for x in xs]

    def _with_halo(self, xs, p: int):
        """Each local slab with ``p`` rows of its neighbours above and
        below (zeros past the image's top and bottom); None for a shard
        without rows. Every shard sends its first and last min(p, rows)
        rows; the rows above slab m are the last p of those below every
        shard before it, because a slab shorter than p sends all of its
        rows."""
        if p == 0:
            return [x if x.shape[2] else None for x in xs]
        factor = self.width // xs[0].shape[3]
        keep = [min(p, rows // factor) for rows in self.rows]
        parts = []
        for x in xs:
            k = min(p, x.shape[2])
            parts.append(_cat_rows([x[:, :, :k], _zeros(x, 2 * (p - k)),
                                    x[:, :, x.shape[2] - k:]]))
        out = []
        for index, x, border in zip(self.group.indices, xs,
                                    self.group.all_gather(parts)):
            if not x.shape[2]:
                out.append(None)
                continue
            above = _cat_rows([_zeros(x, p)]
                              + [border[j][:, :, 2 * p - keep[j]:]
                                 for j in range(index)])
            below = _cat_rows([border[j][:, :, :keep[j]]
                               for j in range(index + 1, self.group.size)]
                              + [_zeros(x, p)])
            out.append(_cat_rows([above[:, :, -p:], x, below[:, :, :p]]))
        return out

    def _block(self, name: str, xs):
        conv = getattr(self.shards[0], name)[0]
        p = conv.weight.shape[2] // 2
        out = []
        for shard, x, e in zip(self.shards, xs, self._with_halo(xs, p)):
            out.append(x.new_empty(x.shape[0], conv.weight.shape[0], 0,
                                   x.shape[3]) if e is None else
                       shard._block(name, e, halo=p > 0))
        return out

    def _head(self, name: str, xs, gelu: bool, out_dtype: torch.dtype,
              x2s=None):
        conv = getattr(self.shards[0], name)[0]
        p = conv.weight.shape[2] // 2
        ext = self._with_halo(xs, p)
        ext2 = self._with_halo(x2s, p) if x2s else [None] * len(xs)
        out = []
        for shard, x, e, e2 in zip(self.shards, xs, ext, ext2):
            # K2 pads every side: its rows beside the slab's are dropped,
            # and the slab's copied out of the strided view
            out.append(x.new_empty(x.shape[0], conv.weight.shape[0], 0,
                                   x.shape[3], dtype=out_dtype)
                       if e is None else
                       shard._head(name, e, gelu, out_dtype, e2)[
                           :, :, p:p + x.shape[2]].contiguous(
                           memory_format=torch.channels_last))
        return out

    def _up(self, level: int, xs):
        deconv = getattr(self.shards[0], f"transposed_conv_{level}")
        return [shard._up(level, x) if x.shape[2] else
                x.new_empty(x.shape[0], deconv.weight.shape[1], 0,
                            2 * x.shape[3])
                for shard, x in zip(self.shards, xs)]


def height_slabs(shards: Sequence[FCNLectureNet], x: torch.Tensor,
                 group=None):
    """The height-sharded network on the model input ``x`` (B, 3, H, W; H
    and W multiples of 32): (the ModelGroup, every shard's rows, the local
    shards' (bin_logits, text_logits, rec) slabs)."""
    if x.shape[2] % UNIT or x.shape[3] % UNIT:
        raise ValueError(f"height-sharded input {tuple(x.shape)}: H and W "
                         f"must be multiples of {UNIT}")
    model_group = ModelGroup(shards, group)
    rows = slab_rows(x.shape[2], model_group.size)
    starts = _starts(rows)
    xs = [x[:, :, starts[m]:starts[m] + rows[m]].to(device).contiguous(
        memory_format=torch.channels_last)
          for m, device in zip(model_group.indices, model_group.devices)]
    outputs = shards[0].network(HeightLayers(model_group, rows, x.shape[3]),
                                xs)
    return model_group, rows, outputs


def forward_height_sharded(shards: Sequence[FCNLectureNet], x: torch.Tensor,
                           group=None):
    """The model's (bin_logits, text_logits, rec) of ``x`` from the height
    shards of one model group (each holding the whole model: ``replicate``),
    the slabs gathered by rows on the first shard's device."""
    model_group, rows, outputs = height_slabs(shards, x, group)
    return tuple(model_group.gather_rows(slabs, rows, 2)
                 for slabs in outputs)


def packed_height_sharded(shards: Sequence[FCNLectureNet], x: torch.Tensor,
                          h: int, w: int, threshold: int = 128,
                          group=None) -> torch.Tensor:
    """The packed binary bitmap [B, h, ceil(w/8)] of ``x`` from the height
    shards of one model group: the packed tail (kernel K1 on the card) on
    each slab's logits, cropped to the frames' (h, w), and the packed rows
    gathered on the first shard's device."""
    pack = threshold_pack_plain if shards[0].plain else threshold_pack
    model_group, rows, (bins, _, _) = height_slabs(shards, x, group)
    valid = [min(max(h - start, 0), count)
             for start, count in zip(_starts(rows), rows)]
    packed = []
    for index, logits in zip(model_group.indices, bins):
        packed.append(pack(logits[:, 0].float().contiguous(), valid[index],
                           w, threshold) if valid[index] else
                      torch.zeros(logits.shape[0], 0, (w + 7) // 8,
                                  dtype=torch.uint8, device=logits.device))
    return model_group.gather_rows(packed, valid, 1)


__all__ = ["ModelGroup", "ChannelLayers", "ChannelShards", "HeightLayers",
           "fold_shards", "forward_channel_sharded", "forward_height_sharded",
           "packed_height_sharded", "height_slabs", "slab_rows"]
