"""Frame-sharded inference over a mesh, with the model axis inside it.

Frames are independent through the FCN forward, so a batch splits by rows
over the mesh's data positions: each process takes its rows of the global
batch (``local_row_slice``; every process holds the same global batch),
each of its model groups runs an equal part of them, and the results meet
on the process's first device, then across processes by ``all_gather``
over the data group, so every process receives every frame, as the JAX
package's replicating fetch gives it. On a data-only mesh a model group is
one replica of the model on one device. On a ``DxM`` mesh it is M shards
(``parallel/model_axis.py``): over the convs' channels
(``shard_params_over_model``, also the stage-01 ``Binarizer``'s layout), or
over the frame height with halo exchanges (``shard_spatial``), for few huge
frames such as one 4K board scan. Inside a process one Python thread
launches each group's work in turn, and the cards compute at once.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..models.fcn_lecturenet import (FCNLectureNet, make_binarizer,
                                     make_packed_binarizer, model_input,
                                     unpack_bits_host)
from .mesh import (Mesh, check_mesh, local_model_groups, process_rows,
                   replicate, shard_params)
from .model_axis import (UNIT, forward_channel_sharded,
                         forward_height_sharded, packed_height_sharded)

AXES = (None, "channel", "spatial")


def pad_rows(frames: np.ndarray, multiple: int) -> np.ndarray:
    """Repeat the last frame until the rows divide by ``multiple``."""
    pad = (-len(frames)) % multiple
    if pad:
        frames = np.concatenate([frames, np.repeat(frames[-1:], pad, 0)])
    return frames


def all_gather_rows(mesh: Mesh, rows: torch.Tensor) -> torch.Tensor:
    """Every data group member's ``rows`` (equal shapes), concatenated in
    process order; ``rows`` itself in a world of one, or where this
    process's data group is itself alone."""
    if mesh.world_size <= 1:
        return rows
    import torch.distributed as dist

    n = dist.get_world_size(mesh.data_group)
    if n == 1:
        return rows
    parts = [torch.empty_like(rows) for _ in range(n)]
    dist.all_gather(parts, rows.contiguous(), group=mesh.data_group)
    return torch.cat(parts)


def group_binarizers(mesh: Optional[Mesh], shards: Sequence[FCNLectureNet],
                     axis: Optional[str], packed: bool, threshold: int = 128,
                     force_binary: bool = True, input_format: str = "rgb",
                     pre_halvings: int = 0) -> List[Callable]:
    """One batch function for each of this process's model groups, over
    ``shards`` (one a local device, in order: ``shard_params`` for the
    'channel' axis, ``replicate`` otherwise; the model alone without a
    mesh). ``packed``: ``make_packed_binarizer``'s bitmap; else
    ``make_binarizer``'s (binary, text mask, reconstruction). ``axis``
    None runs each group's first shard alone: on a model axis that is
    the JAX package's replication over 'model'."""
    if axis not in AXES:
        raise ValueError(f"unknown model axis use {axis!r}")
    groups = local_model_groups(mesh) if mesh is not None else [[(0, 0)]]
    model = mesh.shape["model"] if mesh is not None else 1
    fns = []
    for members in groups:
        local = [shards[k] for _, k in members]
        how = axis if model > 1 else None
        group = mesh.model_group if mesh is not None else None
        if how == "spatial" and packed:
            fns.append(_packed_height_binarizer(local, group, threshold,
                                                input_format, pre_halvings))
            continue
        forward = None if how is None else _group_forward(how, local,
                                                          group)
        fns.append(make_packed_binarizer(local[0], threshold, input_format,
                                         pre_halvings, forward)
                   if packed else
                   make_binarizer(local[0], force_binary, threshold,
                                  forward))
    return fns


def _group_forward(axis: str, shards, group) -> Callable:
    sharded = (forward_channel_sharded if axis == "channel" else
               forward_height_sharded)
    return lambda x: sharded(shards, x, group)


def _packed_height_binarizer(shards, group, threshold, input_format,
                             pre_halvings) -> Callable:
    @torch.no_grad()
    def binarize(frames_uint8: torch.Tensor) -> torch.Tensor:
        x, (h, w) = model_input(frames_uint8, input_format, pre_halvings)
        return packed_height_sharded(shards, x, h, w, threshold, group)

    return binarize


def sharded_forward(mesh: Mesh, fns: Sequence[Callable], frames: np.ndarray
                    ) -> torch.Tensor:
    """``fns[g]`` (the batch function of this process's model group g, as
    ``group_binarizers`` makes them) on that group's part of this process's
    rows of the global batch ``frames`` (rows a multiple of the data axis),
    the part on the group's first device; returns the output of every row,
    in order, on ``mesh.device``."""
    groups = local_model_groups(mesh)
    rows = torch.as_tensor(process_rows(mesh, frames))
    if len(rows) % len(groups):
        raise ValueError(f"{len(rows)} rows do not divide over "
                         f"{len(groups)} local model groups")
    outs = []
    for fn, members, part in zip(fns, groups, rows.chunk(len(groups))):
        device = mesh.local_devices[members[0][1]]
        part = part.to(device)
        if device.type == "cuda":
            with torch.cuda.device(device):
                outs.append(fn(part))
        else:
            outs.append(fn(part))
    local = torch.cat([out.to(mesh.device) for out in outs])
    return all_gather_rows(mesh, local)


class ShardedBinarizer:
    """Batched binarizer with the frame axis sharded over the mesh's data
    axis, each data position's model group running ``model`` (weights as
    given, eval mode): one replica of it, or on a model axis its channel
    shards (``shard_params_over_model``) or one replica a height slab
    (``shard_spatial``), not both. Any batch size: rows are padded with
    the last frame to a multiple of the data axis and cropped back; with
    ``shard_spatial`` heights are edge-padded to lcm(32, M) rows as the
    JAX package pads them, and cropped back.

    ``force_binary``: {0, 255} through the packed tail (kernel K1 on a
    card, its plain version on the CPU) and a host unpack; else the
    thresholdless ``sigmoid * 255`` map."""

    def __init__(self, model: FCNLectureNet, mesh: Mesh,
                 force_binary: bool = True, threshold: int = 128,
                 shard_params_over_model: bool = False,
                 shard_spatial: bool = False):
        if shard_params_over_model and shard_spatial:
            raise ValueError("shard_params_over_model and shard_spatial "
                             "both use the mesh 'model' axis — pick one")
        check_mesh(mesh)
        self.mesh = mesh
        self.force_binary = force_binary
        self.threshold = threshold
        self.shard_spatial = shard_spatial
        self.shards: List[FCNLectureNet] = [
            shard.eval() for shard in (shard_params if shard_params_over_model
                                       else replicate)(mesh, model)]
        for shard, device in zip(self.shards, mesh.local_devices):
            if device.type == "cuda" and not shard.plain:
                with torch.cuda.device(device):
                    shard.pack_heads()
        axis = ("spatial" if shard_spatial else
                "channel" if shard_params_over_model else None)
        self._fns = group_binarizers(mesh, self.shards, axis,
                                     packed=force_binary,
                                     threshold=threshold, force_binary=False)
        if not force_binary:
            self._fns = [lambda frames, fn=fn: fn(frames)[0]
                         for fn in self._fns]

    def binarize_frames(self, frames: np.ndarray) -> np.ndarray:
        """uint8 RGB [B, H, W, 3] -> uint8 [B, H, W] in the raw model
        polarity, every row on every process."""
        batch, height, width = frames.shape[:3]
        frames = pad_rows(np.asarray(frames), self.mesh.shape["data"])
        if self.shard_spatial:
            unit = int(np.lcm(UNIT, self.mesh.shape["model"]))
            if height % unit:
                frames = np.pad(frames, ((0, 0), (0, (-height) % unit),
                                         (0, 0), (0, 0)), mode="edge")
        out = sharded_forward(self.mesh, self._fns, frames).cpu().numpy()
        if self.force_binary:
            out = unpack_bits_host(out, width)
        return out[:batch, :height]
