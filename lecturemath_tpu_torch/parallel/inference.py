"""Frame-sharded inference over the data axis of a mesh.

Frames are independent through the FCN forward, so a batch splits by rows:
each process takes its rows of the global batch (``local_row_slice``; every
process holds the same global batch), each of its local devices runs one
replica of the model on an equal part of them, and the results meet on the
process's first device, then across processes by ``all_gather``, so every
process receives every frame, as the JAX package's replicating fetch gives
it. Inside a process no collective runs: one Python thread launches each
card's forward in turn, and the cards compute at once.

The model axis (``shard_params_over_model``, ``shard_spatial`` with its
halo exchanges) is ROADMAP queue 1, item 10b, and raises.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from ..models.fcn_lecturenet import (FCNLectureNet, make_binarizer,
                                     make_packed_binarizer, unpack_bits_host)
from .mesh import (MODEL_AXIS_NOT_PORTED, Mesh, check_mesh, replicate,
                   shard_batch, process_rows)


def pad_rows(frames: np.ndarray, multiple: int) -> np.ndarray:
    """Repeat the last frame until the rows divide by ``multiple``."""
    pad = (-len(frames)) % multiple
    if pad:
        frames = np.concatenate([frames, np.repeat(frames[-1:], pad, 0)])
    return frames


def all_gather_rows(mesh: Mesh, rows: torch.Tensor) -> torch.Tensor:
    """Every process's ``rows`` (equal shapes), concatenated in process
    order; ``rows`` itself in a world of one."""
    if mesh.world_size <= 1:
        return rows
    import torch.distributed as dist

    parts = [torch.empty_like(rows) for _ in range(mesh.world_size)]
    dist.all_gather(parts, rows.contiguous())
    return torch.cat(parts)


def sharded_forward(mesh: Mesh, fns: Sequence[Callable], frames: np.ndarray
                    ) -> torch.Tensor:
    """``fns[k]`` (a batch function of local device k's replica) on that
    device's part of this process's rows of the global batch ``frames``
    (rows a multiple of the data axis); returns the output of every row,
    in order, on ``mesh.device``."""
    parts = shard_batch(mesh, process_rows(mesh, frames))
    outs = []
    for device, fn, part in zip(mesh.local_devices, fns, parts):
        if device.type == "cuda":
            with torch.cuda.device(device):
                outs.append(fn(part))
        else:
            outs.append(fn(part))
    local = torch.cat([out.to(mesh.device) for out in outs])
    return all_gather_rows(mesh, local)


class ShardedBinarizer:
    """Batched binarizer with the frame axis sharded over the mesh's data
    axis: one replica of ``model`` (weights as given, eval mode) per local
    device. Any batch size: rows are padded with the last frame to a
    multiple of the data axis and cropped back.

    ``force_binary``: {0, 255} through the packed tail (kernel K1 on a
    card, its plain version on the CPU) and a host unpack; else the
    thresholdless ``sigmoid * 255`` map."""

    def __init__(self, model: FCNLectureNet, mesh: Mesh,
                 force_binary: bool = True, threshold: int = 128,
                 shard_params_over_model: bool = False,
                 shard_spatial: bool = False):
        if shard_params_over_model or shard_spatial:
            raise NotImplementedError(MODEL_AXIS_NOT_PORTED)
        check_mesh(mesh)
        self.mesh = mesh
        self.force_binary = force_binary
        self.threshold = threshold
        self.replicas: List[FCNLectureNet] = [
            replica.eval() for replica in replicate(mesh, model)]
        for replica, device in zip(self.replicas, mesh.local_devices):
            if device.type == "cuda" and not replica.plain:
                with torch.cuda.device(device):
                    replica.pack_heads()
        if force_binary:
            self._fns = [make_packed_binarizer(replica, threshold=threshold)
                         for replica in self.replicas]
        else:
            self._fns = [self._full_output(replica)
                         for replica in self.replicas]

    @staticmethod
    def _full_output(replica: FCNLectureNet) -> Callable:
        binarize = make_binarizer(replica, force_binary=False)
        return lambda frames: binarize(frames)[0]

    def binarize_frames(self, frames: np.ndarray) -> np.ndarray:
        """uint8 RGB [B, H, W, 3] -> uint8 [B, H, W] in the raw model
        polarity, every row on every process."""
        batch, height, width = frames.shape[:3]
        frames = pad_rows(np.asarray(frames), self.mesh.shape["data"])
        out = sharded_forward(self.mesh, self._fns, frames).cpu().numpy()
        if self.force_binary:
            out = unpack_bits_host(out, width)
        return out[:batch, :height]
