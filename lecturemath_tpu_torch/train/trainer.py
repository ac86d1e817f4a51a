"""Training loop for FCN-LectureNet on one card (or the CPU when asked),
or data-parallel over a mesh of processes, one card each.

Reference training surface (lecturenet_train_00/01/02): SGD (momentum 0)
with per-phase learning rates/epochs from config, periodic backup
checkpoints, final state save. The JAX package's ``train/trainer.py`` in
PyTorch's idiom: ``torch.optim.SGD`` in place of optax (optax's momentum
trace is torch's momentum buffer), autograd in place of
``jax.value_and_grad``, ``nn.BatchNorm2d`` with torch's own running
statistics (the JAX package's ``TorchBatchNorm`` reproduces them).

Options that carry over:
  * ``freeze_bn``: every BatchNorm in ``eval()`` for the whole phase, as the
    reference trainers do after loading a pretrained model;
  * ``fold_frozen_bn``: the frozen BN affines folded into the conv weights
    inside each step (``fold_batch_norms(differentiable=True)``), the
    BN-free model run on them with ``torch.func.functional_call``; the
    original conv and BN parameters stay the gradient targets;
  * on a card, a float32 step with the fold and without mesh or clip runs
    as three CUDA graphs (``_StepGraphs``: the forward with the losses, the
    backward, the optimizer's step), captured on the second step and
    replayed after, so its pace is the card's and not the host's;
  * ``clip_norm``: optax's ``clip_by_global_norm``, g / |g| * c where |g| >=
    c (not ``clip_grad_norm_``, which divides by |g| + 1e-6);
  * mixed precision: the model's ``compute_dtype`` (bf16) over f32 master
    weights, BN in f32 unless TRAIN_BN_DTYPE = bf16 (``run_phase``);
  * a data-axis mesh (``-mesh D``, parallel/mesh.py): every process builds
    the same seeded global batch and trains on its rows
    (``local_row_slice``); live BatchNorms normalize over the global batch
    (parallel/sync_norm.py), weighted loss terms are global ratios
    (train/losses.py), gradients are all-reduced and averaged before the
    clip, so every process takes the same step the JAX package's
    data-sharded step takes;
  * a model axis (``-mesh DxM``, M > 1): the parameters are cut over the
    model axis as the JAX package's ``params_pspec_tree`` lays them out
    (``shard_params``), and the step runs the channel-sharded network
    (parallel/model_axis.py, whose note sets out the loss convention that
    makes the gradients exact). The rows, the cross-replica BN, the
    weighted ratios and the gradient average go over the data group
    (``Mesh.data_group``): a model group's shards hold different channels
    of the same rows. A replicated tensor's copies get the sum of their
    gradients over the model group; the clip's global norm counts a sharded
    gradient's squares over the group and a replicated one once. A process
    drives one data position: all its M shards (one card shared by them,
    M cards, or M CPU shards), or an equal part of a model group that spans
    processes; in a ``torch.distributed`` world, one card at most.
    Checkpoints and resume files hold the assembled full state
    (``gather_params``), so they load meshless, on any mesh and in the JAX
    package.

The heads train through ``F.conv2d`` (kernel K2 has no backward;
``FCNLectureNet._head``). The JAX package's space-to-depth layouts
(``TRAIN_S2D``, the frozen path's ``s2d_heads``) only change the TPU's
layout, not the result: the port has one layout, ``channels_last``.
"""

from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from ..core.config import Config
from ..core.device import resolve_device
from ..core.timing import span
from ..models.convert import load_checkpoint, save_checkpoint
from ..models.fcn_lecturenet import (FCNConfig, FCNLectureNet,
                                     fold_batch_norms, init_weights)
from ..parallel.mesh import (Mesh, MeshSpec, check_mesh, gather_params,
                             initialize_distributed_from_env,
                             local_model_groups, make_mesh, mesh_devices,
                             process_rows, shard_params, shard_state,
                             warmup_collectives)
from ..parallel.model_axis import ChannelShards, fold_shards
from .losses import phase_losses

_DTYPES = {"fp32": torch.float32, "float32": torch.float32,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def clip_by_global_norm_(parameters, max_norm: float,
                         norm: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the gradients, in place: where
    the global norm |g| reaches ``max_norm``, each gradient becomes
    g / |g| * max_norm. ``norm``: |g| where the parameters hold more than
    the model (a model axis's copies), else computed from them. Returns |g|
    (on the device, no sync)."""
    grads = [p.grad for p in parameters if p.grad is not None]
    if norm is None:
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm.to(g.device)
                            * max_norm))
    return norm


@contextlib.contextmanager
def _timed_convolutions():
    """cuDNN's convolutions timed on each new shape and the fastest kept
    (``torch.backends.cudnn.benchmark``) for the span of a step: a step's
    shapes repeat on every batch, so the first one pays for the timing.

    The reconstruction phase's steps run so. Its float32 convolutions get
    FFT engines from cuDNN's heuristics, which transpose the channels_last
    activations and fork onto a second stream; timed, a step of 8 crops of
    256x256 takes 22.2 ms on an H100 against 48.6. The binarizer phase
    keeps the heuristics' engines: timed, its first gradient lay about
    twice as far from a float32 reference's and its set-up took seconds
    more, for a step that is not what holds it back."""
    kept = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = kept


class DeviceBatch(dict):
    """A batch that ``Trainer.to_device`` made: NCHW tensors on the
    trainer's device."""


class Trainer:
    def __init__(self, model: FCNLectureNet, learning_rate: float,
                 momentum: float = 0.0, phase: str = "binarizer",
                 use_weights: bool = False, freeze_bn: bool = False,
                 clip_norm: Optional[float] = None,
                 fold_frozen_bn: bool = False, prefetch_depth: int = 2,
                 device: Union[None, str, torch.device] = None,
                 mesh: Optional[Mesh] = None):
        """``model`` moves to ``device`` (``cuda`` unless the caller asks
        for ``cpu``) in ``channels_last`` memory; its parameters are the
        f32 master weights. ``prefetch_depth`` batches are prepared and
        uploaded ahead on a producer thread (train/prefetch.py); 0 loads
        synchronously.

        ``mesh`` replaces ``device``. On a data-axis mesh this process
        holds one device (one card a process); in a joined
        ``torch.distributed`` world the steps are data-parallel over it,
        and without one (a 1x1 mesh in a single process) they are the plain
        steps. On a model axis (M > 1) this process holds one data
        position's shards (``shard_params`` cuts ``model``, which stays
        where it is): ``shards`` lists them and ``model`` is the first."""
        if fold_frozen_bn and not freeze_bn:
            raise ValueError("fold_frozen_bn requires freeze_bn (the fold "
                             "is only exact with frozen stats)")
        self.mesh = mesh
        self._group = None
        axis = mesh is not None and mesh.shape.get("model", 1) > 1
        if mesh is not None:
            check_mesh(mesh)
            held = len(mesh.local_devices)
            if len(local_model_groups(mesh)) != 1:
                raise ValueError(
                    f"data-parallel training drives one device a process "
                    f"(one data position's model shards on a model axis), "
                    f"and this process holds {held} devices of "
                    f"{len(local_model_groups(mesh))} data positions: start "
                    f"one process a data position (the training CLIs do so "
                    f"for -mesh D or DxM without LM_COORDINATOR; across "
                    f"hosts set CUDA_VISIBLE_DEVICES per process)")
            import torch.distributed as dist

            cards = {d for d in mesh.local_devices if d.type == "cuda"}
            if dist.is_available() and dist.is_initialized():
                if len(cards) > 1:
                    # autograd runs one thread a card, so the collectives
                    # a backward issues would reach their peers in an
                    # order that may differ between processes
                    raise ValueError(
                        f"a process of a torch.distributed world trains on "
                        f"one card, and this one holds {len(cards)}: start "
                        f"one process a card (-mesh DxM without "
                        f"LM_COORDINATOR does so on cards)")
                self._group = mesh.data_group
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        if axis:
            self.shards = [shard.to(memory_format=torch.channels_last)
                           for shard in shard_params(mesh, model)]
        else:
            self.shards = [model.to(self.device,
                                    memory_format=torch.channels_last)]
        self.model = self.shards[0]
        self._axis = axis
        for shard in self.shards:
            shard.bn_group = self._group
        # the share of the model group's loss this process backpropagates
        # (parallel/model_axis.py's loss convention)
        self._loss_share = (len(self.shards) / mesh.shape["model"]
                            if axis else 1.0)
        self.phase = phase
        self.use_weights = use_weights
        self.freeze_bn = freeze_bn
        self.clip_norm = clip_norm
        self.prefetch_depth = prefetch_depth
        self.optimizer = torch.optim.SGD(
            [p for shard in self.shards for p in shard.parameters()],
            lr=learning_rate, momentum=momentum)
        self.step_count = 0
        self._fold_model = None
        if fold_frozen_bn:
            # the BN-free structure the folded weights run in; it holds no
            # weights of its own (functional_call supplies every one)
            with torch.device("meta"):
                folds = [FCNLectureNet(
                    model.config, model.reconstruction_mode, fold_bn=True,
                    compute_dtype=model.compute_dtype) for _ in self.shards]
            if axis:
                for fold, shard in zip(folds, self.shards):
                    fold.model_index, fold.model_size = (shard.model_index,
                                                         shard.model_size)
                    fold.model_specs = shard.model_specs
                self._fold_model = ChannelShards(folds, mesh.model_group)
            else:
                self._fold_model = folds[0]
        self._live = (ChannelShards(self.shards, mesh.model_group) if axis
                      else self.model)
        # the step's CUDA graphs (``_StepGraphs``): None until captured, or
        # where the step may not run so; False once a capture has failed
        self._graphs = None if self._graphable(model) else False
        self._eager_steps = 0

    # -------------------------------------------------------------- steps

    def _set_modes(self) -> None:
        for shard in self.shards:
            shard.train()
            if self.freeze_bn:
                for module in shard.modules():
                    if isinstance(module, nn.BatchNorm2d):
                        module.eval()

    def to_device(self, batch) -> "DeviceBatch":
        """An NHWC batch as the dataset yields it -> NCHW tensors on the
        device, channels_last: numpy arrays pinned and copied asynchronously
        to a card, tensors already on the device (the card's route of
        ``LectureNetDataset.batches``) only permuted. Under a mesh the batch
        is the global one, and this process keeps its rows."""
        with span("train.upload"):
            if self.mesh is not None:
                batch = process_rows(self.mesh, batch)
            out = DeviceBatch()
            for key, value in batch.items():
                if isinstance(value, torch.Tensor):
                    tensor = value.to(self.device)
                else:
                    tensor = torch.from_numpy(np.ascontiguousarray(value))
                    if self.device.type == "cuda":
                        tensor = tensor.pin_memory().to(self.device,
                                                        non_blocking=True)
                out[key] = tensor.permute(0, 3, 1, 2)
        return out

    def forward(self, image: torch.Tensor):
        """The training forward: the live model (the channel-sharded network
        on a model axis), or with ``fold_frozen_bn`` the BN-free model on
        weights folded from the live ones (the fold is part of the autograd
        graph)."""
        if self._fold_model is None:
            return self._live(image)
        if self._axis:
            folded = {f"shards.{k}.{key}": value for k, state in enumerate(
                fold_shards(self.shards, self.mesh.model_group))
                for key, value in state.items()}
        else:
            state = dict(self.model.named_parameters())
            state.update(self.model.named_buffers())
            folded = fold_batch_norms(state, differentiable=True)
        return torch.func.functional_call(self._fold_model, folded, (image,))

    def step(self, batch) -> Dict[str, torch.Tensor]:
        """One SGD step on ``batch`` (NHWC as the dataset yields it, or
        ``to_device``'s), the span ``train.step``, and inside it the spans
        ``train.forward`` (the forward and the phase's losses, tagged with
        the phase), ``train.backward`` and ``train.update`` (the mesh's
        reductions, the clip and the optimizer's step), none reading the
        thread's CPU clock. Where ``_graphable``, the steps after the first
        replay CUDA graphs of those three parts (``_StepGraphs``). Returns
        the per-term losses and their total as device tensors."""
        with span("train.step"):
            return self._step(batch)

    def _graphable(self, model: FCNLectureNet) -> bool:
        """Whether the step may run as CUDA graphs: on a card, with the
        frozen BN folded, in float32, without a mesh, a clip or the
        reconstruction phase's timed convolutions."""
        return (self.device.type == "cuda" and self._fold_model is not None
                and self.mesh is None and self.clip_norm is None
                and self.phase != "reconstruction"
                and model.compute_dtype == torch.float32)

    def _step(self, batch) -> Dict[str, torch.Tensor]:
        if not isinstance(batch, DeviceBatch):
            batch = self.to_device(batch)
        graphs = self._graphs
        if graphs and not graphs.fits(batch, self.optimizer):
            graphs = self._graphs = None
        if graphs is None and self._eager_steps:
            # the first eager step has made cuDNN's handles and the
            # optimizer's state: what the capture must not make
            graphs = self._graphs = _StepGraphs.capture(self, batch)
        if graphs:
            metrics = graphs.run(batch)
        else:
            metrics = self._eager_step(batch)
            self._eager_steps += 1
        self.step_count += 1
        return metrics

    def _eager_step(self, batch: "DeviceBatch") -> Dict[str, torch.Tensor]:
        self._set_modes()
        self.optimizer.zero_grad(set_to_none=True)
        with (_timed_convolutions() if self.phase == "reconstruction"
              else contextlib.nullcontext()):
            with span("train.forward", tag=self.phase, cpu=False):
                outputs = self.forward(batch["image"].contiguous(
                    memory_format=torch.channels_last))
                terms = phase_losses(self.phase, outputs, batch,
                                     self.use_weights, self._group)
                total = sum(terms.values())
            with span("train.backward", cpu=False):
                (total * self._loss_share if self._axis else total).backward()
        metrics = dict(terms, total=total)
        with span("train.update", cpu=False):
            if self._axis:
                self._sum_replicated_gradients()
            if self._group is not None:
                self._average_gradients()
                metrics = self._global_means(metrics)
            if self.clip_norm is not None:
                clip_by_global_norm_(self._parameters(), self.clip_norm,
                                     self._global_norm() if self._axis
                                     else None)
            self.optimizer.step()
        return {key: value.detach() for key, value in metrics.items()}

    def _parameters(self):
        """Every parameter this process trains, shard by shard."""
        return [p for shard in self.shards for p in shard.parameters()]

    def _replicated(self):
        """(name, the copy of each local shard) of every parameter that the
        model axis replicates."""
        specs = self.model.model_specs
        copies = [dict(shard.named_parameters()) for shard in self.shards]
        return [(name, [c[name] for c in copies]) for name in copies[0]
                if not specs[name]]

    def _sum_replicated_gradients(self) -> None:
        """Each replicated parameter's gradients summed over its copies in
        the model group (the local shards', then over ``model_group`` in
        one flat all-reduce), every copy getting the sum: the meshless
        gradient (parallel/model_axis.py)."""
        sums = []
        for _, copies in self._replicated():
            grads = [p.grad.to(self.device) for p in copies
                     if p.grad is not None]
            sums.append((copies, sum(grads) if grads else
                         torch.zeros_like(copies[0], device=self.device)))
        if self.mesh.model_group is not None and sums:
            import torch.distributed as dist

            flat = torch.cat([total.reshape(-1) for _, total in sums])
            dist.all_reduce(flat, group=self.mesh.model_group)
            sums = [(copies, part.view_as(total)) for (copies, total), part
                    in zip(sums, flat.split([t.numel() for _, t in sums]))]
        for copies, total in sums:
            for p in copies:
                p.grad = total.to(p.device, copy=True)

    def _global_norm(self) -> torch.Tensor:
        """The global gradient norm of the model on a model axis: a sharded
        gradient's squares summed over the model group, a replicated one's
        counted once."""
        replicated = {name for name, _ in self._replicated()}
        sharded, once = [], []
        for k, shard in enumerate(self.shards):
            for name, p in shard.named_parameters():
                if p.grad is None or (name in replicated and k):
                    continue
                square = torch.sum(torch.square(p.grad.float())).to(
                    self.device)
                (once if name in replicated else sharded).append(square)
        total = torch.stack(sharded).sum() if sharded else torch.zeros(
            (), device=self.device)
        if self.mesh.model_group is not None:
            import torch.distributed as dist

            dist.all_reduce(total, group=self.mesh.model_group)
        if once:
            total = total + torch.stack(once).sum()
        return torch.sqrt(total)

    def _average_gradients(self) -> None:
        """All-reduce every gradient in one flat buffer over the data group
        and divide by its size: each process then holds the gradient of the
        global loss (see train/losses.py for the weighted terms)."""
        import torch.distributed as dist

        # each gradient's memory as a flat view (channels_last ones too):
        # one cat, one all-reduce and one multi-tensor copy back
        views = []
        for p in self._parameters():
            g = p.grad
            if g is None:
                continue
            if not (g.is_contiguous() or g.is_contiguous(
                    memory_format=torch.channels_last)):
                g = p.grad = g.contiguous()
            views.append(g.as_strided((g.numel(),), (1,)))
        flat = torch.cat(views)
        dist.all_reduce(flat, group=self._group)
        flat.div_(dist.get_world_size(self._group))
        torch._foreach_copy_(views, flat.split([v.numel() for v in views]))

    def _global_means(self, metrics: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """Each loss term averaged over the data group: the global batch's
        value (a weighted term is already global on every process)."""
        import torch.distributed as dist

        values = torch.stack([v.detach() for v in metrics.values()])
        dist.all_reduce(values, group=self._group)
        values.div_(dist.get_world_size(self._group))
        return dict(zip(metrics, values))

    def train_epoch(self, dataset, batch_size: int) -> Dict[str, float]:
        """One pass over ``dataset.batches(batch_size)``; the mean of each
        loss term. The per-step losses stay on the device and are stacked
        once at the end: one transfer a term, not one a step."""
        from .prefetch import prefetch

        batches = prefetch(dataset.batches(batch_size), self.prefetch_depth,
                           transform=self.to_device)
        losses = []
        try:
            for batch in batches:
                losses.append(self.step(batch))
        finally:
            if hasattr(batches, "close"):
                batches.close()
        if not losses:
            return {}
        return {key: float(torch.stack([m[key] for m in losses]).mean())
                for key in losses[0]}

    # -------------------------------------------------------- checkpoints

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's full state dict (a model axis's shards assembled by
        ``gather_params``: a collective where a model group spans
        processes)."""
        if self._axis:
            return gather_params(self.mesh, self.shards)
        return self.model.state_dict()

    def _writes(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def save(self, path: str) -> None:
        """The model's f32 state dict: a flax ``.msgpack`` the JAX package
        reads for a ``.msgpack``/``.flax`` path, else a torch ``.dat``.
        Every process of a mesh calls it (``state_dict``); process 0
        writes."""
        state = self.state_dict()
        if self._writes():
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            save_checkpoint(state, path)

    # full-state checkpoints (model, optimizer, step) for mid-training
    # resume, as torch.save files: not interchangeable with the JAX
    # package's orbax directories (the card's machine has no orbax). They
    # hold the full model and optimizer state (the JAX package's orbax
    # state holds full arrays too), so a run resumes on any mesh or none.

    def _optimizer_state(self) -> dict:
        """The optimizer's state dict in the full model's parameter order,
        a model axis's momentum buffers assembled like their parameters
        (collective like ``state_dict``)."""
        state = self.optimizer.state_dict()
        if not self._axis:
            return state
        names = [name for name, _ in self.model.named_parameters()]
        n = len(names)
        momenta = [{names[i]: state["state"][k * n + i]["momentum_buffer"]
                    for i in range(n) if state["state"].get(k * n + i, {})
                    .get("momentum_buffer") is not None}
                   for k in range(len(self.shards))]
        full = gather_params(self.mesh, self.shards, momenta)
        return {"state": {i: {"momentum_buffer": full[name]}
                          for i, name in enumerate(names) if name in full},
                "param_groups": [dict(state["param_groups"][0],
                                      params=list(range(n)))]}

    def save_resume_checkpoint(self, path: str) -> None:
        """Every process of a mesh calls it; process 0 writes."""
        state = {"model": self.state_dict(),
                 "optimizer": self._optimizer_state(),
                 "step": self.step_count}
        if self._writes():
            partial = f"{path}.{os.getpid()}.tmp"
            torch.save(state, partial)
            os.replace(partial, path)

    def restore_resume_checkpoint(self, path: str) -> None:
        if os.path.isdir(path):
            raise ValueError(
                f"{path} is a directory, an orbax checkpoint of the JAX "
                f"package; the port resumes only from its own torch.save "
                f"file (remove the directory to start the phase over)")
        state = torch.load(path, map_location="cpu" if self._axis
                           else self.device, weights_only=True)
        self.step_count = int(state["step"])
        if self._graphs:
            # the optimizer's state is replaced: a new capture reads it
            self._graphs = None
        if not self._axis:
            self.model.load_state_dict(state["model"])
            self.optimizer.load_state_dict(state["optimizer"])
            return
        for shard, part in zip(self.shards,
                               shard_state(self.mesh, state["model"])):
            shard.load_state_dict(part)
        names = [name for name, _ in self.model.named_parameters()]
        saved = state["optimizer"]
        momenta = shard_state(self.mesh, {
            names[i]: value["momentum_buffer"]
            for i, value in saved["state"].items()})
        n = len(names)
        self.optimizer.load_state_dict({
            "state": {k * n + i: {"momentum_buffer": part[name]}
                      for k, part in enumerate(momenta)
                      for i, name in enumerate(names) if name in part},
            "param_groups": [dict(saved["param_groups"][0],
                                  params=list(range(len(self.shards) * n)))]})


class _StepGraphs:
    """A trainer's step as three CUDA graphs, captured from one step and
    replayed for every later step whose batch has the same shapes: the
    forward with the phase's losses (``train.forward``), the backward
    (``train.backward``) and the optimizer's step (``train.update``), one
    memory pool. Each step copies its batch into the inputs the capture
    read. The gradients stay in the pool's buffers, written anew by each
    backward (the capture started from none), so the step takes no
    ``zero_grad``. The arithmetic is the eager step's: the same kernels on
    the same buffers' values."""

    def __init__(self, inputs, metrics, graphs, phase: str, rates):
        self.inputs, self.metrics, self.phase = inputs, metrics, phase
        self.forward, self.backward, self.update = graphs
        self.rates = rates

    @staticmethod
    def _rates(optimizer):
        return [(group["lr"], group["momentum"], group["weight_decay"])
                for group in optimizer.param_groups]

    @classmethod
    def capture(cls, trainer: "Trainer", batch: "DeviceBatch"):
        """The graphs of ``trainer``'s step on batches like ``batch``,
        captured, not yet run; False where the capture fails, and the
        trainer then steps eagerly."""
        inputs = DeviceBatch((key, torch.empty_like(value))
                             for key, value in batch.items())
        for key, value in batch.items():
            inputs[key].copy_(value)
        trainer._set_modes()
        trainer.optimizer.zero_grad(set_to_none=True)
        graphs = [torch.cuda.CUDAGraph() for _ in range(3)]
        pool = torch.cuda.graph_pool_handle()
        # the prefetch thread goes on making batches on the default stream
        # meanwhile: only this thread's calls must be capture-safe
        mode = "thread_local"
        try:
            with torch.cuda.graph(graphs[0], pool=pool,
                                  capture_error_mode=mode):
                outputs = trainer.forward(inputs["image"].contiguous(
                    memory_format=torch.channels_last))
                terms = phase_losses(trainer.phase, outputs, inputs,
                                     trainer.use_weights)
                total = sum(terms.values())
            with torch.cuda.graph(graphs[1], pool=pool,
                                  capture_error_mode=mode):
                total.backward()
            with torch.cuda.graph(graphs[2], pool=pool,
                                  capture_error_mode=mode):
                trainer.optimizer.step()
        except RuntimeError as error:
            import warnings

            warnings.warn(f"the training step runs eagerly: its CUDA graph "
                          f"capture failed ({error})")
            trainer.optimizer.zero_grad(set_to_none=True)
            return False
        metrics = {key: value.detach()
                   for key, value in dict(terms, total=total).items()}
        return cls(inputs, metrics, graphs, trainer.phase,
                   cls._rates(trainer.optimizer))

    def fits(self, batch: "DeviceBatch", optimizer) -> bool:
        """Whether ``batch`` and the optimizer's rates are those captured."""
        return (batch.keys() == self.inputs.keys() and all(
            value.shape == self.inputs[key].shape
            and value.dtype == self.inputs[key].dtype
            and value.stride() == self.inputs[key].stride()
            for key, value in batch.items())
            and self._rates(optimizer) == self.rates)

    def run(self, batch: "DeviceBatch") -> Dict[str, torch.Tensor]:
        """One step on ``batch``: its per-term losses and their total, as
        device tensors of their own."""
        with span("train.forward", tag=self.phase, cpu=False):
            for key, value in batch.items():
                self.inputs[key].copy_(value)
            self.forward.replay()
        with span("train.backward", cpu=False):
            self.backward.replay()
        with span("train.update", cpu=False):
            self.update.replay()
        return {key: value.clone() for key, value in self.metrics.items()}


# ---------------------------------------------------------------- phases

@dataclass
class PhaseSpec:
    """Per-phase config keys (reference: configs/FCN_LectureNet.conf:31-106)."""
    name: str
    lr_key: str
    epochs_key: str
    output_key: str
    default_lr: float
    default_epochs: int
    backup_every: int
    reconstruction_mode: bool


PHASES = {
    "reconstruction": PhaseSpec(
        "reconstruction", "FCN_BINARIZER_PRETRAIN_REC_LEARNING_RATE",
        "FCN_BINARIZER_PRETRAIN_REC_EPOCHS",
        "FCN_BINARIZER_PRETRAIN_RECONSTRUCTION_OUTPUT", 0.01, 100, 2, True),
    "text_detector": PhaseSpec(
        "text_detector", "FCN_BINARIZER_PRETRAIN_LEARNING_RATE",
        "FCN_BINARIZER_PRETRAIN_EPOCHS",
        "FCN_BINARIZER_PRETRAIN_TEXT_OUTPUT", 0.01, 100, 5, False),
    "binarizer": PhaseSpec(
        "binarizer", "FCN_BINARIZER_TRAIN_LEARNING_RATE",
        "FCN_BINARIZER_TRAIN_EPOCHS",
        "FCN_BINARIZER_TRAIN_OUTPUT", 0.001, 200, 5, False),
}

# the binarization and text-mask heads (reference reset_main_branches)
HEADS = ("conv_pixels_1", "conv_pixels_2", "conv_text_mask_out", "conv_out")


def init_variables_for(net_config: FCNConfig,
                       generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A fresh full model's state dict, drawn from ``generator``."""
    return init_weights(FCNLectureNet(net_config), generator).state_dict()


def reset_main_branches(state_dict: Dict[str, torch.Tensor],
                        net_config: FCNConfig,
                        generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fresh-init the binarization + text-mask heads (conv and BN) while
    keeping the trunk and the reconstruction head (reference:
    FCN_LectureNet.reset_main_branches, FCN_lecturenet.py:203-211 — used
    when warm-starting from the reconstruction pretrain, whose checkpoint
    has no such heads)."""
    fresh = init_variables_for(net_config, generator)
    out = {key: value for key, value in state_dict.items()
           if not key.startswith(tuple(f"{h}." for h in HEADS))}
    out.update({key: value for key, value in fresh.items()
                if key.startswith(tuple(f"{h}." for h in HEADS))})
    return out


def _dtype(config: Config, key: str) -> torch.dtype:
    value = config.get_str(key, "fp32").lower()
    if value not in _DTYPES:
        raise ValueError(f"{key} must be fp32 or bf16, got {value!r}")
    return _DTYPES[value]


def run_phase(config: Config, phase_name: str, dataset,
              warm_start_path: Optional[str] = None,
              warm_start_is_reconstruction: bool = False,
              mesh_spec: Optional[MeshSpec] = None,
              epochs_override: Optional[int] = None,
              batch_size_override: Optional[int] = None,
              verbose: bool = True,
              device: Union[None, str, torch.device] = None) -> str:
    """Run one curriculum phase end-to-end; returns the checkpoint path.

    Mirrors the reference trainers' flow: build/warm-start the model (with
    head reset when starting from the reconstruction pretrain, and BN
    frozen on any warm start), SGD over epochs with periodic .bak
    checkpoints and a resume file, save the final state to the phase's
    configured output path. Runs on ``device``: ``cuda`` unless the caller
    passes ``cpu``; ``dataset`` (a ``LectureNetDataset``) is routed there
    (``LectureNetDataset.route``), so its batches are made on the same
    device.

    ``mesh_spec``: training over a mesh, one data position a process (its
    devices, or on a model axis that spans processes a part of one), the
    processes joined under the LM_* env contract
    (``initialize_distributed_from_env``); a model axis (M > 1) shards the
    parameters over it (``Trainer``). Only process 0 writes the
    checkpoints, the ``.bak`` files and the resume file, all holding the
    full model; the others wait at a barrier (the JAX package's processes
    each write the same bytes, which processes sharing one file system
    would tear).
    """
    spec = PHASES[phase_name]
    net_config = FCNConfig.from_config(config)
    # TRAIN_PRECISION = bf16 computes the forward/backward in bfloat16 over
    # f32 master weights, optimizer state, losses and BatchNorm; f32 is the
    # default. TRAIN_BN_DTYPE = bf16 also runs live BN in bfloat16 (its
    # running buffers stay f32).
    dtype = _dtype(config, "TRAIN_PRECISION")
    bn_dtype = _dtype(config, "TRAIN_BN_DTYPE")

    if warm_start_path is not None and not os.path.exists(warm_start_path):
        # a typo'd path must not silently fall back to from-scratch training
        # (warm_started also gates the frozen-BN semantics); the reference
        # crashes in torch.load here (lecturenet_train_02:173)
        raise FileNotFoundError(
            f"[{phase_name}] warm-start checkpoint not found: "
            f"{warm_start_path} — run the pretraining phase first or unset "
            "the USE_*_OUTPUT config key")
    device = resolve_device(device)
    mesh = None
    if mesh_spec is not None:
        # after the warm-start check: a process missing the file fails
        # before its peers wait for it in a collective
        initialize_distributed_from_env(device)
        mesh = make_mesh(mesh_spec, mesh_devices(device, mesh_spec))
        warmup_collectives(mesh)

    lr = config.get_float(spec.lr_key, spec.default_lr)
    epochs = epochs_override or config.get_int(spec.epochs_key,
                                               spec.default_epochs)
    if batch_size_override is not None:
        batch_size = batch_size_override
    elif phase_name == "binarizer":
        batch_size = config.get_int("FCN_BINARIZER_TRAIN_BATCH_SIZE", 8)
    else:
        batch_size = config.get_int("FCN_BINARIZER_PRETRAIN_BATCH_SIZE", 8)

    model = FCNLectureNet(net_config,
                          reconstruction_mode=spec.reconstruction_mode,
                          compute_dtype=dtype, bn_dtype=bn_dtype)
    warm_started = warm_start_path is not None
    if warm_started:
        variables = load_checkpoint(warm_start_path)
        if warm_start_is_reconstruction:
            variables = reset_main_branches(
                variables, net_config, torch.Generator().manual_seed(1))
        missing = [key for key in model.state_dict() if key not in variables]
        if missing:
            raise KeyError(f"[{phase_name}] {warm_start_path} lacks "
                           f"{missing[:4]} ({len(missing)} entries)")
        model.load_state_dict({key: variables[key]
                               for key in model.state_dict()})
        if verbose:
            print(f"[{phase_name}] warm start from {warm_start_path}"
                  f"{' (heads reset)' if warm_start_is_reconstruction else ''}")
    else:
        init_weights(model, torch.Generator().manual_seed(0))

    # warm-start phases fold the frozen BN into the convs inside the step
    # by default (an exact rewrite); TRAIN_FROZEN_FAST = 0 keeps the BNs
    frozen_fast = warm_started and config.get_bool("TRAIN_FROZEN_FAST", True)
    trainer = Trainer(model, lr, phase=phase_name, freeze_bn=warm_started,
                      fold_frozen_bn=frozen_fast,
                      prefetch_depth=config.get_int("TRAIN_PREFETCH_BATCHES",
                                                    2),
                      device=device, mesh=mesh)
    # the batches' pixels and medians are made on the trainer's device
    dataset.route(trainer.device)

    def write(save) -> None:
        """``save()`` on every process (a model axis gathers its shards;
        process 0 writes); the others wait until it is done."""
        save()
        if mesh is not None and mesh.world_size > 1:
            import torch.distributed as dist

            dist.barrier()

    out_path = config.get_str(spec.output_key,
                              f"models/lecturenet_{phase_name}.msgpack")

    # resume from a full-state checkpoint if one exists
    resume_path = out_path + ".resume"
    meta_path = resume_path + ".json"
    start_epoch = 0
    if os.path.exists(resume_path) and os.path.exists(meta_path):
        with open(meta_path) as f:
            start_epoch = json.load(f)["completed_epochs"]
        trainer.restore_resume_checkpoint(resume_path)
        if verbose:
            print(f"[{phase_name}] resumed after epoch {start_epoch}")

    for epoch in range(start_epoch, epochs):
        metrics = trainer.train_epoch(dataset, batch_size)
        if verbose:
            printable = ", ".join(f"{k}={v:.5f}" for k, v in metrics.items())
            print(f"[{phase_name}] epoch {epoch + 1}/{epochs}: {printable}")
        if (epoch + 1) % spec.backup_every == 0:
            def backup(epoch=epoch):
                trainer.save(out_path + f".epoch_{epoch + 1}.bak")
                trainer.save_resume_checkpoint(resume_path)
                if mesh is None or mesh.rank == 0:
                    with open(meta_path, "w") as f:
                        json.dump({"completed_epochs": epoch + 1}, f)

            write(backup)

    write(lambda: trainer.save(out_path))
    return out_path
