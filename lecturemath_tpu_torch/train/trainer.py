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
    data-sharded step takes.

The heads train through ``F.conv2d`` (kernel K2 has no backward;
``FCNLectureNet._head``). The JAX package's space-to-depth layouts
(``TRAIN_S2D``, the frozen path's ``s2d_heads``) only change the TPU's
layout, not the result: the port has one layout, ``channels_last``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from ..core.config import Config
from ..core.device import resolve_device
from ..models.convert import load_checkpoint, save_checkpoint
from ..models.fcn_lecturenet import (FCNConfig, FCNLectureNet,
                                     fold_batch_norms, init_weights)
from ..parallel.mesh import (MODEL_AXIS_NOT_PORTED, Mesh, MeshSpec,
                             check_mesh, initialize_distributed_from_env,
                             make_mesh, mesh_devices, process_rows,
                             warmup_collectives)
from .losses import phase_losses

_DTYPES = {"fp32": torch.float32, "float32": torch.float32,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def clip_by_global_norm_(parameters, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the gradients, in place: where
    the global norm |g| reaches ``max_norm``, each gradient becomes
    g / |g| * max_norm. Returns |g| (on the device, no sync)."""
    grads = [p.grad for p in parameters if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


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

        ``mesh``: a data-axis mesh with one device in this process (one
        card a process), which replaces ``device``. In a joined
        ``torch.distributed`` world the steps are data-parallel over it;
        without one (a 1x1 mesh in a single process) they are the plain
        steps."""
        if fold_frozen_bn and not freeze_bn:
            raise ValueError("fold_frozen_bn requires freeze_bn (the fold "
                             "is only exact with frozen stats)")
        self.mesh = mesh
        self._group = None
        if mesh is not None:
            check_mesh(mesh)
            if mesh.shape.get("model", 1) > 1:
                raise NotImplementedError(MODEL_AXIS_NOT_PORTED)
            if len(mesh.local_devices) != 1:
                raise ValueError(
                    f"data-parallel training drives one device a process, "
                    f"and this process holds {len(mesh.local_devices)} of "
                    f"the mesh: start one process a card (the training "
                    f"CLIs do so for -mesh D without LM_COORDINATOR; "
                    f"across hosts set CUDA_VISIBLE_DEVICES per process)")
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                self._group = dist.group.WORLD
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        self.model = model.to(self.device,
                              memory_format=torch.channels_last)
        self.model.bn_group = self._group
        self.phase = phase
        self.use_weights = use_weights
        self.freeze_bn = freeze_bn
        self.clip_norm = clip_norm
        self.prefetch_depth = prefetch_depth
        self.optimizer = torch.optim.SGD(self.model.parameters(),
                                         lr=learning_rate, momentum=momentum)
        self.step_count = 0
        self._fold_model = None
        if fold_frozen_bn:
            # the BN-free structure the folded weights run in; it holds no
            # weights of its own (functional_call supplies every one)
            with torch.device("meta"):
                self._fold_model = FCNLectureNet(
                    model.config, model.reconstruction_mode, fold_bn=True,
                    compute_dtype=model.compute_dtype)

    # -------------------------------------------------------------- steps

    def _set_modes(self) -> None:
        self.model.train()
        if self.freeze_bn:
            for module in self.model.modules():
                if isinstance(module, nn.BatchNorm2d):
                    module.eval()

    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str,
                                                                 torch.Tensor]:
        """NHWC numpy batch -> NCHW tensors on the device, channels_last
        (pinned and copied asynchronously to a card). Under a mesh the
        batch is the global one, and this process keeps its rows."""
        if self.mesh is not None:
            batch = process_rows(self.mesh, batch)
        out = {}
        for key, value in batch.items():
            tensor = torch.from_numpy(np.ascontiguousarray(value))
            if self.device.type == "cuda":
                tensor = tensor.pin_memory().to(self.device,
                                                non_blocking=True)
            out[key] = tensor.permute(0, 3, 1, 2)
        return out

    def forward(self, image: torch.Tensor):
        """The training forward: the live model, or with ``fold_frozen_bn``
        the BN-free model on weights folded from the live ones (the fold is
        part of the autograd graph)."""
        if self._fold_model is None:
            return self.model(image)
        state = dict(self.model.named_parameters())
        state.update(self.model.named_buffers())
        folded = fold_batch_norms(state, differentiable=True)
        return torch.func.functional_call(self._fold_model, folded, (image,))

    def step(self, batch) -> Dict[str, torch.Tensor]:
        """One SGD step on ``batch`` (numpy NHWC, or tensors from
        ``to_device``). Returns the per-term losses and their total as
        device tensors."""
        if isinstance(next(iter(batch.values())), np.ndarray):
            batch = self.to_device(batch)
        self._set_modes()
        self.optimizer.zero_grad(set_to_none=True)
        outputs = self.forward(batch["image"].contiguous(
            memory_format=torch.channels_last))
        terms = phase_losses(self.phase, outputs, batch, self.use_weights,
                             self._group)
        total = sum(terms.values())
        total.backward()
        metrics = dict(terms, total=total)
        if self._group is not None:
            self._average_gradients()
            metrics = self._global_means(metrics)
        if self.clip_norm is not None:
            clip_by_global_norm_(self.model.parameters(), self.clip_norm)
        self.optimizer.step()
        self.step_count += 1
        return {key: value.detach() for key, value in metrics.items()}

    def _average_gradients(self) -> None:
        """All-reduce every gradient in one flat buffer and divide by the
        world size: each process then holds the gradient of the global
        loss (see train/losses.py for the weighted terms)."""
        import torch.distributed as dist

        # each gradient's memory as a flat view (channels_last ones too):
        # one cat, one all-reduce and one multi-tensor copy back
        views = []
        for p in self.model.parameters():
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
        """Each loss term averaged over the processes: the global batch's
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

    def save(self, path: str) -> None:
        """The model's f32 state dict: a flax ``.msgpack`` the JAX package
        reads for a ``.msgpack``/``.flax`` path, else a torch ``.dat``."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_checkpoint(self.model.state_dict(), path)

    # full-state checkpoints (model, optimizer, step) for mid-training
    # resume, as torch.save files: not interchangeable with the JAX
    # package's orbax directories (the card's machine has no orbax)

    def save_resume_checkpoint(self, path: str) -> None:
        partial = f"{path}.{os.getpid()}.tmp"
        torch.save({"model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "step": self.step_count}, partial)
        os.replace(partial, path)

    def restore_resume_checkpoint(self, path: str) -> None:
        if os.path.isdir(path):
            raise ValueError(
                f"{path} is a directory, an orbax checkpoint of the JAX "
                f"package; the port resumes only from its own torch.save "
                f"file (remove the directory to start the phase over)")
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step_count = int(state["step"])


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
    passes ``cpu``.

    ``mesh_spec``: data-parallel training over a mesh, one device a
    process, the processes joined under the LM_* env contract
    (``initialize_distributed_from_env``). Only process 0 writes the
    checkpoints, the ``.bak`` files and the resume file; the others wait
    at a barrier (the JAX package's processes each write the same bytes,
    which processes sharing one file system would tear).
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

    def write(save) -> None:
        """``save()`` on process 0 only; the others wait until it is done."""
        if mesh is None or mesh.rank == 0:
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
                with open(meta_path, "w") as f:
                    json.dump({"completed_epochs": epoch + 1}, f)

            write(backup)

    write(lambda: trainer.save(out_path))
    return out_path
