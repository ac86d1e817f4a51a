"""Device meshes for multi-card and multi-process runs.

As in the JAX package, a mesh has a ``data`` axis, over which batches
shard, and a ``model`` axis, over which stage-01 inference shards the
convs' channels or the frames' height (``parallel/model_axis.py``). A
``Mesh`` here is the list of devices in process order, laid out row-major
as (data, model): mesh device i sits at data position ``i // M`` and model
index ``i % M``. Each process drives the cards it sees
(``torch.cuda.device_count()``; a launcher that wants one card a process
sets ``CUDA_VISIBLE_DEVICES``), and processes join one world through the JAX
package's env contract (``LM_COORDINATOR``, ``LM_NUM_PROCESSES``,
``LM_PROCESS_ID``): NCCL between cards, gloo on the CPU. Where a model
group spans processes, ``make_mesh`` creates the sub-groups its collectives
run in. Training shards over the model axis as inference's channel use
does (``shard_params``; ``gather_params`` assembles the full state).
"""

from __future__ import annotations

import copy
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

@dataclass(frozen=True)
class MeshSpec:
    data: int = -1   # -1: all remaining devices
    model: int = 1

    def resolve(self, n_devices: Optional[int] = None) -> "MeshSpec":
        """Fill in ``data = -1`` from ``n_devices`` (default: the cards this
        process sees); raises when the mesh needs more devices than
        there are."""
        n = n_devices if n_devices is not None else torch.cuda.device_count()
        model = max(1, self.model)
        data = self.data if self.data > 0 else max(1, n // model)
        if data * model > n:
            raise ValueError(f"mesh {data}x{model} needs {data * model} "
                             f"devices, have {n}")
        return MeshSpec(data, model)


def parse_mesh_arg(text) -> MeshSpec:
    """Parse a user-facing mesh request: 'D', 'DxM', or 'auto' (all devices
    on the data axis). Used by the -mesh CLI flag and the TPU_MESH config
    key. Raises a usage-style ValueError on malformed input (bare -mesh
    flag, multiple tokens, non-numeric)."""
    usage = (f"invalid mesh request {text!r}: expected 'D', 'DxM', or "
             f"'auto' (e.g. -mesh 4x2)")
    if isinstance(text, (bool, list, tuple)):
        raise ValueError(usage)
    text = str(text).strip().lower()
    if text in ("auto", "all", "-1"):
        return MeshSpec()
    parts = text.split("x")
    try:
        data = int(parts[0])
        model = int(parts[1]) if len(parts) > 1 else 1
    except (ValueError, IndexError):
        raise ValueError(usage) from None
    if len(parts) > 2 or data < 1 or model < 1:
        raise ValueError(usage)
    return MeshSpec(data=data, model=model)


def mesh_spec_from(params=None, config=None) -> Optional[MeshSpec]:
    """Resolve a mesh request from CLI params ('-mesh DxM', wins) or the
    TPU_MESH config key; None when neither asks for a mesh."""
    value = None
    if params:
        value = params.get("mesh")
    if value is None and config is not None:
        value = config.get("TPU_MESH", None)
    if value in (None, "", 0, "0", "none", "1", 1):
        return None
    return parse_mesh_arg(value)


# ------------------------------------------------------------ processes

def process_count() -> int:
    """Processes in the world (1 without ``torch.distributed``)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def initialize_distributed_from_env(device: Union[None, str,
                                                  torch.device] = None
                                    ) -> bool:
    """Join a multi-process world when LM_COORDINATOR (``host:port``),
    LM_NUM_PROCESSES and LM_PROCESS_ID are set; no-op otherwise. Returns
    True when running multi-process, or in a world of one joined this way.
    NCCL for the card (``device`` None or cuda), gloo for the CPU; a second
    call joins nothing. Each process drives the cards it sees: a launcher
    that wants one card a process sets CUDA_VISIBLE_DEVICES."""
    import torch.distributed as dist

    coordinator = os.environ.get("LM_COORDINATOR")
    if not coordinator:
        return process_count() > 1
    if dist.is_initialized():
        return True
    cpu = device is not None and torch.device(device).type == "cpu"
    extra = {}
    if not cpu:
        # the process's first card carries its collectives
        torch.cuda.set_device(0)
        extra["device_id"] = torch.device("cuda", 0)
    dist.init_process_group(
        backend="gloo" if cpu else "nccl",
        init_method=f"tcp://{coordinator}",
        world_size=int(os.environ["LM_NUM_PROCESSES"]),
        rank=int(os.environ["LM_PROCESS_ID"]), **extra)
    return True


def shutdown_distributed() -> bool:
    """Leave a multi-process world: a barrier, then destroy it. False (and
    nothing done) unless ``torch.distributed`` is initialized; the CLIs
    call it on the way out, so a process that finishes early waits for its
    peers."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return False
    dist.barrier()
    _SUBGROUPS.clear()
    dist.destroy_process_group()
    return True


# ----------------------------------------------------------------- mesh

@dataclass(frozen=True)
class Mesh:
    """``devices``: the mesh's (process, device) pairs in process order;
    ``local_devices``: this process's devices among them; ``device_count``:
    the devices of every process, which the mesh may use only part of.
    ``model_group``: the ``torch.distributed`` group of the processes that
    share this process's model group, where one spans processes (else
    None); ``data_group``: the group a shard's rows are reduced and
    gathered over (cross-replica BN, losses, gradients, inference's
    results): the processes holding the same model indices at the other
    data positions where a model group spans processes, else the world
    (None in a process without ``torch.distributed``)."""
    shape: Dict[str, int]
    devices: Tuple[Tuple[int, torch.device], ...]
    local_devices: Tuple[torch.device, ...]
    rank: int
    world_size: int
    device_count: int
    model_group: Any = None
    data_group: Any = None

    @property
    def device(self) -> torch.device:
        """The device this process's collectives and results live on."""
        return self.local_devices[0]

    @property
    def first_local_index(self) -> int:
        """The mesh index of this process's first device."""
        return next(i for i, (p, _) in enumerate(self.devices)
                    if p == self.rank)


def mesh_devices(device: Union[None, str, torch.device],
                 spec: MeshSpec) -> List[torch.device]:
    """The devices this process offers a mesh: every card it sees, or on
    the CPU (``device='cpu'``) the spec's share of this process in CPU
    replicas (one for 'auto')."""
    if device is None or torch.device(device).type == "cuda":
        return [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
    if spec.data <= 0:
        return [torch.device("cpu")]
    return [torch.device("cpu")] * max(
        1, spec.data * max(1, spec.model) // process_count())


def make_mesh(spec: MeshSpec = MeshSpec(),
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """The mesh ``spec`` asks for over every process's devices, this
    process offering ``devices`` (default: the cards it sees). Like the JAX
    package's, it takes the first D*M devices of the world in process
    order, row-major as (data, model). Raises for more devices than there
    are, and for a model axis whose groups would split a process's devices
    unevenly. In a world of several processes every process must call it
    (it gathers the device counts and creates the sub-groups)."""
    local = list(devices) if devices is not None else mesh_devices(None,
                                                                   spec)
    if not local:
        raise ValueError("make_mesh: no devices (is a card visible?)")
    rank, world = process_index(), process_count()
    counts = _gather_counts(len(local), local[0]) if world > 1 else [
        len(local)]
    spec = spec.resolve(sum(counts))
    # another process's k-th device, as that process names it
    cuda = local[0].type == "cuda"
    everyone = [(process, local[k] if process == rank else
                 torch.device("cuda", k) if cuda else torch.device("cpu"))
                for process, count in enumerate(counts)
                for k in range(count)]
    chosen = tuple(everyone[:spec.data * spec.model])
    groups = _model_axis_groups(spec, chosen, world)
    return Mesh(shape={"data": spec.data, "model": spec.model},
                devices=chosen,
                local_devices=tuple(d for p, d in chosen if p == rank),
                rank=rank, world_size=world, device_count=sum(counts),
                model_group=groups[0], data_group=groups[1])


def _model_axis_groups(spec: MeshSpec, chosen, world: int):
    """(model group, data group) of this process: the sub-groups of a model
    axis whose groups span processes; else (None, the world), or (None,
    None) without ``torch.distributed``. A process's devices must hold
    whole model groups, or an equal part of one."""
    import torch.distributed as dist

    model = spec.model
    whole = (None, dist.group.WORLD if dist.is_available()
             and dist.is_initialized() else None)
    if model <= 1 or world <= 1:
        return whole
    held = [sum(1 for p, _ in chosen if p == process)
            for process in range(world)]
    per = held[0]
    if any(n != per for n in held) or not (per % model == 0
                                           or model % per == 0):
        raise ValueError(
            f"mesh {spec.data}x{model} over {world} processes holding "
            f"{held} of its devices: the model axis needs each process to "
            f"hold the same number of devices, whole model groups or an "
            f"equal part of one")
    span = max(1, model // per)   # processes a model group spans
    if span == 1:
        return whole
    # creating a group is collective and each holds communicators, so a
    # world makes the pair of a span once, however often the mesh is made
    key = (id(dist.group.WORLD), world, span)
    if key not in _SUBGROUPS:
        model_ranks = [list(range(g * span, (g + 1) * span))
                       for g in range(world // span)]
        data_ranks = [list(range(i, world, span)) for i in range(span)]
        _SUBGROUPS[key] = (
            dist.new_subgroups_by_enumeration(model_ranks)[0],
            dist.new_subgroups_by_enumeration(data_ranks)[0])
    return _SUBGROUPS[key]


# (world, world size, processes a model group spans) -> (model group, data
# group); emptied when the world is left
_SUBGROUPS: Dict[Tuple[int, int, int], Tuple[Any, Any]] = {}


def _gather_counts(count: int, device: torch.device) -> List[int]:
    """Every process's device count, in process order."""
    import torch.distributed as dist

    mine = torch.tensor([count], dtype=torch.int64,
                        device=device if device.type == "cuda" else "cpu")
    counts = [torch.zeros_like(mine) for _ in range(process_count())]
    dist.all_gather(counts, mine)
    return [int(c.item()) for c in counts]


def check_mesh(mesh: Optional[Mesh]) -> None:
    """Raise for a mesh that leaves this process no device."""
    if mesh is None:
        return
    if not mesh.local_devices:
        raise ValueError(f"process {mesh.rank} owns no device of the "
                         f"{mesh.shape['data']}x{mesh.shape['model']} mesh")


def local_model_groups(mesh: Mesh) -> List[List[Tuple[int, int]]]:
    """This process's devices by the data position they serve, in order:
    for each, the (model index, local device index) of every one of them.
    On a data-only mesh, one device each."""
    model = mesh.shape.get("model", 1)
    first = mesh.first_local_index
    groups: Dict[int, List[Tuple[int, int]]] = {}
    for k in range(len(mesh.local_devices)):
        groups.setdefault((first + k) // model, []).append(
            ((first + k) % model, k))
    return [groups[position] for position in sorted(groups)]


def local_row_slice(mesh: Mesh, n_rows: int) -> slice:
    """The contiguous batch-row range this process owns under a
    'data'-major mesh (process devices are contiguous in mesh order):
    rows [i*n/P, (i+1)*n/P) when the data axis spans the P processes, and
    wider where processes share data positions (a data axis smaller than
    the process count), so each sample enters the global batch once.
    Every process holds the SAME global batch and feeds only its share.
    Raises when the rows do not divide across the data axis, and for a
    sub-mesh in a multi-process run (a process owning no mesh device would
    be assigned rows)."""
    data_size = mesh.shape["data"]
    model_size = math.prod(s for name, s in mesh.shape.items()
                           if name != "data")
    count = mesh.world_size
    index = mesh.rank
    if n_rows % data_size:
        raise ValueError(f"batch of {n_rows} rows does not divide across "
                         f"the {data_size}-way data axis")
    n_mesh_devices = data_size * model_size
    if n_mesh_devices % count or n_mesh_devices != mesh.device_count:
        raise ValueError(
            f"multi-process run: the {data_size}x{model_size} mesh must "
            f"span all {mesh.device_count} devices across the {count} "
            f"processes (sub-meshes cannot be row-partitioned)")
    per_process = n_mesh_devices // count
    first_data = (index * per_process) // model_size
    last_data = ((index + 1) * per_process - 1) // model_size
    rows_per_shard = n_rows // data_size
    return slice(first_data * rows_per_shard,
                 (last_data + 1) * rows_per_shard)


def process_rows(mesh: Mesh, batch: Any) -> Any:
    """This process's rows of a GLOBAL batch (an array or a dict of arrays
    with a leading batch axis): all of them in a world of one."""
    if mesh.world_size <= 1:
        return batch
    if isinstance(batch, dict):
        rows = local_row_slice(mesh, len(next(iter(batch.values()))))
        return {key: value[rows] for key, value in batch.items()}
    return batch[local_row_slice(mesh, len(batch))]


def shard_batch(mesh: Mesh, batch: Any) -> List[Any]:
    """This process's rows (an array or a dict of arrays, leading batch
    axis) split evenly over its local devices: one tensor (or dict of
    tensors) on each local device, in order."""
    n_local = len(mesh.local_devices)

    def split(value):
        value = torch.as_tensor(value)
        if len(value) % n_local:
            raise ValueError(f"{len(value)} rows do not divide over "
                             f"{n_local} local devices")
        return [part.to(device) for part, device in zip(
            value.chunk(n_local), mesh.local_devices)]

    if isinstance(batch, dict):
        parts = {key: split(value) for key, value in batch.items()}
        return [{key: parts[key][k] for key in parts}
                for k in range(n_local)]
    return split(batch)


def replicate(mesh: Mesh, module: torch.nn.Module) -> List[torch.nn.Module]:
    """One copy of ``module`` on each local device, in order: the first is
    ``module`` itself moved there, the others deep copies. On a model axis
    each carries its device's ``model_index`` and the ``model_size`` (the
    height-sharded path holds one whole replica a shard)."""
    model = mesh.shape.get("model", 1)
    first = mesh.first_local_index
    replicas = []
    for k, device in enumerate(mesh.local_devices):
        replica = (module if k == 0 else copy.deepcopy(module)).to(device)
        if model > 1:
            replica.model_index, replica.model_size = (first + k) % model, \
                model
        replicas.append(replica)
    return replicas


def params_pspec_tree(params: Dict[str, torch.Tensor],
                      mesh: Mesh) -> Dict[str, tuple]:
    """Partition spec of each tensor of a ``state_dict``, in torch axis
    order: ``("model", None, ...)`` where its axis 0 shards over the mesh's
    'model' axis, ``()`` where it is replicated (always on a data-only
    mesh). The JAX package's rule (its ``params_pspec_tree``): a flax
    parameter shards its trailing axis where that divides by M and is at
    least M. ``models/convert.py`` maps flax's trailing axis to torch axis
    0 for every tensor: a conv's output channels, but a transposed conv's
    INPUT channels (flax's ConvTranspose(transpose_kernel) kernel is
    (kh, kw, O, I)), while its bias shards on the outputs. The BatchNorms'
    running statistics follow their channels here; the JAX package keeps
    them replicated, which in eval mode is the same function."""
    model = mesh.shape.get("model", 1)

    def spec(value: torch.Tensor) -> tuple:
        shape = tuple(value.shape)
        if model > 1 and shape and shape[0] % model == 0 \
                and shape[0] >= model:
            return ("model",) + (None,) * (len(shape) - 1)
        return ()

    return {key: spec(value) for key, value in params.items()}


def shard_params(mesh: Mesh, module: torch.nn.Module
                 ) -> List[torch.nn.Module]:
    """Place a model on the mesh: one module a local device, replicated over
    'data' (``replicate``) and, on a model axis, holding its device's slice
    of every tensor ``params_pspec_tree`` shards (replicated tensors
    copied). Each shard carries ``model_index``, ``model_size`` and the
    ``model_specs`` it was cut by."""
    model = mesh.shape.get("model", 1)
    if model <= 1:
        return replicate(mesh, module)
    state = dict(module.named_parameters())
    state.update(module.named_buffers())
    specs = params_pspec_tree(state, mesh)
    first = mesh.first_local_index
    shards = []
    for k, (device, parts) in enumerate(zip(mesh.local_devices,
                                            shard_state(mesh, state))):
        memo = {}
        for name, value in state.items():
            part = parts[name].detach().to(device).clone()
            memo[id(value)] = (torch.nn.Parameter(
                part, requires_grad=value.requires_grad)
                if isinstance(value, torch.nn.Parameter) else part)
        # the deep copy takes each tensor's slice from the memo
        shard = copy.deepcopy(module, memo)
        if hasattr(shard, "_head_packs"):
            shard._head_packs = {}
        shard.model_index, shard.model_size = (first + k) % model, model
        shard.model_specs = specs
        shards.append(shard)
    return shards


def shard_state(mesh: Mesh, state: Dict[str, torch.Tensor]
                ) -> List[Dict[str, torch.Tensor]]:
    """``shard_params``'s cut of a full ``state`` (a state dict, or any
    tensors by parameter name, e.g. momentum buffers): one dict a local
    device, each tensor that ``params_pspec_tree`` shards cut to that
    device's model index (a view), the others whole, where they lie."""
    model = mesh.shape.get("model", 1)
    specs = params_pspec_tree(state, mesh)
    first = mesh.first_local_index
    parts = []
    for k in range(len(mesh.local_devices)):
        index = (first + k) % model
        part = {}
        for name, value in state.items():
            if specs[name]:
                size = value.shape[0] // model
                value = value[index * size:(index + 1) * size]
            part[name] = value
        parts.append(part)
    return parts


def gather_params(mesh: Mesh, shards: Sequence[torch.nn.Module],
                  states: Optional[Sequence[Dict[str, torch.Tensor]]] = None
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_params``: the full state dict of the model
    whose model group's shards this process holds (one data position's:
    ``shards``, in model order), detached, on the CPU. A tensor that the
    shards' ``model_specs`` cut is concatenated on axis 0 in model order,
    over ``mesh.model_group`` too where the group spans processes (a
    collective: every process of the group calls it); a replicated one is
    taken once, from the first shard. ``states``: other tensors by
    parameter name to assemble the same way, one dict a shard (momentum
    buffers), in place of the shards' own parameters and buffers."""
    if states is None:
        states = []
        for shard in shards:
            state = dict(shard.named_parameters())
            state.update(shard.named_buffers())
            states.append(state)
    specs = shards[0].model_specs
    out = {}
    for name, value in states[0].items():
        if not specs[name]:
            out[name] = value.detach().cpu().clone()
            continue
        local = torch.cat([state[name].detach().to(mesh.device)
                           for state in states])
        if mesh.model_group is not None:
            import torch.distributed as dist

            received = [torch.empty_like(local) for _ in range(
                dist.get_world_size(mesh.model_group))]
            dist.all_gather(received, local.contiguous(),
                            group=mesh.model_group)
            local = torch.cat(received)
        out[name] = local.cpu()
    return out


def warmup_collectives(mesh: Mesh) -> None:
    """Create the world's communicators, and those of the mesh's model and
    data groups, up front with one small all_reduce in each and a barrier,
    so that no process meets its first collective while a peer is still
    building a model or compiling a kernel. No-op in a world of one process
    that has no process group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return
    groups = [None] + [group for group in (mesh.model_group,
                                            mesh.data_group)
                       if group not in (None, dist.group.WORLD)]
    for group in groups:
        probe = torch.ones(1, device=mesh.device)
        dist.all_reduce(probe, group=group)
        expected = dist.get_world_size(group)
        if int(probe.item()) != expected:
            raise RuntimeError(f"warm-up all_reduce gave {probe.item()}, "
                               f"expected {expected}")
    dist.barrier()
