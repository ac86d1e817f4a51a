"""Device meshes for multi-card and multi-process runs.

The JAX package shards batches over a ``data`` axis and conv channels over
a ``model`` axis of a device mesh. The port has the data axis: frames of a
lecture are independent through the FCN forward, and training is
data-parallel. A ``Mesh`` here is the list of devices in process order with
``shape = {"data": D, "model": 1}``; each process drives the cards it sees
(``torch.cuda.device_count()``; a launcher that wants one card a process
sets ``CUDA_VISIBLE_DEVICES``), and processes join one world through the JAX
package's env contract (``LM_COORDINATOR``, ``LM_NUM_PROCESSES``,
``LM_PROCESS_ID``): NCCL between cards, gloo on the CPU. The model axis
(channel sharding, spatial sharding with halo exchanges) is not ported yet
and raises: ROADMAP queue 1, item 10b.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

MODEL_AXIS_NOT_PORTED = ("sharding over the mesh 'model' axis (-mesh DxM "
                         "with M > 1) is not ported yet (ROADMAP queue 1, "
                         "item 10b)")


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
    dist.destroy_process_group()
    return True


# ----------------------------------------------------------------- mesh

@dataclass(frozen=True)
class Mesh:
    """``devices``: the mesh's (process, device) pairs in process order;
    ``local_devices``: this process's devices among them; ``device_count``:
    the devices of every process, which the mesh may use only part of."""
    shape: Dict[str, int]
    devices: Tuple[Tuple[int, torch.device], ...]
    local_devices: Tuple[torch.device, ...]
    rank: int
    world_size: int
    device_count: int

    @property
    def device(self) -> torch.device:
        """The device this process's collectives and results live on."""
        return self.local_devices[0]


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
    order. Raises for a model axis (item 10b) and for more devices than
    there are."""
    if spec.model > 1:
        raise NotImplementedError(MODEL_AXIS_NOT_PORTED)
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
    return Mesh(shape={"data": spec.data, "model": spec.model},
                devices=chosen,
                local_devices=tuple(d for p, d in chosen if p == rank),
                rank=rank, world_size=world, device_count=sum(counts))


def _gather_counts(count: int, device: torch.device) -> List[int]:
    """Every process's device count, in process order."""
    import torch.distributed as dist

    mine = torch.tensor([count], dtype=torch.int64,
                        device=device if device.type == "cuda" else "cpu")
    counts = [torch.zeros_like(mine) for _ in range(process_count())]
    dist.all_gather(counts, mine)
    return [int(c.item()) for c in counts]


def check_mesh(mesh: Optional[Mesh]) -> None:
    """Raise for a mesh whose model axis is sharded (item 10b), or one
    that leaves this process no device."""
    if mesh is None:
        return
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(MODEL_AXIS_NOT_PORTED)
    if not mesh.local_devices:
        raise ValueError(f"process {mesh.rank} owns no device of the "
                         f"{mesh.shape['data']}x{mesh.shape['model']} mesh")


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
    ``module`` itself moved there, the others deep copies."""
    import copy

    replicas = []
    for k, device in enumerate(mesh.local_devices):
        replicas.append((module if k == 0 else copy.deepcopy(module)).to(
            device))
    return replicas


def params_pspec_tree(params: Dict[str, torch.Tensor],
                      mesh: Mesh) -> Dict[str, tuple]:
    """Partition spec of each parameter: replicated (``()``) on a data-only
    mesh. Channel sharding over 'model' raises (item 10b)."""
    check_mesh(mesh)
    return {key: () for key in params}


def shard_params(mesh: Mesh, module: torch.nn.Module
                 ) -> List[torch.nn.Module]:
    """Place a model on the mesh: replicated over 'data'. Channel sharding
    over 'model' raises (item 10b)."""
    check_mesh(mesh)
    return replicate(mesh, module)


def warmup_collectives(mesh: Mesh) -> None:
    """Create the world's communicators up front with one small all_reduce
    and a barrier, so that no process meets its first collective while a
    peer is still building a model or compiling a kernel. No-op in a world
    of one process that has no process group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return
    probe = torch.ones(1, device=mesh.device)
    dist.all_reduce(probe)
    dist.barrier()
    if int(probe.item()) != mesh.world_size:
        raise RuntimeError(f"warm-up all_reduce gave {probe.item()}, "
                           f"expected {mesh.world_size}")
