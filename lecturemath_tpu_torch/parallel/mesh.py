"""Mesh requests of the CLIs (``-mesh DxM`` and the TPU_MESH config key).

The JAX package shards batches over a ``data`` axis and conv channels over
a ``model`` axis of a device mesh. The port runs on one card: this module
keeps the JAX-free part, parsing a request and resolving it against the
cards there are, so a CLI can tell a one-device request from one it cannot
serve yet. Sharding over several cards is ROADMAP queue 1, item 10.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MeshSpec:
    data: int = -1   # -1: all remaining devices
    model: int = 1


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


def check_single_device(spec: Optional[MeshSpec], n_devices: int) -> None:
    """Raise for a mesh that resolves to more than one of ``n_devices``
    devices: the port does not shard over several cards yet."""
    if spec is None:
        return
    model = max(1, spec.model)
    data = spec.data if spec.data > 0 else max(1, n_devices // model)
    if data * model > 1:
        raise NotImplementedError(
            f"mesh {spec.data}x{spec.model} spans more than one device; "
            f"sharding over several cards is not ported yet (ROADMAP "
            f"queue 1, item 10)")


def shutdown_distributed() -> bool:
    """Leave a multi-process group: a barrier, then destroy it. False (and
    nothing done) unless ``torch.distributed`` is initialized; the CLIs
    call it on the way out, as the JAX package's do."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return False
    dist.barrier()
    dist.destroy_process_group()
    return True
