"""Local launch of a training CLI over a mesh: ``-mesh D`` or ``-mesh DxM``
with D > 1 in a single process starts processes of the same CLI on this
host under the LM_* env contract of ``parallel/mesh.py``.

Training drives one data position a process, and one card a process in a
world of several (the DDP idiom: autograd runs one thread a card, so the
collectives of a backward on several cards of one process could reach
their peers in another order). So a CLI that is asked for a mesh of
several data positions and has not joined a world (no LM_COORDINATOR)
becomes the launcher: on the CPU it starts D workers, each holding its
data position's M CPU shards; on cards D x M workers, one card each, the
M of a model group joined by its sub-group (``make_mesh``). Worker k gets
``LM_PROCESS_ID = k`` and, on the card, ``CUDA_VISIBLE_DEVICES`` naming
the k-th card this process sees; every worker gets
``LM_LOCAL_PROCESSES``, their count, over which each one's dataset splits
the host memory it may keep preloaded (``train/dataset.py
preload_budget``). A mesh of one data position (``-mesh 1xM``) trains in
this process, over M cards or M CPU shards. The launcher waits for the
workers and returns the first non-zero exit code; when a worker fails it
stops the others, which would otherwise wait for it in a collective.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Union

import torch

from .mesh import MeshSpec

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def visible_cards() -> List[str]:
    """The cards this process sees, as CUDA_VISIBLE_DEVICES entries."""
    listed = os.environ.get("CUDA_VISIBLE_DEVICES")
    if listed is not None:
        return [c.strip() for c in listed.split(",") if c.strip()]
    return [str(k) for k in range(torch.cuda.device_count())]


def workers_needed(spec: Optional[MeshSpec],
                   device: Union[None, str, torch.device]) -> int:
    """How many worker processes a training CLI must start for ``spec``:
    0 when it trains in this process (no mesh, a mesh of one data
    position, or a world already joined under LM_COORDINATOR); else D on
    the CPU and D x M on cards (one card each). Raises when the mesh needs
    more cards than this process sees."""
    if spec is None or os.environ.get("LM_COORDINATOR"):
        return 0
    cpu = device is not None and torch.device(device).type == "cpu"
    model = max(1, spec.model)
    if spec.data > 0:
        data = spec.data
    else:
        data = 1 if cpu else max(1, torch.cuda.device_count() // model)
    if not cpu and data * model > len(visible_cards()):
        raise ValueError(f"mesh {data}x{model} needs {data * model} "
                         f"devices, have {len(visible_cards())}")
    if data <= 1:
        return 0
    return data if cpu else data * model


def launch_local(module: str, args: Sequence[str], n: int,
                 device: Union[None, str, torch.device]) -> int:
    """Run ``python -m module *args`` as ``n`` processes of one world on
    127.0.0.1; returns 0, or the first non-zero exit code."""
    cpu = device is not None and torch.device(device).type == "cpu"
    cards = [] if cpu else visible_cards()
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, LM_COORDINATOR=f"127.0.0.1:{port}",
                   LM_NUM_PROCESSES=str(n), LM_PROCESS_ID=str(rank),
                   LM_LOCAL_PROCESSES=str(n))
        env["PYTHONPATH"] = os.pathsep.join(
            [PACKAGE_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        if not cpu:
            env["CUDA_VISIBLE_DEVICES"] = cards[rank]
        procs.append(subprocess.Popen([sys.executable, "-m", module,
                                       *args], env=env))
    code = 0
    try:
        while procs:
            for proc in list(procs):
                status = proc.poll()
                if status is None:
                    continue
                procs.remove(proc)
                if status != 0 and code == 0:
                    code = status
                    for other in procs:
                        other.terminate()
            time.sleep(0.2)
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    return code


def launch_if_needed(module: str, argv: Sequence[str],
                     spec: Optional[MeshSpec],
                     device: Union[None, str, torch.device]) -> bool:
    """The training CLIs' entry: when ``spec`` needs worker processes
    (``workers_needed``), run ``module`` with ``argv[1:]`` in them and
    return True (raising SystemExit with a failed worker's code); else
    False, and the caller trains in this process."""
    n = workers_needed(spec, device)
    if not n:
        return False
    code = launch_local(module, argv[1:], n, device)
    if code:
        raise SystemExit(code)
    return True
