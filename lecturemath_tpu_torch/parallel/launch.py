"""Local launch of a data-parallel training CLI: ``-mesh D`` with D > 1 in a
single process starts D processes of the same CLI on this host, one device
each, under the LM_* env contract of ``parallel/mesh.py``.

Training drives one card a process (the DDP idiom), so a CLI that is asked
for D devices and has not joined a world (no LM_COORDINATOR) becomes the
launcher: worker k gets ``LM_PROCESS_ID = k`` and, on the card,
``CUDA_VISIBLE_DEVICES`` naming the k-th card this process sees. The
launcher waits for the workers and returns the first non-zero exit code;
when a worker fails it stops the others, which would otherwise wait for it
in a collective.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Union

import torch

from .mesh import MODEL_AXIS_NOT_PORTED, MeshSpec

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
    0 when it trains in this process (no mesh, a mesh of one device, or a
    world already joined under LM_COORDINATOR)."""
    if spec is None or os.environ.get("LM_COORDINATOR"):
        return 0
    if spec.model > 1:
        raise NotImplementedError(MODEL_AXIS_NOT_PORTED)
    cpu = device is not None and torch.device(device).type == "cpu"
    if spec.data > 0:
        n = spec.data
    else:
        n = 1 if cpu else torch.cuda.device_count()
    if not cpu and n > len(visible_cards()):
        raise ValueError(f"mesh {n}x1 needs {n} devices, have "
                         f"{len(visible_cards())}")
    return n if n > 1 else 0


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
                   LM_NUM_PROCESSES=str(n), LM_PROCESS_ID=str(rank))
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
