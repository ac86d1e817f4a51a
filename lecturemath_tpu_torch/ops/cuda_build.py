"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at first
use with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``csrc/build/lib<name>.so`` (rebuilt when the source, or a ``csrc`` header
it includes, is newer), then loaded with ``ctypes``. Nothing is compiled
when a module is imported, and a failed build raises: there is no other
path for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Sequence

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
SOURCES = ("threshold_pack", "conv7", "cc_label")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc, from the CUDA toolkit PyTorch itself resolves."""
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "lecturemath_tpu_torch need the CUDA toolkit "
                           "(set CUDA_HOME)")
    return path


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources_of(name: str) -> List[str]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes with
    ``#include "..."``, directly or through another such header."""
    paths = [os.path.join(CSRC_DIR, f"{name}.cu")]
    for path in paths:
        with open(path) as f:
            for header in _INCLUDE.findall(f.read()):
                header = os.path.join(os.path.dirname(path), header)
                if os.path.exists(header) and header not in paths:
                    paths.append(header)
    return paths


def _stale(name: str) -> bool:
    """No library yet, or one older than its source or a header of it."""
    lib = library_path(name)
    return (not os.path.exists(lib) or os.path.getmtime(lib) < max(
        os.path.getmtime(path) for path in sources_of(name)))


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale library among ``names``: one nvcc per source, all
    started together. Returns {name: compiler output} for the ones built
    (ptxas register and shared-memory report included)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in names:
        if not _stale(name):
            continue
        # build under a private name and rename: a concurrent loader never
        # sees a half-written library
        tmp = f"{library_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, time.perf_counter())
    logs = {}
    failed = []
    for name, (proc, tmp, t0) in jobs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{output}")
            continue
        os.replace(tmp, library_path(name))
        logs[name] = f"built in {time.perf_counter() - t0:.1f} s\n{output}"
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build (if stale) and load ``lib<name>.so``; ``signatures`` maps each C
    function to (restype, [argtypes])."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            for fn_name, (restype, argtypes) in signatures.items():
                fn = getattr(lib, fn_name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            _libs[name] = lib
        return lib


def check(code: int, kernel: str) -> None:
    """Raise on the CUDA error code a C launcher returned."""
    if code != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {code}")
