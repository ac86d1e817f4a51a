"""What every cell shares: the run's context, the measured window (traced
with ``torch.profiler`` when asked), host spans, the per-layer readers, the
checks of ``correct`` and the result line.

A cell is found by name: ``BENCHMARK.json`` names its configuration,
``workloads/<cell>.json`` its driver and traffic, ``configs/<config>.json``
its sizes, ``drivers/<driver>.py`` the entry the window drives, and
``metrics/<metric>.py`` the reader of each per-layer metric.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
# top-level modules the run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lecturemath_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def seed_for(seed: int, what: str) -> int:
    """A seed of its own for each input made from the run's ``--seed``."""
    import hashlib

    digest = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX or the
    JAX package."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Context:
    """One run of one cell."""
    cell: str
    seed: int
    seconds: float
    trace: bool
    manifest: dict
    workload: dict
    config: dict
    device: str = "cuda"
    started: float = 0.0
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    checks: List[Check] = field(default_factory=list)
    metrics: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    window_start: Optional[float] = None
    window_end: Optional[float] = None
    memory_peak: int = 0
    profile = None

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]

    @contextlib.contextmanager
    def span(self, name: str):
        """Host time in ``name`` (perf_counter, always), and a profiler
        annotation ``bench:<name>`` when tracing."""
        record = None
        if self.profile is not None:
            from torch.profiler import record_function

            record = record_function(f"bench:{name}")
            record.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)
            if record is not None:
                record.__exit__(None, None, None)

    def begin(self, name: str):
        """Open span ``name`` now; returns the function that closes it."""
        span = self.span(name)
        span.__enter__()
        return lambda: span.__exit__(None, None, None)

    @contextlib.contextmanager
    def window(self):
        """The measured window: set-up ends where it starts. Under
        ``--trace 1`` the device is traced for its whole length."""
        import torch

        cuda = self.device == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.spans.clear()
        profile = None
        if self.trace and cuda:
            from torch.profiler import ProfilerActivity, profile as _profile

            profile = _profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
            profile.__enter__()
            self.profile = profile
        self.window_start = time.perf_counter()
        try:
            yield self
        finally:
            if cuda:
                torch.cuda.synchronize()
            self.window_end = time.perf_counter()
            if profile is not None:
                profile.__exit__(None, None, None)

    @property
    def window_s(self) -> float:
        return self.window_end - self.window_start

    def read_memory_peak(self) -> None:
        """The peak of device memory so far: read before the reference
        runs, since a process's peak never falls again."""
        import torch

        if self.device == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated())

    def free(self) -> None:
        """Let go of the program's state before the reference runs."""
        import torch

        gc.collect()
        if self.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def check(self, name: str, value: float, limit_key: Optional[str] = None):
        """Compare ``value`` with the cell's limit (the workload file's
        ``limits``), recording both."""
        limit = float(self.workload["limits"][limit_key or name])
        self.checks.append(Check(name, float(value), limit))


def end_to_end_of(ctx: Context) -> List[str]:
    """The end-to-end metrics BENCHMARK.json has this cell report."""
    return [m["name"] for m in ctx.manifest["end_to_end"]
            if ctx.cell in m.get("workloads", [ctx.cell])]


def read_per_layer(ctx: Context, trace) -> Dict[str, float]:
    """Every per-layer metric of BENCHMARK.json that names this cell (or,
    without ``workloads``, moves an end-to-end metric the cell reports),
    read by ``metrics/<name>.py``; a reader that finds nothing returns
    None and the metric is left out."""
    from types import SimpleNamespace

    reported = set(end_to_end_of(ctx))
    run = SimpleNamespace(ctx=ctx, trace=trace, counters=ctx.counters,
                          spans=ctx.spans, window_s=ctx.window_s,
                          config=ctx.config, traffic=ctx.traffic)
    out = {}
    for metric in ctx.manifest["per_layer"]:
        cells = metric.get("workloads")
        if cells is not None and ctx.cell not in cells:
            continue
        if cells is None and metric["moves"] not in reported:
            continue
        path = os.path.join(HERE, "metrics", f"{metric['name']}.py")
        reader = load_module(path, f"bench_metric_{len(out)}")
        value = reader.read(run)
        if value is not None:
            out[metric["name"]] = {"value": float(value),
                                   "unit": metric["unit"]}
    return out


def make_context(cell: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", overrides: Optional[dict] = None,
                 started: Optional[float] = None) -> Context:
    """The context of one run of ``cell``: its manifest entry, workload
    file and configuration, with ``overrides`` replacing keys of the
    configuration, the traffic and the limits (tests run tiny sizes on the
    CPU)."""
    manifest = load_json(ROOT, "BENCHMARK.json")
    entry = next(w for w in manifest["workloads"] if w["name"] == cell)
    workload = load_json(HERE, "workloads", f"{entry['traffic']}.json")
    config_entry = next(c for c in manifest["configs"]
                        if c["name"] == entry["config"])
    config = load_json(ROOT, config_entry["file"])
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    workload = dict(workload, traffic=dict(workload["traffic"],
                                           **overrides.get("traffic", {})),
                    limits=dict(workload["limits"],
                                **overrides.get("limits", {})))
    return Context(cell, int(seed), float(seconds), bool(trace), manifest,
                   workload, config, device=device,
                   started=started if started is not None
                   else time.perf_counter())


def execute(cell: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", overrides: Optional[dict] = None,
            started: Optional[float] = None) -> dict:
    """Run ``cell`` once and return the result line's object (with the
    checks under ``checks``, last)."""
    ctx = make_context(cell, seed, seconds, trace, device, overrides, started)
    manifest, workload = ctx.manifest, ctx.workload
    entry = next(w for w in manifest["workloads"] if w["name"] == cell)
    driver = load_module(os.path.join(HERE, "drivers",
                                      f"{workload['driver']}.py"),
                         f"bench_driver_{workload['driver']}")
    driver.run(ctx, **(overrides or {}).get("driver", {}))
    setup_s = ctx.window_start - ctx.started
    result = {"correct": all(c.ok for c in ctx.checks) and bool(ctx.checks),
              "attempted": ctx.attempted, "failed": ctx.failed}
    from . import trace as tracing

    view = tracing.TraceView(ctx) if (trace and ctx.profile is not None) \
        else None
    if trace:
        result["metrics"] = read_per_layer(ctx, view)
    else:
        # the cell's end-to-end metrics (a driver may work out more)
        units = {m["name"]: m["unit"] for m in manifest["end_to_end"]}
        values = dict(ctx.metrics, setup_s=setup_s)
        result["metrics"] = {name: {"value": float(values[name]),
                                    "unit": units[name]}
                             for name in end_to_end_of(ctx)}
    info = {"platform": "gpu" if device == "cuda" else "cpu",
            "kind": _device_name(device), "count": int(entry["chips"]),
            "memory_peak_bytes": ctx.memory_peak}
    if view is not None:
        info["busy_s"] = view.busy_s
        info["window_s"] = view.window_s
        result["breakdown"] = view.breakdown()
    result["device"] = info
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in ctx.checks}
    return result


def _device_name(device: str) -> str:
    import torch

    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
