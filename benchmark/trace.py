"""The device's side of a traced window, read from ``torch.profiler``'s
trace: kernel, copy and memset spans, the host's ``bench:*`` annotations,
the device's busy time, and the kernels of the program by name."""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
K2_NAME = "conv_igemm_kernel"
K1_NAME = "threshold_pack_kernel"


class TraceView:
    """Spans of the window's trace in microseconds of the trace's clock."""

    def __init__(self, ctx):
        self.ctx = ctx
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            ctx.profile.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        spans = [ev for ev in events if ev.get("ph") == "X"]
        self.device = sorted(
            (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev["cat"],
             ev["name"], ev.get("args", {}))
            for ev in spans if ev.get("cat") in DEVICE_CATS)
        self.host = sorted(
            (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
             ev["name"][len("bench:"):])
            for ev in spans if ev.get("cat") == "user_annotation"
            and ev.get("name", "").startswith("bench:"))
        self.window_s = ctx.window_s
        busy, end = 0.0, float("-inf")
        for start, stop, *_ in self.device:
            busy += max(0.0, stop - max(start, end))
            end = max(end, stop)
        self.busy_s = busy / 1e6

    def kernels(self, name: str) -> List[Tuple[float, float, dict]]:
        """(start, end, args) of every kernel whose name holds ``name``."""
        return [(s, e, a) for s, e, cat, n, a in self.device
                if cat == "kernel" and name in n]

    def kernel_s(self, name: str) -> float:
        return sum(e - s for s, e, _ in self.kernels(name)) / 1e6

    def grid_frames(self, name: str):
        """The sum of the grid's z over a kernel's launches (K2 puts its
        ``batch * groups`` blocks on z, and each head is one group), or None
        where the trace has no grid for a launch."""
        launches = self.kernels(name)
        if not launches or any("grid" not in a for _, _, a in launches):
            return None
        return float(sum(a["grid"][2] for _, _, a in launches))

    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.window_s)

    def _host_at(self, t: float) -> str:
        label = "outside the benchmark's host spans"
        for start, stop, name in self.host:
            if start <= t <= stop:
                label = name  # the innermost (latest-starting) wins
        return label

    def breakdown(self) -> Dict[str, list]:
        """The 10 device operations that took most time, and the device's
        idle time summed by what the host was doing (the ``bench:`` span
        open at each gap's middle), the 10 largest."""
        ops: Dict[str, float] = {}
        for start, stop, _, name, _ in self.device:
            ops[name[:96]] = ops.get(name[:96], 0.0) + (stop - start) / 1e6
        gaps: Dict[str, float] = {}
        end = None
        for start, stop, *_ in self.device:
            if end is not None and start > end:
                label = self._host_at((start + end) / 2)
                gaps[label] = gaps.get(label, 0.0) + (start - end) / 1e6
            end = stop if end is None else max(end, stop)
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}
