"""Per-stage wall-clock accounting (reference: AM_CommonTools/util/time_helper.py)
plus optional torch profiler trace capture."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._starts: Dict[str, float] = {}

    def start(self, name: str = "total") -> None:
        self._starts[name] = time.perf_counter()

    def stop(self, name: str = "total") -> float:
        elapsed = time.perf_counter() - self._starts.pop(name)
        self.totals[name] = self.totals.get(name, 0.0) + elapsed
        self.counts[name] = self.counts.get(name, 0) + 1
        return elapsed

    @contextlib.contextmanager
    def measure(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def report(self) -> str:
        lines = []
        for name in self.totals:
            lines.append(f"{name}: {seconds_to_str(self.totals[name])}"
                         f" ({self.counts[name]} calls)")
        return "\n".join(lines)


def seconds_to_str(total_seconds: float) -> str:
    hours, rem = divmod(total_seconds, 3600.0)
    minutes, seconds = divmod(rem, 60.0)
    return f"{int(hours):d}:{int(minutes):02d}:{seconds:06.3f}"


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str]):
    """Capture a torch profiler trace (host ops and, when a card is present,
    its kernels) into ``log_dir/trace.json`` when a log dir is given, else
    no-op."""
    if log_dir is None:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
