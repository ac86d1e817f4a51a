"""Arithmetic the per-layer readers (``metrics/<name>.py``) share. A reader
gets ``run``: the cell's counters and host spans, the window's length, the
configuration, and ``trace`` (``trace.TraceView``, None when the run was not
traced). Each returns None where it finds nothing to read."""

from __future__ import annotations

from benchmark import count
from benchmark.trace import K1_NAME, K2_NAME
from benchmark.traffic.weights import net_widths


def per_frame_ms(run, seconds: float):
    frames = run.counters.get("frames")
    return None if not frames else 1e3 * seconds / frames


def span_ms_per_frame(run, span: str):
    if span not in run.spans:
        return None
    return per_frame_ms(run, sum(run.spans[span]))


def span_ms_mean(run, span: str):
    """The mean length of a host span, in ms."""
    spans = run.spans.get(span)
    return 1e3 * sum(spans) / len(spans) if spans else None


def counter_ms_per_frame(run, key: str):
    if key not in run.counters:
        return None
    return per_frame_ms(run, run.counters[key])


def stream_mfu(run):
    """Frames completed times one frame's forward operations, over the
    wall of the passes that made them, over the bf16 peak, in %."""
    frames, wall = run.counters.get("frames"), run.counters.get("wall_s")
    if not frames or not wall:
        return None
    cfg = run.config
    flops = frames * count.forward_flops(net_widths(cfg), cfg["frame_height"],
                                         cfg["frame_width"])
    return 100.0 * flops / wall / count.PEAK_FLOPS[cfg["precision"]]


def k2_roofline(run, height: int, width: int):
    """K2's least time at the bf16 peak (its operations: the four heads
    over every frame its launches covered, at the padded size) over its
    time in the trace, in %."""
    trace = run.trace
    if trace is None or not trace.kernels(K2_NAME):
        return None
    launched = trace.grid_frames(K2_NAME)
    if launched is None:
        return None
    flops = launched / 4.0 * count.heads_flops(net_widths(run.config),
                                               height, width)
    return 100.0 * flops / count.PEAK_FLOPS["bf16"] / trace.kernel_s(K2_NAME)


def k1_roofline(run, height: int, width: int):
    """K1's least time at the HBM peak (each f32 logit of the crop read
    once, the packed bits written once, over every frame of its launches)
    over its time in the trace, in %."""
    trace = run.trace
    batch = run.counters.get("batch")
    if trace is None or not batch or not trace.kernels(K1_NAME):
        return None
    frames = len(trace.kernels(K1_NAME)) * batch
    return (100.0 * count.k1_bytes(frames, height, width) / count.PEAK_BYTES
            / trace.kernel_s(K1_NAME))


def device_idle(run):
    """The share of the traced window in which no kernel, copy or memset
    ran, in %."""
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * run.trace.idle_share()


def train_peak(run) -> float:
    """The peak of the precision the training convs run in: TF32 where
    cuDNN may use it (PyTorch's default), else float32."""
    cfg = run.config
    if cfg["precision"] == "fp32":
        return count.PEAK_FLOPS["tf32" if run.counters.get("tf32") else "fp32"]
    return count.PEAK_FLOPS[cfg["precision"]]


def train_mfu(run):
    """The steps' operations (forward and backward of every layer) over the
    epochs' wall, over the peak the convs run at, in %."""
    steps, wall = run.counters.get("steps"), run.counters.get("wall_s")
    if not steps or not wall:
        return None
    height, width = run.config["crop_size"]
    flops = steps * count.train_step_flops(
        net_widths(run.config), run.config["batch_size"], height, width)
    return 100.0 * flops / wall / train_peak(run)
