"""train_rec.bn_roofline: the live BatchNorm's least time at the HBM peak
(``live_bn.live_bn_bytes``: each BatchNorm's float32 activations read or
written once, 2 passes forward and 3 backward, every step of the window)
over its kernels' time in the trace (%)."""

from benchmark import count, live_bn
from benchmark.traffic.weights import net_widths


def read(run):
    steps = run.counters.get("steps")
    if run.trace is None or not steps:
        return None
    seconds = live_bn.kernel_s(run.trace)
    if not seconds:
        return None
    cfg = run.config
    height, width = cfg["crop_size"]
    least = steps * live_bn.live_bn_bytes(net_widths(cfg), cfg["batch_size"],
                                          height, width) / count.PEAK_BYTES
    return 100.0 * least / seconds
