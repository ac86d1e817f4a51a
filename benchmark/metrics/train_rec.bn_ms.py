"""train_rec.bn_ms: ms a step of the BatchNorm kernels in the traced window
(``live_bn.KERNELS``: forward statistics and normalisation, backward
reduction and input gradient, of the 17 live BatchNorms)."""

from benchmark import live_bn


def read(run):
    steps = run.counters.get("steps")
    if run.trace is None or not steps:
        return None
    seconds = live_bn.kernel_s(run.trace)
    return 1e3 * seconds / steps if seconds else None
