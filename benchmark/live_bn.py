"""FCN-LectureNet's live BatchNorm in a training step: its least bytes, from
the widths and shapes (the yardstick of the ``bn_roofline`` metrics), and
its kernels' time in a traced window, by name.

The least bytes read each float32 activation a BatchNorm reads once and
write each it writes once, whatever the kernels read again: forward the
input read and the output written (2 passes), backward the input and the
output's gradient read and the input's gradient written (3 passes). Its
per-channel vectors are left out. A kernel that makes two passes over the
input forward and over both tensors backward moves 8/5 of these bytes, so
its share is at most 62.5%.
"""

from __future__ import annotations

from typing import Dict

FORWARD_PASSES = 2
BACKWARD_PASSES = 3
FLOAT32 = 4
# parts of the names of the kernels that run BatchNorm in training: cuDNN's
# channels_last float32 kernels, forward and backward, the only ones of the
# 17 live BatchNorms in a traced H100 run (torch 2.11, cuDNN in CUDA 12.8)
KERNELS = ("batchnorm_fwtr", "batchnorm_bwtr")


def bn_elements_per_pixel(net: Dict) -> float:
    """Elements of every BatchNorm's activation in reconstruction mode, per
    pixel of the input: the down blocks, the middle block, the up blocks'
    upsample and conv BatchNorms and the reconstruction head's."""
    down, up = net["down_filters"], net["up_filters"]
    ups = net["upsample_filters"]
    total = 0.0
    for level, width in enumerate(down, start=1):
        scale = 4.0 ** (level - 1)
        total += (width + ups[level - 1] + up[level - 1]) / scale
    total += net["mid_filters"] / 4.0 ** len(down)
    return total + net["in_channels"]


def live_bn_bytes(net: Dict, batch: int, height: int, width: int) -> float:
    """A training step's least BatchNorm bytes at ``batch`` images of
    height x width (multiples of 32)."""
    elements = batch * height * width * bn_elements_per_pixel(net)
    return (FORWARD_PASSES + BACKWARD_PASSES) * FLOAT32 * elements


def kernel_s(trace) -> float:
    """The seconds of the traced window's BatchNorm kernels (each kernel
    whose name holds one of ``KERNELS``, counted once)."""
    return sum(end - start for start, end, cat, name, _ in trace.device
               if cat == "kernel" and any(k in name for k in KERNELS)) / 1e6
