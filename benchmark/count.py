"""Operations and bytes of FCN-LectureNet from its widths and shapes, and the
published peaks of the card: the yardstick of every roofline and mfu metric.

Counts are multiply-adds times two of the convolutions and transposed
convolutions, as the published architecture defines them (AccessMath
FCN_lecturenet.py); BatchNorm, GELU, pooling and the crop are not counted.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA's H100 SXM data sheet, dense: FLOP/s by the precision the tensor
# cores (or, for fp32, the CUDA cores) run in, and HBM3 bytes/s
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
              "fp32": 67e12, "fp8": 1979e12}
PEAK_BYTES = 3.35e12


def _conv(c_in: int, c_out: int, k: int, scale: int) -> float:
    """FLOP an input pixel of a k x k SAME conv on a map ``scale`` times
    smaller on each side."""
    return 2.0 * c_in * c_out * k * k / (scale * scale)


def trunk_flops_per_pixel(net: Dict) -> float:
    """The encoder, the decoder and the reconstruction head, per pixel of
    the (padded) input."""
    k = net["kernel_size"]
    down, up = net["down_filters"], net["up_filters"]
    ups = net["upsample_filters"]
    total, c_in = 0.0, net["in_channels"]
    for level, width in enumerate(down):
        total += _conv(c_in, width, k, 2 ** level)
        c_in = width
    total += _conv(c_in, net["mid_filters"], k, 2 ** len(down))
    below = net["mid_filters"]
    for level in range(len(down), 0, -1):
        scale = 2 ** (level - 1)
        # 2x2 stride-2 transposed conv: one tap an output pixel
        total += 2.0 * below * ups[level - 1] / (scale * scale)
        total += _conv(ups[level - 1] + down[level - 1], up[level - 1], k,
                       scale)
        below = up[level - 1]
    total += _conv(up[0], net["in_channels"], k, 1)
    return total


def head_flops_per_pixel(net: Dict) -> Dict[str, float]:
    """The four pixel_k head convs (kernel K2), per pixel, by head."""
    pk, c = net["pixel_kernel_size"], net["in_channels"]
    up1 = net["up_filters"][0]
    p1, p2 = net["pixel_features"]
    return {"conv_text_mask_out": _conv(up1, 1, pk, 1),
            "conv_pixels_1": _conv(c + up1, p1, pk, 1),
            "conv_pixels_2": _conv(c + p1, p2, pk, 1),
            "conv_out": _conv(c + p2, 1, pk, 1)}


def padded(size: int, multiple: int = 32) -> int:
    return -(-size // multiple) * multiple


def forward_flops(net: Dict, height: int, width: int) -> float:
    """One frame's forward at the padded size the network runs."""
    pixels = padded(height) * padded(width)
    return pixels * (trunk_flops_per_pixel(net)
                     + sum(head_flops_per_pixel(net).values()))


def heads_flops(net: Dict, height: int, width: int) -> float:
    """K2's operations for one frame: the four heads at the padded size."""
    return padded(height) * padded(width) * sum(
        head_flops_per_pixel(net).values())


def train_step_flops(net: Dict, batch: int, height: int, width: int) -> float:
    """A training step: the forward, and a backward of twice its operations
    (the input and the weight gradient of every conv), every layer
    training."""
    return 3.0 * batch * forward_flops(net, height, width)


def k1_bytes(frames: int, height: int, width: int) -> float:
    """K1 reads each f32 logit of the frame once and writes its packed bit
    map, ceil(width / 8) bytes a row."""
    return frames * height * (4.0 * width + -(-width // 8))
