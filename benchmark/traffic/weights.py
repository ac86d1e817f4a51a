"""Seeded FCN-LectureNet weights, made on the card in a few large calls.

The state dict uses the published module names (AccessMath
FCN_lecturenet.py), which the port and the plain reference both load. The
trunk is xavier-normal with every BatchNorm off identity (random scale,
shift and running statistics), so the port's fold has work to do. The heads
add a luminance threshold to what the trunk computes:

  * ``conv_reconstruct``: xavier;
  * ``conv_text_mask_out``: xavier, BN shift +1, so sigmoid(text) sits
    between about 0.65 and 0.85 and varies with the trunk;
  * ``conv_pixels_1/2``: xavier, BN off identity;
  * ``conv_out``: xavier x ``mix`` over all its inputs, plus ``sharpness``
    on the centre tap of the three diff channels and a shift that puts the
    threshold at gray 130.

So the binaries follow the board's ink (the logits are about +-9 on ink and
board), while the trunk and every head move them by up to about 4. Made in
float32; the program casts them to the served type.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SHARPNESS = 4.0
THRESHOLD_GRAY = 130.0
MIX = 1.0
TEXT_SHIFT = 1.0


def layout(net: Dict) -> Tuple[List[Tuple[str, tuple]], List[Tuple[str, int]]]:
    """(conv and transposed-conv weights with their shapes, BatchNorms with
    their widths), in the order the generator fills them."""
    k, pk, c = net["kernel_size"], net["pixel_kernel_size"], net["in_channels"]
    down, up = net["down_filters"], net["up_filters"]
    ups = net["upsample_filters"]
    p1, p2 = net["pixel_features"]
    convs, norms = [], []

    def block(name, c_in, c_out, kk):
        convs.append((f"{name}.0", (c_out, c_in, kk, kk)))
        norms.append((f"{name}.1", c_out))

    c_in = c
    for level, width in enumerate(down, start=1):
        block(f"conv_down_block_{level}", c_in, width, k)
        c_in = width
    block("mid_block", c_in, net["mid_filters"], k)
    below = net["mid_filters"]
    for level in range(len(down), 0, -1):
        convs.append((f"transposed_conv_{level}",
                      (below, ups[level - 1], 2, 2)))
        norms.append((f"upsample_block_{level}.0", ups[level - 1]))
        block(f"conv_up_block_{level}", ups[level - 1] + down[level - 1],
              up[level - 1], k)
        below = up[level - 1]
    block("conv_reconstruct", up[0], c, k)
    block("conv_text_mask_out", up[0], 1, pk)
    block("conv_pixels_1", c + up[0], p1, pk)
    block("conv_pixels_2", c + p1, p2, pk)
    block("conv_out", c + p2, 1, pk)
    return convs, norms


def make_state(net: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The f32 state dict of the seeded model on ``device``: one normal draw
    for every weight and one uniform draw for every BatchNorm."""
    convs, norms = layout(net)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    n_w = sum(math.prod(shape) for _, shape in convs)
    n_bn = sum(width for _, width in norms)
    normal = torch.randn(n_w, generator=gen, device=device)
    uniform = torch.rand(4, n_bn, generator=gen, device=device)
    state: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, shape in convs:
        size = math.prod(shape)
        # xavier normal: fan_in + fan_out = (dim0 + dim1) * k * k for
        # Conv2d (O, I, k, k) and ConvTranspose2d (I, O, k, k) alike
        std = math.sqrt(2.0 / ((shape[0] + shape[1]) * shape[2] * shape[3]))
        state[f"{name}.weight"] = (normal[offset:offset + size].view(shape)
                                   * std)
        out = shape[1] if name.startswith("transposed") else shape[0]
        state[f"{name}.bias"] = torch.zeros(out, device=device)
        offset += size
    offset = 0
    for name, width in norms:
        u = uniform[:, offset:offset + width]
        state[f"{name}.weight"] = 0.75 + 0.5 * u[0]
        state[f"{name}.bias"] = 0.2 * (u[1] - 0.5)
        state[f"{name}.running_mean"] = 0.2 * (u[2] - 0.5)
        state[f"{name}.running_var"] = 0.75 + 0.5 * u[3]
        state[f"{name}.num_batches_tracked"] = torch.zeros(
            (), dtype=torch.long, device=device)
        offset += width

    state["conv_text_mask_out.1.bias"] += TEXT_SHIFT
    out_w = state["conv_out.0.weight"]
    out_w *= MIX
    centre = net["pixel_kernel_size"] // 2
    out_w[0, :net["in_channels"], centre, centre] += SHARPNESS
    bn = "conv_out.1"
    state[f"{bn}.weight"].fill_(1.0)
    state[f"{bn}.running_mean"].zero_()
    state[f"{bn}.running_var"].fill_(1.0 - 1e-5)
    t_norm = THRESHOLD_GRAY / 127.5 - 1.0
    state[f"{bn}.bias"].fill_(-SHARPNESS * net["in_channels"] * t_norm)
    return {key: value.contiguous() for key, value in state.items()}


def net_widths(config: Dict) -> Dict:
    """The network keys of a configuration file."""
    keys = ("in_channels", "down_filters", "mid_filters", "upsample_filters",
            "up_filters", "pixel_features", "kernel_size", "pixel_kernel_size")
    return {key: config[key] for key in keys}
