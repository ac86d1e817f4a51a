"""Tiled connected-component labeling; kernel K3 on the card.

The counterpart of ``lecturemath_tpu/ops/cc_label_pallas.py``. For a CUDA
tensor ``label_components_tiled`` launches K3 (``csrc/cc_label.cu``, through
``ops/cc_label.label_components_batch``), which uses its own 32x32 block
tiles whatever ``tile`` says. For a CPU tensor it runs the plain
``label_components_plain`` to its fixed point.

Either way the result is the fixed point of ``label_components``: 0 for
background, the component's minimum linear index + 1 (the frame's own
width, never a padded one), so the tile never shows in the output.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .cc_label import Binary, Device, as_device_tensor, label_components_batch


def _check_tile(tile) -> Tuple[int, int]:
    try:
        tile_h, tile_w = (int(t) for t in tile)
    except (TypeError, ValueError):
        raise ValueError(f"tile must be (height, width), got {tile!r}") \
            from None
    if tile_h <= 0 or tile_w <= 0:
        raise ValueError(f"tile sides must be positive, got {tile!r}")
    return tile_h, tile_w


def label_components_tiled(binary: Binary, tile: Tuple[int, int] = (256, 256),
                           device: Device = None) -> torch.Tensor:
    """Label one [H, W] frame (nonzero = foreground) on its device: int32
    [H, W], 0 for background, root linear index + 1. ``tile`` is validated
    only: the result does not depend on it."""
    _check_tile(tile)
    binary = as_device_tensor(binary, device)
    if binary.dim() != 2:
        raise ValueError(f"label_components_tiled: binary must be [H, W], "
                         f"got {tuple(binary.shape)}")
    h, w = binary.shape
    # after k rounds each pixel holds at most the least index within k steps
    # of it, so H*W rounds reach the fixed point (the loop stops there)
    return label_components_batch(binary.unsqueeze(0).contiguous(),
                                  max_iters=h * w)[0]
