"""Frame-difference motion statistics (speaker localization), in PyTorch on
the caller's device (the card unless the caller asks for the CPU).

Equivalent of the reference's C kernel ``speaker_detection_handle_frame``
(reference: accessmath_lib.c:7-111): on a subsampled pixel grid, a pixel
"changed" when any color channel moved more than a threshold; outputs the
changed-pixel bounding box, centroid, per-axis standard deviation, and
total count. The count and the bounding box are computed in integers and
are exact; the centroid and deviations are float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..core.device import as_tensor


class MotionStats(NamedTuple):
    total_changes: torch.Tensor     # int32 scalar
    bbox: torch.Tensor              # float32 [4] = min_x, max_x, min_y, max_y
    centroid: torch.Tensor          # float32 [2] = mean_x, mean_y
    deviation: torch.Tensor         # float32 [2] = std_x, std_y


def motion_stats(frame: Union[np.ndarray, torch.Tensor],
                 last_frame: Union[np.ndarray, torch.Tensor],
                 threshold: int = 15, jump_cells: int = 1,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> MotionStats:
    """frame/last_frame: uint8 [H, W, C], tensors on one device or arrays
    (which go to ``device``, the card by default)."""
    frame = as_tensor(frame, device)
    last_frame = as_tensor(last_frame, device).to(frame.device)
    dev = frame.device
    height, width = frame.shape[:2]
    sub_f = frame[::jump_cells, ::jump_cells].to(torch.int32)
    sub_l = last_frame[::jump_cells, ::jump_cells].to(torch.int32)

    changed = torch.any(torch.abs(sub_l - sub_f) > threshold, dim=-1)

    rows = (torch.arange(changed.shape[0], dtype=torch.int32, device=dev)
            * jump_cells)[:, None].expand(changed.shape)
    cols = (torch.arange(changed.shape[1], dtype=torch.int32, device=dev)
            * jump_cells)[None, :].expand(changed.shape)

    total = changed.sum(dtype=torch.int32)
    any_changed = total > 0

    big = 10 ** 9
    min_x = torch.where(any_changed, torch.where(changed, cols, big).min(),
                        width + 1)
    max_x = torch.where(any_changed, torch.where(changed, cols, -big).max(),
                        -1)
    min_y = torch.where(any_changed, torch.where(changed, rows, big).min(),
                        height + 1)
    max_y = torch.where(any_changed, torch.where(changed, rows, -big).max(),
                        -1)

    denom = torch.clamp_min(total, 1).to(torch.float32)
    # integer sums are exact; each rounds once to f32, as the JAX int32 sums
    mean_x = torch.where(changed, cols, 0).sum().to(torch.float32) / denom
    mean_y = torch.where(changed, rows, 0).sum().to(torch.float32) / denom

    var_x = torch.where(changed, torch.square(cols.to(torch.float32)
                                              - mean_x), 0.0).sum() / denom
    var_y = torch.where(changed, torch.square(rows.to(torch.float32)
                                              - mean_y), 0.0).sum() / denom

    zero = torch.zeros(2, dtype=torch.float32, device=dev)
    return MotionStats(
        total_changes=total,
        bbox=torch.stack([min_x, max_x, min_y, max_y]).to(torch.float32),
        centroid=torch.where(any_changed, torch.stack([mean_x, mean_y]),
                             zero),
        deviation=torch.where(any_changed,
                              torch.stack([torch.sqrt(var_x),
                                           torch.sqrt(var_y)]), zero),
    )
