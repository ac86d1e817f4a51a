"""Contrast-Limited Adaptive Histogram Equalization in PyTorch, on the
caller's device (the card unless the caller asks for the CPU).

Replaces the reference's C kernel (reference: accessmath_lib.c:113-329,
tools/adaptive_equalizer.py:273-291): per-grid-cell histograms (one
``bincount`` over ``cell * 256 + tone``), contrast-limited CDFs (a 255-step
loop vectorised over every cell of every frame), and per-pixel bilinear
interpolation between the four surrounding cell CDFs (one gather), in
float32. Tile boundaries, the interpolation weights and the rounding with
its unsigned-char wrap are the C kernel's.

The contrast limit follows the C recurrence, which ``clahe_host`` runs:
after a bin is clipped, the next difference is taken from the clipped
value. The JAX package's device ``clahe`` takes it from the unclipped one
and so differs from its own ``clahe_host`` by several gray levels on most
pixels of board-like frames, where bins clip; this port does not copy
that. In f32 the result sits at most one gray level from ``clahe_host``,
on a small share of the pixels (f32 against f64 rounding at a .5 step).

``clahe_host`` (float64 numpy, bit-exact with the C kernel) and its helpers
are the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import as_tensor


def _tile_limits(extent: int, cells: int) -> Tuple[np.ndarray, np.ndarray]:
    """Cell boundaries along one axis: the remainder pixels go to the first
    cells; centers are round((start + end) / 2) (accessmath_lib.c:190-200)."""
    base = extent // cells
    remainder = extent % cells
    sizes = np.full(cells, base, dtype=np.int64)
    sizes[:remainder] += 1
    ends = np.cumsum(sizes) - 1
    starts = ends - sizes + 1
    centers = np.floor((starts + ends) / 2.0 + 0.5).astype(np.int64)
    return ends, centers


def _axis_interp(extent: int, centers: np.ndarray):
    """Per-pixel (k0, k1, weight) for interpolation between cell centers,
    with single-cell clamping at the borders (C semantics)."""
    cells = len(centers)
    pos = np.arange(extent)
    if cells == 1:
        return (np.zeros(extent, np.int64), np.zeros(extent, np.int64),
                np.zeros(extent))
    k0 = np.clip(np.searchsorted(centers, pos, side="left") - 1, 0, cells - 2)
    k1 = k0 + 1
    weight = (pos - centers[k0]) / (centers[k1] - centers[k0])
    weight = np.clip(weight, 0.0, 1.0)
    return k0, k1, weight


def clahe_batch(grayscale: Union[np.ndarray, torch.Tensor],
                slope: float = 0.04, grid_x: int = 8, grid_y: int = 8,
                device: Optional[Union[str, torch.device]] = None
                ) -> torch.Tensor:
    """CLAHE of uint8 [B, H, W] -> uint8 [B, H, W] on the tensor's device
    (an array goes to ``device``, the card by default)."""
    gray = as_tensor(grayscale, device)
    if gray.dtype != torch.uint8 or gray.dim() != 3:
        raise ValueError(f"expected uint8 [B, H, W], got {gray.dtype} "
                         f"{tuple(gray.shape)}")
    dev = gray.device
    batch, height, width = gray.shape
    y_ends, y_centers = _tile_limits(height, grid_y)
    x_ends, x_centers = _tile_limits(width, grid_x)
    row_cell = np.searchsorted(y_ends, np.arange(height), side="left")
    col_cell = np.searchsorted(x_ends, np.arange(width), side="left")
    cell_ids = torch.from_numpy(row_cell[:, None] * grid_x
                                + col_cell[None, :]).to(dev)

    n_cells = grid_x * grid_y
    tones = gray.long()
    frame_base = (torch.arange(batch, device=dev) * n_cells)[:, None, None]
    flat = ((frame_base + cell_ids) * 256 + tones).reshape(-1)
    # integer counts, exact in f32 (a cell holds far fewer than 2^24 pixels)
    hist = torch.bincount(flat, minlength=batch * n_cells * 256).to(
        torch.float32).reshape(batch * n_cells, 256)

    # normalized CDF per cell, bins on the leading axis: cdf[i] is one row
    cdf = torch.cumsum(hist, dim=1)
    cdf = (cdf / cdf[:, -1:]).T.contiguous()

    if slope > 0.0:
        # contrast limit, sequential over bins and vectorised over cells
        # (accessmath_lib.c:152-170): each difference from the clipped bin
        dh = torch.zeros(batch * n_cells, dtype=torch.float32, device=dev)
        for i in range(255):
            diff = cdf[i + 1] - cdf[i] - dh - slope
            dh = dh + torch.clamp_min(diff, 0.0)
            cdf[i + 1] -= dh
        cdf += (1.0 - (cdf[255] - cdf[0])) / 2.0

    # [B, gy, gx, 256] flattened: the table of every (frame, cell, tone)
    table = cdf.T.contiguous().reshape(-1)

    y0, y1, wy = _axis_interp(height, y_centers)
    x0, x1, wx = _axis_interp(width, x_centers)

    def rows(cells):
        return torch.from_numpy(cells * grid_x)[:, None].to(dev)

    def cols(cells):
        return torch.from_numpy(cells)[None, :].to(dev)

    wy = torch.from_numpy(wy.astype(np.float32))[:, None].to(dev)
    wx = torch.from_numpy(wx.astype(np.float32))[None, :].to(dev)
    frame_cells = frame_base * 256

    def lookup(row_cells, col_cells):
        cell = (rows(row_cells) + cols(col_cells)) * 256
        return table[frame_cells + cell + tones]

    d00 = lookup(y0, x0)
    d01 = lookup(y1, x0)
    d10 = lookup(y0, x1)
    d11 = lookup(y1, x1)
    value = (d00 * (1 - wx) * (1 - wy) + d01 * (1 - wx) * wy +
             d10 * wx * (1 - wy) + d11 * wx * wy)

    # C round() (half away from zero on non-negative values), then the
    # unsigned-char wrap: the centering offset can push the CDF past 1.0
    # (255.4 -> 256 -> 0)
    rounded = torch.floor(value * 255.0 + 0.5).to(torch.int32)
    return torch.remainder(rounded, 256).to(torch.uint8)


def clahe(grayscale: Union[np.ndarray, torch.Tensor], slope: float = 0.04,
          grid_x: int = 8, grid_y: int = 8,
          device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """CLAHE of one uint8 [H, W] image -> uint8 [H, W]."""
    gray = as_tensor(grayscale, device)
    return clahe_batch(gray[None], slope, grid_x, grid_y)[0]


def clahe_host(grayscale: np.ndarray, slope: float = 0.04, grid_x: int = 8,
               grid_y: int = 8) -> np.ndarray:
    """Float64 host CLAHE, bit-exact with the reference C kernel (the
    device path above is float32 and may differ by one gray level on a
    small share of the pixels — harmless downstream, but this variant
    exists for exact-parity use)."""
    height, width = grayscale.shape
    y_ends, y_centers = _tile_limits(height, grid_y)
    x_ends, x_centers = _tile_limits(width, grid_x)

    row_cell = np.searchsorted(y_ends, np.arange(height), side="left")
    col_cell = np.searchsorted(x_ends, np.arange(width), side="left")
    cell_ids = row_cell[:, None] * grid_x + col_cell[None, :]

    tones = grayscale.astype(np.int64)
    n_cells = grid_x * grid_y
    flat = cell_ids.reshape(-1) * 256 + tones.reshape(-1)
    hist = np.bincount(flat, minlength=n_cells * 256).reshape(n_cells, 256)

    cdf = np.cumsum(hist, axis=1).astype(np.float64)
    cdf = cdf / cdf[:, -1:]

    if slope > 0.0:
        dh = np.zeros(n_cells)
        for i in range(255):
            diff = cdf[:, i + 1] - cdf[:, i] - dh - slope
            dh = dh + np.maximum(diff, 0.0)
            cdf[:, i + 1] -= dh
        cdf += ((1.0 - (cdf[:, 255] - cdf[:, 0])) / 2.0)[:, None]

    cdf = cdf.reshape(grid_y, grid_x, 256)

    y0, y1, wy = _axis_interp(height, y_centers)
    x0, x1, wx = _axis_interp(width, x_centers)
    y0 = y0[:, None]
    y1 = y1[:, None]
    wy = wy[:, None]
    x0 = x0[None, :]
    x1 = x1[None, :]
    wx = wx[None, :]

    value = (cdf[y0, x0, tones] * (1 - wx) * (1 - wy) +
             cdf[y1, x0, tones] * (1 - wx) * wy +
             cdf[y0, x1, tones] * wx * (1 - wy) +
             cdf[y1, x1, tones] * wx * wy)

    # C round() + unsigned-char wraparound past 255 (see device path note)
    return (np.floor(value * 255.0 + 0.5).astype(np.int64) % 256).astype(np.uint8)


def combine_board_content(only_board: Union[np.ndarray, torch.Tensor],
                          equalized: Union[np.ndarray, torch.Tensor],
                          threshold: int = 128,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> torch.Tensor:
    """Fuse a board mask with the equalized grayscale: content is where the
    board mask is off and the equalized value is dark
    (reference: accessmath_lib.c:331-354 combine_results). Tensors stay on
    their device; arrays go to ``device`` (None: the card)."""
    only_board = as_tensor(only_board, device)
    equalized = as_tensor(equalized, device).to(only_board.device)
    content = torch.where(equalized < threshold, 255, 0)
    return torch.where(only_board > 128, 0, content).to(torch.uint8)
