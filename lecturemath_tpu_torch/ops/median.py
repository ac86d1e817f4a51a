"""The exact median of uint8 crops (``cv2.medianBlur``); kernel K4 on the card.

The contract of ``native.median_u8``, on a batch: for uint8 [B, H, W, C]
and an odd window k from 3 to 255, the value of rank k*k / 2 in each k x k
window, each channel on its own, rows and columns past the crop's edge
replicated.

For a CUDA tensor ``median_u8_batch`` launches ``csrc/median.cu`` (Huang's
sliding histogram, a thread down a column strip). For a CPU tensor it runs
the plain version, ``native.median_u8`` an image at a time, which the tests
hold K4 to byte for byte. ``median_unit_batch`` is the training data's
route (``train/dataset.py``): the same medians as float32 m / 127.5 - 1,
which K4 writes itself, from crops that kernel K5 left on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import native
from . import cuda_build

_SIGNATURES = {
    "lm_median_u8": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
}


def median_u8_plain(crops: torch.Tensor, ksize: int) -> torch.Tensor:
    """``native.median_u8`` of each image of a CPU uint8 [B, H, W, C]
    tensor."""
    out = np.empty(tuple(crops.shape), np.uint8)
    for index, image in enumerate(crops.numpy()):
        out[index] = native.median_u8(image, ksize)
    return torch.from_numpy(out)


def median_u8_batch(crops: torch.Tensor, ksize: int) -> torch.Tensor:
    """The k x k median of each crop of a contiguous uint8 [B, H, W, C]
    tensor, on its device: kernel K4 for a CUDA tensor, launched on the
    current stream; ``median_u8_plain`` for a CPU one."""
    return _median(crops, ksize, torch.uint8)


def median_unit_batch(crops: torch.Tensor, ksize: int) -> torch.Tensor:
    """``median_u8_batch`` as float32 m / 127.5 - 1, rounded as numpy's
    float32 rounds it: the training data's median targets. K4 writes them
    for a CUDA tensor."""
    return _median(crops, ksize, torch.float32)


def _median(crops: torch.Tensor, ksize: int, dtype: torch.dtype):
    if not isinstance(crops, torch.Tensor):
        raise TypeError(f"median_u8_batch: crops must be a tensor, got "
                        f"{type(crops).__name__}")
    if crops.dim() != 4:
        raise ValueError(f"median_u8_batch: crops must be [B, H, W, C], got "
                         f"{tuple(crops.shape)}")
    if crops.dtype != torch.uint8:
        raise TypeError(f"median_u8_batch: crops must be uint8, got "
                        f"{crops.dtype}")
    if not crops.is_contiguous():
        raise ValueError("median_u8_batch: crops must be contiguous")
    if (not isinstance(ksize, (int, np.integer)) or ksize % 2 == 0
            or not 1 < ksize < 256):
        raise ValueError(f"median_u8_batch: ksize must be odd and in "
                         f"3..255, got {ksize!r}")
    if crops.device.type == "cpu":
        median = median_u8_plain(crops, ksize)
        if dtype == torch.uint8:
            return median
        return torch.from_numpy(median.numpy().astype(np.float32) / 127.5
                                - 1.0)
    if crops.device.type != "cuda":
        raise ValueError(f"median_u8_batch: unsupported device "
                         f"{crops.device}")
    batch, height, width, channels = crops.shape
    if height * width * channels >= 2 ** 31:
        raise ValueError(f"median_u8_batch: a crop of {height}x{width}x"
                         f"{channels} bytes is too large")
    out = torch.empty(crops.shape, dtype=dtype, device=crops.device)
    if out.numel() == 0:
        return out
    unit = dtype == torch.float32
    lib = cuda_build.load("median", _SIGNATURES)
    with torch.cuda.device(crops.device):
        code = lib.lm_median_u8(
            crops.data_ptr(), None if unit else out.data_ptr(),
            out.data_ptr() if unit else None, batch, height, width,
            channels, int(ksize),
            torch.cuda.current_stream(crops.device).cuda_stream)
    cuda_build.check(code, "median")
    median_u8_batch.launches += 1
    return out


median_u8_batch.launches = 0
