"""The exact median of uint8 crops (``cv2.medianBlur``); kernel K4 on the card.

The contract of ``native.median_u8``, on a batch: for uint8 [B, H, W, C]
and an odd window k from 3 to 255, the value of rank k*k / 2 in each k x k
window, each channel on its own, rows and columns past the crop's edge
replicated.

For a CUDA tensor ``median_u8_batch`` launches ``csrc/median.cu`` (Huang's
sliding histogram, a thread down a column strip). For a CPU tensor it runs
the plain version, ``native.median_u8`` an image at a time, which the tests
hold K4 to byte for byte. ``median_u8_pinned`` is the training data's route
to K4 from host crops (``train/dataset.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import numpy as np
import torch

from .. import native
from . import cuda_build

_SIGNATURES = {
    "lm_median_u8": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}

_side_streams: Dict[int, torch.cuda.Stream] = {}


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
        return median_u8_plain(crops, ksize)
    if crops.device.type != "cuda":
        raise ValueError(f"median_u8_batch: unsupported device "
                         f"{crops.device}")
    batch, height, width, channels = crops.shape
    if height * width * channels >= 2 ** 31:
        raise ValueError(f"median_u8_batch: a crop of {height}x{width}x"
                         f"{channels} bytes is too large")
    out = torch.empty_like(crops)
    if out.numel() == 0:
        return out
    lib = cuda_build.load("median", _SIGNATURES)
    with torch.cuda.device(crops.device):
        code = lib.lm_median_u8(
            crops.data_ptr(), out.data_ptr(), batch, height, width, channels,
            int(ksize), torch.cuda.current_stream(crops.device).cuda_stream)
    cuda_build.check(code, "median")
    median_u8_batch.launches += 1
    return out


median_u8_batch.launches = 0


def median_u8_pinned(crops: Sequence[np.ndarray], ksize: int) -> np.ndarray:
    """The medians of host crops (equal uint8 [H, W, C] arrays) through K4
    on the calling thread's card, as a uint8 [B, H, W, C] array.

    The crops are stacked straight into pinned memory, uploaded, ranked and
    copied back on a side stream of this module's, and only that stream is
    waited for: the steps another thread has in flight on the default
    stream do not hold the medians up."""
    device = torch.device("cuda", torch.cuda.current_device())
    stream = _side_streams.get(device.index)
    if stream is None:
        stream = _side_streams.setdefault(device.index,
                                          torch.cuda.Stream(device))
    shape = (len(crops), *crops[0].shape)
    host = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
    np.stack(crops, out=host.numpy())
    out = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
    with torch.cuda.stream(stream):
        medians = median_u8_batch(host.to(device, non_blocking=True), ksize)
        out.copy_(medians, non_blocking=True)
    stream.synchronize()
    return out.numpy()
