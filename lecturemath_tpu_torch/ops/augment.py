"""A training batch's colour augmentation and targets; kernel K5 on the card.

For uint8 crops [B, H, W, 3] whose draws were made on the host
(``train/dataset.py``), with ``params`` int32 [B, 4] holding each sample's
(invert, hue, hue shift, noise row or -1), float64 ``noise`` [rows, H, W, 3]
and the uint8 ground truth [B, H, W] where there is one: each sample's
colour chain in the host's order (``train/augment.py``: ``color_invert``,
``hue_rotate``, ``add_noise``), the float32 image x / 127.5 - 1, where asked
the uint8 crops after the chain (K4 makes median targets of them), and from
the ground truth the target gt / 255, the text mask ``text_region_mask`` /
255 and the weights ``weight_map``. The targets are [B, H, W, 1].

For CUDA tensors ``augment_batch`` launches ``csrc/augment.cu``, one launch a
batch. For CPU tensors it runs the plain version, ``augment_plain``: those
host functions a sample at a time, which the tests hold K5 to byte for byte.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from ..train import augment
from ..utils.image import ellipse_kernel
from . import cuda_build

# the largest erosion radius K5 takes (its shared memory holds the tile's
# ground truth with a halo of this many pixels)
MAX_RADIUS = 64

_SIGNATURES = {
    "lm_augment": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}


@functools.lru_cache(maxsize=None)
def run_widths(expansion: int) -> np.ndarray:
    """The half width of each row of ``ellipse_kernel(2 * expansion + 1)``,
    every row of which is a run of ones centred on the kernel's middle
    column: int32 [2 * expansion + 1], read-only (one array an expansion,
    0 to ``MAX_RADIUS``, kept for the process)."""
    kernel = ellipse_kernel(2 * expansion + 1)
    widths = []
    for row in kernel:
        cols = np.flatnonzero(row)
        half = (len(cols) - 1) // 2
        if (not len(cols) or cols[0] != expansion - half
                or cols[-1] != expansion + half):
            raise ValueError(f"row {row} of the ellipse of expansion "
                             f"{expansion} is not a centred run")
        widths.append(half)
    widths = np.array(widths, np.int32)
    widths.setflags(write=False)
    return widths


@functools.lru_cache(maxsize=16)
def heavy_weight(fg_extra: float) -> np.float32:
    """The weight ``augment.weight_map`` gives an eroded ink pixel."""
    return augment.weight_map(np.zeros((1, 1), np.uint8), 0, fg_extra)[0, 0]


def augment_plain(images: torch.Tensor, params: torch.Tensor,
                  noise: torch.Tensor, noise_level: float,
                  truths: Optional[torch.Tensor] = None, target: bool = False,
                  text_mask_expansion: Optional[int] = None,
                  weight_expansion: Optional[int] = None,
                  weight_fg_extra: float = 1.0,
                  keep_crops: bool = False) -> Dict[str, torch.Tensor]:
    """``augment_batch`` of CPU tensors: ``train/augment.py``'s host
    functions, a sample at a time."""
    images, params, noise = images.numpy(), params.numpy(), noise.numpy()
    batch, height, width = images.shape[:3]
    image = np.empty((batch, height, width, 3), np.float32)
    crops = np.empty((batch, height, width, 3), np.uint8)
    for k in range(batch):
        invert, hue, shift, row = (int(v) for v in params[k])
        img = images[k]
        if invert:
            img = augment.color_invert(img)
        if hue:
            img = augment.hue_rotate(img, shift)
        if row >= 0:
            img = augment.add_noise(img, noise[row], noise_level)
        crops[k] = img
        image[k] = img.astype(np.float32) / 127.5 - 1.0
    out = {"image": image}
    if keep_crops:
        out["crops"] = crops
    if truths is not None:
        gts = truths.numpy()
        if target:
            out["target"] = (gts.astype(np.float32) / 255.0)[..., None]
        if text_mask_expansion is not None:
            out["text_mask"] = np.stack([
                augment.text_region_mask(gt, text_mask_expansion)
                for gt in gts]).astype(np.float32)[..., None] / 255.0
        if weight_expansion is not None:
            out["weights"] = np.stack([
                augment.weight_map(gt, weight_expansion, weight_fg_extra)
                for gt in gts])[..., None]
    return {key: torch.from_numpy(value) for key, value in out.items()}


def _check(name: str, tensor: torch.Tensor, dtype: torch.dtype, dims: int,
           device: torch.device) -> None:
    if not isinstance(tensor, torch.Tensor):
        raise TypeError(f"augment_batch: {name} must be a tensor, got "
                        f"{type(tensor).__name__}")
    if tensor.dtype != dtype:
        raise TypeError(f"augment_batch: {name} must be {dtype}, got "
                        f"{tensor.dtype}")
    if tensor.dim() != dims:
        raise ValueError(f"augment_batch: {name} must have {dims} "
                         f"dimensions, got {tuple(tensor.shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"augment_batch: {name} must be contiguous")
    if tensor.device != device:
        raise ValueError(f"augment_batch: {name} is on {tensor.device}, "
                         f"the images on {device}")


def augment_batch(images: torch.Tensor, params: torch.Tensor,
                  noise: torch.Tensor, noise_level: float,
                  truths: Optional[torch.Tensor] = None, target: bool = False,
                  text_mask_expansion: Optional[int] = None,
                  weight_expansion: Optional[int] = None,
                  weight_fg_extra: float = 1.0,
                  keep_crops: bool = False) -> Dict[str, torch.Tensor]:
    """The batch's pixels on its device: ``image`` [B, H, W, 3] float32,
    ``crops`` [B, H, W, 3] uint8 with ``keep_crops``, and from ``truths``
    the [B, H, W, 1] float32 ``target`` (with ``target``), ``text_mask``
    and ``weights`` (with their expansions). Kernel K5 for CUDA tensors,
    launched on the current stream; ``augment_plain`` for CPU ones."""
    device = images.device if isinstance(images, torch.Tensor) else None
    _check("images", images, torch.uint8, 4, device)
    batch, height, width, channels = images.shape
    if channels != 3:
        raise ValueError(f"augment_batch: images must be [B, H, W, 3], got "
                         f"{tuple(images.shape)}")
    _check("params", params, torch.int32, 2, device)
    if tuple(params.shape) != (batch, 4):
        raise ValueError(f"augment_batch: params must be [{batch}, 4], got "
                         f"{tuple(params.shape)}")
    _check("noise", noise, torch.float64, 4, device)
    if tuple(noise.shape[1:]) != (height, width, 3):
        raise ValueError(f"augment_batch: noise must be [rows, {height}, "
                         f"{width}, 3], got {tuple(noise.shape)}")
    if truths is not None:
        _check("truths", truths, torch.uint8, 3, device)
        if tuple(truths.shape) != (batch, height, width):
            raise ValueError(f"augment_batch: truths must be [{batch}, "
                             f"{height}, {width}], got "
                             f"{tuple(truths.shape)}")
    elif target or text_mask_expansion is not None or (
            weight_expansion is not None):
        raise ValueError("augment_batch: targets need the ground truth")
    expansions = (("text_mask_expansion", text_mask_expansion),
                  ("weight_expansion", weight_expansion))
    for name, expansion in expansions:
        if expansion is not None and not (
                isinstance(expansion, (int, np.integer)) and expansion >= 0):
            raise ValueError(f"augment_batch: {name} must be a whole number "
                             f"of at least 0, got {expansion!r}")
    options = dict(truths=truths, target=target,
                   text_mask_expansion=text_mask_expansion,
                   weight_expansion=weight_expansion,
                   weight_fg_extra=weight_fg_extra, keep_crops=keep_crops)
    if device.type == "cpu":
        return augment_plain(images, params, noise, noise_level, **options)
    if device.type != "cuda":
        raise ValueError(f"augment_batch: unsupported device {device}")
    for name, expansion in expansions:
        if expansion is not None and expansion > MAX_RADIUS:
            raise ValueError(f"augment_batch: K5 erodes by at most "
                             f"{MAX_RADIUS}, got {name} {expansion}")
    if batch > 65535 or height * width * 3 >= 2 ** 31:
        raise ValueError(f"augment_batch: a batch of {batch} crops of "
                         f"{height}x{width} is too large")
    pixels = (batch, height, width)
    out = {"image": torch.empty((*pixels, 3), dtype=torch.float32,
                                device=device)}
    if keep_crops:
        out["crops"] = torch.empty((*pixels, 3), dtype=torch.uint8,
                                   device=device)
    widths = {}
    if truths is not None:
        if target:
            out["target"] = torch.empty((*pixels, 1), dtype=torch.float32,
                                        device=device)
        for key, expansion in (("text_mask", text_mask_expansion),
                               ("weights", weight_expansion)):
            if expansion is not None:
                out[key] = torch.empty((*pixels, 1), dtype=torch.float32,
                                       device=device)
                widths[key] = run_widths(expansion)
    if images.numel() == 0:
        return out

    def pointer(tensor):
        return None if tensor is None else tensor.data_ptr()

    def host(key):  # the half widths travel with the launch
        return widths[key].ctypes.data if key in widths else None

    lib = cuda_build.load("augment", _SIGNATURES)
    with torch.cuda.device(device):
        code = lib.lm_augment(
            images.data_ptr(), pointer(truths), params.data_ptr(),
            noise.data_ptr(), float(noise_level), out["image"].data_ptr(),
            pointer(out.get("crops")), pointer(out.get("target")),
            pointer(out.get("text_mask")), pointer(out.get("weights")),
            float(heavy_weight(weight_fg_extra)),
            len(widths.get("text_mask", ())) // 2, host("text_mask"),
            len(widths.get("weights", ())) // 2, host("weights"),
            batch, height, width,
            torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check(code, "augment")
    augment_batch.launches += 1
    return out


augment_batch.launches = 0
