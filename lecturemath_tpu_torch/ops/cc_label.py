"""Connected-component labeling (4-connectivity); kernel K3 on the card.

The contract of ``lecturemath_tpu/ops/cc_label.py``: int32 labels, 0 for
background and, for a foreground pixel, its component's root linear index
+ 1, where the root is the component's minimum linear index (its raster-
first pixel). Sorting roots ascending reproduces ``scipy.ndimage.label``'s
numbering, which ``compact_labels`` relies on.

For a CUDA tensor ``label_components_batch`` launches ``csrc/cc_label.cu``
(a block union-find, exact at its fixed point). For a CPU tensor it runs the
plain version: the JAX package's min-label propagation with pointer jumping,
round for round, including its ``max_iters`` bound.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from . import cuda_build

_BG = torch.iinfo(torch.int32).max
_SIGNATURES = {
    "lm_cc_label": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]),
}

Binary = Union[np.ndarray, torch.Tensor]
Device = Optional[Union[str, torch.device]]


def as_device_tensor(binary: Binary, device: Device = None) -> torch.Tensor:
    """``binary`` on the device it names: ``device`` when given, else the
    tensor's own device; a numpy array without ``device`` goes to the card
    (``resolve_device``)."""
    if isinstance(binary, torch.Tensor):
        if device is None:
            return binary
        return binary.to(resolve_device(device))
    return torch.from_numpy(np.ascontiguousarray(binary)).to(
        resolve_device(device))


def _neighbor_min(labels: torch.Tensor) -> torch.Tensor:
    """Min over the 4-neighbourhood (cross) and the pixel itself of
    [B, H, W] labels, with _BG beyond the frame."""
    out = labels.clone()
    out[:, 1:, :] = torch.minimum(out[:, 1:, :], labels[:, :-1, :])
    out[:, :-1, :] = torch.minimum(out[:, :-1, :], labels[:, 1:, :])
    out[:, :, 1:] = torch.minimum(out[:, :, 1:], labels[:, :, :-1])
    out[:, :, :-1] = torch.minimum(out[:, :, :-1], labels[:, :, 1:])
    return out


def _jump(flat: torch.Tensor) -> torch.Tensor:
    """label <- label[label] per frame of [B, N]; background stays _BG."""
    background = flat == _BG
    jumped = torch.gather(flat, 1, torch.where(background, 0, flat).long())
    return torch.where(background, _BG, jumped)


def label_components_plain(binary: torch.Tensor, max_iters: int = 64
                           ) -> torch.Tensor:
    """The JAX algorithm on [B, H, W]: each round takes the 4-neighbourhood
    minimum and jumps pointers twice, per frame until nothing changes or
    ``max_iters`` rounds ran (a frame that has stopped keeps its labels,
    as under ``jax.vmap`` of the while loop)."""
    b, h, w = binary.shape
    fg = binary != 0
    lin = torch.arange(h * w, dtype=torch.int32,
                       device=binary.device).reshape(1, h, w)
    labels = torch.where(fg, lin, _BG)
    active = torch.ones(b, dtype=torch.bool, device=binary.device)
    for _ in range(max_iters):
        new = torch.where(fg, _neighbor_min(labels), _BG)
        new = _jump(_jump(new.reshape(b, -1))).reshape(b, h, w)
        changed = (new != labels).flatten(1).any(dim=1)
        labels = torch.where(active[:, None, None], new, labels)
        active &= changed
        if not bool(active.any()):
            break
    return torch.where(fg, labels + 1, 0).to(torch.int32)


def label_components_batch(binary: Binary, max_iters: int = 64,
                           device: Device = None) -> torch.Tensor:
    """Label a [B, H, W] batch (nonzero = foreground) on its device: int32
    [B, H, W], 0 for background, root linear index + 1 in each frame.

    A CUDA tensor launches kernel K3, which returns the fixed point whatever
    ``max_iters`` says; a CPU tensor runs ``label_components_plain``, which
    honours it (64 rounds cover any realistic frame)."""
    binary = as_device_tensor(binary, device)
    if binary.dim() != 3:
        raise ValueError(f"label_components_batch: binary must be "
                         f"[B, H, W], got {tuple(binary.shape)}")
    if binary.device.type == "cpu":
        return label_components_plain(binary, max_iters)
    if binary.device.type != "cuda":
        raise ValueError(f"label_components_batch: unsupported device "
                         f"{binary.device}")
    if binary.dtype == torch.bool:
        binary = binary.view(torch.uint8)
    if binary.dtype != torch.uint8:
        raise TypeError(f"label_components_batch: binary must be uint8 or "
                        f"bool on the card, got {binary.dtype}")
    if not binary.is_contiguous():
        raise ValueError("label_components_batch: binary must be contiguous")
    batch, h, w = binary.shape
    if h * w >= 2 ** 31:
        raise ValueError(f"label_components_batch: a frame of {h}x{w} "
                         f"pixels does not fit int32 labels")
    if batch > 65535:
        raise ValueError(f"label_components_batch: at most 65535 frames a "
                         f"launch, got {batch}")
    out = torch.empty((batch, h, w), dtype=torch.int32, device=binary.device)
    if out.numel() == 0:
        return out
    lib = cuda_build.load("cc_label", _SIGNATURES)
    with torch.cuda.device(binary.device):
        code = lib.lm_cc_label(
            binary.data_ptr(), out.data_ptr(), batch, h, w,
            torch.cuda.current_stream(binary.device).cuda_stream)
    cuda_build.check(code, "cc_label")
    label_components_batch.launches += 1
    return out


label_components_batch.launches = 0


def label_components(binary: Binary, max_iters: int = 64,
                     device: Device = None) -> torch.Tensor:
    """Label one [H, W] frame: int32 [H, W] (see label_components_batch)."""
    binary = as_device_tensor(binary, device)
    if binary.dim() != 2:
        raise ValueError(f"label_components: binary must be [H, W], got "
                         f"{tuple(binary.shape)}")
    return label_components_batch(binary.unsqueeze(0).contiguous(),
                                  max_iters)[0]


def compact_labels(labels: np.ndarray) -> Tuple[np.ndarray, int]:
    """Host-side: map root labels to consecutive 1..N in ascending-root order.

    Ascending root order == raster order of each component's first pixel ==
    scipy.ndimage.label numbering, giving parity with the reference labeler.
    """
    labels = np.asarray(labels)
    roots = np.unique(labels)
    roots = roots[roots != 0]
    lut_size = int(labels.max()) + 1 if labels.size else 1
    lut = np.zeros(lut_size, dtype=np.int32)
    lut[roots] = np.arange(1, len(roots) + 1, dtype=np.int32)
    return lut[labels], len(roots)
