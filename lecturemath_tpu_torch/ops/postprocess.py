"""Kernel K1: the stage-01 tail, logits -> packed binary bitmap.

``threshold_pack`` launches ``csrc/threshold_pack.cu`` for a CUDA tensor. It
replaces the Pallas ``_postprocess_kernel`` of
``lecturemath_tpu/ops/pallas_postprocess.py`` and fuses the crop and
``pack_bits`` that follow it in ``make_packed_binarizer``. Its plain version,
``threshold_pack_plain``, runs for CPU tensors and is the reference the card
is held to.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_SIGNATURES = {
    "lm_threshold_pack": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
}

_PACK_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_bits(binary: torch.Tensor) -> torch.Tensor:
    """Pack a boolean/binary [B, H, W] into a uint8 bitmap [B, H, ceil(W/8)]
    (MSB-first, np.packbits layout, padding bits 0)."""
    b, h, w = binary.shape
    pad = (-w) % 8
    bits = (binary != 0).to(torch.uint8)
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(b, h, -1, 8)
    weights = torch.tensor(_PACK_WEIGHTS, dtype=torch.uint8,
                           device=binary.device)
    return (bits * weights).sum(dim=-1, dtype=torch.uint8)


def threshold_pack_plain(logits_padded: torch.Tensor, h: int, w: int,
                         threshold: int = 128) -> torch.Tensor:
    """sigmoid -> x255 -> truncate to uint8 -> >= threshold, cropped to
    [:h, :w] and packed: the reference binarize semantics in f32."""
    prob = torch.sigmoid(logits_padded.float())
    binary = (prob * 255.0).to(torch.uint8) >= threshold
    return pack_bits(binary[:, :h, :w])


def threshold_pack(logits_padded: torch.Tensor, h: int, w: int,
                   threshold: int = 128) -> torch.Tensor:
    """f32 logits [B, Hp, Wp] -> MSB-first packed bitmap uint8
    [B, h, ceil(w/8)] of ``sigmoid(logits)*255`` truncated ``>= threshold``
    over the [:h, :w] crop. One kernel launch for a CUDA tensor; the plain
    version for a CPU tensor."""
    device = logits_padded.device
    if device.type == "cpu":
        return threshold_pack_plain(logits_padded, h, w, threshold)
    if device.type != "cuda":
        raise ValueError(f"threshold_pack: unsupported device {device}")
    if logits_padded.dtype != torch.float32:
        raise TypeError(f"threshold_pack: logits must be float32, got "
                        f"{logits_padded.dtype}")
    if logits_padded.dim() != 3:
        raise ValueError(f"threshold_pack: logits must be [B, Hp, Wp], got "
                         f"{tuple(logits_padded.shape)}")
    if not logits_padded.is_contiguous():
        raise ValueError("threshold_pack: logits must be contiguous")
    batch, hp, wp = logits_padded.shape
    if not (0 < h <= hp and 0 < w <= wp):
        raise ValueError(f"threshold_pack: crop {h}x{w} outside {hp}x{wp}")
    if not 0 <= threshold <= 256:
        raise ValueError(f"threshold_pack: threshold {threshold} not in "
                         f"[0, 256]")
    out = torch.empty((batch, h, (w + 7) // 8), dtype=torch.uint8,
                      device=device)
    lib = cuda_build.load("threshold_pack", _SIGNATURES)
    with torch.cuda.device(device):
        code = lib.lm_threshold_pack(
            logits_padded.data_ptr(), out.data_ptr(), batch, hp, wp, h, w,
            int(threshold), torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check(code, "threshold_pack")
    threshold_pack.launches += 1
    return out


threshold_pack.launches = 0
