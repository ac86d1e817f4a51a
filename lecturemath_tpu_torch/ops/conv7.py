"""Kernel K2: k x k SAME stride-1 conv + bias + optional exact GELU for the
narrow-channel, full-resolution head convs of FCN-LectureNet.

``conv_same_nhwc`` launches ``csrc/conv7.cu`` for a CUDA tensor. It replaces
the Pallas ``_kernel`` of ``lecturemath_tpu/ops/pallas_conv7.py``. Its plain
version, ``conv_same_plain`` (``F.conv2d`` + bias + ``F.gelu`` in f32), runs
for CPU tensors and is the reference the card is held to. ``conv7_same`` is
the same function in the JAX package's (B, H, C, W) / HWIO layout.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_build

_SIGNATURES = {
    "lm_conv_same_nhwc": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}

_ACTIVATIONS = (None, "gelu")


def conv_same_plain(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    activation: Optional[str] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The same function as ``conv_same_nhwc`` in f32 with ``F.conv2d``."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    k = weight.shape[-1]
    y = F.conv2d(x.float(), weight.float(),
                 None if bias is None else bias.float(), padding=k // 2)
    if activation == "gelu":
        y = F.gelu(y)
    return y.to(out_dtype or x.dtype)


def conv_same_nhwc(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   activation: Optional[str] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """k x k SAME stride-1 conv + bias + optional exact GELU.

    ``x`` is a (B, C, H, W) tensor; on the card it must be bf16 in
    ``channels_last`` memory (NHWC bytes), as the model carries its
    activations. ``weight`` is (N, C, k, k) as for ``F.conv2d`` (k odd,
    at most 7), ``bias`` (N,) or None. Returns (B, N, H, W) in
    ``channels_last`` memory, of ``out_dtype`` (bf16 or f32; default the
    input's dtype). One kernel launch for a CUDA tensor; the plain version
    for a CPU tensor."""
    device = x.device
    if device.type == "cpu":
        return conv_same_plain(x, weight, bias, activation, out_dtype)
    if device.type != "cuda":
        raise ValueError(f"conv_same_nhwc: unsupported device {device}")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"conv_same_nhwc: unknown activation {activation!r}")
    out_dtype = out_dtype or x.dtype
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv_same_nhwc: input must be bfloat16, got "
                        f"{x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv_same_nhwc: output must be bfloat16 or "
                        f"float32, got {out_dtype}")
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError("conv_same_nhwc: x must be (B, C, H, W) and weight "
                         "(N, C, k, k)")
    batch, c_in, height, width = x.shape
    n_out, w_in, k, k2 = weight.shape
    if w_in != c_in or k != k2 or k % 2 == 0 or not 1 <= k <= 7:
        raise ValueError(f"conv_same_nhwc: weight {tuple(weight.shape)} does "
                         f"not fit input channels {c_in} with odd k <= 7")
    if bias is not None and tuple(bias.shape) != (n_out,):
        raise ValueError(f"conv_same_nhwc: bias must be ({n_out},)")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv_same_nhwc: x must be channels_last contiguous")
    if weight.device != device or (bias is not None and
                                   bias.device != device):
        raise ValueError("conv_same_nhwc: weight and bias must be on the "
                         "input's device")

    w_hwio = weight.detach().permute(2, 3, 1, 0).float().contiguous()
    b = (torch.zeros(n_out, dtype=torch.float32, device=device)
         if bias is None else bias.detach().float().contiguous())
    out = torch.empty((batch, n_out, height, width), dtype=out_dtype,
                      device=device, memory_format=torch.channels_last)
    lib = cuda_build.load("conv7", _SIGNATURES)
    with torch.cuda.device(device):
        code = lib.lm_conv_same_nhwc(
            x.data_ptr(), w_hwio.data_ptr(), b.data_ptr(), out.data_ptr(),
            batch, height, width, c_in, n_out, k,
            int(activation == "gelu"), int(out_dtype == torch.float32),
            torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check(code, "conv_same_nhwc")
    conv_same_nhwc.launches += 1
    return out


conv_same_nhwc.launches = 0


def conv7_same(x_bhcw: torch.Tensor, kernel_hwio: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``conv_same_nhwc`` in the layout of lecturemath_tpu's ``conv7_same``:
    x (B, H, C, W), kernel (k, k, C, N) HWIO; returns (B, H, N, W)."""
    x = x_bhcw.permute(0, 2, 1, 3).contiguous(
        memory_format=torch.channels_last)
    y = conv_same_nhwc(x, kernel_hwio.permute(3, 2, 0, 1), bias, activation,
                       out_dtype)
    return y.permute(0, 2, 1, 3)
