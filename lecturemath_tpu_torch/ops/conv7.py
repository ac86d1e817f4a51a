"""Kernel K2: k x k SAME stride-1 conv + bias + optional exact GELU for the
narrow-channel, full-resolution head convs of FCN-LectureNet.

``conv_same_nhwc`` launches ``csrc/conv7.cu``, an implicit GEMM on the
tensor cores, for a CUDA tensor; it can read its input as two tensors (the
diff image and a feature map) without concatenating them. It replaces the
Pallas ``_kernel`` of ``lecturemath_tpu/ops/pallas_conv7.py``. Its plain
version, ``conv_same_plain`` (``torch.cat`` + ``F.conv2d`` + bias +
``F.gelu`` in f32), runs for CPU tensors and is the reference the card is
held to. ``pack_weights`` lays the weights out as the kernel reads them.
``conv7_same`` is the same function in the JAX package's (B, H, C, W) /
HWIO layout, single-input.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_build

_SIGNATURES = {
    "lm_conv_same_nhwc": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}

_ACTIVATIONS = (None, "gelu")
CHUNK = 8   # input channels a K chunk of the kernel (16 bytes of bf16)


def n_tiles(n_out: int) -> int:
    """n8 tiles of output channels the kernel computes at once: 1, 2 or 4
    (more than 32 channels run as several groups of 32)."""
    return 1 if n_out <= 8 else 2 if n_out <= 16 else 4


def pack_weights(weight: torch.Tensor, c1: int, c2: int,
                 nt: int) -> torch.Tensor:
    """(N, c1 + c2, k, k) weights -> bf16 in the kernel's mma B-fragment
    order, [groups][chunks][steps][nt][32 lanes][2 slots][2], zero-padded.

    Chunks are 8 input channels: ceil(c1 / 8) of the first input, then
    ceil(c2 / 8) of the second. Step s pairs taps 2s (slot 0) and 2s + 1
    (slot 1) of a chunk, tap = dy * k + dx, zero past k * k. Lane
    4 * n + i holds, for output channel n of its n8 tile, the weights of
    channels 2i and 2i + 1 of the chunk, slot 0 then slot 1: the b0..b3 of
    ``mma.m16n8k16`` for a K order (slot, channel)."""
    n_out, c_in, k, _ = weight.shape
    g1, g2 = -(-c1 // CHUNK), -(-c2 // CHUNK)
    steps = (k * k + 1) // 2
    groups = -(-n_out // (8 * nt))
    w = weight.detach().to(torch.bfloat16).permute(1, 2, 3, 0).reshape(
        c_in, k * k, n_out)
    full = w.new_zeros((g1 + g2) * CHUNK, 2 * steps, groups * nt * 8)
    full[:c1, :k * k, :n_out] = w[:c1]
    full[g1 * CHUNK:g1 * CHUNK + c2, :k * k, :n_out] = w[c1:]
    # [chunk][lane%4][half][step][slot][group][tile][lane/4]
    full = full.reshape(g1 + g2, 4, 2, steps, 2, groups, nt, 8)
    return full.permute(5, 0, 3, 6, 7, 1, 4, 2).reshape(
        groups, g1 + g2, steps, nt, 32, 2, 2).contiguous()


def conv_same_plain(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    activation: Optional[str] = None,
                    out_dtype: Optional[torch.dtype] = None,
                    x2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same function as ``conv_same_nhwc`` in f32 with ``F.conv2d``,
    on ``torch.cat([x, x2], dim=1)`` when ``x2`` is given. The weights are
    first rounded to the input's dtype (``weight.to(x.dtype)``), as the
    Pallas kernel casts them to its input's type and the CUDA kernel keeps
    them in bf16; for an f32 input that changes nothing."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    k = weight.shape[-1]
    xin = x if x2 is None else torch.cat([x, x2], dim=1)
    y = F.conv2d(xin.float(), weight.to(x.dtype).float(),
                 None if bias is None else bias.float(), padding=k // 2)
    if activation == "gelu":
        y = F.gelu(y)
    return y.to(out_dtype or x.dtype)


def conv_same_nhwc(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   activation: Optional[str] = None,
                   out_dtype: Optional[torch.dtype] = None,
                   x2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k x k SAME stride-1 conv + bias + optional exact GELU.

    ``x`` is a (B, C, H, W) tensor; on the card it must be bf16 in
    ``channels_last`` memory (NHWC bytes), as the model carries its
    activations. ``x2`` (B, C2, H, W), the same, is read as channels C..
    of the input, as if concatenated after ``x``. ``weight`` is
    (N, C + C2, k, k) as for ``F.conv2d`` (k odd, at most 7; the kernel
    computes with it rounded to bf16), ``bias`` (N,) or None. Returns
    (B, N, H, W) in ``channels_last`` memory, of ``out_dtype`` (bf16 or
    f32; default the input's dtype). One kernel launch for a CUDA tensor;
    the plain version for a CPU tensor."""
    device = x.device
    if device.type == "cpu":
        return conv_same_plain(x, weight, bias, activation, out_dtype, x2)
    if device.type != "cuda":
        raise ValueError(f"conv_same_nhwc: unsupported device {device}")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"conv_same_nhwc: unknown activation {activation!r}")
    out_dtype = out_dtype or x.dtype
    inputs = [x] if x2 is None else [x, x2]
    for t in inputs:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"conv_same_nhwc: input must be bfloat16, got "
                            f"{t.dtype}")
        if t.dim() != 4:
            raise ValueError("conv_same_nhwc: x and x2 must be (B, C, H, W)")
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("conv_same_nhwc: x and x2 must be channels_last "
                             "contiguous")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv_same_nhwc: output must be bfloat16 or "
                        f"float32, got {out_dtype}")
    if weight.dim() != 4:
        raise ValueError("conv_same_nhwc: weight must be (N, C, k, k)")
    batch, c_in, height, width = x.shape
    c2 = 0 if x2 is None else x2.shape[1]
    if x2 is not None and (x2.shape[0], *x2.shape[2:]) != (batch, height,
                                                           width):
        raise ValueError(f"conv_same_nhwc: x2 {tuple(x2.shape)} does not "
                         f"match x {tuple(x.shape)}")
    n_out, w_in, k, k2 = weight.shape
    if w_in != c_in + c2 or k != k2 or k % 2 == 0 or not 1 <= k <= 7:
        raise ValueError(f"conv_same_nhwc: weight {tuple(weight.shape)} does "
                         f"not fit input channels {c_in} + {c2} with odd "
                         f"k <= 7")
    if bias is not None and tuple(bias.shape) != (n_out,):
        raise ValueError(f"conv_same_nhwc: bias must be ({n_out},)")
    if any(t.device != device for t in inputs + [weight]) or (
            bias is not None and bias.device != device):
        raise ValueError("conv_same_nhwc: x2, weight and bias must be on "
                         "the input's device")

    nt = n_tiles(n_out)
    packed = pack_weights(weight, c_in, c2, nt)
    b = (torch.zeros(n_out, dtype=torch.float32, device=device)
         if bias is None else bias.detach().float().contiguous())
    out = torch.empty((batch, n_out, height, width), dtype=out_dtype,
                      device=device, memory_format=torch.channels_last)
    lib = cuda_build.load("conv7", _SIGNATURES)
    with torch.cuda.device(device):
        code = lib.lm_conv_same_nhwc(
            x.data_ptr(), c_in, None if x2 is None else x2.data_ptr(), c2,
            packed.data_ptr(), b.data_ptr(), out.data_ptr(),
            batch, height, width, n_out, k, nt,
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
