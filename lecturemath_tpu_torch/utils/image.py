"""Image resampling and colour conversion in numpy, in place of OpenCV and
Pillow on the port's host paths, so that they run where neither is
installed.

Each function reproduces one library call's arithmetic:

  * ``resize_nearest``: ``cv2.resize(..., interpolation=cv2.INTER_NEAREST)``;
  * ``resize_area``: ``cv2.resize(..., interpolation=cv2.INTER_AREA)``, by
    OpenCV's three paths: an integer factor down (box sums), a fractional
    factor down (area weights in f32) and any factor up (linear weights in
    11-bit fixed point, placed by area);
  * ``halve_lanczos``: ``PIL.Image.resize((w // 2, h // 2), Image.LANCZOS)``
    (Pillow's separable resample in 22-bit fixed point, horizontal first;
    each pass in the native library where it builds, else in numpy);
  * ``rgb_to_yuv420``: ``cv2.cvtColor(..., cv2.COLOR_RGB2YUV_I420)`` in
    OpenCV's 20-bit integer BT.601 arithmetic.

Images are uint8 [H, W] or [H, W, C]; sizes are (width, height) as for cv2.
The coefficient tables are built once for each (source, destination) size
and kept, read-only, for the next frame.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

from .. import native

__all__ = ["resize_nearest", "resize_area", "halve_lanczos", "rgb_to_yuv420"]


def _check(img: np.ndarray, size: Tuple[int, int]) -> Tuple[int, int]:
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected a uint8 [H, W] or [H, W, C] image, got "
                         f"{img.dtype} {img.shape}")
    width, height = (int(v) for v in size)
    if width <= 0 or height <= 0 or img.shape[0] == 0 or img.shape[1] == 0:
        raise ValueError(f"cannot resize {img.shape[1]}x{img.shape[0]} to "
                         f"{width}x{height}")
    return width, height


def _frozen(*arrays: np.ndarray):
    """The arrays made read-only, as a cached table's callers share them."""
    for array in arrays:
        array.setflags(write=False)
    return arrays


@functools.lru_cache(maxsize=64)
def _nearest_index(src: int, dst: int) -> np.ndarray:
    # OpenCV: ifx = 1 / (dst / src) in double, sx = min(floor(x * ifx), src - 1)
    inverse = 1.0 / (dst / src)
    index = np.floor(np.arange(dst, dtype=np.float64) * inverse)
    return _frozen(np.minimum(index.astype(np.int64), src - 1))[0]


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)``."""
    img = np.asarray(img)
    width, height = _check(img, size)
    rows = _nearest_index(img.shape[0], height)
    cols = _nearest_index(img.shape[1], width)
    return np.ascontiguousarray(img[rows][:, cols])


# ------------------------------------------------------------- INTER_AREA

def _round_f32(values: np.ndarray) -> np.ndarray:
    """``saturate_cast<uchar>(float)``: round half to even, clamp."""
    return np.clip(np.rint(values), 0, 255).astype(np.uint8)


def _area_integer(img: np.ndarray, sx: int, sy: int) -> np.ndarray:
    """OpenCV's resizeAreaFast: box sums over sy x sx; a 2x2 box rounds
    (sum + 2) >> 2, any other box rounds sum * (1.f / area) in f32."""
    h, w = img.shape[0] // sy, img.shape[1] // sx
    img = img[:h * sy, :w * sx]
    sums = np.zeros((h, w, *img.shape[2:]), np.int32)
    for dy in range(sy):
        for dx in range(sx):
            sums += img[dy::sy, dx::sx]
    if sx == 2 and sy == 2:
        return ((sums + 2) >> 2).astype(np.uint8)
    scale = np.float32(1.0) / np.float32(sx * sy)
    return _round_f32(sums.astype(np.float32) * scale)


@functools.lru_cache(maxsize=64)
def _area_table(src: int, dst: int, scale: float):
    """OpenCV's computeResizeAreaTab as [dst, slots] source indices and f32
    weights, in its order (padding slots: index 0, weight 0, which add an
    exact 0 to the sums)."""
    entries = [[] for _ in range(dst)]
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            entries[d].append((s1 - 1, np.float32((s1 - f1) / cell)))
        for s in range(s1, s2):
            entries[d].append((s, np.float32(1.0 / cell)))
        if f2 - s2 > 1e-3:
            entries[d].append((s2, np.float32(min(min(f2 - s2, 1.0), cell)
                                              / cell)))
    slots = max(len(e) for e in entries)
    index = np.zeros((dst, slots), np.int64)
    weight = np.zeros((dst, slots), np.float32)
    for d, entry in enumerate(entries):
        for k, (s, a) in enumerate(entry):
            index[d, k] = s
            weight[d, k] = a
    return _frozen(index, weight)


def _area_fractional(img: np.ndarray, width: int, height: int,
                     scale_x: float, scale_y: float) -> np.ndarray:
    """OpenCV's ResizeArea_Invoker: each source row's horizontal sums in
    f32 in table order, then each output row as the f32 sum of its source
    rows times their weights, in table order."""
    xindex, xweight = _area_table(img.shape[1], width, scale_x)
    yindex, yweight = _area_table(img.shape[0], height, scale_y)
    data = img.astype(np.float32)
    tail = (1,) * (img.ndim - 2)
    rows = np.zeros((img.shape[0], width, *img.shape[2:]), np.float32)
    for k in range(xindex.shape[1]):
        rows += data[:, xindex[:, k]] * xweight[:, k].reshape(width, *tail)
    total = np.zeros((height, width, *img.shape[2:]), np.float32)
    for k in range(yindex.shape[1]):
        total += yweight[:, k].reshape(height, 1, *tail) * rows[yindex[:, k]]
    return _round_f32(total)


_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


@functools.lru_cache(maxsize=64)
def _area_up_table(src: int, dst: int):
    """Source index and the two 11-bit weights of each output position for
    OpenCV's INTER_AREA upscale (linear interpolation placed by area)."""
    scale = 1.0 / (dst / src)
    inverse = dst / src
    index = np.empty(dst, np.int64)
    weights = np.empty((dst, 2), np.int64)
    for d in range(dst):
        s = math.floor(d * scale)
        f = float(np.float32((d + 1) - (s + 1) * inverse))
        f = 0.0 if f <= 0 else f - math.floor(f)
        if s >= src - 1:
            s, f = src - 1, 0.0
        # cbuf[0] = 1.f - fx, in f32; saturate_cast<short>(c * 2048) rounds
        c0 = float(np.float32(1.0) - np.float32(f))
        index[d] = s
        weights[d] = (int(np.rint(np.float32(c0) * np.float32(_COEF_SCALE))),
                      int(np.rint(np.float32(f) * np.float32(_COEF_SCALE))))
    return _frozen(index, weights)


def _area_upscale(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """OpenCV's resize with INTER_AREA when a factor is below 1: linear
    weights in 11-bit fixed point, horizontal sums in int32, then the
    vertical step ((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16),
    rounded by (+ 2) >> 2."""
    src_h, src_w = img.shape[:2]
    xi, xw = _area_up_table(src_w, width)
    yi, yw = _area_up_table(src_h, height)
    x1 = np.minimum(xi + 1, src_w - 1)
    data = img.astype(np.int64)
    shape = (1, width, 1) if img.ndim == 3 else (1, width)
    a0 = xw[:, 0].reshape(shape)
    a1 = xw[:, 1].reshape(shape)
    # past the last full pair of source columns OpenCV takes S[sx] * 2048
    last = (xi + 1 >= src_w).reshape(shape)
    horizontal = np.where(last, data[:, xi] * _COEF_SCALE,
                          data[:, xi] * a0 + data[:, x1] * a1)
    y1 = np.minimum(yi + 1, src_h - 1)
    bshape = (height,) + (1,) * (img.ndim - 1)
    b0 = yw[:, 0].reshape(bshape)
    b1 = yw[:, 1].reshape(bshape)
    s0 = horizontal[yi] >> 4
    s1 = horizontal[y1] >> 4
    value = ((b0 * s0) >> 16) + ((b1 * s1) >> 16)
    return np.clip((value + 2) >> 2, 0, 255).astype(np.uint8)


def resize_area(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_AREA)``."""
    img = np.asarray(img)
    width, height = _check(img, size)
    src_h, src_w = img.shape[:2]
    if (width, height) == (src_w, src_h):
        return img.copy()
    scale_x = 1.0 / (width / src_w)
    scale_y = 1.0 / (height / src_h)
    if scale_x >= 1 and scale_y >= 1:
        ix, iy = round(scale_x), round(scale_y)
        if (abs(scale_x - ix) < np.finfo(np.float64).eps
                and abs(scale_y - iy) < np.finfo(np.float64).eps):
            return _area_integer(img, ix, iy)
        return _area_fractional(img, width, height, scale_x, scale_y)
    return _area_upscale(img, width, height)


# ---------------------------------------------------------- PIL LANCZOS

_PRECISION_BITS = 32 - 8 - 2


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


@functools.lru_cache(maxsize=64)
def _lanczos_coefficients(src: int, dst: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for LANCZOS:
    [dst, ksize] int weights of 22 fractional bits and each output's first
    source index."""
    scale = filterscale = src / dst
    if filterscale < 1.0:
        filterscale = 1.0
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(dst, np.int64)
    weights = np.zeros((dst, ksize), np.int64)
    for xx in range(dst):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), src) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = 0.0
        for w in k:
            total += w
        if total != 0.0:
            k = [w / total for w in k]
        for x, w in enumerate(k):
            scaled = w * (1 << _PRECISION_BITS)
            weights[xx, x] = int(-0.5 + scaled) if w < 0 else int(0.5 + scaled)
        first[xx] = xmin
    return _frozen(first, weights.astype(np.int32))


def _resample_axis(data: np.ndarray, dst: int, axis: int) -> np.ndarray:
    src = data.shape[axis]
    first, weights = _lanczos_coefficients(src, dst)
    if native.available():
        return native.resample_u8(data, axis, first, weights, _PRECISION_BITS)
    taps = weights.shape[1]
    index = np.minimum(first[:, None] + np.arange(taps)[None, :], src - 1)
    # the resampled axis first and contiguous, so each tap gathers whole
    # rows; int32 as in Pillow (the sums stay below 2^31)
    moved = np.ascontiguousarray(np.moveaxis(data, axis, 0), np.int32)
    acc = np.full((dst, *moved.shape[1:]), 1 << (_PRECISION_BITS - 1),
                  np.int32)
    wshape = (dst,) + (1,) * (moved.ndim - 1)
    for k in range(taps):
        # taps past a row's own count have weight 0
        acc += moved[index[:, k]] * weights[:, k].reshape(wshape)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def halve_lanczos(img: np.ndarray) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize((w // 2, h // 2), Image.LANCZOS)``
    as an array: the horizontal pass, then the vertical, each rounding to
    uint8 with Pillow's clip8."""
    img = np.asarray(img)
    height, width = img.shape[:2]
    _check(img, (width // 2, height // 2))
    return _resample_axis(_resample_axis(img, width // 2, 1), height // 2, 0)


# ------------------------------------------------------------------- I420

_SHIFT = 20
_HALF = 1 << (_SHIFT - 1)
_CRY, _CGY, _CBY = 269484, 528482, 102760
_CRU, _CGU, _CBU = -155188, -305135, 460324
_CGV, _CBV = -385875, -74448


def rgb_to_yuv420(rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB [H, W, 3] (H, W even) -> I420 planes [H * 3 / 2, W], as
    ``cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420)``: Y of every pixel, U and V
    of the top-left pixel of each 2x2 block, in 20-bit fixed point."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected uint8 RGB [H, W, 3], got {rgb.dtype} "
                         f"{rgb.shape}")
    height, width = rgb.shape[:2]
    if height % 2 or width % 2 or height == 0 or width == 0:
        raise ValueError(f"I420 needs an even width and height, got "
                         f"{width}x{height}")
    r, g, b = (rgb[..., c].astype(np.int64) for c in range(3))
    y = (_CRY * r + _CGY * g + _CBY * b + _HALF + (16 << _SHIFT)) >> _SHIFT
    r0, g0, b0 = r[::2, ::2], g[::2, ::2], b[::2, ::2]
    u = (_CRU * r0 + _CGU * g0 + _CBU * b0 + _HALF + (128 << _SHIFT)) >> _SHIFT
    v = (_CBU * r0 + _CGV * g0 + _CBV * b0 + _HALF + (128 << _SHIFT)) >> _SHIFT
    planes = np.concatenate([np.clip(p, 0, 255).astype(np.uint8).ravel()
                             for p in (y, u, v)])
    return planes.reshape(height * 3 // 2, width)
