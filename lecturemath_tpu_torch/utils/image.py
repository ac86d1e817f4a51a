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
    OpenCV's 20-bit integer BT.601 arithmetic;
  * ``fill_poly``: ``cv2.fillPoly(img, [pts], color)`` with the default
    ``lineType=8`` and ``shift=0`` (8-connected outline plus a 16-bit
    fixed-point scanline fill, both clipped to the image as OpenCV clips);
  * ``find_homography``, ``perspective_transform`` and ``warp_perspective``:
    ``cv2.findHomography`` (method 0, 4 points), ``cv2.perspectiveTransform``
    and ``cv2.warpPerspective`` (INTER_LINEAR, BORDER_CONSTANT on uint8), the
    last in OpenCV 5.0's float32 arithmetic, or with
    ``interpolation="nearest"`` as ``cv2.INTER_NEAREST`` warps any integer
    image;
  * ``line``, ``polylines``, ``rectangle`` and ``circle``: OpenCV's
    ``LINE_8`` drawing with ``shift=0`` (a thick line is a quad in 16-bit
    fixed point through OpenCV's convex fill, with round caps; the filled
    circle is its integer ``Circle``);
  * ``threshold_otsu``: the threshold ``cv2.threshold(..., THRESH_OTSU)``
    returns.

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

__all__ = ["resize_nearest", "resize_area", "resize_linear", "halve_lanczos",
           "rgb_to_yuv420", "rgb_to_gray", "rgb_to_hsv", "hsv_to_rgb",
           "ellipse_kernel", "erode", "dilate", "morph_close", "morph_open",
           "median_blur", "fill_poly", "find_homography",
           "perspective_transform", "warp_perspective", "threshold_otsu",
           "line", "polylines", "rectangle", "circle"]


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
    """The two source indices and 11-bit weights of each output position for
    OpenCV's INTER_AREA upscale (linear interpolation placed by area)."""
    scale = 1.0 / (dst / src)
    inverse = dst / src
    index = np.empty((dst, 2), np.int64)
    weights = np.empty((dst, 2), np.int64)
    for d in range(dst):
        s = math.floor(d * scale)
        f = float(np.float32((d + 1) - (s + 1) * inverse))
        f = 0.0 if f <= 0 else f - math.floor(f)
        if s >= src - 1:
            s, f = src - 1, 0.0
        # cbuf[0] = 1.f - fx, in f32; saturate_cast<short>(c * 2048) rounds
        c0 = float(np.float32(1.0) - np.float32(f))
        index[d] = (s, min(s + 1, src - 1))
        weights[d] = (int(np.rint(np.float32(c0) * np.float32(_COEF_SCALE))),
                      int(np.rint(np.float32(f) * np.float32(_COEF_SCALE))))
    return _frozen(index, weights)


def _area_upscale(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """OpenCV's resize with INTER_AREA when a factor is below 1: linear
    weights placed by area."""
    src_h, src_w = img.shape[:2]
    return _fixed_point_linear(img, _area_up_table(src_w, width),
                               _area_up_table(src_h, height))


@functools.lru_cache(maxsize=128)
def _linear_table(src: int, dst: int, clamp: bool):
    """The two source indices and 11-bit weights of each output position
    for OpenCV's INTER_LINEAR: f = (float)((d + 0.5) * scale - 0.5), s =
    floor(f). Columns (``clamp``) move s and f to the first or last source
    pixel; rows keep s and f and read the clamped rows s and s + 1."""
    scale = 1.0 / (dst / src)
    index = np.empty((dst, 2), np.int64)
    weights = np.empty((dst, 2), np.int64)
    for d in range(dst):
        f = np.float32((d + 0.5) * scale - 0.5)
        s = math.floor(f)
        f = np.float32(f - np.float32(s))
        if clamp and s < 0:
            s, f = 0, np.float32(0)
        if clamp and s >= src - 1:
            s, f = src - 1, np.float32(0)
        index[d] = (min(max(s, 0), src - 1), min(max(s + 1, 0), src - 1))
        weights[d] = (int(np.rint((np.float32(1.0) - f)
                                  * np.float32(_COEF_SCALE))),
                      int(np.rint(f * np.float32(_COEF_SCALE))))
    return _frozen(index, weights)


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` by any
    factor along either axis, in OpenCV's 11-bit fixed point (its 2x
    halving by INTER_AREA averages the same four pixels)."""
    img = np.asarray(img)
    width, height = _check(img, size)
    src_h, src_w = img.shape[:2]
    if (width, height) == (src_w, src_h):
        return img.copy()
    return _fixed_point_linear(img, _linear_table(src_w, width, True),
                               _linear_table(src_h, height, False))


def _fixed_point_linear(img: np.ndarray, xtable, ytable) -> np.ndarray:
    """OpenCV's linear resize of uint8 in fixed point: 11-bit weights,
    horizontal sums in int32, then the vertical step ((b0 * (S0 >> 4)) >>
    16) + ((b1 * (S1 >> 4)) >> 16), rounded by (+ 2) >> 2. Each table is
    ([dst, 2] source indices, [dst, 2] weights)."""
    (xi, xw), (yi, yw) = xtable, ytable
    width, height = len(xi), len(yi)
    data = img.astype(np.int64)
    shape = (1, width, 1) if img.ndim == 3 else (1, width)
    horizontal = (data[:, xi[:, 0]] * xw[:, 0].reshape(shape)
                  + data[:, xi[:, 1]] * xw[:, 1].reshape(shape))
    bshape = (height,) + (1,) * (img.ndim - 1)
    b0 = yw[:, 0].reshape(bshape)
    b1 = yw[:, 1].reshape(bshape)
    s0 = horizontal[yi[:, 0]] >> 4
    s1 = horizontal[yi[:, 1]] >> 4
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


# ------------------------------------------------- gray, HSV (uint8, cv2)

# OpenCV 5's RGB2GRAY weights for uint8, 15-bit fixed point (OpenCV 4 used
# 4899, 9617, 1868 in 14 bits)
_GRAY_SHIFT = 15
_R2Y, _G2Y, _B2Y = 9798, 19235, 3735


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)`` for uint8 RGB [H, W, 3]:
    (R 9798 + G 19235 + B 3735 + 2^14) >> 15."""
    rgb = _check_rgb(rgb)
    r, g, b = (rgb[..., c].astype(np.int32) for c in range(3))
    return ((r * _R2Y + g * _G2Y + b * _B2Y + (1 << (_GRAY_SHIFT - 1)))
            >> _GRAY_SHIFT).astype(np.uint8)


def _check_rgb(rgb: np.ndarray) -> np.ndarray:
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {rgb.dtype} "
                         f"{rgb.shape}")
    return rgb


_HSV_SHIFT = 12


@functools.lru_cache(maxsize=1)
def _hsv_tables():
    """OpenCV's RGB2HSV_b tables: sdiv[v] = round((255 << 12) / v) and
    hdiv[d] = round((180 << 12) / (6 d)), 0 at 0."""
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.rint((255 << _HSV_SHIFT) / i), 0)
        hdiv = np.where(i > 0, np.rint((180 << _HSV_SHIFT) / (6.0 * i)), 0)
    return _frozen(sdiv.astype(np.int64), hdiv.astype(np.int64))


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)`` for uint8: hue in [0, 180]
    (180 only where rounding carries it there, as OpenCV's does), S and V
    in [0, 255], in OpenCV's 12-bit fixed point."""
    rgb = _check_rgb(rgb)
    sdiv, hdiv = _hsv_tables()
    r, g, b = (rgb[..., c].astype(np.int64) for c in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff,
                                         r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([np.clip(h, 0, 255), s, v], axis=-1).astype(np.uint8)


# sectors of OpenCV's HSV2RGB: the tab entries of (b, g, r)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])
# pixels of a row OpenCV's vector HSV2RGB takes at once (4 x 8 f32 lanes)
_HSV_BLOCK = 32


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` for uint8 (hue in [0,
    180)), through float32 as OpenCV's 8-bit conversion goes: h * 6 / 180,
    S and V over 255, the sector table with 1 - s * h and 1 - s * (1 - h)
    each rounded once (fused multiply-add), then each channel times 255.
    OpenCV's vector path, which takes each row's pixels in blocks of 32,
    truncates that to uint8; the row's last pixels, past its last whole
    block, take the scalar path, which rounds."""
    hsv = _check_rgb(hsv)
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h)
    h = h - sector
    sector = sector.astype(np.int64)
    s64, h64 = s.astype(np.float64), h.astype(np.float64)
    one = f32(1.0)
    # a product of two f32 is exact in f64: one rounding to f32, as an FMA
    tab = np.stack([v, v * (one - s), v * (1.0 - s64 * h64).astype(f32),
                    v * (1.0 - s64 * (one - h).astype(np.float64)
                         ).astype(f32)], axis=-1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1) * f32(255.0)
    vector = hsv.shape[1] // _HSV_BLOCK * _HSV_BLOCK
    out = np.empty(bgr.shape, np.uint8)
    out[:, :vector] = np.clip(np.trunc(bgr[:, :vector]), 0, 255)
    out[:, vector:] = np.clip(np.rint(bgr[:, vector:]), 0, 255)
    return np.ascontiguousarray(out[..., ::-1])


# ------------------------------------------------- morphology, median

def ellipse_kernel(size: int) -> np.ndarray:
    """``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size))``:
    row i spans c -/+ dx with r = size // 2, c = size // 2 and dx =
    saturate_cast<int>(c * sqrt((r^2 - dy^2) / r^2)), dy = i - r."""
    if size < 1:
        raise ValueError(f"kernel size must be positive, got {size}")
    r = c = size // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    kernel = np.zeros((size, size), np.uint8)
    for i in range(size):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * math.sqrt((r * r - dy * dy) * inv_r2)))
            kernel[i, max(c - dx, 0):min(c + dx + 1, size)] = 1
    return kernel


def _window_reduce(img: np.ndarray, left: int, right: int, reduce,
                   outside: int) -> np.ndarray:
    """out[:, x] = ``reduce`` (np.minimum or np.maximum) of img[:, x + left
    .. x + right] over the columns inside the image, by doubling windows;
    ``outside`` fills the columns past the edges and never wins."""
    height, width = img.shape[:2]
    span = right - left + 1
    # column j of ``padded`` holds image column j + left
    padded = np.full((height, width + span - 1) + img.shape[2:], outside,
                     np.uint8)
    lo, hi = max(0, left), min(width, width + right)
    if hi > lo:
        padded[:, lo - left:hi - left] = img[:, lo:hi]
    n = padded.shape[1]
    covered = 1
    while covered < span:
        step = min(covered, span - covered)
        padded[:, :n - step] = reduce(padded[:, :n - step], padded[:, step:])
        covered += step
    return padded[:, :width]


def _morphology(img: np.ndarray, kernel: np.ndarray, reduce, outside: int,
                name: str) -> np.ndarray:
    """``reduce`` over the kernel's support of each pixel: out(y, x) =
    reduce of img(y + i - kh // 2, x + j - kw // 2) over the kernel's ones
    (i, j), OpenCV's convention for erode and dilate alike (the kernel is not
    mirrored, so an even kernel's anchor sits past its centre)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected a uint8 [H, W] or [H, W, C] image, got "
                         f"{img.dtype} {img.shape}")
    kernel = np.asarray(kernel) != 0
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    height = img.shape[0]
    out = np.full(img.shape, outside, np.uint8)
    rows_by_run = {}
    for i in range(kh):
        cols = np.flatnonzero(kernel[i])
        if not len(cols):
            continue
        if cols[-1] - cols[0] + 1 != len(cols):
            raise ValueError(f"{name} takes kernels whose rows are runs")
        run = (int(cols[0]) - ax, int(cols[-1]) - ax)
        if run not in rows_by_run:
            rows_by_run[run] = _window_reduce(img, *run, reduce, outside)
        shifted = rows_by_run[run]
        dy = i - ay
        lo, hi = max(0, -dy), min(height, height - dy)
        if hi > lo:
            reduce(out[lo:hi], shifted[lo + dy:hi + dy], out=out[lo:hi])
    return out


def erode(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.erode(img, kernel)`` for uint8 [H, W] or [H, W, C], the anchor
    at ``(kh // 2, kw // 2)`` and OpenCV's default border (pixels outside the
    image never win the minimum). Each kernel row must be one run of ones,
    as ``ellipse_kernel``'s are."""
    return _morphology(img, kernel, np.minimum, 255, "erode")


def dilate(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.dilate(img, kernel)``: as ``erode`` with the maximum (pixels
    outside the image never win it)."""
    return _morphology(img, kernel, np.maximum, 0, "dilate")


def morph_close(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.morphologyEx(img, cv2.MORPH_CLOSE, kernel)``."""
    return erode(dilate(img, kernel), kernel)


def morph_open(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.morphologyEx(img, cv2.MORPH_OPEN, kernel)``."""
    return dilate(erode(img, kernel), kernel)


def median_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.medianBlur(img, ksize)`` for uint8 [H, W] or [H, W, C], ksize
    odd (3 to 255): the exact median of each ksize x ksize window, border
    replicated, each channel on its own. In the native library (a sliding
    histogram) where it builds, else in numpy."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected a uint8 [H, W] or [H, W, C] image, got "
                         f"{img.dtype} {img.shape}")
    if ksize % 2 == 0 or not 1 < ksize < 256:
        raise ValueError(f"median ksize must be odd and in 3..255, got "
                         f"{ksize}")
    if native.available():
        return native.median_u8(img, ksize)
    return _median_numpy(img, ksize)


def median_route() -> str:
    """The route of the training data's median targets (``train/dataset.py``):
    ``"cuda"`` where the process sees a card (kernel K4, ``ops/median.py``,
    a batch a launch), else ``median_blur``'s, a crop at a time: ``"native"``
    where the native library builds, else ``"numpy"``. A child forked after
    its parent used the card cannot use it, and takes the host's route."""
    import torch

    if not torch.cuda._is_in_bad_fork() and torch.cuda.is_available():
        return "cuda"
    return "native" if native.available() else "numpy"


def _median_numpy(img: np.ndarray, ksize: int) -> np.ndarray:
    """The exact median by partitioning each window, a band of rows at a
    time."""
    r = ksize // 2
    planes = img[..., None] if img.ndim == 2 else img
    padded = np.pad(planes, ((r, r), (r, r), (0, 0)), mode="edge")
    out = np.empty(planes.shape, np.uint8)
    middle = ksize * ksize // 2
    band = max(1, (1 << 22) // (planes.shape[1] * ksize * ksize * planes.shape[2]))
    for y0 in range(0, planes.shape[0], band):
        y1 = min(planes.shape[0], y0 + band)
        windows = np.lib.stride_tricks.sliding_window_view(
            padded[y0:y1 + 2 * r], (ksize, ksize), axis=(0, 1))
        flat = windows.reshape(*windows.shape[:3], ksize * ksize)
        out[y0:y1] = np.partition(flat, middle, axis=-1)[..., middle]
    return out[..., 0] if img.ndim == 2 else out


# ------------------------------------------------------------ polygon fill

_XY_SHIFT = 16
_PAST_RIGHT = 1 << 62   # the x of an edge that does not span the row


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on integer points: returns (inside, x1, y1,
    x2, y2), the points moved onto the image's edges by its truncating
    double arithmetic (also when the segment misses the image)."""
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _outside(width: int, height: int, x1: int, y1: int, x2: int,
             y2: int) -> bool:
    return not (0 <= x1 < width and 0 <= x2 < width and 0 <= y1 < height
                and 0 <= y2 < height)


def _line(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
          color) -> None:
    """OpenCV's 8-connected ``Line`` (its ``LineIterator``, left to
    right, clipped first): one pixel for each step along the major axis,
    and a step along the minor axis where Bresenham's error goes
    negative, which is step k's offset (2 * minor * k + major - 1) //
    (2 * major)."""
    height, width = img.shape[:2]
    if _outside(width, height, x1, y1, x2, y2):
        inside, x1, y1, x2, y2 = _clip_line(width, height, x1, y1, x2, y2)
        if not inside:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = 1 if y2 >= y1 else -1
    major, minor = max(dx, dy), min(dx, dy)
    steps = np.arange(major + 1, dtype=np.int64)
    offsets = (2 * minor * steps + major - 1) // (2 * major) if major else steps
    if dy > dx:
        img[y1 + sy * steps, x1 + offsets] = color
    else:
        img[y1 + sy * offsets, x1 + steps] = color


def fill_poly(img: np.ndarray, pts: np.ndarray, color=255) -> np.ndarray:
    """``cv2.fillPoly(img, [pts], color)`` for one integer polygon [N, 2]
    (x, y) on a uint8 [H, W] or [H, W, C] image, in place; returns img.

    OpenCV draws every edge with its 8-connected line, then fills the rows
    between edges even-odd. Each edge spans its own rows, its x in 16-bit
    fixed point from its upper end, one truncated step a row; a row fills
    from the ceiling of its left x to the floor of its right x. An edge
    with an end outside the image takes its ends' x from the segment
    clipLine leaves of it, and their rows too unless those are level: its
    step and its x at the top row follow that segment. Rows and columns
    outside the image are cut, and a polygon wholly outside fills nothing.
    One and two points draw their outline only."""
    pts = np.asarray(pts).reshape(-1, 2).astype(np.int64)
    height, width = img.shape[:2]
    if len(pts) == 0 or height == 0 or width == 0:
        return img
    edges = []  # (top y, bottom y, x at the top in fixed point, x step)
    x0, y0 = (int(v) for v in pts[-1])
    for x1, y1 in ((int(x), int(y)) for x, y in pts):
        _line(img, x0, y0, x1, y1, color)
        c0 = [x0 << _XY_SHIFT, y0]
        c1 = [x1 << _XY_SHIFT, y1]
        if _outside(width, height, x0, y0, x1, y1):
            _, a, b, c, d = _clip_line(width, height, x0, y0, x1, y1)
            if b != d:
                c0[1], c1[1] = b, d
            c0[0], c1[0] = a << _XY_SHIFT, c << _XY_SHIFT
        if y0 != y1:
            num, den = c1[0] - c0[0], c1[1] - c0[1]
            step = abs(num) // abs(den) * (1 if (num < 0) == (den < 0) else -1)
            top, bottom, c_top = (y0, y1, c0) if y0 < y1 else (y1, y0, c1)
            edges.append((top, bottom, c_top[0] + (top - c_top[1]) * step,
                          step))
        x0, y0 = x1, y1
    if len(edges) < 2:
        return img

    tops, bottoms, xs, steps = (np.array(column, dtype=np.int64)
                                for column in zip(*edges))
    ends = xs + (bottoms - tops) * steps
    if (bottoms.max() < 0 or tops.min() >= height
            or max(xs.max(), ends.max()) < 0
            or min(xs.min(), ends.min()) >= width << _XY_SHIFT):
        return img
    # every edge of a closed polygon that spans row y ([top, bottom))
    # advances once a row, so its x there is exact: top x + (y - top) * step
    rows = np.arange(max(0, int(tops.min())),
                     min(height, int(bottoms.max())), dtype=np.int64)
    if not len(rows):
        return img
    live = (rows[:, None] >= tops) & (rows[:, None] < bottoms)
    at_row = xs + (rows[:, None] - tops) * steps
    at_row = np.where(live, at_row, _PAST_RIGHT)
    if len(edges) % 2:
        at_row = np.pad(at_row, ((0, 0), (0, 1)), constant_values=_PAST_RIGHT)
    at_row.sort(axis=1)
    pairs = live.sum(axis=1)[:, None] > np.arange(0, at_row.shape[1], 2)
    left = (at_row[:, 0::2] + (1 << _XY_SHIFT) - 1) >> _XY_SHIFT
    right = at_row[:, 1::2] >> _XY_SHIFT
    pairs &= (left < width) & (right >= 0)
    row_of, k = np.nonzero(pairs)
    runs = np.zeros((len(rows), width + 1), np.int32)
    np.add.at(runs, (row_of, np.clip(left[row_of, k], 0, None)), 1)
    np.add.at(runs, (row_of, np.clip(right[row_of, k], None, width - 1) + 1),
              -1)
    filled = np.cumsum(runs[:, :width], axis=1) > 0
    img[rows[0]:rows[-1] + 1][filled] = color
    return img


# ----------------------------------------------------------------- drawing

_XY_ONE = 1 << _XY_SHIFT


def _color_value(img: np.ndarray, color):
    """OpenCV's ``scalarToRawData``: one value for each channel, the
    scalar's missing channels 0, each rounded half to even and saturated
    to the image's integer type."""
    channels = img.shape[2] if img.ndim == 3 else 1
    values = np.zeros(channels, np.float64)
    given = np.atleast_1d(np.asarray(color, np.float64)).ravel()[:channels]
    values[:len(given)] = given
    if img.dtype.kind in "iu":
        info = np.iinfo(img.dtype)
        values = np.clip(np.rint(values), info.min, info.max)
    values = values.astype(img.dtype)
    return values if img.ndim == 3 else values[0]


def _fill_circle(img: np.ndarray, cx: int, cy: int, radius: int,
                 color) -> None:
    """OpenCV's integer ``Circle`` with ``fill``: Bresenham's octant walk,
    a row span for each of its four mirrored rows a step, clipped."""
    height, width = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    spans = []
    while dx >= dy:
        spans += [(cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                  (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)]
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    for y, x0, x1 in spans:
        if 0 <= y < height and x1 >= 0 and x0 < width:
            img[y, max(x0, 0):min(x1, width - 1) + 1] = color


def _div_trunc(a: int, b: int) -> int:
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _line_fixed(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
                color) -> None:
    """OpenCV's ``Line2``: an 8-connected line between points in 16-bit
    fixed point, clipped to the image there, one pixel a step along the
    major axis with the minor coordinate advanced by a truncated fixed
    step, plus the rounded end point."""
    height, width = img.shape[:2]
    inside, x1, y1, x2, y2 = _clip_line(width << _XY_SHIFT,
                                        height << _XY_SHIFT, x1, y1, x2, y2)
    if not inside:
        return
    x_major = abs(x2 - x1) > abs(y2 - y1)
    if (x2 < x1) if x_major else (y2 < y1):
        x1, y1, x2, y2 = x2, y2, x1, y1
    half = _XY_ONE >> 1
    if x_major:
        step = _div_trunc((y2 - y1) << _XY_SHIFT, (x2 - x1) | 1)
        count = (x2 - x1) >> _XY_SHIFT
    else:
        step = _div_trunc((x2 - x1) << _XY_SHIFT, (y2 - y1) | 1)
        count = (y2 - y1) >> _XY_SHIFT
    k = np.arange(count + 1, dtype=np.int64)
    if x_major:
        xs = ((x1 + half) >> _XY_SHIFT) + k
        ys = (y1 + half + k * step) >> _XY_SHIFT
    else:
        xs = (x1 + half + k * step) >> _XY_SHIFT
        ys = ((y1 + half) >> _XY_SHIFT) + k
    xs = np.append(xs, (x2 + half) >> _XY_SHIFT)
    ys = np.append(ys, (y2 + half) >> _XY_SHIFT)
    keep = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
    img[ys[keep], xs[keep]] = color


def _fill_convex_fixed(img: np.ndarray, pts, color) -> None:
    """OpenCV's ``FillConvexPoly`` with ``shift=16`` and ``LINE_8``: the
    outline by ``_line_fixed``, then one span a row between a left and a
    right edge walked down from the topmost vertex, each edge's x stepped
    by its rounded fixed-point slope from the row it starts on."""
    height, width = img.shape[:2]
    count = len(pts)
    half = _XY_ONE >> 1
    x0, y0 = pts[-1]
    for x1, y1 in pts:
        _line_fixed(img, x0, y0, x1, y1, color)
        x0, y0 = x1, y1
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    top = ys.index(min(ys))
    y_min = (min(ys) + half) >> _XY_SHIFT
    y_max = (max(ys) + half) >> _XY_SHIFT
    if (count < 3 or (max(xs) + half) >> _XY_SHIFT < 0 or y_max < 0
            or (min(xs) + half) >> _XY_SHIFT >= width or y_min >= height):
        return
    y_max = min(y_max, height - 1)
    # each edge: [vertex index, index step, x, x step, row it ends on]
    edges = [[top, 1, -_XY_ONE, 0, y_min], [top, count - 1, -_XY_ONE, 0, y_min]]
    left = count
    y = y_min
    while True:
        for edge in edges:
            if y < edge[4]:
                continue
            start, di = edge[0], edge[1]
            idx = (start + di) % count
            while left > 0:
                left -= 1
                end_y = (ys[idx] + half) >> _XY_SHIFT
                if end_y > y:
                    edge[:] = [idx, di, xs[start], _div_trunc(
                        (xs[idx] - xs[start]) * 2 + (end_y - y),
                        2 * (end_y - y)), end_y]
                    break
                start, idx = idx, (idx + di) % count
            else:
                left -= 1
        if left < 0:
            break
        if y >= 0:
            a, b = sorted((edges[0][2], edges[1][2]))
            x_left, x_right = (a + half) >> _XY_SHIFT, (b + half) >> _XY_SHIFT
            if x_right >= 0 and x_left < width:
                img[y, max(x_left, 0):min(x_right, width - 1) + 1] = color
        edges[0][2] += edges[0][3]
        edges[1][2] += edges[1][3]
        y += 1
        if y > y_max:
            break


def _thick_line(img: np.ndarray, p0, p1, color, thickness: int,
                caps: int) -> None:
    """OpenCV's ``ThickLine`` for integer points and ``LINE_8``: thickness
    1 is the 8-connected ``_line``; a thicker line is first clipped to the
    image grown by the thickness on every side, then drawn as the quad of
    its two ends offset by half the thickness across it (in fixed point,
    rounded), with a filled circle of radius (thickness + 1) // 2 at the
    ends that ``caps`` names (bit 0 the first, bit 1 the second)."""
    x0, y0 = int(p0[0]), int(p0[1])
    x1, y1 = int(p1[0]), int(p1[1])
    if thickness <= 1:
        _line(img, x0, y0, x1, y1, color)
        return
    height, width = img.shape[:2]
    inside, x0, y0, x1, y1 = _clip_line(
        width + 2 * thickness, height + 2 * thickness, x0 + thickness,
        y0 + thickness, x1 + thickness, y1 + thickness)
    if not inside:
        return
    x0, y0, x1, y1 = (v - thickness for v in (x0, y0, x1, y1))
    fx0, fy0, fx1, fy1 = (v << _XY_SHIFT for v in (x0, y0, x1, y1))
    dx = (fx0 - fx1) / _XY_ONE
    dy = (fy1 - fy0) / _XY_ONE
    r = dx * dx + dy * dy
    half_width = thickness << (_XY_SHIFT - 1)
    if abs(r) > _DBL_EPSILON:
        r = (half_width + (thickness & 1) * _XY_ONE * 0.5) / math.sqrt(r)
        ox, oy = round(dy * r), round(dx * r)
        _fill_convex_fixed(img, [(fx0 + ox, fy0 + oy), (fx0 - ox, fy0 - oy),
                                 (fx1 - ox, fy1 - oy), (fx1 + ox, fy1 + oy)],
                           color)
    radius = (half_width + (_XY_ONE >> 1)) >> _XY_SHIFT
    for bit, (cx, cy) in ((1, (x0, y0)), (2, (x1, y1))):
        if caps & bit:
            _fill_circle(img, cx, cy, radius, color)


def line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, p0, p1, color, thickness)`` (``LINE_8``, integer
    points) on an [H, W] or [H, W, C] image of any integer type, in place;
    returns img. Both ends get their round cap."""
    _thick_line(img, p0, p1, _color_value(img, color), int(thickness), 3)
    return img


def polylines(img: np.ndarray, polygons, closed: bool, color,
              thickness: int = 1) -> np.ndarray:
    """``cv2.polylines(img, polygons, closed, color, thickness)``: each
    polygon's points ([N, 2] or [N, 1, 2]) joined by ``line``'s segments,
    the last back to the first where ``closed``. A segment caps its end
    only, and an open polyline's first segment its start too, as OpenCV's
    ``PolyLine`` does."""
    value = _color_value(img, color)
    for points in polygons:
        points = np.asarray(points).reshape(-1, 2).astype(np.int64)
        if not len(points):
            continue
        start = points[-1] if closed else points[0]
        caps = 2 if closed else 3
        for point in points[0 if closed else 1:]:
            _thick_line(img, start, point, value, int(thickness), caps)
            start, caps = point, 2
    return img


def rectangle(img: np.ndarray, p0, p1, color,
              thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle(img, p0, p1, color, thickness)`` for thickness >= 1:
    the closed polyline through the four corners from p0."""
    (x0, y0), (x1, y1) = p0, p1
    return polylines(img, [[(x0, y0), (x1, y0), (x1, y1), (x0, y1)]], True,
                     color, thickness)


def circle(img: np.ndarray, center, radius: int, color,
           thickness: int = -1) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, -1)``: the filled circle of
    OpenCV's integer ``Circle`` (``LINE_8``, ``shift=0``), clipped. Only
    the filled form is provided."""
    if thickness >= 0:
        raise ValueError(f"circle draws filled circles only (thickness < "
                         f"0), got thickness {thickness}")
    if radius < 0:
        raise ValueError(f"circle radius must be >= 0, got {radius}")
    _fill_circle(img, int(center[0]), int(center[1]), int(radius),
                 _color_value(img, color))
    return img


def threshold_otsu(gray: np.ndarray) -> float:
    """The threshold ``cv2.threshold(gray, 0, 255, cv2.THRESH_BINARY |
    cv2.THRESH_OTSU)`` returns for a uint8 image (any strides): OpenCV's
    ``getThreshVal_Otsu`` over the 256-bin histogram, in double, the first
    level of the largest between-class variance; 0 for a flat image."""
    gray = np.asarray(gray)
    if gray.dtype != np.uint8 or gray.size == 0:
        raise ValueError(f"threshold_otsu takes a non-empty uint8 image, "
                         f"got {gray.dtype} {gray.shape}")
    hist = np.bincount(gray.ravel(), minlength=256).tolist()
    scale = 1.0 / gray.size
    mu = 0.0
    for level, count in enumerate(hist):
        mu += level * float(count)
    mu *= scale
    mu1 = q1 = max_sigma = 0.0
    best = 0
    for level, count in enumerate(hist):
        p = count * scale
        mu1 *= q1
        q1 += p
        q2 = 1.0 - q1
        if min(q1, q2) < _FLT_EPSILON or max(q1, q2) > 1.0 - _FLT_EPSILON:
            continue
        mu1 = (mu1 + level * p) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, best = sigma, level
    return float(best)


# -------------------------------------------------------------- homography

# the spread under which OpenCV's homography kernel gives up (DBL_EPSILON),
# and the weight under which perspectiveTransform gives (0, 0) (FLT_EPSILON)
_DBL_EPSILON = float(np.finfo(np.float64).eps)
_FLT_EPSILON = float(np.finfo(np.float32).eps)
# the pixels a vector step of OpenCV's float warp covers (its AVX2 build: two
# registers of 8 floats); the row's remainder goes through its scalar loop
_WARP_STEP = 16


def find_homography(src: np.ndarray, dst: np.ndarray):
    """``cv2.findHomography(src, dst)`` (method 0) for 4 point pairs: the
    points rounded to float32, each set centred on its mean and scaled by
    its mean absolute deviation, the eigenvector of the smallest eigenvalue
    of the 9x9 normal matrix, denormalized and scaled to H[2, 2] = 1. With 4
    points the solution is exact, so it agrees with OpenCV's Jacobi
    eigensolver to rounding. Returns a float64 [3, 3], or None where a set
    has no spread in x or y (OpenCV returns an empty matrix)."""
    src = np.asarray(src, np.float32).reshape(-1, 2).astype(np.float64)
    dst = np.asarray(dst, np.float32).reshape(-1, 2).astype(np.float64)
    if len(src) != 4 or len(dst) != 4:
        raise ValueError(f"find_homography takes 4 point pairs, got "
                         f"{len(src)} and {len(dst)}")
    count = len(src)
    c_src, c_dst = src.mean(axis=0), dst.mean(axis=0)
    s_src = np.abs(src - c_src).sum(axis=0)
    s_dst = np.abs(dst - c_dst).sum(axis=0)
    if (np.abs(s_src) < _DBL_EPSILON).any() or \
            (np.abs(s_dst) < _DBL_EPSILON).any():
        return None
    s_src, s_dst = count / s_src, count / s_dst
    inv_norm_dst = np.array([[1.0 / s_dst[0], 0.0, c_dst[0]],
                             [0.0, 1.0 / s_dst[1], c_dst[1]],
                             [0.0, 0.0, 1.0]])
    norm_src = np.array([[s_src[0], 0.0, -c_src[0] * s_src[0]],
                         [0.0, s_src[1], -c_src[1] * s_src[1]],
                         [0.0, 0.0, 1.0]])
    X, Y = ((src - c_src) * s_src).T
    x, y = ((dst - c_dst) * s_dst).T
    zero, one = np.zeros(count), np.ones(count)
    rows_x = np.stack([X, Y, one, zero, zero, zero, -x * X, -x * Y, -x], 1)
    rows_y = np.stack([zero, zero, zero, X, Y, one, -y * X, -y * Y, -y], 1)
    normal = rows_x.T @ rows_x + rows_y.T @ rows_y
    _, vectors = np.linalg.eigh(normal)
    h = inv_norm_dst @ vectors[:, 0].reshape(3, 3) @ norm_src
    return h * (1.0 / h[2, 2])


def perspective_transform(points: np.ndarray, H: np.ndarray) -> np.ndarray:
    """``cv2.perspectiveTransform`` of 2-D points ([N, 2] or [N, 1, 2],
    same shape back) by a 3x3 matrix, in float64: each point times the
    reciprocal of its weight, (0, 0) where the weight is within FLT_EPSILON
    of 0."""
    points = np.asarray(points, np.float64)
    m = np.asarray(H, np.float64).reshape(9)
    x, y = points.reshape(-1, 2).T
    w = x * m[6] + y * m[7] + m[8]
    live = np.abs(w) > _FLT_EPSILON
    w = np.divide(1.0, w, out=np.zeros_like(w), where=live)
    out = np.stack([(x * m[0] + y * m[1] + m[2]) * w,
                    (x * m[3] + y * m[4] + m[5]) * w], axis=1)
    out[~live] = 0.0
    return out.reshape(points.shape)


def _invert3(m: np.ndarray) -> np.ndarray:
    """``cv::invert`` of a 3x3 double matrix (DECOMP_LU): the adjugate over
    the determinant, in OpenCV's order of operations; zeros if singular."""
    det = (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
           - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
           + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))
    if det == 0:
        return np.zeros((3, 3))
    d = 1.0 / det
    return np.array([
        [(m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]) * d,
         (m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]) * d,
         (m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]) * d],
        [(m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]) * d,
         (m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]) * d,
         (m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]) * d],
        [(m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]) * d,
         (m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]) * d,
         (m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]) * d]])


def _fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once to float32, for float32 operands (the product
    is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _warp_coords(m: np.ndarray, width: int, height: int):
    """Source x and y of every destination pixel, as OpenCV's float warp
    computes them from the inverse map ``m`` (float32 [3, 3]): a vector
    step takes x * m0 + (y * m1 + m2) fused, the remainder of the row
    x * m0 + y * m1 fused, plus m2; then the quotient by the weight."""
    xs = np.arange(width, dtype=np.float32)[None, :]
    ys = np.arange(height, dtype=np.float32)[:, None]
    vector = xs < width - width % _WARP_STEP

    def row(r):
        return np.where(vector, _fma(xs, m[r, 0], ys * m[r, 1] + m[r, 2]),
                        _fma(xs, m[r, 0], ys * m[r, 1]) + m[r, 2])

    weight = row(2)
    with np.errstate(divide="ignore", invalid="ignore"):
        return row(0) / weight, row(1) / weight


def warp_perspective(img: np.ndarray, H: np.ndarray, size: Tuple[int, int],
                     border_value=0, interpolation: str = "linear"
                     ) -> np.ndarray:
    """``cv2.warpPerspective(img, H, size, borderValue=border_value)``
    (INTER_LINEAR, BORDER_CONSTANT) of a uint8 [H, W] or [H, W, C] image,
    as OpenCV 5.0 (and 4.11 on) warps one: H inverted by ``cv::invert``,
    the map in float32, each destination pixel's source point by
    ``_warp_coords``, its floor and fraction, the four neighbours (the
    border value off the image) blended by fused steps along x, then y,
    and rounded half to even. Bit for bit with OpenCV's x86 AVX2 build.

    With ``interpolation="nearest"`` it is ``cv2.INTER_NEAREST`` on an
    integer image of any type (``_warp_nearest``)."""
    img = np.asarray(img)
    if interpolation == "nearest":
        return _warp_nearest(img, H, size, border_value)
    if interpolation != "linear":
        raise ValueError(f"interpolation must be 'linear' or 'nearest', got "
                         f"{interpolation!r}")
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected a uint8 [H, W] or [H, W, C] image, got "
                         f"{img.dtype} {img.shape}")
    width, height = (int(v) for v in size)
    src_h, src_w = img.shape[:2]
    out_shape = (height, width) + img.shape[2:]
    if width <= 0 or height <= 0:
        return np.zeros(out_shape, np.uint8)
    m = _invert3(np.asarray(H, np.float64).reshape(3, 3)).astype(np.float32)
    sx, sy = _warp_coords(m, width, height)
    with np.errstate(invalid="ignore"):
        fx, fy = np.floor(sx), np.floor(sy)
        off = ~((fx >= -1) & (fx < src_w) & (fy >= -1) & (fy < src_h))
    # a pixel off the image blends four border pixels of the padding
    ax = np.where(off, 0, sx - fx).astype(np.float32)
    ay = np.where(off, 0, sy - fy).astype(np.float32)
    ix = np.where(off, src_w, fx).astype(np.int64) + 1
    iy = np.where(off, src_h, fy).astype(np.int64) + 1
    pad = ((1, 2), (1, 2)) + ((0, 0),) * (img.ndim - 2)
    padded = np.pad(img, pad, constant_values=np.uint8(border_value)
                    ).astype(np.float32)
    if img.ndim == 3:
        ax, ay = ax[..., None], ay[..., None]
    p00, p01 = padded[iy, ix], padded[iy, ix + 1]
    p10, p11 = padded[iy + 1, ix], padded[iy + 1, ix + 1]
    top = _fma(ax, p01 - p00, p00)
    bottom = _fma(ax, p11 - p10, p10)
    value = _fma(ay, bottom - top, top)
    return np.clip(np.rint(value), 0, 255).astype(np.uint8).reshape(out_shape)


# the block OpenCV's warp maps at a time (BLOCK_SZ = 32: 16 rows of 64)
_WARP_BLOCK = 32
_INT_MIN, _INT_MAX = -2 ** 31, 2 ** 31 - 1


def _nearest_coords_double(m: np.ndarray, width: int, height: int):
    """Source pixel of every destination pixel as OpenCV's generic warp
    finds it: for each block of the map, the row's numerators and weight
    at the block's first column in double, plus the matrix column times
    the offset in the block; the weight's reciprocal (0 for a weight of 0)
    times each numerator, clamped to int and rounded half to even
    (``saturate_cast<int>``), then saturated to short."""
    m = m.reshape(9)
    rows = min(_WARP_BLOCK // 2, height)
    cols = min(_WARP_BLOCK * _WARP_BLOCK // rows, width)
    xs = np.arange(width)
    first = (xs // cols * cols).astype(np.float64)[None, :]
    offset = (xs % cols).astype(np.float64)[None, :]
    ys = np.arange(height, dtype=np.float64)[:, None]
    x0 = m[0] * first + m[1] * ys + m[2]
    y0 = m[3] * first + m[4] * ys + m[5]
    w = m[6] * first + m[7] * ys + m[8] + m[6] * offset
    live = w != 0
    w = np.divide(1.0, w, out=np.zeros_like(w), where=live)
    out = []
    for numerator, column in ((x0, m[0]), (y0, m[3])):
        value = np.clip((numerator + column * offset) * w, _INT_MIN, _INT_MAX)
        out.append(np.clip(np.rint(value), -32768, 32767).astype(np.int64))
    return out


def _warp_nearest(img: np.ndarray, H: np.ndarray, size: Tuple[int, int],
                  border_value=0) -> np.ndarray:
    """``cv2.warpPerspective(img, H, size, flags=cv2.INTER_NEAREST,
    borderValue=border_value)`` (BORDER_CONSTANT) of an integer [H, W] or
    [H, W, C] image. OpenCV 5.0 maps uint8 and uint16 images by its float
    warp: ``_warp_coords`` rounded half to even. Every other type goes
    through its generic map (``_nearest_coords_double``). A destination
    pixel whose source pixel lies off the image takes the border value."""
    if img.dtype.kind not in "iu" or img.ndim not in (2, 3):
        raise ValueError(f"expected an integer [H, W] or [H, W, C] image, "
                         f"got {img.dtype} {img.shape}")
    width, height = (int(v) for v in size)
    src_h, src_w = img.shape[:2]
    out = np.empty((max(height, 0), max(width, 0)) + img.shape[2:], img.dtype)
    out[...] = _color_value(img, border_value)
    if width <= 0 or height <= 0:
        return out
    m = _invert3(np.asarray(H, np.float64).reshape(3, 3))
    if img.dtype in (np.uint8, np.uint16):
        sx, sy = _warp_coords(m.astype(np.float32), width, height)
        with np.errstate(invalid="ignore"):
            sx, sy = np.rint(sx), np.rint(sy)
            keep = (sx >= 0) & (sx < src_w) & (sy >= 0) & (sy < src_h)
        sx = np.where(keep, sx, 0).astype(np.int64)
        sy = np.where(keep, sy, 0).astype(np.int64)
    else:
        sx, sy = _nearest_coords_double(m, width, height)
        keep = (sx >= 0) & (sx < src_w) & (sy >= 0) & (sy < src_h)
    out[keep] = img[sy[keep], sx[keep]]
    return out
