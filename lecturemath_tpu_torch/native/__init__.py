"""ctypes bindings for the native C++ runtime kernels (lecturemath_native.cpp).

The library is built on demand with g++ (cached next to the source); every
entry point has a pure-Python fallback elsewhere in the package, so the
framework works without a compiler — just slower on the host-side CC path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_THIS_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_THIS_DIR, "lecturemath_native.cpp")
_LIB_PATH = os.path.join(_THIS_DIR, "liblecturemath_native.so")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_load_lock = threading.Lock()


def build(force: bool = False) -> str:
    """Compile the native library (g++ -O3); returns the .so path. The
    library is written under a name of this process's own and then renamed
    into place, so processes building at once never load a partial file."""
    if force or not os.path.exists(_LIB_PATH) or (
            os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
        partial = f"{_LIB_PATH}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
             "-o", partial], check=True)
        os.replace(partial, _LIB_PATH)
    return _LIB_PATH


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed); returns None when unavailable. Safe to
    call from several threads at once."""
    with _load_lock:
        return _load()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = ctypes.CDLL(build())
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        _load_failed = True
        return None

    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)

    lib.cc_runs_label.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32, f32p,
                                  ctypes.c_int32, ctypes.c_int32, i64p]
    lib.cc_runs_label.restype = ctypes.c_void_p
    lib.cc_runs_take.argtypes = [ctypes.c_void_p, i32p, f32p, u8p]
    lib.cc_runs_take.restype = None

    lib.batch_mask_overlap.argtypes = [u8p, i64p, i32p, u8p, i64p, i32p,
                                       i32p, ctypes.c_int64, i64p]
    lib.batch_mask_overlap.restype = None

    lib.render_masks.argtypes = [u8p, i64p, i32p, ctypes.c_int32, u8p,
                                 ctypes.c_int32, ctypes.c_int32]
    lib.render_masks.restype = None

    lib.png_unfilter.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32,
                                 ctypes.c_int32, u8p]
    lib.png_unfilter.restype = ctypes.c_int32

    lib.resample_u8.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32,
                                ctypes.c_int64, i64p, i32p, ctypes.c_int32,
                                ctypes.c_int32, ctypes.c_int32, u8p]
    lib.resample_u8.restype = None

    lib.median_u8.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32,
                              ctypes.c_int32, ctypes.c_int32, u8p]
    lib.median_u8.restype = None

    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


# ------------------------------------------------------------------ wrappers

def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def label_runs(binary: np.ndarray, ages: Optional[np.ndarray] = None,
               min_pixels: int = 0, max_components: int = 1 << 16):
    """Connected components (4-connectivity) of a binary frame, labelled by
    its runs of ink, with each kept component's crop, in one native call.

    Returns (components found, runs found, stats int32 [n, 5] = min_x,
    max_x, min_y, max_y, size of the first n = min(found, max_components)
    components in scipy.ndimage.label's order, their min ages float32 [n]
    (None without ``ages``), crops uint8: the 0/255 crop of each of those n
    with at least ``min_pixels`` pixels, row-major, packed in order). Makes
    no frame-sized buffer and keeps no state; releases the interpreter lock.
    """
    lib = get_lib()
    assert lib is not None, "native library unavailable"
    binary = np.ascontiguousarray(binary, dtype=np.uint8)
    if binary.ndim != 2:
        raise ValueError(f"binary frame must be 2-D, got {binary.shape}")
    h, w = binary.shape
    if ages is not None:
        ages = np.ascontiguousarray(ages, dtype=np.float32)
        if ages.shape != binary.shape:
            raise ValueError(f"ages {ages.shape} differ from the frame's "
                             f"{binary.shape}")
        ages_ptr = _ptr(ages, ctypes.c_float)
    else:
        ages_ptr = None

    info = np.empty(4, dtype=np.int64)
    result = lib.cc_runs_label(_ptr(binary, ctypes.c_uint8), h, w, ages_ptr,
                               max_components, min_pixels,
                               _ptr(info, ctypes.c_int64))
    if not result:
        raise MemoryError("native CC labeling ran out of memory")
    n_found, n_runs, n_stored, crop_bytes = info.tolist()
    try:
        stats = np.empty((n_stored, 5), dtype=np.int32)
        min_ages = (np.empty(n_stored, dtype=np.float32)
                    if ages is not None else None)
        crops = np.empty(crop_bytes, dtype=np.uint8)
    except MemoryError:
        lib.cc_runs_take(result, None, None, None)
        raise
    lib.cc_runs_take(result, _ptr(stats, ctypes.c_int32),
                     None if min_ages is None else _ptr(min_ages, ctypes.c_float),
                     _ptr(crops, ctypes.c_uint8))
    return n_found, n_runs, stats, min_ages, crops


class PackedMasks:
    """CC mask crops packed into one buffer for native batch calls."""

    def __init__(self, ccs: Sequence):
        self.n = len(ccs)
        self.boxes = np.array([[cc.min_x, cc.max_x, cc.min_y, cc.max_y]
                               for cc in ccs], dtype=np.int32).reshape(-1, 4)
        sizes = [cc.img.size for cc in ccs]
        self.offsets = np.zeros(self.n, dtype=np.int64)
        if self.n:
            self.offsets[1:] = np.cumsum(sizes[:-1])
        total = int(sum(sizes))
        self.data = np.empty(total, dtype=np.uint8)
        for offset, cc in zip(self.offsets, ccs):
            flat = np.ascontiguousarray(cc.img, dtype=np.uint8).reshape(-1)
            self.data[offset:offset + flat.size] = flat


def batch_overlap(packed_a: PackedMasks, packed_b: PackedMasks,
                  pairs: np.ndarray) -> np.ndarray:
    """Matched-pixel counts (int64 [P]) for candidate index pairs."""
    lib = get_lib()
    assert lib is not None, "native library unavailable"
    pairs = np.ascontiguousarray(pairs, dtype=np.int32).reshape(-1, 2)
    out = np.empty(len(pairs), dtype=np.int64)
    lib.batch_mask_overlap(
        _ptr(packed_a.data, ctypes.c_uint8), _ptr(packed_a.offsets, ctypes.c_int64),
        _ptr(packed_a.boxes, ctypes.c_int32),
        _ptr(packed_b.data, ctypes.c_uint8), _ptr(packed_b.offsets, ctypes.c_int64),
        _ptr(packed_b.boxes, ctypes.c_int32),
        _ptr(pairs, ctypes.c_int32), len(pairs),
        _ptr(out, ctypes.c_int64))
    return out


def render_masks(packed: PackedMasks, height: int, width: int) -> np.ndarray:
    lib = get_lib()
    assert lib is not None, "native library unavailable"
    frame = np.zeros((height, width), dtype=np.uint8)
    lib.render_masks(_ptr(packed.data, ctypes.c_uint8),
                     _ptr(packed.offsets, ctypes.c_int64),
                     _ptr(packed.boxes, ctypes.c_int32), packed.n,
                     _ptr(frame, ctypes.c_uint8), height, width)
    return frame


def png_unfilter(raw: np.ndarray, height: int, stride: int,
                 bpp: int) -> Tuple[np.ndarray, int]:
    """Undo the row filters of 8-bit PNG scanlines: ``raw`` is uint8
    height x (1 + stride) bytes. Returns (uint8 [height, stride], the first
    row of an unknown filter type or -1). The call releases the
    interpreter lock."""
    lib = get_lib()
    assert lib is not None, "native library unavailable"
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    out = np.empty((height, stride), dtype=np.uint8)
    bad = lib.png_unfilter(_ptr(raw, ctypes.c_uint8), height, stride, bpp,
                           _ptr(out, ctypes.c_uint8))
    return out, int(bad)


def resample_u8(data: np.ndarray, axis: int, first: np.ndarray,
                weights: np.ndarray, bits: int) -> np.ndarray:
    """One pass of Pillow's fixed-point separable resample of uint8 ``data``
    along ``axis``: output d is the int32 sum, from half a unit, of source
    min(first[d] + k, n - 1) times weights[d, k] (``bits`` fractional bits),
    rounded as Pillow's clip8. Releases the interpreter lock."""
    lib = get_lib()
    assert lib is not None, "native library unavailable"
    data = np.ascontiguousarray(data, dtype=np.uint8)
    first = np.ascontiguousarray(first, dtype=np.int64)
    weights = np.ascontiguousarray(weights, dtype=np.int32)
    dst_len, ksize = weights.shape
    outer = int(np.prod(data.shape[:axis], dtype=np.int64))
    inner = int(np.prod(data.shape[axis + 1:], dtype=np.int64))
    out = np.empty(data.shape[:axis] + (dst_len,) + data.shape[axis + 1:],
                   dtype=np.uint8)
    lib.resample_u8(_ptr(data, ctypes.c_uint8), outer, data.shape[axis],
                    inner, _ptr(first, ctypes.c_int64),
                    _ptr(weights, ctypes.c_int32), ksize, dst_len, bits,
                    _ptr(out, ctypes.c_uint8))
    return out


def median_u8(img: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.medianBlur(img, ksize)`` of uint8 [H, W] or [H, W, C] (odd
    ksize, replicated border) by a sliding histogram. Releases the
    interpreter lock."""
    lib = get_lib()
    assert lib is not None, "native library unavailable"
    img = np.ascontiguousarray(img, dtype=np.uint8)
    channels = img.shape[2] if img.ndim == 3 else 1
    out = np.empty_like(img)
    lib.median_u8(_ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1],
                  channels, ksize, _ptr(out, ctypes.c_uint8))
    return out
