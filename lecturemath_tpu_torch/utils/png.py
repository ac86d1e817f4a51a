"""PNG codec in numpy + zlib, byte-identical to ``cv2.imencode(".png", img)``.

The stage artifacts keep PNG-compressed frames (reference:
FCN_lecturenet_binarizer.py:56) and the summary export writes keyframe
PNGs. OpenCV's encoder, with its defaults, runs libpng with row filter Sub on
every row, zlib at ``Z_BEST_SPEED`` with ``Z_RLE``, and 8192-byte IDAT
chunks; this module does the same, so the port's artifacts and keyframes
match the JAX package's byte for byte without OpenCV. (Under ``Z_RLE``, zlib
writes level-flag 0 in the stream header whatever the level.)

``decode_png_gray`` reads 8-bit grayscale, non-interlaced PNGs with any of
the five row filters (another writer's artifact may use Avg or Paeth) and
raises ``PNGFormatError`` on anything else.
"""

from __future__ import annotations

import struct
import zlib
from typing import Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
IDAT_CHUNK = 8192
_COLOR_TYPES = {1: 0, 3: 2}  # channels -> PNG colour type (gray, RGB)
# libpng's default zlib memLevel
_MEM_LEVEL = 8


class PNGFormatError(ValueError):
    """A buffer that is not an 8-bit grayscale, non-interlaced PNG."""


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _window_bits(data_size: int) -> int:
    """libpng's deflate window for the IDAT stream (png_deflate_claim): 15,
    halved while at most 16 KiB of filtered data (+262) fits in half the
    window; never below 9, zlib's least."""
    bits = 15
    if data_size <= 16384:
        half = 1 << (bits - 1)
        while data_size + 262 <= half:
            half >>= 1
            bits -= 1
    return max(bits, 9)


def _optimize_cmf(stream: bytes, data_size: int) -> bytes:
    """libpng's optimize_cmf: for at most 16 KiB of data, the zlib header
    claims the least window (down to 256 bytes) that holds the data, with
    the header check bits recomputed."""
    cmf = stream[0]
    if data_size > 16384 or (cmf & 0x0F) != 8 or (cmf & 0xF0) > 0x70:
        return stream
    cinfo = cmf >> 4
    half = 1 << (cinfo + 7)
    if data_size > half:
        return stream
    while True:
        half >>= 1
        cinfo -= 1
        if not (cinfo > 0 and data_size <= half):
            break
    cmf = (cmf & 0x0F) | (cinfo << 4)
    flg = stream[1] & 0xE0
    flg += 0x1F - ((cmf << 8) + flg) % 0x1F
    return bytes((cmf, flg)) + stream[2:]


def encode_png(img: np.ndarray) -> bytes:
    """Encode an 8-bit gray [H, W] (or [H, W, 1]) or BGR [H, W, 3] image as
    PNG bytes, BGR stored as RGB as OpenCV does."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise PNGFormatError(f"encode_png takes uint8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        channels = 1
    elif img.ndim == 3 and img.shape[2] == 3:
        channels = 3
        img = img[:, :, ::-1]
    else:
        raise PNGFormatError(f"encode_png takes [H, W] gray or [H, W, 3] "
                             f"BGR images, got shape {img.shape}")
    height, width = img.shape[:2]
    if height == 0 or width == 0:
        raise PNGFormatError("encode_png: empty image")
    rows = np.ascontiguousarray(img).reshape(height, width * channels)

    # filter Sub: each byte minus the byte one pixel to its left, mod 256;
    # libpng drops Sub (to None) for an image one pixel wide
    filtered = np.empty((height, width * channels + 1), np.uint8)
    filtered[:, 0] = 1 if width > 1 else 0
    filtered[:, 1:channels + 1] = rows[:, :channels]
    np.subtract(rows[:, channels:], rows[:, :-channels],
                out=filtered[:, channels + 1:])
    raw = filtered.tobytes()

    comp = zlib.compressobj(zlib.Z_BEST_SPEED, zlib.DEFLATED,
                            _window_bits(len(raw)), _MEM_LEVEL, zlib.Z_RLE)
    stream = _optimize_cmf(comp.compress(raw) + comp.flush(), len(raw))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, _COLOR_TYPES[channels],
                       0, 0, 0)
    parts = [SIGNATURE, _chunk(b"IHDR", ihdr)]
    parts += [_chunk(b"IDAT", stream[i:i + IDAT_CHUNK])
              for i in range(0, len(stream), IDAT_CHUNK)]
    parts.append(_chunk(b"IEND", b""))
    return b"".join(parts)


def _unfilter(raw: np.ndarray, height: int, width: int) -> np.ndarray:
    """Undo the per-row filters of 8-bit gray scanlines (1 byte a pixel)."""
    rows = raw.reshape(height, width + 1)
    kinds = rows[:, 0]
    if (kinds == 1).all():  # what OpenCV writes: one cumsum for all rows
        return np.cumsum(rows[:, 1:], axis=1, dtype=np.uint8)
    out = np.empty((height, width), np.uint8)
    prior = np.zeros(width, np.uint8)
    for y in range(height):
        kind = int(rows[y, 0])
        line = rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:
            np.cumsum(line, dtype=np.uint8, out=out[y])
        elif kind == 2:
            np.add(line, prior, out=out[y])
        elif kind == 3:
            left = 0
            recon = out[y]
            for x in range(width):
                left = (int(line[x]) + ((left + int(prior[x])) >> 1)) & 0xFF
                recon[x] = left
        elif kind == 4:
            left = up_left = 0
            recon = out[y]
            for x in range(width):
                up = int(prior[x])
                p = left + up - up_left
                pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
                pred = (left if pa <= pb and pa <= pc
                        else up if pb <= pc else up_left)
                left = (int(line[x]) + pred) & 0xFF
                recon[x] = left
                up_left = up
        else:
            raise PNGFormatError(f"row {y}: unknown PNG filter type {kind}")
        prior = out[y]
    return out


def decode_png_gray(buf: Union[bytes, bytearray, memoryview, np.ndarray]
                    ) -> np.ndarray:
    """Decode an 8-bit grayscale, non-interlaced PNG into uint8 [H, W]."""
    data = (np.ascontiguousarray(buf, dtype=np.uint8).tobytes()
            if isinstance(buf, np.ndarray) else bytes(buf))
    if not data.startswith(SIGNATURE):
        raise PNGFormatError("not a PNG: bad signature")
    pos = len(SIGNATURE)
    header = None
    idat = []
    while True:
        if pos + 8 > len(data):
            raise PNGFormatError("truncated PNG: no IEND chunk")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PNGFormatError(f"truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise PNGFormatError(f"CRC mismatch in PNG chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            if length != 13:
                raise PNGFormatError("bad IHDR length")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind[:1].isupper():
            raise PNGFormatError(f"unsupported critical PNG chunk {kind!r}")
    if header is None:
        raise PNGFormatError("PNG has no IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    if (depth, color) != (8, 0):
        raise PNGFormatError(f"only 8-bit grayscale PNGs are supported (bit "
                             f"depth {depth}, colour type {color})")
    if compression or filter_method or interlace:
        raise PNGFormatError("only non-interlaced PNGs with the standard "
                             "compression and filter methods are supported")
    if width == 0 or height == 0:
        raise PNGFormatError("PNG has an empty image")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise PNGFormatError(f"corrupt PNG image data: {exc}") from None
    if len(raw) != height * (width + 1):
        raise PNGFormatError(f"PNG image data holds {len(raw)} bytes, "
                             f"expected {height * (width + 1)}")
    return _unfilter(np.frombuffer(raw, np.uint8), height, width)
