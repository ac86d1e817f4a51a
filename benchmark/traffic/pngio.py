"""The benchmark's own PNG writer and reader (8-bit gray and RGB), so that
neither the request bodies nor the reading of a reply depend on the
program's codec."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def encode(img: np.ndarray, level: int = 1) -> bytes:
    """uint8 gray [H, W] or RGB [H, W, 3] -> PNG bytes (filter None)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    height, width = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = img.reshape(height, -1)
    raw = np.zeros((height, rows.shape[1] + 1), np.uint8)
    raw[:, 1:] = rows
    header = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def decode(data: bytes) -> np.ndarray:
    """PNG bytes of an 8-bit gray or RGB image, rows filtered None, Sub or
    Up -> uint8 [H, W] or [H, W, 3]."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + length
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in (0, 2) or interlace:
        raise ValueError(f"unsupported PNG: depth {depth} color {color}")
    channels = 1 if color == 0 else 3
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(height, width * channels + 1)
    out = np.empty((height, width * channels), np.uint8)
    previous = np.zeros(width * channels, np.uint8)
    for y in range(height):
        kind, row = raw[y, 0], raw[y, 1:]
        if kind == 0:
            line = row
        elif kind == 1:
            # Sub: a running sum mod 256 over the bytes of each channel
            line = np.cumsum(row.reshape(width, channels), axis=0,
                             dtype=np.uint64).astype(np.uint8).reshape(-1)
        elif kind == 2:
            line = row + previous
        else:
            raise ValueError(f"unsupported PNG row filter {kind}")
        out[y] = line
        previous = out[y]
    return out if channels == 1 else out.reshape(height, width, 3)
