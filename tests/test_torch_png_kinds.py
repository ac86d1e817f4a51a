"""Every kind of the PNG standard through the port's decoders, equal to
``cv2.imdecode`` with IMREAD_COLOR and IMREAD_GRAYSCALE: palette at 1, 2,
4 and 8 bits (tRNS ignored), gray at 1, 2, 4, 8 and 16 bits, gray+alpha,
RGB and RGBA at 8 and 16 bits, each plain and Adam7 interlaced, with every
row filter, through the native unfilter and its Python fallback. The PNGs
are written here, so each kind is made exactly as the standard lays it
out."""

import struct
import subprocess
import sys
import os
import zlib

import cv2
import numpy as np
import pytest

from lecturemath_tpu_torch import native
from lecturemath_tpu_torch.pipeline.server import decode_image
from lecturemath_tpu_torch.utils import png as png_module
from lecturemath_tpu_torch.utils.png import (PNGFormatError, decode_png,
                                             decode_png_color, decode_png_gray,
                                             decode_png_grayscale)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# (colour type, bit depth) of every kind the standard allows
KINDS = ([(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)]
         + [(3, d) for d in (1, 2, 4, 8)] + [(4, 8), (4, 16), (6, 8), (6, 16)])


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _row_bytes(samples, depth):
    """[h, w, c] samples -> the scanlines' bytes (no filter byte)."""
    h = samples.shape[0]
    if depth == 16:
        return [samples[y].astype(">u2").tobytes() for y in range(h)]
    flat = samples.reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return [flat[y].tobytes() for y in range(h)]
    per = 8 // depth
    n = -(-flat.shape[1] // per)
    padded = np.zeros((h, n * per), np.uint8)
    padded[:, :flat.shape[1]] = flat
    padded = padded.reshape(h, n, per)
    packed = np.zeros((h, n), np.uint8)
    for k in range(per):
        packed |= padded[:, :, k] << (8 - depth * (k + 1))
    return [packed[y].tobytes() for y in range(h)]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filtered(rows, bpp, rng):
    """Each scanline behind a random filter type 0-4."""
    out = bytearray()
    prior = bytes(len(rows[0]))
    for row in rows:
        kind = int(rng.integers(0, 5))
        out.append(kind)
        for x, value in enumerate(row):
            a = row[x - bpp] if x >= bpp else 0
            b = prior[x]
            c = prior[x - bpp] if x >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            out.append((value - pred) & 0xFF)
        prior = row
    return bytes(out)


def _png(samples, depth, color, interlace, seed, palette=None, trns=None):
    h, w, c = samples.shape
    bpp = max(1, depth * c // 8)
    rng = np.random.default_rng(seed)
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        part = samples[y0::dy, x0::dx]
        if part.shape[0] and part.shape[1]:
            raw += _filtered(_row_bytes(part, depth), bpp, rng)
    chunks = [_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                          0, interlace))]
    if palette is not None:
        chunks.append(_chunk(b"PLTE", palette.tobytes()))
    if trns is not None:
        chunks.append(_chunk(b"tRNS", trns))
    chunks.append(_chunk(b"IDAT", zlib.compress(raw)))
    return b"\x89PNG\r\n\x1a\n" + b"".join(chunks) + _chunk(b"IEND", b"")


def _case(color, depth, interlace, shape, seed):
    rng = np.random.default_rng(seed)
    h, w = shape
    top = (1 << depth) if color != 3 else min(1 << depth, 200)
    samples = rng.integers(0, top, (h, w, CHANNELS[color]),
                           dtype=np.uint16 if depth == 16 else np.uint8)
    palette = trns = None
    if color == 3:
        # a short palette (index 199 at most): indices past it read black
        palette = rng.integers(0, 256, (min(1 << depth, 180), 3),
                               dtype=np.uint8)
        trns = bytes(range(0, 256, 7))[:len(palette)]
    return _png(samples, depth, color, interlace, seed, palette, trns)


@pytest.fixture(params=["native", "python"])
def native_or_python(request, monkeypatch):
    if request.param == "native":
        assert native.available()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("color,depth", KINDS,
                         ids=[f"type{c}-{d}bit" for c, d in KINDS])
def test_every_kind_equals_cv2(color, depth, interlace, native_or_python):
    for k, shape in enumerate([(1, 1), (3, 5), (9, 17), (21, 33)]):
        buf = _case(color, depth, interlace, shape, seed=k + 10 * depth)
        array = np.frombuffer(buf, np.uint8)
        theirs_color = cv2.imdecode(array, cv2.IMREAD_COLOR)
        theirs_gray = cv2.imdecode(array, cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(decode_png_color(buf),
                                      theirs_color[..., ::-1])
        np.testing.assert_array_equal(decode_png_grayscale(buf), theirs_gray)
        if color in (0, 4):
            np.testing.assert_array_equal(decode_png_gray(buf), theirs_gray)
            np.testing.assert_array_equal(decode_png(buf), theirs_gray)
        else:
            with pytest.raises(PNGFormatError, match="grayscale"):
                decode_png_gray(buf)
            np.testing.assert_array_equal(decode_png(buf),
                                          theirs_color[..., ::-1])


def test_every_colour_to_gray_equals_cv2():
    """IMREAD_GRAYSCALE on all 2^24 colours of an 8-bit RGB PNG (libpng's
    rgb_to_gray in 15-bit fixed point), and a 16-bit RGB PNG's gray."""
    codes = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(codes >> 16) & 255, (codes >> 8) & 255, codes & 255],
                   axis=-1).astype(np.uint8).reshape(4096, 4096, 3)
    ok, buf = cv2.imencode(".png", rgb[..., ::-1])
    assert ok
    np.testing.assert_array_equal(decode_png_grayscale(buf),
                                  cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))
    wide = np.random.default_rng(3).integers(0, 1 << 16, (64, 300, 3),
                                             dtype=np.uint16)
    ok, buf = cv2.imencode(".png", wide)
    np.testing.assert_array_equal(decode_png_grayscale(buf),
                                  cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))


def test_palette_without_plte_is_refused():
    buf = _case(3, 8, 0, (4, 4), seed=1)
    plte = buf.index(b"PLTE") - 4
    length = struct.unpack(">I", buf[plte:plte + 4])[0]
    without = buf[:plte] + buf[plte + 12 + length:]
    with pytest.raises(PNGFormatError, match="PLTE"):
        decode_png_color(without)


_NO_OPENCV = r"""
import sys
for name in ("cv2", "PIL", "PIL.Image"):
    sys.modules[name] = None
sys.path.insert(0, %r)
from lecturemath_tpu_torch.pipeline.server import decode_image
for path in %r:
    print(decode_image(open(path, "rb").read()).tobytes().hex())
try:
    decode_image(b"\xff\xd8\xff\xe0 a jpeg body")
except ValueError as err:
    print("refused:", err)
"""


def test_server_decodes_every_kind_without_opencv(tmp_path):
    """decode_image reads palette, 16-bit, gray+alpha and interlaced bodies
    with cv2 unimportable, equal to cv2.imdecode; a JPEG body is refused
    with an error naming OpenCV."""
    paths, expected = [], []
    for k, (color, depth) in enumerate([(3, 4), (0, 16), (4, 8), (6, 16),
                                        (2, 8)]):
        buf = _case(color, depth, k % 2, (11, 13), seed=k)
        path = tmp_path / f"{k}.png"
        path.write_bytes(buf)
        paths.append(str(path))
        theirs = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        expected.append(np.ascontiguousarray(theirs[..., ::-1]))
        np.testing.assert_array_equal(decode_image(buf), expected[-1])
    result = subprocess.run(
        [sys.executable, "-c", _NO_OPENCV % (REPO, paths)], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-3000:]
    lines = result.stdout.splitlines()
    for line, image in zip(lines, expected):
        assert line == image.tobytes().hex()
    assert "JPEG body needs OpenCV" in lines[-1]


def test_interlaced_header_fields_are_checked():
    with pytest.raises(PNGFormatError, match="interlace"):
        header = struct.pack(">IIBBBBB", 2, 2, 8, 0, 0, 0, 2)
        decode_png(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                   + _chunk(b"IDAT", zlib.compress(b"\x00" * 6))
                   + _chunk(b"IEND", b""))
    assert png_module.MAX_PIXELS == 1 << 30
