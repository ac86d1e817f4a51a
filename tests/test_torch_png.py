"""The port's PNG codec (lecturemath_tpu_torch/utils/png.py) against OpenCV
and the JAX package: the encoder's bytes equal cv2.imencode's (and the JAX
package's compress_png) for gray frames and 3-channel keyframes, the decoder
equals cv2.imdecode on cv2-written PNGs and on PNGs built by hand with each
row filter 0-4, and bad input raises."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from lecturemath_tpu.pipeline.video import compress_png as jax_compress_png
from lecturemath_tpu_torch.pipeline.keyframes import export_summary
from lecturemath_tpu_torch.pipeline.video import compress_png, decompress_png
from lecturemath_tpu_torch.utils.png import (PNGFormatError, decode_png_gray,
                                             encode_png)

SHAPES = [(1, 1), (1, 9), (5, 1), (3, 5), (16, 16), (37, 45), (96, 128),
          (127, 129), (200, 300), (540, 960)]


def _frame(shape, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return ((rng.random(shape) < 0.1) * 255).astype(np.uint8)
    if kind == "noise":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    # a keyframe: ink on a white board in three channels, plus noise
    board = np.where(rng.random(shape) < 0.1, 0, 255).astype(np.uint8)
    frame = np.repeat(board[..., None], 3, axis=2)
    frame[..., 1] = rng.integers(0, 256, shape, dtype=np.uint8)
    return frame


@pytest.mark.parametrize("kind", ["binary", "noise", "keyframe"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encoder_bytes_equal_cv2(shape, kind):
    frame = _frame(shape, kind, seed=shape[0] * 1000 + shape[1])
    ok, reference = cv2.imencode(".png", frame)
    assert ok
    assert encode_png(frame) == reference.tobytes()


def test_compress_png_equals_jax_package():
    frames = [_frame((96, 128), "binary", seed) for seed in range(3)]
    frames.append(_frame((540, 960), "binary", 3))
    ours = compress_png(frames)
    theirs = jax_compress_png(frames)
    for mine, other in zip(ours, theirs):
        # the (n, 1) buffers of cv2 4.x, which a reference installation
        # pickles; cv2 5 returns (n,) with the same bytes
        assert mine.dtype == other.dtype == np.uint8
        assert mine.shape == (other.size, 1)
        assert mine.tobytes() == other.tobytes()
    for frame, decoded in zip(frames, decompress_png(ours)):
        np.testing.assert_array_equal(decoded, frame)


def test_export_summary_keyframes_equal_cv2_imwrite(tmp_path):
    keyframes = [_frame((96, 128), "keyframe", seed) for seed in range(2)]
    export_summary(str(tmp_path / "ours"), "DB", "lecture", ["v.avi"],
                   [(0, 10), (11, 20)], [(0.0, 1.0), (1.0, 2.0)], [10, 20],
                   [1.0, 2.0], keyframes)
    for index, keyframe in zip((10, 20), keyframes):
        path = tmp_path / "cv2.png"
        cv2.imwrite(str(path), keyframe)
        written = (tmp_path / "ours" / "keyframes" / f"{index}.png")
        assert written.read_bytes() == path.read_bytes()


@pytest.mark.parametrize("shape", [(1, 1), (37, 45), (96, 128), (540, 960)])
def test_decoder_equals_cv2_imdecode(shape):
    for kind in ("binary", "noise"):
        frame = _frame(shape, kind, seed=7)
        _, buf = cv2.imencode(".png", frame)
        np.testing.assert_array_equal(
            decode_png_gray(buf), cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))
        # compression level 9 lets libpng choose its filters per row
        _, buf = cv2.imencode(".png", frame, [cv2.IMWRITE_PNG_COMPRESSION, 9])
        np.testing.assert_array_equal(
            decode_png_gray(buf), cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filtered_rows(img, kinds):
    """Scanlines of an 8-bit gray image, row y filtered by kinds[y]."""
    h, w = img.shape
    out = bytearray()
    for y in range(h):
        kind = kinds[y]
        out.append(kind)
        for x in range(w):
            a = int(img[y, x - 1]) if x else 0
            b = int(img[y - 1, x]) if y else 0
            c = int(img[y - 1, x - 1]) if x and y else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            out.append((int(img[y, x]) - pred) & 0xFF)
    return bytes(out)


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png(img, kinds, depth=8, color=0, interlace=0, idat=None):
    h, w = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    if idat is None:
        idat = zlib.compress(_filtered_rows(img, kinds))
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", idat) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "avg", "paeth", "mixed"])
def test_decoder_every_filter_type(kinds):
    img = np.random.default_rng(len(kinds) * 10 + kinds[0]).integers(
        0, 256, (23, 31), dtype=np.uint8)
    row_kinds = [kinds[y % len(kinds)] for y in range(img.shape[0])]
    buf = _png(img, row_kinds)
    ours = decode_png_gray(buf)
    np.testing.assert_array_equal(ours, img)
    np.testing.assert_array_equal(
        ours, cv2.imdecode(np.frombuffer(buf, np.uint8),
                           cv2.IMREAD_GRAYSCALE))


def test_decoder_raises_on_what_it_does_not_take():
    img = np.zeros((4, 5), np.uint8)
    good = _png(img, [1] * 4)
    with pytest.raises(PNGFormatError, match="signature"):
        decode_png_gray(b"GIF89a" + good[6:])
    with pytest.raises(PNGFormatError, match="grayscale"):
        decode_png_gray(_png(img, [0] * 4, color=2))
    with pytest.raises(PNGFormatError, match="grayscale"):
        decode_png_gray(_png(img, [0] * 4, depth=16))
    with pytest.raises(PNGFormatError, match="interlaced"):
        decode_png_gray(_png(img, [0] * 4, interlace=1))
    rows = bytearray(_filtered_rows(img, [0] * 4))
    rows[img.shape[1] + 1] = 7  # the filter byte of row 1
    with pytest.raises(PNGFormatError, match="filter type 7"):
        decode_png_gray(_png(img, None, idat=zlib.compress(bytes(rows))))
    with pytest.raises(PNGFormatError, match="corrupt"):
        decode_png_gray(_png(img, [0] * 4, idat=b"not zlib"))
    with pytest.raises(PNGFormatError, match="expected"):
        decode_png_gray(_png(img, [0] * 4,
                             idat=zlib.compress(b"\x00" * 7)))
    corrupt = bytearray(good)
    corrupt[-20] ^= 0xFF
    with pytest.raises(PNGFormatError, match="CRC|truncated|corrupt"):
        decode_png_gray(bytes(corrupt))
    with pytest.raises(PNGFormatError, match="truncated"):
        decode_png_gray(good[:-12])
    # a colour image is refused, not converted
    _, colour = cv2.imencode(".png", _frame((8, 8), "keyframe", 0))
    with pytest.raises(PNGFormatError):
        decompress_png([colour])
    with pytest.raises(PNGFormatError):
        encode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(PNGFormatError):
        encode_png(np.zeros((4, 4, 2), np.uint8))
