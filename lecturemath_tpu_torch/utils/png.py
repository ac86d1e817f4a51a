"""PNG codec in numpy + zlib, byte-identical to ``cv2.imencode(".png", img)``.

The stage artifacts keep PNG-compressed frames (reference:
FCN_lecturenet_binarizer.py:56) and the summary export writes keyframe
PNGs. OpenCV's encoder, with its defaults, runs libpng with row filter Sub on
every row, zlib at ``Z_BEST_SPEED`` with ``Z_RLE``, and 8192-byte IDAT
chunks; this module does the same, so the port's artifacts and keyframes
match the JAX package's byte for byte without OpenCV. (Under ``Z_RLE``, zlib
writes level-flag 0 in the stream header whatever the level.)

The decoders read every kind of the PNG standard (gray at 1, 2, 4, 8 and
16 bits, gray+alpha, RGB and RGBA at 8 and 16 bits, palette at 1, 2, 4 and
8 bits, Adam7 interlaced or not, any of the five row filters) and give what
OpenCV's decoder (libpng, as OpenCV configures it) gives:

  * ``decode_png_color``: ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` in RGB
    order. 16-bit samples are stripped to their high byte, gray at 1, 2 or
    4 bits is scaled to 0..255, a palette is looked up (``tRNS`` ignored),
    alpha is dropped and gray is repeated into the three channels;
  * ``decode_png_grayscale``: ``cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)``.
    Colour goes through libpng's ``rgb_to_gray`` with OpenCV's weights
    (0.299, 0.587) in 15-bit fixed point, (9797 R + 19234 G + 3737 B) >> 15
    at 8 bits, and rounded at 16 bits before the high byte is kept;
  * ``decode_png``: gray kinds as ``decode_png_grayscale``, colour kinds
    as ``decode_png_color`` (the serving surface's request bodies);
  * ``decode_png_gray``: gray kinds only, refusing colour (the stage
    artifacts' relay, which never holds colour).

Each raises ``PNGFormatError`` on a buffer that is not a PNG.
``read_image`` reads a file as ``cv2.imread`` does (BGR or gray): a PNG
here, any other format through OpenCV where it is installed;
``write_image`` writes one as ``cv2.imwrite`` writes a PNG. Passes whose
rows are all filtered Sub (what this encoder and OpenCV write) are undone
in numpy; any other mix of filters (libpng's and Pillow's adaptive
filtering choose Avg and Paeth for many rows) goes to the native library's
``png_unfilter``, which releases the interpreter lock, one Adam7 pass at a
time, and to a Python loop only where that library cannot be built. JPEG
and the other formats are not decoded here: only OpenCV reads them.
"""

from __future__ import annotations

import struct
import zlib
from typing import Union

import numpy as np

from .. import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
IDAT_CHUNK = 8192
_COLOR_TYPES = {1: 0, 3: 2}  # channels -> PNG colour type (gray, RGB)
# colour type -> (samples a pixel, the bit depths the standard allows)
_KINDS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
          4: (2, (8, 16)), 6: (4, (8, 16))}
_GRAY_KINDS = (0, 4)
# (x0, y0, dx, dy) of the seven Adam7 passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# libpng's rgb_to_gray weights for OpenCV's (0.299, 0.587): 15-bit fixed
# point, blue the rest of 32768
_GRAY_R, _GRAY_G, _GRAY_B = 9797, 19234, 3737
# libpng's default zlib memLevel
_MEM_LEVEL = 8
# the decoders' largest image, OpenCV's default (CV_IO_MAX_IMAGE_PIXELS)
MAX_PIXELS = 1 << 30
# deflate's largest expansion: 258 bytes from about 2 bits, plus slack
_DEFLATE_RATIO = 1100


class ImageFormatError(ValueError):
    """An image file the port cannot decode without OpenCV (JPEG and the
    other non-PNG formats where OpenCV is not installed), or a broken
    one."""


class PNGFormatError(ValueError):
    """A buffer that is not a PNG of a kind the decoders take."""


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


def _unfilter(raw: np.ndarray, height: int, stride: int,
              bpp: int = 1) -> np.ndarray:
    """Undo the per-row filters of ``height`` scanlines of ``stride`` bytes
    (``bpp`` bytes a pixel, at least 1); returns uint8 [height, stride]."""
    rows = raw.reshape(height, stride + 1)
    kinds = rows[:, 0]
    if (kinds == 1).all():  # what OpenCV writes: one cumsum for all rows
        return np.cumsum(rows[:, 1:].reshape(height, stride // bpp, bpp),
                         axis=1, dtype=np.uint8).reshape(height, stride)
    if native.available():
        out, bad = native.png_unfilter(rows, height, stride, bpp)
        if bad >= 0:
            raise PNGFormatError(f"row {bad}: unknown PNG filter type "
                                 f"{int(kinds[bad])}")
        return out
    return _unfilter_rows(rows, height, stride, bpp)


def _unfilter_rows(rows: np.ndarray, height: int, stride: int,
                   bpp: int) -> np.ndarray:
    """``_unfilter`` a row at a time in Python and numpy, where the native
    library is unavailable: None, Sub and Up vectorised, Avg and Paeth a
    byte at a time (slow on large images)."""
    width = stride // bpp
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind = int(rows[y, 0])
        line = rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:
            np.cumsum(line.reshape(width, bpp), axis=0, dtype=np.uint8,
                      out=out[y].reshape(width, bpp))
        elif kind == 2:
            np.add(line, prior, out=out[y])
        elif kind == 3:
            recon = out[y]
            for x in range(stride):
                left = int(recon[x - bpp]) if x >= bpp else 0
                recon[x] = (int(line[x]) + ((left + int(prior[x])) >> 1)) \
                    & 0xFF
        elif kind == 4:
            recon = out[y]
            for x in range(stride):
                up = int(prior[x])
                if x >= bpp:
                    left, up_left = int(recon[x - bpp]), int(prior[x - bpp])
                else:
                    left = up_left = 0
                p = left + up - up_left
                pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
                pred = (left if pa <= pb and pa <= pc
                        else up if pb <= pc else up_left)
                recon[x] = (int(line[x]) + pred) & 0xFF
        else:
            raise PNGFormatError(f"row {y}: unknown PNG filter type {kind}")
        prior = out[y]
    return out


def _read_chunks(buf: Union[bytes, bytearray, memoryview, np.ndarray]):
    """(IHDR fields, concatenated IDAT bytes, PLTE bytes or None) of a PNG
    buffer, CRCs checked."""
    data = (np.ascontiguousarray(buf, dtype=np.uint8).tobytes()
            if isinstance(buf, np.ndarray) else bytes(buf))
    if not data.startswith(SIGNATURE):
        raise PNGFormatError("not a PNG: bad signature")
    pos = len(SIGNATURE)
    header = None
    palette = None
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
        elif kind == b"PLTE":
            # in RGB and RGBA images only a suggested palette
            palette = body
        elif kind[:1].isupper():
            raise PNGFormatError(f"unsupported critical PNG chunk {kind!r}")
    if header is None:
        raise PNGFormatError("PNG has no IHDR chunk")
    return header, b"".join(idat), palette


def _pass_sizes(width: int, height: int, interlace: int):
    """(x0, y0, dx, dy, pass width, pass height) of each non-empty pass:
    the whole image, or the Adam7 passes."""
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    for x0, y0, dx, dy in passes:
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w > 0 and h > 0:
            yield x0, y0, dx, dy, w, h


def _unpack(rows: np.ndarray, width: int, channels: int,
            depth: int) -> np.ndarray:
    """Unfiltered scanlines -> samples [h, width, channels]: uint16 at 16
    bits (big endian in the file), else uint8 (sub-byte samples unpacked,
    most significant bits first, not scaled)."""
    height = rows.shape[0]
    count = width * channels
    if depth == 16:
        samples = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        samples = rows
    else:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)
                   ).reshape(height, -1)
    return samples[:, :count].reshape(height, width, channels)


def _samples(buf, gray_only: bool = False):
    """Every pixel of a PNG of any standard kind: (samples [H, W, channels]
    uint8, or uint16 at 16 bits; colour type; bit depth; palette [256, 3]
    uint8 or None). ``gray_only`` refuses the colour kinds."""
    header, idat, plte = _read_chunks(buf)
    width, height, depth, color, compression, filter_method, interlace = header
    if color not in _KINDS or depth not in _KINDS[color][1]:
        raise PNGFormatError(f"not a valid PNG: bit depth {depth} with "
                             f"colour type {color}")
    if gray_only and color not in _GRAY_KINDS:
        raise PNGFormatError(f"expected a grayscale PNG, got colour type "
                             f"{color}")
    if compression or filter_method or interlace not in (0, 1):
        raise PNGFormatError("unknown PNG compression, filter or interlace "
                             "method")
    if width == 0 or height == 0:
        raise PNGFormatError("PNG has an empty image")
    channels = _KINDS[color][0]
    bits = depth * channels
    bpp = max(1, bits // 8)
    passes = list(_pass_sizes(width, height, interlace))
    expected = sum(h * (-(-w * bits // 8) + 1) for *_, w, h in passes)
    if width * height > MAX_PIXELS or expected > _DEFLATE_RATIO * len(idat):
        # a header no image data of this size can fill: refused before any
        # buffer is allocated for it
        raise PNGFormatError(f"PNG of {width}x{height} pixels: larger than "
                             f"{MAX_PIXELS} pixels or than its "
                             f"{len(idat)} bytes of image data can hold")
    try:
        # one output buffer of the known size: growing it step by step
        # takes the interpreter lock between steps, which serialises
        # concurrent decodes (the server decodes on one thread a request)
        raw = zlib.decompress(idat, bufsize=expected)
    except zlib.error as exc:
        raise PNGFormatError(f"corrupt PNG image data: {exc}") from None
    if len(raw) != expected:
        raise PNGFormatError(f"PNG image data holds {len(raw)} bytes, "
                             f"expected {expected}")
    raw = np.frombuffer(raw, np.uint8)
    samples = None
    start = 0
    for x0, y0, dx, dy, w, h in passes:
        stride = -(-w * bits // 8)
        rows = _unfilter(raw[start:start + h * (stride + 1)], h, stride, bpp)
        start += h * (stride + 1)
        part = _unpack(rows, w, channels, depth)
        if not interlace:
            samples = part
            break
        if samples is None:
            samples = np.empty((height, width, channels), part.dtype)
        samples[y0::dy, x0::dx] = part
    palette = None
    if color == 3:
        if plte is None or len(plte) % 3 or not 0 < len(plte) <= 768:
            raise PNGFormatError("palette PNG without a valid PLTE chunk")
        # indices past the palette read black, as libpng pads it
        palette = np.zeros((256, 3), np.uint8)
        palette[:len(plte) // 3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
    return samples, color, depth, palette


def _to_8bit(samples: np.ndarray, depth: int) -> np.ndarray:
    """Gray or colour samples as 8 bits: the high byte of 16 (libpng's
    strip), 1, 2 and 4 bits scaled to 0..255."""
    if depth == 16:
        return (samples >> 8).astype(np.uint8)
    if depth < 8:
        return samples * np.uint8(255 // ((1 << depth) - 1))
    return samples


def _rgb(samples, color, depth, palette) -> np.ndarray:
    if color == 3:
        return palette[samples[:, :, 0]]
    if color in _GRAY_KINDS:
        gray = _to_8bit(samples[:, :, 0], depth)
        return np.repeat(gray[:, :, None], 3, axis=2)
    return np.ascontiguousarray(_to_8bit(samples[:, :, :3], depth))


def _gray(samples, color, depth, palette) -> np.ndarray:
    if color in _GRAY_KINDS:
        return np.ascontiguousarray(_to_8bit(samples[:, :, 0], depth))
    rgb = (palette[samples[:, :, 0]] if color == 3 else samples[:, :, :3]
           ).astype(np.int64)
    weighted = (_GRAY_R * rgb[:, :, 0] + _GRAY_G * rgb[:, :, 1]
                + _GRAY_B * rgb[:, :, 2])
    if depth == 16:
        return (((weighted + (1 << 14)) >> 15) >> 8).astype(np.uint8)
    return (weighted >> 15).astype(np.uint8)


def decode_png_color(buf: Union[bytes, bytearray, memoryview, np.ndarray]
                     ) -> np.ndarray:
    """Decode a PNG of any kind into uint8 RGB [H, W, 3], equal to
    ``cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1]``."""
    return _rgb(*_samples(buf))


def decode_png_grayscale(buf: Union[bytes, bytearray, memoryview, np.ndarray]
                         ) -> np.ndarray:
    """Decode a PNG of any kind into uint8 [H, W], equal to
    ``cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)``."""
    return _gray(*_samples(buf))


def decode_png_gray(buf: Union[bytes, bytearray, memoryview, np.ndarray]
                    ) -> np.ndarray:
    """Decode a grayscale PNG (gray or gray+alpha, any bit depth) into
    uint8 [H, W]; a colour PNG is refused, not converted."""
    return _gray(*_samples(buf, gray_only=True))


def decode_png(buf: Union[bytes, bytearray, memoryview, np.ndarray]
               ) -> np.ndarray:
    """Decode a PNG of any kind into uint8 gray [H, W] (gray kinds) or RGB
    [H, W, 3] (RGB, RGBA and palette kinds; alpha dropped)."""
    decoded = _samples(buf)
    if decoded[1] in _GRAY_KINDS:
        return _gray(*decoded)
    return _rgb(*decoded)


def write_image(path: str, img: np.ndarray) -> None:
    """``cv2.imwrite(path, img)`` for a PNG path: ``encode_png``'s bytes."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def read_image(path: str, grayscale: bool = False,
               rgb: bool = False) -> np.ndarray:
    """``cv2.imread(path)``: the file as uint8 BGR [H, W, 3], or with
    ``grayscale`` as ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``, uint8
    [H, W]. With ``rgb`` the colour channels come in RGB order, which a PNG
    decodes to with no copy. PNGs of every kind decode without OpenCV; any
    other file needs it, and where it is not installed raises
    ``ImageFormatError`` naming it."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if grayscale:
            return decode_png_grayscale(data)
        image = decode_png_color(data)
        return image if rgb else np.ascontiguousarray(image[:, :, ::-1])
    except PNGFormatError as err:
        if data.startswith(SIGNATURE):
            raise ImageFormatError(f"{path}: {err}") from None
    try:
        import cv2
    except ImportError:
        raise ImageFormatError(
            f"{path}: not a PNG; JPEG and other formats need OpenCV (cv2), "
            f"which is not installed; convert the file to PNG") from None
    image = cv2.imdecode(np.frombuffer(data, np.uint8),
                         cv2.IMREAD_GRAYSCALE if grayscale
                         else cv2.IMREAD_COLOR)
    if image is None:
        raise ImageFormatError(f"{path}: not a decodable image")
    if rgb and not grayscale:
        return np.ascontiguousarray(image[:, :, ::-1])
    return image
