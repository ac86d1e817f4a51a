"""The port's numpy image operations (lecturemath_tpu_torch.utils.image and
utils/png.py decode_png) against OpenCV and Pillow, and stage 01 of the
port with both of them unimportable: frames above the pixel cap and I420
uploads give the JAX package's frames (fp32, TINY widths, on the CPU)."""

import io
import struct
import sys
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lecturemath_tpu.models import fcn_lecturenet as jfcn
from lecturemath_tpu.pipeline.binarize import Binarizer as JaxBinarizer
from lecturemath_tpu.pipeline.video import ArraySource as JaxArraySource
from lecturemath_tpu.utils.synthetic import (synthetic_rgb_lecture,
                                             threshold_binarizer_variables)
from lecturemath_tpu_torch import native
from lecturemath_tpu_torch.models import fcn_lecturenet as tfcn
from lecturemath_tpu_torch.models.convert import state_dict_from_flax
from lecturemath_tpu_torch.pipeline.binarize import Binarizer
from lecturemath_tpu_torch.pipeline.video import ArraySource
from lecturemath_tpu_torch.utils.image import (halve_lanczos, resize_area,
                                               resize_nearest, rgb_to_yuv420)
from lecturemath_tpu_torch.utils import png as png_module
from lecturemath_tpu_torch.utils.png import (PNGFormatError, decode_png,
                                             decode_png_gray)

torch.set_num_threads(1)


def _image(height, width, channels, seed, kind="random"):
    """Random pixels, or a smooth gradient with a few sharp edges (where
    rounding ties and ringing show)."""
    rng = np.random.default_rng(seed)
    shape = (height, width, channels) if channels else (height, width)
    if kind == "random":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    yy, xx = np.mgrid[:height, :width]
    base = (xx * 255 // max(width - 1, 1) + yy * 7) % 256
    base[height // 3:height // 2, width // 4:width // 2] = 12
    img = np.stack([(base + 40 * c) % 256 for c in range(max(channels, 1))],
                   axis=-1).astype(np.uint8)
    return img if channels else img[..., 0]


SIZES_NEAREST = [((64, 48), (128, 96)), ((131, 77), (64, 40)),
                 ((960, 540), (1920, 1080)), ((33, 17), (100, 51)),
                 ((100, 51), (33, 17)), ((7, 5), (7, 13)), ((1, 1), (3, 2))]


@pytest.mark.parametrize("src,dst", SIZES_NEAREST,
                         ids=[f"{s[0]}x{s[1]}-{d[0]}x{d[1]}"
                              for s, d in SIZES_NEAREST])
@pytest.mark.parametrize("channels", [0, 3])
def test_resize_nearest_equals_cv2(src, dst, channels):
    img = _image(src[1], src[0], channels, seed=sum(src))
    np.testing.assert_array_equal(
        resize_nearest(img, dst),
        cv2.resize(img, dst, interpolation=cv2.INTER_NEAREST))


# integer factors (OpenCV's box-sum path: 2x2 rounds (sum + 2) >> 2, other
# boxes round sum * (1/n) in f32, half to even)
SIZES_AREA_INTEGER = [((128, 96), (64, 48)), ((1920, 1080), (960, 540)),
                      ((192, 144), (64, 48)), ((256, 192), (64, 48)),
                      ((192, 96), (64, 48)), ((2, 2), (1, 1))]
# fractional downscales (area weights in f32, summed in OpenCV's order) and
# upscales (linear weights in 11-bit fixed point, placed by area); OpenCV's
# arithmetic is reproduced step for step, so these too are held to exact
# equality (bound: 0 differing pixels)
SIZES_AREA_OTHER = [((1280, 720), (960, 540)), ((131, 77), (64, 40)),
                    ((100, 90), (64, 48)), ((80, 60), (64, 48)),
                    ((640, 480), (960, 540)), ((64, 48), (128, 96)),
                    ((37, 29), (64, 48)), ((96, 40), (64, 48)),
                    ((40, 100), (64, 48)), ((1, 1), (5, 5))]


@pytest.mark.parametrize("src,dst", SIZES_AREA_INTEGER + SIZES_AREA_OTHER,
                         ids=[f"{s[0]}x{s[1]}-{d[0]}x{d[1]}" for s, d in
                              SIZES_AREA_INTEGER + SIZES_AREA_OTHER])
@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("kind", ["random", "gradient"])
def test_resize_area_equals_cv2(src, dst, channels, kind):
    img = _image(src[1], src[0], channels, seed=sum(src) + channels, kind=kind)
    np.testing.assert_array_equal(
        resize_area(img, dst),
        cv2.resize(img, dst, interpolation=cv2.INTER_AREA))


def test_resize_area_same_size_is_a_copy():
    img = _image(5, 7, 3, seed=1)
    out = resize_area(img, (7, 5))
    np.testing.assert_array_equal(out, img)
    assert out is not img


def test_coefficient_tables_are_built_once_and_read_only():
    """The tables of each (source, destination) size are kept for the next
    frame, and no caller can change a kept table."""
    from lecturemath_tpu_torch.utils import image

    for build, args in ((image._lanczos_coefficients, (3840, 1920)),
                        (image._area_table, (1280, 960, 1280 / 960)),
                        (image._area_up_table, (640, 960))):
        first = build(*args)
        assert build(*args) is first
        for table in first:
            assert not table.flags.writeable
    assert not image._nearest_index(540, 2160).flags.writeable


def test_resize_refuses_bad_input():
    with pytest.raises(ValueError):
        resize_area(np.zeros((4, 4), np.float32), (2, 2))
    with pytest.raises(ValueError):
        resize_nearest(np.zeros((4, 4), np.uint8), (0, 2))
    with pytest.raises(ValueError):
        rgb_to_yuv420(np.zeros((5, 4, 3), np.uint8))


@pytest.fixture(params=["native", "python"])
def native_or_python(request, monkeypatch):
    """The native library's routine (png_unfilter for rows not all filtered
    Sub, resample_u8 for the LANCZOS passes), or the numpy and Python code
    that runs where that library is unavailable."""
    if request.param == "native":
        assert native.available()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("width,height", [(128, 96), (1920, 1080), (131, 77),
                                          (7, 5), (2, 2), (1000, 3)])
@pytest.mark.parametrize("kind", ["random", "gradient"])
def test_halve_lanczos_equals_pil(width, height, kind, native_or_python):
    img = _image(height, width, 3, seed=width, kind=kind)
    expected = np.asarray(Image.fromarray(img).resize(
        (width // 2, height // 2), Image.LANCZOS))
    np.testing.assert_array_equal(halve_lanczos(img), expected)


@pytest.mark.parametrize("width,height", [(128, 96), (960, 540), (66, 34),
                                          (2, 2)])
def test_rgb_to_yuv420_equals_cv2(width, height):
    img = _image(height, width, 3, seed=height)
    np.testing.assert_array_equal(
        rgb_to_yuv420(img), cv2.cvtColor(img, cv2.COLOR_RGB2YUV_I420))


def test_rgb_to_yuv420_host_equals_jax_package():
    frames = np.stack([_image(48, 64, 3, seed=k) for k in range(3)])
    np.testing.assert_array_equal(tfcn.rgb_to_yuv420_host(frames),
                                  jfcn.rgb_to_yuv420_host(frames))


# ------------------------------------------------------------ decode_png


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _png(img, kinds, color):
    """An 8-bit PNG of ``img`` [H, W, channels] with row y filtered by
    kinds[y % len(kinds)]."""
    height, width, bpp = img.shape
    rows = img.reshape(height, width * bpp).astype(int)
    raw = bytearray()
    for y in range(height):
        kind = kinds[y % len(kinds)]
        raw.append(kind)
        for x in range(width * bpp):
            a = rows[y, x - bpp] if x >= bpp else 0
            b = rows[y - 1, x] if y else 0
            c = rows[y - 1, x - bpp] if x >= bpp and y else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            raw.append((rows[y, x] - pred) & 0xFF)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "avg", "paeth", "mixed"])
@pytest.mark.parametrize("color,channels", [(0, 1), (2, 3), (6, 4)],
                         ids=["gray", "rgb", "rgba"])
def test_decode_png_every_filter_equals_cv2(kinds, color, channels,
                                            native_or_python):
    img = _image(13, 17, channels, seed=color * 10 + kinds[0])
    buf = _png(img, kinds, color)
    ours = decode_png(buf)
    theirs = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED)
    if channels == 1:
        np.testing.assert_array_equal(ours, img[..., 0])
        np.testing.assert_array_equal(ours, theirs)
    else:
        np.testing.assert_array_equal(ours, img[..., :3])
        np.testing.assert_array_equal(ours, theirs[..., 2::-1])


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_decode_png_of_other_writers(mode):
    """libpng's adaptive filters (cv2 at level 9, Pillow's optimize)."""
    img = _image(40, 57, 4, seed=5, kind="gradient")
    pil = Image.fromarray(img, "RGBA").convert(mode)
    out = io.BytesIO()
    pil.save(out, format="PNG", optimize=True)
    expected = np.asarray(pil.convert("RGB" if mode != "L" else "L"))
    np.testing.assert_array_equal(decode_png(out.getvalue()), expected)
    ok, buf = cv2.imencode(".png", expected[..., ::-1] if mode != "L"
                           else expected, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    assert ok
    np.testing.assert_array_equal(decode_png(buf), expected)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_decode_png_adaptive_filters_at_full_size(mode):
    """A 960x540 body as Pillow writes it by default (libpng's adaptive
    filtering: Up, Sub and Paeth rows on this image) decodes through the
    native unfilter to Pillow's pixels, as cv2.imdecode does."""
    img = _image(540, 960, 4, seed=9, kind="gradient")
    img[::7] = _image(540, 960, 4, seed=10)[::7]   # rows of noise
    pil = Image.fromarray(img, "RGBA").convert(mode)
    out = io.BytesIO()
    pil.save(out, format="PNG")
    buf = out.getvalue()
    bpp = len(mode)
    raw = zlib.decompress(png_module._read_chunks(buf)[1])
    kinds = np.frombuffer(raw, np.uint8)[::960 * bpp + 1]
    assert len(set(kinds.tolist())) > 1 and (kinds == 4).any()
    expected = np.asarray(pil)[..., :3]
    np.testing.assert_array_equal(decode_png(buf), expected)
    theirs = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(decode_png(buf), theirs[..., ::-1])


def test_decode_png_refuses_what_it_does_not_take():
    img = _image(6, 5, 3, seed=2)
    # palette and 16-bit PNGs decode as cv2 decodes them (every kind:
    # tests/test_torch_png_kinds.py); what is not a PNG is refused
    out = io.BytesIO()
    Image.fromarray(img).convert("P").save(out, format="PNG")
    np.testing.assert_array_equal(
        decode_png(out.getvalue()),
        cv2.imdecode(np.frombuffer(out.getvalue(), np.uint8),
                     cv2.IMREAD_COLOR)[..., ::-1])
    ok, buf = cv2.imencode(".png", img.astype(np.uint16) * 257)
    np.testing.assert_array_equal(decode_png(buf), img[..., ::-1])
    with pytest.raises(PNGFormatError, match="signature"):
        decode_png(b"\xff\xd8\xff\xe0 a jpeg")
    # decode_png_gray keeps its contract: gray only
    with pytest.raises(PNGFormatError, match="grayscale"):
        decode_png_gray(_png(img, [1], 2))


# --------------------------------------- stage 01 without OpenCV or Pillow

TINY = dict(down_filters=(2, 3, 4, 5, 6), mid_filters=6,
            upsample_filters=(2, 3, 4, 5, 6), up_filters=(2, 3, 4, 5, 6),
            pixel_features=(4, 3), kernel_size=3, pixel_kernel_size=3)


@pytest.fixture(scope="module")
def lecture():
    rgb, _, _, _ = synthetic_rgb_lecture(seed=6, n_frames=4, height=96,
                                         width=128)
    return rgb


@pytest.mark.parametrize("downscale_filter,upload_format,max_pixels", [
    ("lanczos", "rgb", 5_000),      # 128x96 -> 64x48, Pillow's LANCZOS
    ("area", "rgb", 5_000),         # the same through cv2 INTER_AREA
    ("lanczos", "rgb", 1_000),      # two halvings: 32x24
    ("lanczos", "yuv420", 5_000),   # I420 upload after the halving
    ("area", "yuv420", 2_500_000),  # I420 upload at full size
])
def test_stage01_without_opencv_or_pillow_equals_jax(
        lecture, monkeypatch, downscale_filter, upload_format, max_pixels):
    cfg = jfcn.FCNConfig(**TINY)
    variables = threshold_binarizer_variables(cfg)
    kwargs = dict(batch_size=3, upload_format=upload_format,
                  downscale_filter=downscale_filter,
                  max_model_pixels=max_pixels)
    jax_bin = JaxBinarizer(jfcn.FCNLectureNet(cfg, dtype=jnp.float32),
                           variables, **kwargs)
    _, _, expected = jax_bin.process_source(JaxArraySource(lecture, fps=1.0))

    model = tfcn.FCNLectureNet(tfcn.FCNConfig(**TINY))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    for name in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import cv2 as _  # noqa: F401 — proves the block is in place
    port_bin = Binarizer(model, device="cpu", **kwargs)
    assert port_bin.upload_format == upload_format
    _, _, frames = port_bin.process_source(ArraySource(lecture, fps=1.0))
    assert len(frames) == len(expected) == len(lecture)
    for ours, theirs in zip(frames, expected):
        assert ours.shape == (96, 128)
        np.testing.assert_array_equal(ours, theirs)
    assert any((frame == 255).any() for frame in frames)


def test_decode_png_refuses_a_header_its_data_cannot_fill():
    """A header claiming far more pixels than its image data can hold is
    refused before a buffer is allocated for it (request bodies come from
    outside the program)."""
    good = _png(_image(4, 4, 3, seed=4), [0], 2)
    ihdr = struct.pack(">IIBBBBB", 50_000, 50_000, 8, 2, 0, 0, 0)
    chunk = (struct.pack(">I", 13) + b"IHDR" + ihdr
             + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr) & 0xFFFFFFFF))
    lying = good[:8] + chunk + good[8 + 25:]
    with pytest.raises(PNGFormatError, match="50000x50000"):
        decode_png(lying)
    # an all-zero image compresses about 1000:1 and still decodes
    zeros = np.zeros((600, 700, 3), np.uint8)
    np.testing.assert_array_equal(decode_png(_png_fast(zeros)), zeros)


def _png_fast(img):
    """An 8-bit RGB PNG of ``img`` with filter None on every row, compressed
    at zlib's best level."""
    height, width, _ = img.shape
    raw = np.concatenate([np.zeros((height, 1), np.uint8),
                          img.reshape(height, -1)], axis=1).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))
