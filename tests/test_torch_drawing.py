"""The port's OpenCV-free drawing, Otsu threshold and nearest warp
(utils/image.py) against cv2 at every pixel, on seeded cases: endpoints
and centres on and off the image and degenerate ones, thickness 1-12,
radius 0-10, uint8 and int32 images of 1 and 3 channels, flat, tiny and
non-contiguous Otsu inputs, and strong perspectives for the warp. These
are the calls that set the GT editors' saved files (the strokes that paint
and erase the binary, the Otsu thresholds of the threshold grid and the
Otsu portions, and the label warp of the unique-CC matching)."""

import cv2
import numpy as np
import pytest

from lecturemath_tpu_torch.utils import image

CASES = 300
IMAGES = [(np.uint8, 1), (np.uint8, 3), (np.int32, 1), (np.int32, 3)]


def _blank(rng, dtype, channels, low=1, high=60):
    height, width = (int(v) for v in rng.integers(low, high, 2))
    shape = (height, width) + ((channels,) if channels > 1 else ())
    return np.zeros(shape, dtype), height, width


def _color(rng):
    return tuple(int(v) for v in rng.integers(1, 255, 3))


def _point(rng, width, height, margin):
    return (int(rng.integers(-margin, width + margin)),
            int(rng.integers(-margin, height + margin)))


@pytest.mark.parametrize("dtype,channels", IMAGES)
def test_circle_equals_cv2(dtype, channels):
    """Filled circles, radius 0-10, centres up to 15 px off the image."""
    rng = np.random.default_rng(1 + channels)
    for _ in range(CASES):
        blank, height, width = _blank(rng, dtype, channels)
        center = _point(rng, width, height, 15)
        radius, color = int(rng.integers(0, 11)), _color(rng)
        expected = cv2.circle(blank.copy(), center, radius, color, -1)
        got = image.circle(blank.copy(), center, radius, color, -1)
        np.testing.assert_array_equal(got, expected,
                                      err_msg=str((center, radius)))


@pytest.mark.parametrize("dtype,channels", IMAGES)
def test_line_equals_cv2(dtype, channels):
    """Lines of thickness 1-12 between points up to 20 px off the image
    (clipped as OpenCV clips), one case in seven a single point."""
    rng = np.random.default_rng(11 + channels)
    for k in range(CASES):
        blank, height, width = _blank(rng, dtype, channels)
        p0 = _point(rng, width, height, 20)
        p1 = _point(rng, width, height, 20) if k % 7 else p0
        thickness, color = int(rng.integers(1, 13)), _color(rng)
        expected = cv2.line(blank.copy(), p0, p1, color, thickness)
        got = image.line(blank.copy(), p0, p1, color, thickness)
        np.testing.assert_array_equal(got, expected,
                                      err_msg=str((p0, p1, thickness)))


@pytest.mark.parametrize("thickness", [2, 4, 6, 8])
def test_editor_strokes_equal_cv2(thickness):
    """The GT editor's strokes: polylines of a scalar ink or background
    value at thickness 2 * radius, segment by segment, on a binary."""
    rng = np.random.default_rng(thickness)
    for _ in range(CASES // 3):
        binary = np.where(rng.random((int(rng.integers(20, 90)),
                                      int(rng.integers(20, 90)))) < 0.3,
                          0, 255).astype(np.uint8)
        height, width = binary.shape
        points = [_point(rng, width, height, 6)
                  for _ in range(int(rng.integers(2, 6)))]
        value = int(rng.choice([0, 255]))
        expected, got = binary.copy(), binary.copy()
        for a, b in zip(points, points[1:]):
            cv2.line(expected, a, b, value, thickness=thickness)
            image.line(got, a, b, value, thickness=thickness)
        np.testing.assert_array_equal(got, expected, err_msg=str(points))


@pytest.mark.parametrize("dtype,channels", IMAGES)
def test_polylines_equal_cv2(dtype, channels):
    """Open and closed polylines of 1-5 points at thickness 1-5, vertices
    up to 10 px off the image."""
    rng = np.random.default_rng(21 + channels)
    for k in range(CASES):
        blank, height, width = _blank(rng, dtype, channels)
        n = int(rng.integers(1, 6))
        points = np.stack([rng.integers(-10, width + 10, n),
                           rng.integers(-10, height + 10, n)],
                          axis=1).astype(np.int32).reshape(-1, 1, 2)
        closed, thickness = bool(k % 3), int(rng.integers(1, 6))
        color = _color(rng)
        expected = cv2.polylines(blank.copy(), [points], closed, color,
                                 thickness)
        got = image.polylines(blank.copy(), [points], closed, color,
                              thickness)
        np.testing.assert_array_equal(got, expected, err_msg=str(
            (points.tolist(), closed, thickness)))


@pytest.mark.parametrize("thickness", [1, 2, 4])
def test_rectangle_equals_cv2(thickness):
    """Rectangles at the editors' thicknesses, corners in any order and
    off the image, on 3-channel uint8 frames."""
    rng = np.random.default_rng(31 + thickness)
    for _ in range(CASES):
        blank, height, width = _blank(rng, np.uint8, 3)
        p0, p1 = (_point(rng, width, height, 8) for _ in range(2))
        color = _color(rng)
        expected = cv2.rectangle(blank.copy(), p0, p1, color, thickness)
        got = image.rectangle(blank.copy(), p0, p1, color, thickness)
        np.testing.assert_array_equal(got, expected, err_msg=str((p0, p1)))


def test_scalar_color_fills_the_first_channel_only():
    """A scalar colour on a 3-channel image is (v, 0, 0), as cv2.Scalar."""
    expected = cv2.line(np.zeros((20, 30, 3), np.uint8), (2, 3), (25, 15),
                        200, 3)
    got = image.line(np.zeros((20, 30, 3), np.uint8), (2, 3), (25, 15),
                     200, 3)
    np.testing.assert_array_equal(got, expected)
    assert got[..., 1:].max() == 0 and got[..., 0].max() == 200


def _otsu_inputs(rng):
    """Random, bimodal, normal, flat, one-pixel, one-row and strided
    (non-contiguous) uint8 images."""
    height, width = (int(v) for v in rng.integers(1, 60, 2))
    kind = int(rng.integers(0, 7))
    if kind == 0:
        return rng.integers(0, 256, (height, width), dtype=np.uint8)
    if kind == 1:
        return np.where(rng.random((height, width)) < rng.random(),
                        rng.integers(0, 120), rng.integers(120, 256)
                        ).astype(np.uint8)
    if kind == 2:
        return np.clip(rng.normal(rng.integers(40, 200), 25,
                                  (height, width)), 0, 255).astype(np.uint8)
    if kind == 3:
        return np.full((height, width), rng.integers(0, 256), np.uint8)
    if kind == 4:
        return rng.integers(0, 256, (1, 1), dtype=np.uint8)
    if kind == 5:
        return rng.integers(0, 256, (1, width), dtype=np.uint8)
    big = rng.integers(0, 256, (2 * height + 3, 3 * width + 2),
                       dtype=np.uint8)
    return big[1::2, 2::3][:height, :width]


@pytest.mark.parametrize("seed", [0, 1])
def test_threshold_otsu_equals_cv2(seed):
    rng = np.random.default_rng(41 + seed)
    for _ in range(CASES):
        gray = _otsu_inputs(rng)
        expected, _ = cv2.threshold(gray, 0, 255,
                                    cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        assert image.threshold_otsu(gray) == expected, gray.shape


def test_threshold_otsu_of_editor_cells():
    """The threshold grid's cells: windows of a lit gradient with dark
    glyphs, as views of the gray image."""
    rng = np.random.default_rng(5)
    gray = np.clip(np.linspace(90, 240, 200)[None, :] + rng.normal(
        0, 8, (120, 200)), 0, 255).astype(np.uint8)
    gray[30:50, 40:90] = 40
    for y in range(0, 120, 10):
        for x in range(0, 200, 25):
            cell = gray[y:y + 37, x:x + 51]
            expected, _ = cv2.threshold(cell, 0, 255,
                                        cv2.THRESH_BINARY | cv2.THRESH_OTSU)
            assert image.threshold_otsu(cell) == expected


def _homography(rng, width, height, strength):
    src = np.array([[0, 0], [width, 0], [width, height], [0, height]],
                   np.float32)
    dst = src + rng.normal(0, strength, (4, 2)).astype(np.float32) * \
        np.array([width, height], np.float32)
    return cv2.getPerspectiveTransform(src, dst).astype(np.float64)


@pytest.mark.parametrize("dtype", [np.int32, np.int16, np.uint8, np.uint16])
def test_warp_nearest_equals_cv2(dtype):
    """cv2.warpPerspective(..., INTER_NEAREST) with border value 0 under
    strong perspectives (corners moved by a third of the side), into
    destinations smaller and larger than the source."""
    rng = np.random.default_rng(51)
    for k in range(CASES // 2):
        height, width = (int(v) for v in rng.integers(8, 100, 2))
        channels = () if k % 2 or dtype not in (np.uint8,) else (3,)
        source = rng.integers(0, 200, (height, width) + channels
                              ).astype(dtype)
        H = _homography(rng, width, height, 0.33)
        size = (int(rng.integers(8, 140)), int(rng.integers(8, 140)))
        expected = cv2.warpPerspective(source, H, size,
                                       flags=cv2.INTER_NEAREST)
        got = image.warp_perspective(source, H, size,
                                     interpolation="nearest")
        np.testing.assert_array_equal(got, expected, err_msg=str(k))


def test_warp_nearest_labels_with_border_value():
    """int32 labels (the unique-CC matching's input) past int16's range,
    with a border value."""
    rng = np.random.default_rng(61)
    labels = rng.integers(0, 100000, (64, 96)).astype(np.int32)
    for _ in range(20):
        H = _homography(rng, 96, 64, 0.2)
        expected = cv2.warpPerspective(labels, H, (96, 64),
                                       flags=cv2.INTER_NEAREST,
                                       borderValue=7)
        got = image.warp_perspective(labels, H, (96, 64), border_value=7,
                                     interpolation="nearest")
        np.testing.assert_array_equal(got, expected)


def test_argument_checks():
    with pytest.raises(ValueError):
        image.circle(np.zeros((5, 5), np.uint8), (2, 2), 1, 255, 1)
    with pytest.raises(ValueError):
        image.threshold_otsu(np.zeros((0, 3), np.uint8))
    with pytest.raises(ValueError):
        image.threshold_otsu(np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError):
        image.warp_perspective(np.zeros((4, 4), np.uint8), np.eye(3),
                               (4, 4), interpolation="cubic")
    with pytest.raises(ValueError):
        image.warp_perspective(np.zeros((4, 4), np.float32), np.eye(3),
                               (4, 4), interpolation="nearest")
