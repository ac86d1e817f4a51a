"""The port's homography helpers (utils/image.py find_homography,
perspective_transform, warp_perspective) against the OpenCV calls they
replace in the word/formula ground truth: ``cv2.warpPerspective``
(INTER_LINEAR, BORDER_CONSTANT) equal at every pixel on binary warps, and
within one gray level on RGB ones; ``cv2.findHomography`` (method 0) and
``cv2.perspectiveTransform`` within rtol 1e-9. Entries that are 0 in exact
arithmetic come out as rounding (about 1e-13 of the largest entry) in both,
so the homography's atol is 1e-9 of its largest entry."""

import cv2
import numpy as np
import pytest

from lecturemath_tpu_torch.utils.image import (find_homography,
                                               perspective_transform,
                                               warp_perspective)

RTOL = 1e-9


def _corners(w, h):
    return np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)


def _near_identity(rng, w, h, jitter=3.0):
    """A homography from a quad to the same quad, each corner moved by up
    to ``jitter`` pixels."""
    src = _corners(w, h) + rng.uniform(-jitter, jitter, (4, 2))
    dst = _corners(w, h) + rng.uniform(-jitter, jitter, (4, 2))
    return src, dst


def _binary(rng, h, w, ink=0.3):
    return np.where(rng.random((h, w)) < ink, 0, 255).astype(np.uint8)


def _assert_h_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("chunk", range(8))
def test_binary_warp_equals_opencv_on_random_quads(chunk):
    """200 random near-identity quads (25 a chunk) at sizes 1-300, binary
    noise images, white and black borders: every pixel equal."""
    rng = np.random.default_rng(100 + chunk)
    for _ in range(25):
        w, h = (int(v) for v in rng.integers(1, 301, 2))
        src, dst = _near_identity(rng, w, h)
        H = cv2.findHomography(src, dst)[0]
        img = _binary(rng, h, w)
        border = int(rng.choice([0, 255]))
        want = cv2.warpPerspective(img, H, (w, h),
                                   borderMode=cv2.BORDER_CONSTANT,
                                   borderValue=(border,) * 3)
        got = warp_perspective(img, H, (w, h), border_value=border)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want), (w, h, int((got != want).sum()))


@pytest.mark.parametrize("channels", [1, 3])
def test_binary_warp_of_the_word_projections(channels):
    """The projections the word tier makes: the annotator's default quad
    (offset 10) with one corner moved, on a keyframe-sized binary of
    glyph-like blocks, white border (warp_binary) and black (warp_keyframe's
    raw warp)."""
    rng = np.random.default_rng(7)
    h, w = 120, 200
    img = np.full((h, w), 255, np.uint8)
    for _ in range(40):
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 6)
        img[y:y + rng.integers(2, 8), x:x + rng.integers(2, 6)] = 0
    if channels == 3:
        img = np.repeat(img[:, :, None], 3, axis=2)
    quad = np.array([[10, 10], [w - 10, 10], [w - 10, h - 10], [10, h - 10]],
                    np.float64)
    for corner, delta in ((0, (4.5, -3.25)), (2, (-7.0, 5.5)),
                          (3, (0.125, 9.0))):
        moved = quad.copy()
        moved[corner] += delta
        H = find_homography(quad, moved)
        for border in (255, 0):
            want = cv2.warpPerspective(img, H, (w, h),
                                       borderMode=cv2.BORDER_CONSTANT,
                                       borderValue=(border,) * 3)
            assert np.array_equal(
                warp_perspective(img, H, (w, h), border_value=border), want)


@pytest.mark.parametrize("seed", range(4))
def test_rgb_warp_within_one_gray_level(seed):
    """RGB noise (every pixel an edge) under strong perspective and other
    output sizes than the input's."""
    rng = np.random.default_rng(seed)
    for _ in range(10):
        w, h = (int(v) for v in rng.integers(1, 160, 2))
        ow, oh = (int(v) for v in rng.integers(1, 160, 2))
        src, dst = _near_identity(rng, w, h, jitter=0.2 * max(w, h))
        H = cv2.findHomography(src, dst)[0]
        if H is None:
            continue
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = cv2.warpPerspective(img, H, (ow, oh)).astype(np.int64)
        got = warp_perspective(img, H, (ow, oh)).astype(np.int64)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("H", [
    np.eye(3),
    np.array([[1.0, 0, 0.5], [0, 1, 0], [0, 0, 1]]),
    np.array([[1.0, 0, 0.25], [0, 1, -0.75], [0, 0, 1]]),
    np.array([[2.0, 0, 0], [0, 2, 0], [0, 0, 1]]),
    np.array([[0.5, 0, 3], [0, 0.5, 2], [0, 0, 1]]),
    np.array([[1.0, 0, 500], [0, 1, 500], [0, 0, 1]]),
    np.array([[1.0, 0.1, -4], [0.05, 0.9, 3], [1e-3, -2e-3, 1]]),
], ids=["identity", "half", "quarter", "up2", "down2", "off", "persp"])
def test_warp_on_the_grid_and_off_the_image(H):
    """Coordinates on the half and quarter grid (round half to even),
    scalings, a map wholly off the image (all border) and a perspective
    whose weight changes sign inside the output; widths around the 16-pixel
    vector step."""
    rng = np.random.default_rng(1)
    for w in (1, 15, 16, 17, 33):
        img = rng.integers(0, 256, (9, w), dtype=np.uint8)
        for border in (0, 7, 255):
            want = cv2.warpPerspective(img, H, (w + 3, 11),
                                       borderMode=cv2.BORDER_CONSTANT,
                                       borderValue=(border,) * 3)
            got = warp_perspective(img, H, (w + 3, 11), border_value=border)
            assert np.array_equal(got, want), (w, border)


def test_warp_rejects_what_it_does_not_follow():
    with pytest.raises(ValueError):
        warp_perspective(np.zeros((4, 4), np.float32), np.eye(3), (4, 4))
    assert warp_perspective(np.zeros((4, 4), np.uint8), np.eye(3),
                            (0, 5)).shape == (5, 0)


@pytest.mark.parametrize("chunk", range(4))
def test_find_homography_matches_opencv(chunk):
    rng = np.random.default_rng(200 + chunk)
    for _ in range(50):
        w, h = (int(v) for v in rng.integers(1, 2000, 2))
        src, dst = _near_identity(rng, w, h, jitter=0.1 * max(w, h))
        _assert_h_close(find_homography(src, dst),
                        cv2.findHomography(src, dst)[0])


def test_find_homography_identity_and_float32_inputs():
    """The default projection's quad onto itself, and points that float32
    rounds (OpenCV converts the points to float32 first)."""
    quad = np.array([[10, 10], [950, 10], [950, 530], [10, 530]], np.float64)
    _assert_h_close(find_homography(quad, quad),
                    cv2.findHomography(quad, quad)[0])
    fine = quad + np.array([[1e-9, 0.1 + 1e-9], [0.3, 1e-8], [0, 0],
                            [0.7, 0.2]])
    _assert_h_close(find_homography(fine, quad),
                    cv2.findHomography(fine, quad)[0])


def test_find_homography_degenerate():
    """No spread in x or in y: OpenCV gives no matrix, neither does the
    port; other point counts than 4 are refused."""
    flat = np.array([[0, 5], [10, 5], [20, 5], [30, 5]], np.float64)
    quad = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    assert cv2.findHomography(flat, quad)[0] is None
    assert find_homography(flat, quad) is None
    assert find_homography(quad, flat) is None
    with pytest.raises(ValueError):
        find_homography(quad[:3], quad[:3])


@pytest.mark.parametrize("shape", [(7, 2), (7, 1, 2)])
def test_perspective_transform_matches_opencv(shape):
    rng = np.random.default_rng(3)
    for _ in range(20):
        src, dst = _near_identity(rng, 300, 200, jitter=30)
        H = cv2.findHomography(src, dst)[0]
        points = rng.uniform(-50, 350, (7, 2))
        want = cv2.perspectiveTransform(points.reshape(-1, 1, 2), H)
        got = perspective_transform(points.reshape(shape), H)
        assert got.shape == shape
        np.testing.assert_allclose(got.reshape(-1, 1, 2), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


def test_perspective_transform_zero_weight():
    """A point on the horizon (weight 0) maps to (0, 0), as in OpenCV."""
    H = np.array([[1.0, 0, 0], [0, 1, 0], [1, 0, -2]])
    points = np.array([[[2.0, 3.0]], [[5.0, 1.0]]])
    np.testing.assert_array_equal(perspective_transform(points, H),
                                  cv2.perspectiveTransform(points, H))
