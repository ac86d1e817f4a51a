"""The port's classical binarizers (ops/classical.py), its interval index
and ``CCTracker.add_frame(input_binary=False)`` against the JAX package's
on the same seeded inputs, and its morphology (utils/image.py dilate,
morph_close, morph_open) against OpenCV. The background-subtraction and
chalkboard methods, and the tracker's classical path, run with cv2 and PIL
unimportable for the port."""

import sys

import cv2
import numpy as np
import pytest

from lecturemath_tpu.ops import classical as jax_classical
from lecturemath_tpu.ops.interval_index import IntervalIndex as JaxIndex
from lecturemath_tpu.pipeline.cc_tracking import CCTracker as JaxTracker
from lecturemath_tpu_torch.ops import IntervalIndex, classical
from lecturemath_tpu_torch.pipeline.cc_tracking import CCTracker
from lecturemath_tpu_torch.utils import image as timage

BLOCKED = ("cv2", "PIL")


@pytest.fixture
def no_cv2(monkeypatch):
    """cv2 and PIL unimportable while the port runs (the JAX reference is
    computed before the fixture's test body blocks them)."""
    def block():
        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                monkeypatch.delitem(sys.modules, name)
        for name in BLOCKED:
            monkeypatch.setitem(sys.modules, name, None)
    return block


def board_image(seed, dark=False):
    """A whiteboard- (or chalkboard-) style image: a background level,
    random strokes, noise — tests/test_classical_ops.py's fuzz inputs."""
    rng = np.random.default_rng(100 + seed)
    height, width = int(rng.integers(40, 120)), int(rng.integers(60, 160))
    image = np.full((height, width), int(rng.integers(150, 240)), np.uint8)
    for _ in range(int(rng.integers(1, 6))):
        y = int(rng.integers(0, height - 8))
        x = int(rng.integers(0, width - 12))
        image[y:y + int(rng.integers(3, 9)),
              x:x + int(rng.integers(5, 13))] = int(rng.integers(10, 90))
    image = np.clip(image.astype(int)
                    + rng.normal(0, rng.uniform(1, 4), image.shape),
                    0, 255).astype(np.uint8)
    return 255 - image if dark else image


def rgb_board(seed, height=96, width=128):
    from lecturemath_tpu_torch.utils.synthetic import synthetic_rgb_lecture

    rgb, _, _, _ = synthetic_rgb_lecture(seed=seed, n_frames=4, height=height,
                                         width=width, n_boards=1,
                                         glyphs_per_board=6)
    return rgb


@pytest.mark.parametrize("seed", range(5))
def test_cv2_free_methods_equal_jax(seed, no_cv2):
    gray = board_image(seed)
    rgb = np.stack([gray, 255 - gray, gray // 2], axis=-1)
    dark = board_image(seed, dark=True)
    want = [jax_classical.background_subtraction_binarize(gray),
            jax_classical.background_subtraction_binarize(rgb),
            jax_classical.chalkboard_binarize(dark),
            jax_classical.chalkboard_binarize_mask(dark),
            jax_classical.binarize(gray, jax_classical.METHOD_CHALKBOARD),
            jax_classical.binarize(
                gray, jax_classical.METHOD_BACKGROUND_SUBTRACTION)]
    no_cv2()
    got = [classical.background_subtraction_binarize(gray),
           classical.background_subtraction_binarize(rgb),
           classical.chalkboard_binarize(dark),
           classical.chalkboard_binarize_mask(dark),
           classical.binarize(gray, classical.METHOD_CHALKBOARD),
           classical.binarize(gray, classical.METHOD_BACKGROUND_SUBTRACTION)]
    for ours, theirs in zip(got, want):
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("seed", range(3))
def test_cv2_methods_equal_jax(seed):
    """The methods that need OpenCV's Canny and bilateral filter (they
    import it when called, as the JAX package's do)."""
    gray = board_image(seed)
    rgb = np.stack([gray] * 3, axis=-1)
    dark = 255 - gray
    for name, args in (("subtraction_k_binarize", (gray,)),
                       ("subtraction_k_binarize", (dark, True)),
                       ("edge_based_region_binarize", (rgb,)),
                       ("edge_based_region_binarize", (gray,))):
        ours = getattr(classical, name)(*args)
        theirs = getattr(jax_classical, name)(*args)
        assert ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, np.asarray(theirs))
    for method in (classical.METHOD_EDGE_BASED,
                   classical.METHOD_SUBTRACTION_K):
        np.testing.assert_array_equal(
            classical.binarize(gray, method),
            np.asarray(jax_classical.binarize(gray, method)))
    with pytest.raises(ValueError):
        classical.binarize(gray, 9)


def test_edge_based_frame_equals_jax():
    frame = rgb_board(2, 120, 160)[3]
    frame[10:110, 10:150] = np.clip(frame[10:110, 10:150].astype(int) + 10,
                                    0, 255)
    box, content = classical.edge_based_frame_binarize(frame)
    j_box, j_content = jax_classical.edge_based_frame_binarize(frame)
    assert tuple(int(v) for v in box) == tuple(int(v) for v in j_box)
    np.testing.assert_array_equal(content, j_content)


@pytest.mark.parametrize("size", [3, 4, 5, 13, 14, 15])
def test_dilate_close_open_equal_cv2(size):
    """Even kernels put the anchor past the centre, and OpenCV does not
    mirror the kernel for dilate: both must hold."""
    kernel = timage.ellipse_kernel(size)
    rng = np.random.default_rng(size)
    for trial in range(4):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        if trial % 2:
            img = np.where(rng.random((h, w)) < 0.1, 0, 230).astype(np.uint8)
        if trial == 3:
            img = np.repeat(img[..., None], 3, axis=-1)
        np.testing.assert_array_equal(timage.dilate(img, kernel),
                                      cv2.dilate(img, kernel))
        np.testing.assert_array_equal(
            timage.morph_close(img, kernel),
            cv2.morphologyEx(img, cv2.MORPH_CLOSE, kernel))
        np.testing.assert_array_equal(
            timage.morph_open(img, kernel),
            cv2.morphologyEx(img, cv2.MORPH_OPEN, kernel))
    with pytest.raises(ValueError, match="runs"):
        timage.dilate(np.zeros((4, 4), np.uint8),
                      np.array([[1, 0, 1]], np.uint8))


@pytest.mark.parametrize("min_pixels", [0, 1, 5, 40])
def test_filter_small_ccs_equals_jax(min_pixels):
    rng = np.random.default_rng(min_pixels)
    binary = (rng.random((80, 100)) < 0.3).astype(np.uint8) * 255
    np.testing.assert_array_equal(
        classical.filter_small_ccs(binary, min_pixels),
        jax_classical.filter_small_ccs(binary, min_pixels))
    empty = np.zeros((10, 10), np.uint8)
    np.testing.assert_array_equal(classical.filter_small_ccs(empty, 3),
                                  jax_classical.filter_small_ccs(empty, 3))


def test_interval_index_equals_jax():
    rng = np.random.default_rng(8)
    ours, theirs = IntervalIndex(), JaxIndex()
    other, j_other = IntervalIndex(), JaxIndex()
    added = []
    for k in range(60):
        start = int(rng.integers(0, 100))
        end = start + int(rng.integers(1, 20))
        for index, jax_index in ((ours, theirs), (other, j_other)):
            index.add(start, end, k)
            jax_index.add(start, end, k)
        added.append((start, end, k))
    for start, end, value in added[::7]:
        assert ours.remove(start, end, value) == theirs.remove(start, end,
                                                               value)
    assert ours.remove(-5, 0, "absent") is theirs.remove(-5, 0, "absent")
    assert list(ours) == list(theirs) and len(ours) == len(theirs)
    assert ours.find_matches(other) == theirs.find_matches(j_other)


def _track(tracker_cls, frames):
    tracker = tracker_cls(width=frames.shape[2], height=frames.shape[1],
                          min_recall=0.85, min_precision=0.85, max_gap=10)
    for frame in frames:
        tracker.add_frame(frame, input_binary=False)
    return tracker


def test_tracker_classical_path_equals_jax(no_cv2):
    """``add_frame(input_binary=False)`` binarizes each RGB frame by
    background subtraction before tracking, as the JAX tracker does."""
    frames = rgb_board(4)
    theirs = _track(JaxTracker, frames)
    no_cv2()
    ours = _track(CCTracker, frames)
    assert len(ours.unique_ccs) == len(theirs.unique_ccs) > 0
    assert ours.unique_cc_frames == theirs.unique_cc_frames
    for mine, other in zip(ours.unique_ccs, theirs.unique_ccs):
        assert (mine.min_x, mine.max_x, mine.min_y, mine.max_y, mine.size) \
            == (other.min_x, other.max_x, other.min_y, other.max_y,
                other.size)
        np.testing.assert_array_equal(mine.img, other.img)
