"""The evaluation path's geometry without OpenCV or matplotlib, against
them and against the JAX package: ``utils/image.py fill_poly`` equal to
``cv2.fillPoly`` (the object masks), ``eval/lecture_annotation.py
points_in_polygon`` equal to ``matplotlib.path.Path.contains_points`` (the
non-convex polygon overlap), and the JAX-free ops and metrics the port
copies (``ops/overlap.py``, ``text_detector_eval.cc_iou_matching``), all
on seeded inputs and equal exactly."""

import os

import cv2
import numpy as np
import pytest
from matplotlib.path import Path

from lecturemath_tpu.data.cc import extract_ccs as jax_extract_ccs
from lecturemath_tpu.eval.annotation import (KeyframeAnnotation as
                                             JaxKeyframeAnnotation,
                                             KeyframePortion as
                                             JaxKeyframePortion,
                                             VideoObject as JaxVideoObject)
from lecturemath_tpu.eval.lecture_annotation import \
    polygon_intersection_area as jax_polygon_intersection_area
from lecturemath_tpu.eval.text_detector_eval import \
    cc_iou_matching as jax_cc_iou_matching
from lecturemath_tpu.ops import overlap as jax_overlap
from lecturemath_tpu_torch import native
from lecturemath_tpu_torch.data.cc import extract_ccs
from lecturemath_tpu_torch.eval.annotation import (KeyframeAnnotation,
                                                   KeyframePortion,
                                                   VideoObject)
from lecturemath_tpu_torch.eval.lecture_annotation import (
    points_in_polygon, polygon_intersection_area)
from lecturemath_tpu_torch.eval.text_detector_eval import cc_iou_matching
from lecturemath_tpu_torch.ops import (candidate_pairs, pairwise_overlap,
                                       self_candidate_pairs)
from lecturemath_tpu_torch.utils.image import fill_poly

N_POLYGONS = 60   # of each kind: 7 kinds, 420 polygons


def _polygon(kind, rng, h, w):
    """int32 [N, 2] (x, y) vertices of one seeded polygon of ``kind``."""
    if kind == "convex":
        angles = np.sort(rng.uniform(0, 2 * np.pi, rng.integers(3, 12)))
        radius = rng.uniform(2, min(h, w) / 2)
        centre = rng.uniform((radius, radius), (w - radius, h - radius))
        points = centre + radius * np.stack([np.cos(angles),
                                             np.sin(angles)], 1)
    elif kind == "concave":
        angles = np.sort(rng.uniform(0, 2 * np.pi, rng.integers(5, 14)))
        radius = rng.uniform(0.2, 1.0, len(angles)) * min(h, w) / 2
        points = np.array([w / 2, h / 2]) + radius[:, None] * np.stack(
            [np.cos(angles), np.sin(angles)], 1)
    elif kind == "self_crossing":
        points = rng.uniform((0, 0), (w, h), (rng.integers(4, 10), 2))
    elif kind == "outside":
        points = rng.uniform((-w, -h), (2 * w, 2 * h),
                             (rng.integers(3, 9), 2))
    elif kind == "one_or_two_points":
        points = rng.uniform((-2, -2), (w + 2, h + 2),
                             (rng.integers(1, 3), 2))
    elif kind == "collinear":
        start = rng.uniform((-5, -5), (w + 5, h + 5))
        step = rng.integers(-6, 7, 2)
        points = start + np.outer(rng.permutation(rng.integers(3, 7)), step)
    else:  # "large": a keyframe-sized frame
        points = rng.uniform((-50, -50), (w + 50, h + 50),
                             (rng.integers(3, 9), 2))
    return np.asarray(points).astype(np.int32)


KINDS = ["convex", "concave", "self_crossing", "outside",
         "one_or_two_points", "collinear", "large"]


@pytest.mark.parametrize("kind", KINDS)
def test_fill_poly_equals_cv2(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    for case in range(N_POLYGONS):
        if kind == "large":
            h, w = 1080, 1920
        else:
            h, w = (int(v) for v in rng.integers(4, 90, 2))
        pts = _polygon(kind, rng, h, w)
        channels = 3 if case % 5 == 0 else 1
        colour = (255, 40, 7) if channels == 3 else 255
        shape = (h, w, 3) if channels == 3 else (h, w)
        expected = np.zeros(shape, np.uint8)
        cv2.fillPoly(expected, [pts], colour)
        ours = np.zeros(shape, np.uint8)
        assert fill_poly(ours, pts, colour) is ours
        np.testing.assert_array_equal(ours, expected,
                                      err_msg=f"{kind} {case}: {pts.tolist()}")


def test_object_mask_equals_jax(tmp_path):
    """KeyframeAnnotation.update_object_mask with float polygons and boxes,
    some reaching past the frame, against the JAX package's cv2 mask."""
    rng = np.random.default_rng(3)
    for case in range(20):
        h, w = (int(v) for v in rng.integers(20, 120, 2))
        objects = []
        for k in range(int(rng.integers(1, 4))):
            points = rng.uniform((-10, -10), (w + 10, h + 10),
                                 (int(rng.integers(3, 8)), 2))
            objects.append((k, f"o{k}", VideoObject.SHAPE_POLYGON, points))
        raw = np.zeros((h, w, 3), np.uint8)
        ours = KeyframeAnnotation("DB", "l", 0, 0.0,
                                  [VideoObject(*o) for o in objects], raw)
        theirs = JaxKeyframeAnnotation("DB", "l", 0, 0.0,
                                       [JaxVideoObject(*o) for o in objects],
                                       raw)
        np.testing.assert_array_equal(ours.object_mask, theirs.object_mask)


def test_save_portions_bytes_equal_cv2(tmp_path):
    """save_portions writes the portion and binary PNGs cv2.imwrite
    writes."""
    rng = np.random.default_rng(5)
    binary = np.where(rng.random((40, 60)) < 0.1, 0, 255).astype(np.uint8)
    written = []
    for name, kf_cls, portion_cls in (
            ("port", KeyframeAnnotation, KeyframePortion),
            ("jax", JaxKeyframeAnnotation, JaxKeyframePortion)):
        kf = kf_cls("DB", "l", 7, 0.0, [], np.zeros((40, 60, 3), np.uint8))
        kf.portions = [portion_cls(0, 0, 60, 40, binary),
                       portion_cls(10, 5, 20, 10, binary[5:15, 10:30])]
        kf.update_binary_image(True)
        out = str(tmp_path / name)
        kf_cls.save_portions([kf], out)
        written.append(out)
    for rel in ("binary/7.png", "portions/frame_7/0.png",
                "portions/frame_7/1.png", "portions.xml"):
        with open(os.path.join(written[0], rel), "rb") as a, \
                open(os.path.join(written[1], rel), "rb") as b:
            assert a.read() == b.read(), rel


def _grid_points(p, q):
    """The sample grid _raster_intersection_area builds for p and q."""
    lo = np.maximum(p.min(axis=0), q.min(axis=0))
    hi = np.minimum(p.max(axis=0), q.max(axis=0))
    extent = hi - lo
    scale = float(np.clip(np.sqrt(2e6 / (extent[0] * extent[1])), 4, 256))
    nx, ny = (np.ceil(extent * scale).astype(np.int64) + 1)
    xs = lo[0] + (np.arange(nx) + 0.5) / scale
    ys = lo[1] + (np.arange(ny) + 0.5) / scale
    grid_x, grid_y = np.meshgrid(xs, ys)
    return np.column_stack([grid_x.ravel(), grid_y.ravel()])


def _non_convex(rng, n, size=30):
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    radius = rng.uniform(0.2, 1.0, n) * size / 2
    points = size / 2 + radius[:, None] * np.stack([np.cos(angles),
                                                    np.sin(angles)], 1)
    return np.round(points)


@pytest.mark.parametrize("seed", range(4))
def test_points_in_polygon_equals_matplotlib_on_raster_grids(seed):
    rng = np.random.default_rng(seed)
    for _ in range(3):
        p, q = _non_convex(rng, 7), _non_convex(rng, 9) + rng.integers(-4, 5)
        points = _grid_points(p, q)
        for polygon in (p, q):
            np.testing.assert_array_equal(
                points_in_polygon(polygon, points),
                Path(polygon).contains_points(points))


@pytest.mark.parametrize("seed", range(4))
def test_points_in_polygon_equals_matplotlib_on_vertices_and_edges(seed):
    """Points on every vertex, on each edge (its midpoint, its quarter
    points, and grid points that integer-vertex edges pass through), and a
    half-pixel grid."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(20):
        polygon = rng.integers(0, 16, (int(rng.integers(3, 9)), 2)) \
            .astype(np.float64)
        ends = np.roll(polygon, -1, axis=0)
        on_edges = [polygon + t * (ends - polygon)
                    for t in (0.25, 0.5, 0.75, rng.random())]
        grid = np.stack(np.meshgrid(np.arange(-1, 17, 0.5),
                                    np.arange(-1, 17, 0.5)), -1).reshape(-1, 2)
        points = np.concatenate([polygon, *on_edges, grid])
        np.testing.assert_array_equal(points_in_polygon(polygon, points),
                                      Path(polygon).contains_points(points))
    assert not points_in_polygon(polygon[:2], points).any()


@pytest.mark.parametrize("seed", range(3))
def test_polygon_intersection_area_equals_jax(seed):
    """Non-convex x non-convex pairs take the raster fallback; convex ones
    the exact clip."""
    rng = np.random.default_rng(200 + seed)
    for _ in range(4):
        p = _non_convex(rng, int(rng.integers(5, 9)))
        q = _non_convex(rng, int(rng.integers(5, 9))) + rng.integers(-6, 7, 2)
        assert polygon_intersection_area(p, q) == \
            jax_polygon_intersection_area(p, q)
    box = np.array([[2.0, 3.0], [20.0, 3.0], [20.0, 18.0], [2.0, 18.0]])
    assert polygon_intersection_area(p, box) == \
        jax_polygon_intersection_area(p, box)


def _ccs(seed, extract):
    rng = np.random.default_rng(seed)
    binary = np.where(rng.random((60, 80)) < 0.35, 255, 0).astype(np.uint8)
    return extract(binary, filter_small=False)


@pytest.mark.parametrize("use_native", [True, False])
def test_pairwise_overlap_equals_jax(use_native, monkeypatch):
    """Candidate pairs and matched-pixel counts, native and numpy."""
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    ours_a, ours_b = _ccs(1, extract_ccs), _ccs(2, extract_ccs)
    theirs_a, theirs_b = _ccs(1, jax_extract_ccs), _ccs(2, jax_extract_ccs)
    pairs = candidate_pairs(ours_a, ours_b)
    np.testing.assert_array_equal(pairs,
                                  jax_overlap.candidate_pairs(theirs_a,
                                                              theirs_b))
    assert len(pairs) > 8   # past the small-list shortcut
    np.testing.assert_array_equal(
        pairwise_overlap(ours_a, ours_b, pairs),
        jax_overlap.pairwise_overlap(theirs_a, theirs_b, pairs))
    np.testing.assert_array_equal(
        self_candidate_pairs(ours_a),
        jax_overlap.self_candidate_pairs(theirs_a))


@pytest.mark.parametrize("seed", range(3))
def test_cc_iou_matching_equals_jax(seed):
    rng = np.random.default_rng(300 + seed)
    gt = np.zeros((50, 70), np.uint8)
    for y, x in rng.integers(0, (44, 62), (8, 2)):
        gt[y:y + 6, x:x + 8] = 255
    pred = np.roll(gt, int(rng.integers(-2, 3)), axis=1)
    pred[rng.random(pred.shape) < 0.05] = 255
    assert cc_iou_matching(pred, gt) == jax_cc_iou_matching(pred, gt)
