"""The port's ground-truth tooling (eval/gt_authoring, eval/words,
eval/text_export, eval/visual_alignment and the dataset-prep mask writers)
against the JAX package's on the same seeded keyframes and annotation
(``_torch_tooling_scenario``): every file byte for byte, except the
projection matrices, which the port computes without OpenCV and which are
compared within rtol 1e-9 (atol 1e-9 of the matrix's largest entry, for
entries that are 0 up to rounding); the word boxes, groups and formulas
equal. The port's run with cv2, PIL and matplotlib blocked writes the same
bytes as its run with them allowed."""

import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

import cv2
import numpy as np
import pytest

import lecturemath_tpu.eval.gt_authoring as jax_gt
import lecturemath_tpu.eval.text_export as jax_text_export
import lecturemath_tpu.eval.visual_alignment as jax_alignment
import lecturemath_tpu.eval.words as jax_words
import lecturemath_tpu_torch.eval.gt_authoring as gt
import lecturemath_tpu_torch.eval.text_export as text_export
import lecturemath_tpu_torch.eval.visual_alignment as alignment
import lecturemath_tpu_torch.eval.words as words

import _torch_tooling_scenario as scenario

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("lecturemath_tpu", "lecturemath_tpu_torch")
RTOL = 1e-9
# files holding a projection matrix the port computes itself
PROJECTION_FILES = ("projections.xml", "word_annotations.xml")


def _tree(root):
    files = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, root)] = f.read()
    return files


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{package: (summary, files)}, both run in the same directory."""
    root = str(tmp_path_factory.mktemp("gt_tools") / "run")
    out = {}
    for package in PACKAGES:
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        out[package] = (scenario.run(package, root), _tree(root))
    return out


def _pick(runs, prefix):
    theirs, ours = (runs[p][1] for p in PACKAGES)
    pick = lambda files: {k: v for k, v in files.items()  # noqa: E731
                          if k.startswith(prefix)}
    return pick(theirs), pick(ours)


def _assert_xml_equal(ours, theirs):
    """Same elements and texts, projection entries within RTOL."""
    a, b = ET.fromstring(ours), ET.fromstring(theirs)
    assert [e.tag for e in a.iter()] == [e.tag for e in b.iter()]
    for node_a, node_b in zip(a.iter("Projection"), b.iter("Projection")):
        ha = np.array([float(v.text) for v in node_a], np.float64)
        hb = np.array([float(v.text) for v in node_b], np.float64)
        np.testing.assert_allclose(ha, hb, rtol=RTOL,
                                   atol=RTOL * np.abs(hb).max())
        for v in list(node_a) + list(node_b):
            v.text = ""
    assert ET.tostring(a) == ET.tostring(b)


@pytest.mark.parametrize("prefix", ["annotations/", "binary_only/"])
def test_gt_tree_equals_jax(runs, prefix):
    """export_gt_tree with raw keyframes and portions, and from binaries
    alone with given segments: keyframe and binary PNGs, segments.xml,
    unique_ccs.xml, portions.xml and the portion PNGs."""
    theirs, ours = _pick(runs, prefix)
    assert ours == theirs
    names = {os.path.basename(k) for k in ours}
    assert {"segments.xml", "unique_ccs.xml"} <= names
    if prefix == "annotations/":
        assert "portions.xml" in names
    assert sum(k.endswith(".png") and "/binary/" in k for k in ours) == 3


def test_lecture_annotation_equals_jax(runs):
    theirs, ours = _pick(runs, "lecture.xml")
    assert ours == theirs and ours


@pytest.mark.parametrize("key", ["words", "loaded", "from_trees",
                                 "in_region"])
def test_word_boxes_equal_jax(runs, key):
    """The word boxes of every keyframe (the second through an edited
    projection), as built, as loaded from either word_annotations schema,
    and those inside a region."""
    theirs, ours = (runs[p][0][key] for p in PACKAGES)
    assert ours == theirs
    assert any(len(boxes) > 3 for boxes in ours) if key != "in_region" \
        else ours


@pytest.mark.parametrize("name", PROJECTION_FILES)
def test_projection_xml_equals_jax(runs, name):
    theirs, ours = (runs[p][1][name] for p in PACKAGES)
    _assert_xml_equal(ours, theirs)


@pytest.mark.parametrize("name", ["word_trees.xml", "unique_words.xml",
                                  "formulas.xml"])
def test_word_tier_xml_equals_jax(runs, name):
    theirs, ours = (runs[p][1][name] for p in PACKAGES)
    assert ours == theirs


@pytest.mark.parametrize("key", ["groups", "split", "formulas",
                                 "cc_groups"])
def test_word_groups_and_formulas_equal_jax(runs, key):
    theirs, ours = (runs[p][0][key] for p in PACKAGES)
    assert ours == theirs


def test_warps_equal_jax(runs):
    """warp_keyframe's raw, binary (white border) and object-mask warps
    through the edited projection, byte for byte."""
    theirs, ours = _pick(runs, "warps/")
    assert len(ours) == 3 and ours == theirs


@pytest.mark.parametrize("key", ["warp_points", "unwarp_points"])
def test_warp_points_within_rtol(runs, key):
    theirs, ours = (np.array(runs[p][0][key]) for p in PACKAGES)
    np.testing.assert_allclose(ours, theirs, rtol=RTOL,
                               atol=RTOL * np.abs(theirs).max())


@pytest.mark.parametrize("mode", ["per_frame", "unique"])
def test_text_export_equals_jax(runs, mode):
    """The PNG branch: per-frame images and XML (a binary passed where
    Binary/ was not made is not written, as cv2.imwrite writes nothing
    there), and the unique-box crops chosen by MSE plus text_objects.xml;
    the visible and occluded boxes of every exported frame."""
    theirs, ours = _pick(runs, f"text/{mode}/")
    assert ours == theirs and ours
    assert not any("/Binary/" in k for k in ours)
    assert runs[PACKAGES[1]][0]["text"][mode] == \
        runs[PACKAGES[0]][0]["text"][mode]


def test_mask_writers_equal_jax(runs):
    theirs, ours = _pick(runs, "masks/")
    assert len(ours) == 2 and ours == theirs


def test_text_export_jpeg_branch_equals_jax(tmp_path):
    """The JPEG branch (OpenCV at quality 100 in both)."""
    frames = scenario.keyframes()
    trees = []
    for package, module in (("lecturemath_tpu", jax_text_export),
                            ("lecturemath_tpu_torch", text_export)):
        out = tmp_path / "jpeg"
        shutil.rmtree(out, ignore_errors=True)
        exporter = module.TextAnnotationExporter(
            scenario.lecture_annotation(package), ["text"], "speaker", 0.25,
            module.TextAnnotationExporter.ALL_PER_FRAME, str(out),
            export_images=True)
        exporter.export_img_format = "jpg"
        exporter.initialize(scenario.WIDTH, scenario.HEIGHT)
        for frame_idx in (0, 7, 30):
            binary, raw = frames[frame_idx % 3]
            exporter.handle_frame(raw[:, :, ::-1].copy(), frame_idx)
        trees.append(_tree(str(out)))
    assert trees[0] == trees[1]
    assert sum(k.endswith(".jpg") for k in trees[1]) == 3


def test_text_detection_evaluator_equals_jax():
    """Per-frame GT from the exporter, raw / refined metrics, the
    threshold sweep and both tables."""
    rng = np.random.default_rng(9)
    detections = {}
    for frame_idx in (0, 10, 25, 40):
        boxes = []
        for _ in range(int(rng.integers(0, 4))):
            x, y = rng.integers(0, 100), rng.integers(0, 60)
            boxes.append((x, y, x + rng.integers(2, 30),
                          y + rng.integers(2, 20)))
        detections[frame_idx] = {"bboxes": boxes,
                                 "confidences": rng.random(len(boxes))}
    results = []
    for package, module in (("lecturemath_tpu", jax_text_export),
                            ("lecturemath_tpu_torch", text_export)):
        exporter = module.TextAnnotationExporter(
            scenario.lecture_annotation(package), ["text"], "speaker", 0.25,
            module.TextAnnotationExporter.ALL_PER_FRAME, None)
        exporter.initialize(scenario.WIDTH, scenario.HEIGHT,
                            prepare_dirs=False)
        evaluator = module.TextDetectionEvaluator(min_confidence=0.3)
        lecture = evaluator.evaluate_lecture("lec", exporter, detections,
                                             detections)
        sweep = module.TextDetectionEvaluator()
        sweep.evaluate_lecture_thresholds("lec", exporter, detections)
        results.append((lecture, evaluator.totals_table(),
                        sweep.train_totals()))
    assert results[0] == results[1]


def _views(seed=0):
    """Two views of one keyframe under known homographies (OpenCV warps)."""
    rng = np.random.default_rng(seed)
    base = np.full((240, 320), 0, np.uint8)
    for _ in range(120):
        y, x = rng.integers(0, 230), rng.integers(0, 310)
        base[y:y + rng.integers(2, 10), x:x + rng.integers(2, 10)] = \
            rng.integers(100, 256)
    quad = np.array([[0, 0], [320, 0], [320, 240], [0, 240]], np.float32)
    views = []
    for k in range(2):
        moved = quad + rng.uniform(-12, 12, (4, 2)).astype(np.float32)
        views.append(cv2.warpPerspective(
            base, cv2.getPerspectiveTransform(quad, moved), (320, 240)))
    return views


def test_visual_alignment_equals_jax():
    """SIFT matches, the RANSAC homography, the projection score and the
    best alignment over frame pairs (OpenCV in both)."""
    main, aux = _views()
    results = []
    for module in (jax_alignment, alignment):
        cv2.setRNGSeed(0)
        points_a, points_b = module.matching_points(aux, main)
        cv2.setRNGSeed(0)
        H, inliers = module.estimate_homography(points_a, points_b)
        score = module.projection_score(H, [main], [aux])
        cv2.setRNGSeed(0)
        best, best_score = module.compute_visual_alignment([main], [aux])
        results.append((points_a, points_b, H, inliers, score, best,
                        best_score))
    for theirs, ours in zip(*results):
        assert np.array_equal(np.asarray(ours), np.asarray(theirs))
    assert results[1][4] > 0.5
    empty = np.zeros((0, 2), np.float32)
    assert alignment.estimate_homography(empty, empty) == (None, None)


@pytest.mark.parametrize("module", [jax_words, words],
                         ids=["jax", "port"])
def test_degenerate_projection_quad_raises(module):
    """A quad with no spread: no homography, the projection unchanged."""
    projection = module.KeyFrameProjection.create_default(100, 80)
    flat = np.array([[0, 5], [10, 5], [20, 5], [30, 5]], np.float64)
    with pytest.raises(ValueError):
        projection.update_from_points(flat, flat)
    assert np.array_equal(projection.H, np.identity(3))


@pytest.mark.parametrize("frame", [0, 48, -3])
def test_segment_split_bounds(frame):
    for module in (jax_gt, gt):
        annotation = module.author_lecture_annotation("DB", "t", [], 48)
        with pytest.raises(ValueError):
            module.add_segment_split(annotation, frame)


_BLOCKED_RUN = r"""
import json, sys
BANNED = %r
for name in BANNED:
    sys.modules[name] = None
sys.path[:0] = [%r, %r]
import _torch_tooling_scenario as scenario
summary = scenario.run("lecturemath_tpu_torch", %r)
assert not [m for m in BANNED if sys.modules.get(m) is not None]
print(json.dumps(summary))
"""


def test_tooling_runs_without_opencv(tmp_path):
    """GT authoring, the word tier, the PNG text export and the mask
    writers with cv2, PIL and matplotlib blocked (as on a machine without
    them): the same files and summary as the run with them allowed."""
    root = str(tmp_path / "run")
    runs = []
    for banned in (("cv2", "PIL", "PIL.Image", "matplotlib",
                    "matplotlib.pyplot"), ()):
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        result = subprocess.run(
            [sys.executable, "-c", _BLOCKED_RUN % (
                banned, REPO, os.path.join(REPO, "tests"), root)],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert result.returncode == 0, result.stderr[-3000:]
        runs.append((json.loads(result.stdout.strip().splitlines()[-1]),
                     _tree(root)))
    assert runs[0] == runs[1]
    assert len(runs[0][1]) > 40
