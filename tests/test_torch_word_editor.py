"""The port's word/formula-tier annotator (utils/word_editor.py): the JAX
package's tests of projection editing, word trees, unique-word and
unique-CC linking and formulas run on the port's sessions (the trees-only
word_annotations.xml read back by the JAX package's loader where the JAX
test reads it with the reference's), and parity with the JAX package: the
same HTTP requests (``_torch_editor_scenario.word_annotator``) get the same
JSON and PNG bytes from both servers, and the saved XMLs are equal (byte
for byte, the projection matrices, which the port computes without OpenCV,
within rtol 1e-9). The unique-CC match through a projection warps the
label image as ``cv2.warpPerspective(..., INTER_NEAREST)`` does."""

import json
import os
import shutil
import threading
import urllib.request
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from lecturemath_tpu_torch.eval.annotation import (KeyframeAnnotation,
                                                   UniqueCCGroup)
from lecturemath_tpu_torch.eval.words import load_word_annotations
from lecturemath_tpu_torch.utils.word_editor import (
    FormulaAnnotatorSession, UniqueCCAnnotatorSession, WordAnnotatorSession,
    WordTierEditor, base_dst_from_quad, serve)

import _torch_editor_scenario as scenario

PACKAGES = ("lecturemath_tpu", "lecturemath_tpu_torch")
RTOL = 1e-9

BLOBS_A = ((10, 10), (10, 60), (50, 30))
BLOBS_B = ((11, 11), (10, 60), (50, 30), (70, 90))
REGION_ALL = (0, 0, 128, 96)


def _keyframe(idx, blobs, height=96, width=128):
    binary = np.full((height, width), 255, np.uint8)
    for y, x in blobs:
        binary[y:y + 12, x:x + 20] = 0   # ink=0 convention
    raw = np.stack([binary] * 3, axis=-1)
    kf = KeyframeAnnotation("DB", "lec", idx, 1000.0 * idx, [], raw)
    kf.binary_image = np.stack([binary] * 3, axis=-1)
    return kf


@pytest.fixture()
def keyframes():
    return [_keyframe(0, BLOBS_A), _keyframe(1, BLOBS_B)]


@pytest.fixture()
def word_session(keyframes, tmp_path):
    session = WordAnnotatorSession(keyframes, str(tmp_path))
    session.auto_split(0, 20, 16)
    session.auto_split(1, 20, 16)
    return session


# ---------------------------------------------------------------- words

def test_word_tree_edits(word_session):
    session = word_session
    assert len(session.words(0)) == 3 and len(session.words(1)) == 4

    # a forced vertical cut through a word's middle removes that word:
    # CCs filter by full containment on both sides, exactly like the
    # reference (segmentation_tree.py:20-34 filter_by_interval)
    n_before = len(session.words(0))
    n_leaves = len(session.kf_words[0].tree.leaves())
    session.split_at(0, 20, 16, vertical=True)
    assert len(session.words(0)) == n_before - 1
    assert len(session.kf_words[0].tree.leaves()) == n_leaves + 1

    # merging at the same point collapses that split again
    session.merge_at(0, 18, 16)
    assert len(session.words(0)) == n_before
    assert len(session.kf_words[0].tree.leaves()) == n_leaves

    # the root region cannot be merged away
    session.reset_tree(0)
    with pytest.raises(ValueError):
        session.merge_at(0, 20, 16)

    # reset -> single word (the whole content box); undo restores
    assert len(session.words(0)) == 1
    assert session.undo()
    assert len(session.words(0)) == n_before

    # copy_tree transplants the neighbor's structure
    session.copy_tree(1, direction=-1)
    assert len(session.kf_words[1].tree.leaves()) == \
        len(session.kf_words[0].tree.leaves())


def test_unique_word_matching(word_session):
    session = word_session
    singles = len(session.groups)   # every word its own group
    assert singles == 7

    matches = session.greedy_word_matches(1, REGION_ALL)
    # 3 of kf0's words reappear in kf1 (one shifted by 1px)
    assert len(matches) == 3
    assert all(m["iou"] > 0.5 for m in matches)

    assert session.accept_word_matches(min_iou=0.5) == 3
    assert len(session.groups) == 4   # 3 chains + 1 new word

    # chains span both keyframes now
    chains = [g for g in session.groups if len(g.words_refs) == 2]
    assert len(chains) == 3 and all(g.start_frame == 0 for g in chains)

    # unlinking the region splits them back into singletons
    assert session.remove_word_matches(1, REGION_ALL) == 3
    assert len(session.groups) == 7
    assert session.undo()
    assert len(session.groups) == 4

    # matching again finds nothing new (all already matched)
    assert session.greedy_word_matches(1, REGION_ALL) == []


def test_word_session_save_reload(word_session, keyframes, tmp_path):
    session = word_session
    session.greedy_word_matches(1, REGION_ALL)
    session.accept_word_matches(0.5)
    paths = session.save()
    for path in paths.values():
        assert os.path.exists(path)

    reloaded = WordAnnotatorSession(keyframes, str(tmp_path))
    assert [reloaded.words(i) for i in range(2)] == \
        [session.words(i) for i in range(2)]
    assert len(reloaded.groups) == len(session.groups)
    spans = sorted(len(g.words_refs) for g in reloaded.groups)
    assert spans == sorted(len(g.words_refs) for g in session.groups)


def test_trees_only_schema_loads_in_jax(word_session, keyframes):
    """The JAX package's loader reads the trees-only word_annotations.xml
    the port's session saves (the schema the reference GTWordAnnotator
    writes, gt_word_annotator.py:712-724) to the same words, and so does
    the port's own loader."""
    from lecturemath_tpu.eval import annotation as jax_annotation
    from lecturemath_tpu.eval.words import \
        load_word_annotations as jax_load_word_annotations

    paths = word_session.save()
    jax_keyframes = []
    for kf in keyframes:
        twin = jax_annotation.KeyframeAnnotation(
            "DB", "lec", kf.idx, kf.time, [], kf.raw_image)
        twin.binary_image = kf.binary_image
        jax_keyframes.append(twin)
    theirs = jax_load_word_annotations(paths["words"], jax_keyframes)
    assert [w.get_words() for w in theirs] == \
        [word_session.words(i) for i in range(2)]

    # and our own loader auto-detects the trees-only schema
    back = load_word_annotations(paths["words"], keyframes)
    assert [w.get_words() for w in back] == \
        [word_session.words(i) for i in range(2)]


def test_projection_edits(word_session):
    session = word_session
    quad = [[8.0, 6.0], [120.0, 8.0], [122.0, 90.0], [6.0, 88.0]]
    session.set_projection_quad(0, quad, delta_x=2, delta_y=-1)
    projection = session.kf_words[0].projection
    np.testing.assert_allclose(projection.src_points,
                               np.asarray(quad, np.float64))
    np.testing.assert_allclose(projection.base_dst_points,
                               base_dst_from_quad(np.asarray(quad)))
    # H maps the source quad onto the shifted destination rectangle
    np.testing.assert_allclose(projection.warp_points(quad),
                               projection.dst_points(), atol=1e-6)

    session.copy_projection(1, direction=-1)
    np.testing.assert_allclose(
        session.kf_words[1].projection.H, projection.H)
    assert session.undo()   # copy undone
    assert not np.allclose(session.kf_words[1].projection.H, projection.H)

    # clicks in normal view are warped into segment space
    x, y = session.to_segment_space(0, 30.0, 20.0)
    np.testing.assert_allclose([[x, y]],
                               projection.warp_points([[30.0, 20.0]]))


# ------------------------------------------------------------ unique CCs

def test_unique_cc_matching(keyframes, tmp_path):
    session = UniqueCCAnnotatorSession(keyframes, str(tmp_path))
    assert len(session.groups) == 7   # 3 + 4 singletons

    matches = session.greedy_cc_matches(1, 0, REGION_ALL)
    assert len(matches) == 3
    exact = [m for m in matches if m["recall"] == 1.0]
    assert len(exact) == 2   # two blobs are identical, one shifted

    assert session.accept_cc_matches(0.5, 0.5) == 3
    assert len(session.groups) == 4
    chains = [g for g in session.groups if len(g.cc_refs) == 2]
    assert len(chains) == 3

    # save -> reference-schema unique_ccs.xml loads back identically
    path = session.save()
    cc_group, groups = UniqueCCGroup.groups_from_xml(keyframes, path)
    assert len(groups) == 4
    assert sorted(len(g.cc_refs) for g in groups) == [1, 2, 2, 2]

    # unlink splits chains; undo restores
    assert session.remove_cc_matches(1, REGION_ALL) == 3
    assert len(session.groups) == 7
    assert session.undo()
    assert len(session.groups) == 4

    # the colored render paints linked CCs (not background-only)
    colored = session.render(1, "colored")
    assert (colored != 255).any()


def test_unique_cc_matching_through_projection(tmp_path):
    """A large translation defeats direct overlap but matches through the
    annotator's projection transform (gt_unique_cc_annotator.py:655-677)."""
    kf0 = _keyframe(0, ((10, 10),))
    kf1 = _keyframe(1, ((40, 50),))   # shifted +40x, +30y
    session = UniqueCCAnnotatorSession([kf0, kf1], str(tmp_path))

    assert session.greedy_cc_matches(1, 0, REGION_ALL) == []

    shift = np.asarray([[1.0, 0.0, 40.0], [0.0, 1.0, 30.0],
                        [0.0, 0.0, 1.0]])
    matches = session.greedy_cc_matches(1, 0, REGION_ALL, matrix=shift)
    assert len(matches) == 1 and matches[0]["recall"] == 1.0
    assert session.accept_cc_matches() == 1
    assert len(session.groups) == 1


def test_unique_cc_gap_fill(tmp_path):
    """Matching across a keyframe gap pads the chain with None (reference
    gap fill, gt_unique_cc_annotator.py:766-769)."""
    kfs = [_keyframe(0, ((10, 10),)), _keyframe(1, ((70, 90),)),
           _keyframe(2, ((10, 10),))]
    session = UniqueCCAnnotatorSession(kfs, str(tmp_path))
    matches = session.greedy_cc_matches(2, 0, REGION_ALL)
    assert len(matches) == 1
    assert session.accept_cc_matches() == 1
    group = next(g for g in session.groups if len(g.cc_refs) == 3)
    assert group.cc_refs[1] is None
    # the gapped chain round-trips through the XML schema
    path = session.save()
    _, groups = UniqueCCGroup.groups_from_xml(kfs, path)
    spans = sorted(len(g.cc_refs) for g in groups)
    assert spans == [1, 3]


# -------------------------------------------------------------- formulas

def test_formula_session(keyframes, tmp_path):
    # link CCs first so formulas can span keyframes
    cc_session = UniqueCCAnnotatorSession(keyframes, str(tmp_path))
    cc_session.greedy_cc_matches(1, 0, REGION_ALL)
    cc_session.accept_cc_matches()
    cc_session.save()

    session = FormulaAnnotatorSession(keyframes, str(tmp_path))
    assert len(session.groups) == 4

    selected = session.groups_in_region(0, (0, 0, 128, 40))
    assert len(selected) == 2   # the two top-row blobs
    session.add_formula(selected, "x^2 + y")
    state = session.state()
    assert state["formulas"][0]["latex"] == "x^2 + y"
    assert state["formulas"][0]["first_visible"] == 0
    assert state["formulas"][0]["last_visible"] == 1

    session.set_tag(0, r"\frac{x}{y}")
    assert session.state()["formulas"][0]["latex"] == r"\frac{x}{y}"
    assert session.undo()
    assert session.state()["formulas"][0]["latex"] == "x^2 + y"

    path = session.save()
    reloaded = FormulaAnnotatorSession(keyframes, str(tmp_path))
    assert reloaded.state()["formulas"] == session.state()["formulas"]

    session.del_formula(0)
    assert session.state()["formulas"] == []
    assert session.undo()
    assert len(session.state()["formulas"]) == 1
    assert os.path.exists(path)

    render = session.render(0)
    assert render.shape == keyframes[0].raw_image.shape


# ------------------------------------------------- disk open + HTTP

def test_open_from_exported_tree(tmp_path):
    """Sessions open an export_gt_tree file set directly."""
    from lecturemath_tpu_torch.eval.gt_authoring import export_gt_tree

    binaries = []
    for blobs in (BLOBS_A, BLOBS_B):
        binary = np.full((96, 128), 255, np.uint8)
        for y, x in blobs:
            binary[y:y + 12, x:x + 20] = 0
        binaries.append(binary)
    prefix = export_gt_tree(str(tmp_path), "DB", "lec", [100, 200],
                            [4000.0, 8000.0], binaries)

    session = WordAnnotatorSession.open(prefix)
    session.auto_split(0, 20, 16)
    assert len(session.words(0)) == 3
    session.save()

    cc_session = UniqueCCAnnotatorSession.open(prefix)
    # export_gt_tree already chained identical CCs across keyframes
    assert any(len(g.cc_refs) > 1 for g in cc_session.groups)


def test_http_surface(keyframes, tmp_path):
    editor = WordTierEditor(str(tmp_path), keyframes=keyframes)
    server = serve(editor, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return r.read()

    def post(path, body):
        req = urllib.request.Request(base + path,
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    try:
        assert b"Word/formula annotator" in get("/")
        state = json.loads(get("/api/state?tool=words"))
        assert state["unique_words"] == 2   # default single-region words

        out = post("/api/words/auto_split",
                   {"kf": 0, "x": 20, "y": 16, "normal": False})
        assert out["ok"]
        out = post("/api/words/auto_split",
                   {"kf": 1, "x": 20, "y": 16, "normal": False})
        assert out["ok"]
        out = post("/api/words/match", {"kf": 1, "region": REGION_ALL})
        assert out["ok"] and len(out["result"]) == 3
        out = post("/api/words/accept", {"min_iou": 0.5})
        assert out["ok"] and out["result"] == 3
        assert json.loads(get("/api/state?tool=words"))["unique_words"] == 4

        png = get("/img/words/0?view=projected_bin")
        assert png[:4] == b"\x89PNG"

        out = post("/api/ccs/match",
                   {"kf": 1, "source": 0, "region": REGION_ALL})
        assert out["ok"] and len(out["result"]) == 3
        out = post("/api/ccs/accept", {})
        assert out["ok"] and out["result"] == 3

        out = post("/api/formulas/add",
                   {"kf": 0, "region": [0, 0, 128, 40], "latex": "x"})
        assert out["ok"]
        assert json.loads(
            get("/api/state?tool=formulas"))["formulas"][0]["latex"] == "x"

        # errors surface as ok=False, not 500s
        out = post("/api/words/merge",
                   {"kf": 0, "x": 10000, "y": 16, "normal": False})
        assert out["ok"] is False and "outside" in out["error"]

        out = post("/api/words/save", {})
        assert out["ok"]
        assert os.path.exists(tmp_path / "unique_words.xml")
    finally:
        server.shutdown()
        thread.join(timeout=5)


# -------------------------------------------- round-4 review regressions

def test_degenerate_projection_quad_rejected(word_session):
    """A collinear source quad raises ValueError and leaves the
    projection (H AND inv_H) untouched — no partial assignment."""
    session = word_session
    projection = session.kf_words[0].projection
    H_before = projection.H.copy()
    inv_before = projection.inv_H.copy()
    with pytest.raises(ValueError):
        session.set_projection_quad(
            0, [[10.0, 10.0], [50.0, 10.0], [90.0, 10.0], [30.0, 10.0]])
    np.testing.assert_array_equal(session.kf_words[0].projection.H,
                                  H_before)
    np.testing.assert_array_equal(session.kf_words[0].projection.inv_H,
                                  inv_before)


def test_word_tree_lives_in_warped_space(keyframes, tmp_path):
    """After a non-identity projection edit the tree re-anchors to the
    WARPED binary (reference gt_word_annotator.py:76-134 keeps the whole
    word tier in projected space), and normal-view clicks still land on
    the right region through to_segment_space."""
    from lecturemath_tpu_torch.data.region_tree import RegionTree
    from lecturemath_tpu_torch.eval.words import tree_word_bboxes

    session = WordAnnotatorSession(keyframes, str(tmp_path))
    words_before = session.words(0)

    quad = [[30.0, 20.0], [105.0, 10.0], [110.0, 80.0], [25.0, 88.0]]
    session.set_projection_quad(0, quad)
    projection = session.kf_words[0].projection

    _, proj_bin = projection.warp_keyframe(keyframes[0].raw_image,
                                           keyframes[0].binary_image)
    warped_ink = 255 - proj_bin[:, :, 0]
    expected = tree_word_bboxes(RegionTree.from_binary(warped_ink))
    assert session.words(0) == expected
    assert session.words(0) != words_before

    # a normal-view click on a glyph maps into the warped tree and
    # auto-splits it there (no 'outside the tree' error)
    wx, wy = session.to_segment_space(0, 20.0, 16.0)
    session.auto_split(0, wx, wy)
    assert len(session.words(0)) == 3   # the three blobs, in warped space


def test_word_match_excludes_extended_groups(word_session):
    """Previous-keyframe words whose group already reaches this keyframe
    are not offered as match candidates (appending another frame-1 word
    would break the contiguous chain invariant)."""
    session = word_session
    matches = session.greedy_word_matches(1, REGION_ALL)
    assert len(matches) == 3
    assert session.accept_word_matches(0.5) == 3

    # every kf0 word is now in a group spanning frames 0..1: re-matching
    # the same region must offer nothing, even for still-unmatched kf1
    # words (the 4th blob has no valid prev candidate left)
    assert session.greedy_word_matches(1, REGION_ALL) == []
    for group in session.groups:
        offsets = [group.start_frame + k
                   for k in range(len(group.words_refs))]
        assert offsets == sorted(set(offsets))   # one word per frame


def test_add_formula_returns_sorted_index(keyframes, tmp_path):
    """add_formula returns the index of the NEW formula after the sort
    by first-visibility, not blindly len-1."""
    cc_session = UniqueCCAnnotatorSession(keyframes, str(tmp_path))
    cc_session.greedy_cc_matches(1, 0, REGION_ALL)
    cc_session.accept_cc_matches()
    cc_session.save()

    session = FormulaAnnotatorSession(keyframes, str(tmp_path))
    late = [g.str_id() for g in session.groups if g.start_frame == 1]
    early = [g.str_id() for g in session.groups if g.start_frame == 0]
    assert late and early

    first = session.add_formula(late, "late")
    assert first == 0
    second = session.add_formula(early[:1], "early")
    # the new formula becomes first-visible at frame 0 -> sorts to front
    assert second == 0
    assert session.state()["formulas"][second]["latex"] == "early"
    assert session.state()["formulas"][1]["latex"] == "late"


# ------------------------------------------------- parity with the JAX package

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
    """{package: (answers, reloaded equal, files)} of the word annotator
    scenario over a fresh GT tree, both run in the same directory."""
    root = str(tmp_path_factory.mktemp("word_editor") / "run")
    out = {}
    for package in PACKAGES:
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        answers = scenario.run(package, root, parts=("word_annotator",))
        out[package] = (answers["word_annotator"], answers["words_reloaded"],
                        _tree(root))
    return out


def _strip_projections(value):
    """The answers with each keyframe's projection quad taken out (the
    port computes its matrices without OpenCV; they are compared within
    RTOL in test_projection_xml_within_rtol)."""
    if isinstance(value, dict):
        return {k: _strip_projections(v) for k, v in value.items()
                if k != "src_points"}
    if isinstance(value, list):
        return [_strip_projections(v) for v in value]
    return value


def test_http_answers_equal_jax(runs):
    """Every answer of the two servers for the same requests is equal:
    words, matches (unique CCs through the projection's nearest warp),
    formulas, errors, and the PNG views byte for byte."""
    theirs, ours = (runs[p][0] for p in PACKAGES)
    assert len(ours) == len(theirs) > 40
    for k, (a, b) in enumerate(zip(ours, theirs)):
        assert _strip_projections(a) == _strip_projections(b), (k, a, b)
    assert sum(kind == "png" for kind, _ in ours) >= 8
    merged = [v["result"] for kind, v in ours if kind == "json"
              and isinstance(v, dict) and isinstance(v.get("result"), int)
              and not isinstance(v.get("result"), bool)]
    assert max(merged) > 0     # matches were accepted


def test_reload_equals_saved_state(runs):
    for package in PACKAGES:
        assert runs[package][1], package


@pytest.mark.parametrize("name", ["unique_words.xml", "word_annotations.xml",
                                  "unique_ccs.xml", "formula_ccs.xml"])
def test_saved_xml_equals_jax(runs, name):
    theirs, ours = (runs[p][2] for p in PACKAGES)
    path = os.path.join("annotations", f"{scenario.DB}_"
                        f"{scenario.LECTURE.lower()}", name)
    assert ours[path] == theirs[path]


def test_projection_xml_within_rtol(runs):
    """projections.xml: the same elements and texts, the matrix entries
    within RTOL (atol RTOL of the matrix's largest entry)."""
    theirs, ours = (runs[p][2] for p in PACKAGES)
    path = os.path.join("annotations", f"{scenario.DB}_"
                        f"{scenario.LECTURE.lower()}", "projections.xml")
    a, b = ET.fromstring(ours[path]), ET.fromstring(theirs[path])
    assert [e.tag for e in a.iter()] == [e.tag for e in b.iter()]
    matrices = 0
    for node_a, node_b in zip(a.iter("Projection"), b.iter("Projection")):
        ha = np.array([float(v.text) for v in node_a], np.float64)
        hb = np.array([float(v.text) for v in node_b], np.float64)
        np.testing.assert_allclose(ha, hb, rtol=RTOL,
                                   atol=RTOL * np.abs(hb).max())
        for v in list(node_a) + list(node_b):
            v.text = ""
        matrices += 1
    assert matrices == len(scenario.KEYFRAMES)
    assert ET.tostring(a) == ET.tostring(b)


def test_cc_match_through_projection_uses_nearest_warp(tmp_path):
    """The label image a unique-CC match warps through a projection is
    cv2.warpPerspective(..., INTER_NEAREST) of the source labels, so the
    warped source CCs equal the JAX session's."""
    import lecturemath_tpu.utils.word_editor as jax_word_editor
    from lecturemath_tpu.eval.annotation import \
        KeyframeAnnotation as JaxKeyframe

    def frames(cls):
        out = []
        for idx, blobs in ((0, BLOBS_A), (1, BLOBS_B)):
            binary = np.full((96, 128), 255, np.uint8)
            for y, x in blobs:
                binary[y:y + 12, x:x + 20] = 0
            kf = cls("DB", "lec", idx, 1000.0 * idx, [],
                     np.stack([binary] * 3, axis=-1))
            kf.binary_image = np.stack([binary] * 3, axis=-1)
            out.append(kf)
        return out

    matrix = np.asarray(scenario.CC_MATRIX) @ np.asarray(
        [[1.2, 0.1, -4.0], [0.05, 0.9, 3.0], [2e-3, 1e-3, 1.0]])
    ours = UniqueCCAnnotatorSession(frames(KeyframeAnnotation),
                                    str(tmp_path / "a"))
    theirs = jax_word_editor.UniqueCCAnnotatorSession(
        frames(JaxKeyframe), str(tmp_path / "b"))
    a = ours._warped_source_ccs(0, 1, REGION_ALL, matrix)
    b = theirs._warped_source_ccs(0, 1, REGION_ALL, matrix)
    assert sorted(a) == sorted(b) and a
    for key in a:
        assert (a[key].min_x, a[key].max_x, a[key].min_y, a[key].max_y,
                a[key].size) == (b[key].min_x, b[key].max_x, b[key].min_y,
                                 b[key].max_y, b[key].size)
        np.testing.assert_array_equal(a[key].img, b[key].img)
