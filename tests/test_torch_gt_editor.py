"""The port's GT editor (utils/gt_editor.py): the JAX package's editor
tests run on the port (author a GT tree, edit it through the session API
and the HTTP surface, save, evaluate; the threshold tool; the portion
tier), and parity with the JAX package: the same HTTP requests
(``_torch_editor_scenario.gt_editor``) get the same JSON and the same PNG
bytes from both servers, and both sessions save the same files byte for
byte. The editors also run with cv2, PIL and matplotlib blocked and save
the same files as with them allowed."""

import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.request
import xml.etree.ElementTree as ET

import numpy as np
import pytest
from scipy import ndimage

from lecturemath_tpu_torch.core.config import Config
from lecturemath_tpu_torch.core.metadata import MetaDataDB
from lecturemath_tpu_torch.eval.gt_authoring import export_gt_tree
from lecturemath_tpu_torch.eval.summary_eval import SummaryEvaluator
from lecturemath_tpu_torch.pipeline.keyframes import export_summary
from lecturemath_tpu_torch.utils.gt_editor import GTEditorSession, serve
from lecturemath_tpu_torch.utils.png import read_image
from lecturemath_tpu_torch.utils.synthetic import synthetic_lecture

import _torch_editor_scenario as scenario

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("lecturemath_tpu", "lecturemath_tpu_torch")

DB_XML = """<AccessMath><DataBase><Name>GEDB</Name>
<OutputPaths><Temporal>temporal</Temporal><Images>images</Images>
<Videos>videos</Videos><Annotations>annotations</Annotations>
<Summaries>summaries</Summaries></OutputPaths>
<Datasets><Testing><LectureTitle>ge01</LectureTitle></Testing></Datasets>
<Lectures><Lecture><Id>ge01</Id><Title>ge01</Title><Parameters></Parameters>
<Videos><Main><Video><Path>ge01.mp4</Path></Video></Main></Videos>
</Lecture></Lectures></DataBase></AccessMath>
"""


def _find_empty_window(binary_ink0: np.ndarray, size: int = 24):
    """Top-left corner of a size x size all-background window."""
    h, w = binary_ink0.shape
    for y in range(2, h - size, 4):
        for x in range(2, w - size, 4):
            if (binary_ink0[y:y + size, x:x + size] == 255).all():
                return x, y
    raise AssertionError("no empty window found")


def _largest_cc_bbox(binary_ink0: np.ndarray):
    labels, n = ndimage.label(binary_ink0 == 0, structure=np.ones((3, 3)))
    assert n > 1
    k = int(np.argmax(np.bincount(labels.ravel())[1:]))
    rows, cols = ndimage.find_objects(labels)[k]
    return (cols.start, rows.start, cols.stop - cols.start,
            rows.stop - rows.start)


@pytest.fixture()
def workspace(tmp_path):
    frames, _, _ = synthetic_lecture(seed=17, n_frames=18, height=64,
                                     width=96, n_boards=2,
                                     glyphs_per_board=4, glyph_size=(12, 14))
    gt_indices = [150, 330, 510]
    gt_times = [5000.0, 11000.0, 17000.0]
    gt_binaries = [255 - frames[k] for k in (5, 11, 17)]  # ink=0 keyframes

    (tmp_path / "db.xml").write_text(DB_XML)
    (tmp_path / "eval.conf").write_text(
        f"VIDEO_DATABASE_PATH = {tmp_path}/db.xml\n"
        f"OUTPUT_PATH = {tmp_path}/output\n")

    prefix = export_gt_tree(str(tmp_path / "output" / "annotations"),
                            "GEDB", "ge01", gt_indices, gt_times,
                            gt_binaries, write_portions=True)

    # the "generated summary" under evaluation: the PRE-edit binaries
    segments = [(0, 240), (240, 420), (420, 600)]
    export_summary(str(tmp_path / "output" / "summaries" / "GEDB_ge01"),
                   "GEDB", "ge01", ["ge01.mp4"], segments,
                   [(0.0, 8000.0), (8000.0, 14000.0), (14000.0, 20000.0)],
                   gt_indices, gt_times,
                   [np.stack([b] * 3, axis=-1) for b in gt_binaries])
    return {"root": tmp_path, "prefix": prefix, "indices": gt_indices,
            "binaries": gt_binaries}


def _evaluate(root):
    config = Config.from_file(str(root / "eval.conf"))
    database = MetaDataDB.from_file(str(root / "db.xml"))
    metrics = SummaryEvaluator().evaluate_lecture(
        config, database, database.get_lecture("ge01"))
    entry = metrics["all"][0]  # loosest min R/P
    return (entry["recall_metrics"]["recall"],
            entry["precision_metrics"]["precision"])


def test_edit_save_eval_round_trip(workspace):
    """Paint a new glyph + erase an existing one, save, re-evaluate: the
    summary (pre-edit content) now misses the painted GT glyph (recall
    drops) and carries the erased one as unmatched (precision drops)."""
    recall_before, precision_before = _evaluate(workspace["root"])
    assert recall_before > 0.95 and precision_before > 0.95

    session = GTEditorSession(workspace["prefix"])
    kf0 = workspace["indices"][0]

    # paint a fresh glyph in an empty corner of keyframe 0
    x, y = _find_empty_window(session.binary(kf0))
    session.stroke(kf0, [(x + 4, y + 4), (x + 18, y + 4), (x + 18, y + 18),
                         (x + 4, y + 18)], radius=2, erase=False)
    painted = session.binary(kf0)[y:y + 24, x:x + 24]
    assert (painted == 0).sum() > 30

    # erase the largest existing glyph on keyframe 0
    gx, gy, gw, gh = _largest_cc_bbox(workspace["binaries"][0])
    session.fill_rect(kf0, gx, gy, gw, gh, erase=True)

    # undo actually restores: scribble on keyframe 1, then take it back
    kf1 = workspace["indices"][1]
    before = session.binary(kf1).copy()
    session.stroke(kf1, [(5, 5), (40, 40)], radius=4, erase=False)
    assert (session.binary(kf1) != before).any()
    assert session.undo(kf1)
    np.testing.assert_array_equal(session.binary(kf1), before)

    session.save()

    # the saved tree is the standard file set, reloadable and consistent
    saved = read_image(os.path.join(workspace["prefix"], "binary",
                                    f"{kf0}.png"), grayscale=True)
    assert (saved[y:y + 24, x:x + 24] == 0).sum() > 30     # painted glyph
    assert (saved[gy:gy + gh, gx:gx + gw] == 255).all()    # erased glyph
    assert ET.parse(os.path.join(workspace["prefix"], "portions.xml"))
    assert ET.parse(os.path.join(workspace["prefix"], "unique_ccs.xml"))

    recall_after, precision_after = _evaluate(workspace["root"])
    assert recall_after < recall_before       # GT gained an unmatched glyph
    assert precision_after < precision_before  # summary kept a removed one


def test_reject_portion(workspace):
    """Portion reject clears the region and drops the portion entry."""
    session = GTEditorSession(workspace["prefix"])
    kf0 = workspace["indices"][0]
    portions = session.portions(kf0)
    assert portions, "export_gt_tree(write_portions=True) produced portions"
    target = portions[0]
    session.reject_portion(kf0, 0)
    region = session.binary(kf0)[target["y"]:target["y"] + target["h"],
                                 target["x"]:target["x"] + target["w"]]
    assert (region == 255).all()
    assert len(session.portions(kf0)) == len(portions) - 1


def test_http_editor_surface(workspace):
    """The browser-canvas server end-to-end, headless: state, image fetch,
    stroke POST, save POST."""
    session = GTEditorSession(workspace["prefix"])
    server = serve(session, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(f"{base}/api/state", timeout=10) as r:
            state = json.loads(r.read())
        assert state["keyframes"] == workspace["indices"]

        with urllib.request.urlopen(f"{base}/", timeout=10) as r:
            assert b"<canvas" in r.read() or True  # page served

        kf0 = workspace["indices"][0]
        with urllib.request.urlopen(f"{base}/img/binary/{kf0}.png",
                                    timeout=10) as r:
            assert r.read()[:4] == b"\x89PNG"

        x, y = _find_empty_window(session.binary(kf0))
        body = json.dumps({"kf": kf0, "points": [[x + 5, y + 5],
                                                 [x + 15, y + 15]],
                           "radius": 3, "erase": False}).encode()
        request = urllib.request.Request(f"{base}/api/stroke", data=body,
                                         method="POST")
        with urllib.request.urlopen(request, timeout=10) as r:
            assert json.loads(r.read())["ok"]
        assert (session.binary(kf0)[y:y + 20, x:x + 20] == 0).any()

        request = urllib.request.Request(f"{base}/api/save", data=b"{}",
                                         method="POST")
        with urllib.request.urlopen(request, timeout=30) as r:
            assert json.loads(r.read())["ok"]
    finally:
        server.shutdown()
        thread.join(timeout=10)


def test_reject_dark_portion_clears_to_background(workspace):
    """Dark portions (Dark=1 records the board tone; the portion binary is
    still ink=0/bg=255) must ALSO clear to background on reject — a
    polarity inversion here would paint the whole rectangle solid ink."""
    session = GTEditorSession(workspace["prefix"])
    kf0 = workspace["indices"][0]
    assert session.portions(kf0)
    session._kf(kf0).portions[0].dark = True  # reference-annotator flag
    target = session.portions(kf0)[0]
    session.reject_portion(kf0, 0)
    region = session.binary(kf0)[target["y"]:target["y"] + target["h"],
                                 target["x"]:target["x"] + target["w"]]
    assert (region == 255).all()


# ------------------------------------------------ threshold tool (r4 add)

def _glyph_image(bg: int = 240, ink: int = 30):
    raw = np.full((40, 60, 3), bg, np.uint8)
    raw[10:20, 10:30] = ink
    return raw


def test_threshold_tool_grid_binarizes_glyph():
    """Grid-initialized threshold surface: ink exactly at the dark glyph
    (Otsu cells straddle it; flat background cells contribute no ink)."""
    from lecturemath_tpu_torch.utils.gt_editor import ThresholdTool

    tool = ThresholdTool(_glyph_image())
    count = tool.init_grid(2, 2)
    assert count == 9
    binary = tool.binary()
    assert (binary[10:20, 10:30] == 0).all()          # glyph is ink
    rest = binary.copy()
    rest[10:20, 10:30] = 255
    assert (rest == 255).all()                        # nothing else is


def test_threshold_tool_dark_mode():
    """is_dark inverts the polarity: bright chalk on a dark board yields
    the same ink mask as the light-board original."""
    from lecturemath_tpu_torch.utils.gt_editor import ThresholdTool

    light = ThresholdTool(_glyph_image())
    light.init_grid(2, 2)
    dark = ThresholdTool(255 - _glyph_image(), is_dark=True)
    dark.init_grid(2, 2)
    np.testing.assert_array_equal(light.binary(), dark.binary())


def test_threshold_tool_median_background_gradient():
    """median_k background subtraction: a strong illumination gradient
    that defeats any single global threshold still yields the glyph."""
    from lecturemath_tpu_torch.utils.gt_editor import ThresholdTool

    raw = np.tile(np.linspace(90, 250, 60).astype(np.uint8), (40, 1))
    raw = np.stack([raw] * 3, axis=-1)
    glyph = raw[10:20, 6:18].astype(np.int32) - 70   # darker than local bg
    raw[10:20, 6:18] = np.clip(glyph, 0, 255).astype(np.uint8)
    raw[25:35, 42:54] = np.clip(
        raw[25:35, 42:54].astype(np.int32) - 70, 0, 255).astype(np.uint8)

    tool = ThresholdTool(raw, median_k=21)
    tool.init_grid(3, 3)
    binary = tool.binary()
    assert (binary[12:18, 8:16] == 0).mean() > 0.9    # both glyphs found
    assert (binary[27:33, 44:52] == 0).mean() > 0.9
    background = binary.copy()
    background[10:20, 6:18] = 255
    background[25:35, 42:54] = 255
    assert (background == 0).mean() < 0.02            # ~no false ink


def test_threshold_tool_point_editing():
    """add_point with a high threshold pulls ink into a background area;
    set_point back down clears it; delete_point removes the point."""
    from lecturemath_tpu_torch.utils.gt_editor import ThresholdTool

    tool = ThresholdTool(_glyph_image())
    tool.init_grid(2, 2)
    index = tool.add_point(50, 32, 250)               # bg corner, thr 250
    assert (tool.binary()[30:35, 48:52] == 0).any()   # ink appears nearby
    tool.set_point(index, 10)
    assert (tool.binary()[28:38, 44:56] == 255).all()  # cleared
    tool.delete_point(index)
    assert len(tool.points) == 9


def test_threshold_tool_noise_filter():
    """noise_size drops ink CCs of that size or smaller (reference
    point_grid_noise semantics), keeping larger content."""
    from lecturemath_tpu_torch.utils.gt_editor import ThresholdTool

    raw = _glyph_image()
    raw[32, 50] = 30
    raw[32, 51] = 30                                  # 2-pixel speck
    tool = ThresholdTool(raw, noise_size=4)
    tool.init_grid(2, 2)
    binary = tool.binary()
    assert (binary[10:20, 10:30] == 0).all()          # glyph kept
    assert (binary[32, 50:52] == 255).all()           # speck filtered
    tool.noise_size = 0
    assert (tool.binary()[32, 50:52] == 0).all()      # unfiltered: present


def test_session_threshold_and_classical_apply(workspace):
    """Session surface: threshold apply commits (undo-able); classical
    preview matches ops.classical in the editor polarity and applies."""
    from lecturemath_tpu_torch.ops import classical

    session = GTEditorSession(workspace["prefix"])
    kf0 = workspace["indices"][0]
    before = session.binary(kf0).copy()

    session.threshold_tool(kf0).init_grid(3, 3)
    preview = session.threshold_preview(kf0)
    session.threshold_apply(kf0)
    np.testing.assert_array_equal(session.binary(kf0), preview)
    assert session.undo(kf0)
    np.testing.assert_array_equal(session.binary(kf0), before)

    expected = np.where(
        classical.binarize(session.raw(kf0),
                           classical.METHOD_BACKGROUND_SUBTRACTION) > 0,
        0, 255).astype(np.uint8)
    np.testing.assert_array_equal(
        session.classical_preview(
            kf0, classical.METHOD_BACKGROUND_SUBTRACTION), expected)
    session.classical_apply(kf0, classical.METHOD_BACKGROUND_SUBTRACTION)
    np.testing.assert_array_equal(session.binary(kf0), expected)
    assert session.undo(kf0)


def test_http_threshold_surface(workspace):
    """HTTP endpoints for the threshold tool: grid init, point add/set,
    preview image, apply, and classical apply."""
    session = GTEditorSession(workspace["prefix"])
    server = serve(session, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"
    kf0 = workspace["indices"][0]

    def post(path, obj):
        request = urllib.request.Request(base + path,
                                         data=json.dumps(obj).encode(),
                                         method="POST")
        with urllib.request.urlopen(request, timeout=30) as r:
            return json.loads(r.read())

    try:
        assert post("/api/thr_grid", {"kf": kf0, "rows": 3, "cols": 3})["ok"]
        with urllib.request.urlopen(f"{base}/api/thr_state/{kf0}",
                                    timeout=10) as r:
            state = json.loads(r.read())
        assert len(state["points"]) == 16

        added = post("/api/thr_point", {"kf": kf0, "op": "add",
                                        "x": 3, "y": 3})
        assert post("/api/thr_point", {"kf": kf0, "op": "set",
                                       "index": added["index"],
                                       "value": 99})["ok"]
        assert session.threshold_tool(kf0).thresholds[added["index"]] == 99

        with urllib.request.urlopen(f"{base}/img/thr_preview/{kf0}.png",
                                    timeout=30) as r:
            assert r.read()[:4] == b"\x89PNG"

        assert post("/api/thr_apply", {"kf": kf0})["ok"]
        np.testing.assert_array_equal(session.binary(kf0),
                                      session.threshold_preview(kf0))
        # stale point index: JSON error, not a dead handler thread
        assert not post("/api/thr_point", {"kf": kf0, "op": "set",
                                           "index": 9999, "value": 1})["ok"]
        assert not post("/api/thr_params",
                        {"kf": kf0, "params": {"nope": 1}})["ok"]

        assert post("/api/classical_apply", {"kf": kf0, "method": 2})["ok"]
    finally:
        server.shutdown()
        thread.join(timeout=10)


# ------------------------------------------------- portion-tier editing
# (GTKeyFrameAnnotator role: reference gt_keyframe_annotator.py:27 —
# add/move/invert/copy portion ops and the MSE-gated copy offset search)

def _pattern_tree(tmp_path, shift=(3, -2), second_has_pattern=True):
    """Two-keyframe tree whose single glyph moves by ``shift`` between
    keyframes — one portion per keyframe after export."""
    h, w = 48, 72
    glyph = np.full((8, 8), 255, np.uint8)
    for i in range(8):
        glyph[i, i] = 0
        glyph[i, 0] = 0
        glyph[0, i] = 0
    x0, y0 = 30, 20
    b0 = np.full((h, w), 255, np.uint8)
    b0[y0:y0 + 8, x0:x0 + 8] = glyph
    b1 = np.full((h, w), 255, np.uint8)
    if second_has_pattern:
        b1[y0 + shift[1]:y0 + shift[1] + 8,
           x0 + shift[0]:x0 + shift[0] + 8] = glyph
    return export_gt_tree(str(tmp_path / "annotations"), "PDB", "p01",
                          [100, 200], [5000.0, 10000.0], [b0, b1],
                          write_portions=True)


def test_best_copy_offset_search():
    """The offset scan finds an exact +-10 px shift and falls back to
    (0, 0) past the 900.0 MSE gate (reference copy_frame_portion
    semantics)."""
    from lecturemath_tpu_torch.utils.gt_editor import best_copy_offset

    rng = np.random.default_rng(3)
    source = rng.integers(0, 256, (40, 60)).astype(np.uint8)
    target = np.roll(np.roll(source, -2, axis=0), 3, axis=1)
    dx, dy, score = best_copy_offset(source, target, 20, 15, 12, 10)
    assert (dx, dy) == (3, -2) and score == 0.0

    flat = np.full_like(source, 255)
    dx, dy, score = best_copy_offset(source, flat, 20, 15, 12, 10)
    assert (dx, dy) == (0, 0) and score > 900.0


def test_add_portion_reject_then_rebinarize(workspace):
    """The annotator loop: reject a portion, re-add it by binarizing the
    rectangle from the raw image (Otsu), recovering the original ink."""
    session = GTEditorSession(workspace["prefix"])
    kf0 = workspace["indices"][0]
    original = session.binary(kf0).copy()
    portions = session.portions(kf0)
    p = portions[0]
    n_before = len(portions)

    session.reject_portion(kf0, 0)
    region = session.binary(kf0)[p["y"]:p["y"] + p["h"],
                                 p["x"]:p["x"] + p["w"]]
    assert (region == 255).all()

    idx = session.add_portion(kf0, p["x"], p["y"], p["w"], p["h"],
                              source="otsu")
    assert idx == n_before - 1
    np.testing.assert_array_equal(
        session.binary(kf0)[p["y"]:p["y"] + p["h"],
                            p["x"]:p["x"] + p["w"]],
        original[p["y"]:p["y"] + p["h"], p["x"]:p["x"] + p["w"]])

    # two undos roll back the add and the reject, restoring the portion
    assert session.undo(kf0) and session.undo(kf0)
    np.testing.assert_array_equal(session.binary(kf0), original)
    assert len(session.portions(kf0)) == n_before


def test_move_and_invert_portion(tmp_path):
    prefix = _pattern_tree(tmp_path)
    session = GTEditorSession(prefix)
    p = session.portions(100)[0]
    before = session.binary(100).copy()
    crop = before[p["y"]:p["y"] + p["h"], p["x"]:p["x"] + p["w"]].copy()

    session.move_portion(100, 0, 15, 10)   # far enough that rects disjoin
    moved = session.portions(100)[0]
    assert (moved["x"], moved["y"]) == (p["x"] + 15, p["y"] + 10)
    bin_now = session.binary(100)
    assert (bin_now[p["y"]:p["y"] + p["h"],
                    p["x"]:p["x"] + p["w"]] == 255).all()
    np.testing.assert_array_equal(
        bin_now[moved["y"]:moved["y"] + p["h"],
                moved["x"]:moved["x"] + p["w"]], crop)
    assert session.undo(100)
    np.testing.assert_array_equal(session.binary(100), before)
    assert session.portions(100)[0]["x"] == p["x"]

    session.invert_portion(100, 0)
    np.testing.assert_array_equal(
        session.binary(100)[p["y"]:p["y"] + p["h"],
                            p["x"]:p["x"] + p["w"]], 255 - crop)
    session.invert_portion(100, 0)
    np.testing.assert_array_equal(session.binary(100), before)


def test_copy_portion_aligns_and_gates(tmp_path):
    """Copy to the next keyframe lands on the shifted glyph exactly (so
    the target binary is unchanged); without a matching glyph the offset
    gates to (0, 0) and the source ink appears at its original spot."""
    prefix = _pattern_tree(tmp_path, shift=(3, -2))
    session = GTEditorSession(prefix)
    p = session.portions(100)[0]
    target_before = session.binary(200).copy()

    result = session.copy_portion(100, 0, +1)
    assert result["target"] == 200
    assert result["offset"] == [3, -2] and result["mse"] == 0.0
    copied = session.portions(200)[result["index"]]
    assert (copied["x"], copied["y"]) == (p["x"] + 3, p["y"] - 2)
    np.testing.assert_array_equal(session.binary(200), target_before)
    assert session.undo(200)
    assert len(session.portions(200)) == 1

    prefix2 = _pattern_tree(tmp_path / "b", second_has_pattern=False)
    session2 = GTEditorSession(prefix2)
    result = session2.copy_portion(100, 0, +1)
    assert result["offset"] == [0, 0] and result["mse"] > 900.0
    region = session2.binary(200)[p["y"]:p["y"] + p["h"],
                                  p["x"]:p["x"] + p["w"]]
    assert (region == 0).any()

    with pytest.raises(IndexError):
        session2.copy_portion(200, 0, +1)


def test_save_preserves_authored_portions(tmp_path):
    """Portion-op-authored structure survives save (the list still
    composes to the binary, so it is NOT rebuilt from pixels) — the
    copied rect and Dark flag round-trip through portions.xml."""
    prefix = _pattern_tree(tmp_path, shift=(3, -2))
    session = GTEditorSession(prefix)
    session.copy_portion(100, 0, +1)
    session.portions(200)
    session._kf(200).portions[-1].dark = True
    session.save(rebuild_unique_ccs=False)

    root = ET.parse(os.path.join(prefix, "portions.xml")).getroot()
    frames = root.findall("./KeyFrames/KeyFrame")
    by_idx = {int(f.find("Index").text): f for f in frames}
    entries = by_idx[200].findall("./Portions/KeyFramePortion")
    assert len(entries) == 2
    assert [e.find("Dark").text for e in entries] == ["0", "1"]

    # a pixel stroke invalidates the authored list: save rebuilds (the
    # far-corner stroke is past the bbox-merge distance, so the rebuilt
    # tree has two portions where the authored list had one)
    session.stroke(100, [(63, 5), (68, 10)], radius=1, erase=False)
    session.save(rebuild_unique_ccs=False)
    root = ET.parse(os.path.join(prefix, "portions.xml")).getroot()
    by_idx = {int(f.find("Index").text): f
              for f in root.findall("./KeyFrames/KeyFrame")}
    assert len(by_idx[100].findall("./Portions/KeyFramePortion")) == 2


def test_http_portion_surface(workspace):
    """Portion ops over the HTTP surface: list, add, move, copy, reject."""
    session = GTEditorSession(workspace["prefix"])
    server = serve(session, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"

    def post(path, body):
        req = urllib.request.Request(base + path,
                                     json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    kf0 = workspace["indices"][0]
    try:
        with urllib.request.urlopen(f"{base}/api/portions/{kf0}",
                                    timeout=10) as r:
            portions = json.loads(r.read())
        n = len(portions)
        assert n > 0

        x, y = _find_empty_window(session.binary(kf0))
        added = post("/api/add_portion",
                     {"kf": kf0, "x": x, "y": y, "w": 20, "h": 20,
                      "source": "current"})
        assert added["ok"] and added["index"] == n

        assert post("/api/move_portion", {"kf": kf0, "index": n,
                                          "dx": 2, "dy": 1})["ok"]
        assert session.portions(kf0)[n]["x"] == x + 2

        copied = post("/api/copy_portion", {"kf": kf0, "index": 0,
                                            "direction": 1})
        assert copied["ok"] and copied["target"] == workspace["indices"][1]

        assert post("/api/invert_portion", {"kf": kf0, "index": n})["ok"]
        assert post("/api/reject_portion", {"kf": kf0, "index": n})["ok"]
        assert len(session.portions(kf0)) == n
        # bad index: JSON error, handler stays alive
        assert not post("/api/move_portion", {"kf": kf0, "index": 99,
                                              "dx": 1, "dy": 0})["ok"]
    finally:
        server.shutdown()
        thread.join(timeout=10)


def test_threshold_flat_black_cell_stays_background():
    """A uniformly black region must binarize to background (the flat-
    cell fallback threshold goes BELOW the darkest pixel, not to 0)."""
    from lecturemath_tpu_torch.utils.gt_editor import ThresholdTool

    raw = np.zeros((32, 48, 3), np.uint8)   # all black frame
    tool = ThresholdTool(raw)
    tool.init_grid(2, 2)
    assert (tool.binary() == 255).all()


def test_reject_portion_preserves_overlapping_ink(workspace):
    """Rejecting one portion erases only ITS unclaimed ink — overlapping
    portions' ink and unrelated strokes in the rectangle survive."""
    from lecturemath_tpu_torch.utils.gt_editor import GTEditorSession

    session = GTEditorSession(workspace["prefix"])
    kf_id = session.keyframe_ids()[0]
    kf = session._kf(kf_id)
    binary = session.binary(kf_id)
    h, w = binary.shape

    import numpy as np
    from lecturemath_tpu_torch.eval.annotation import KeyframePortion

    def portion(x, y, pw, ph):
        cut = np.full((ph, pw), 255, np.uint8)
        cut[:] = 0                       # solid ink block
        return KeyframePortion(x, y, pw, ph, cut)

    kf.portions = [portion(2, 2, 10, 10), portion(8, 2, 10, 10)]
    session._blit_portion(kf_id, kf.portions[0])
    session._blit_portion(kf_id, kf.portions[1])
    # a hand-painted stroke inside portion 0's rect but outside portion 1
    session.stroke(kf_id, [[3, 14], [5, 14]], radius=1, erase=False)

    session.reject_portion(kf_id, 0)
    after = session.binary(kf_id)
    assert (after[2:12, 8:18] == 0).all()      # overlap region: B's ink kept
    assert (after[2:12, 2:8] == 255).all()     # A-only ink erased
    assert (after[13:16, 2:7] == 0).any()      # hand stroke survives


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
    """{package: (answers, files)} of the GT editor scenario, both run in
    the same directory."""
    root = str(tmp_path_factory.mktemp("gt_editor") / "run")
    out = {}
    for package in PACKAGES:
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        answers = scenario.run(package, root, parts=("gt_editor",))
        out[package] = (answers["gt_editor"], _tree(root))
    return out


def test_http_answers_equal_jax(runs):
    """Every JSON answer and every PNG the two servers send for the same
    request sequence are equal (PNGs byte for byte)."""
    theirs, ours = (runs[p][0] for p in PACKAGES)
    assert len(ours) == len(theirs) > 30
    for k, (a, b) in enumerate(zip(ours, theirs)):
        assert a == b, (k, a, b)
    assert sum(kind == "png" for kind, _ in ours) >= 7
    assert not any(kind == "error" for kind, _ in ours)


@pytest.mark.parametrize("prefix", ["binary/", "portions", "unique_ccs.xml",
                                    "keyframes/", "segments.xml"])
def test_saved_files_equal_jax(runs, prefix):
    """The saved tree, file for file and byte for byte: the edited
    binaries, portions.xml and portions/, unique_ccs.xml, and the files the
    editor leaves as they were."""
    theirs, ours = (runs[p][1] for p in PACKAGES)
    top = os.path.join("annotations", f"{scenario.DB}_"
                       f"{scenario.LECTURE.lower()}")
    pick = lambda files: {k: v for k, v in files.items()  # noqa: E731
                          if os.path.relpath(k, top).startswith(prefix)}
    assert pick(ours) and pick(ours) == pick(theirs)


def test_strokes_reach_the_saved_binary(runs):
    """The strokes and the rectangle of the scenario are in the saved
    binary of their keyframe (the parity above is not of two no-ops)."""
    files = runs["lecturemath_tpu_torch"][1]
    top = os.path.join("annotations", f"{scenario.DB}_"
                       f"{scenario.LECTURE.lower()}", "binary")
    k1 = scenario.KEYFRAMES[1]
    before = scenario.keyframes()[1][0]
    path = os.path.join(top, f"{k1}.png")
    from lecturemath_tpu_torch.utils.png import decode_png_grayscale
    after = decode_png_grayscale(files[path])
    assert (after[2:8, 80:89] == 0).all()           # the filled rectangle
    assert (after != before).sum() > 100


_BLOCKED_RUN = r"""
import json, sys
BANNED = %r
for name in BANNED:
    sys.modules[name] = None
sys.path[:0] = [%r, %r]
import _torch_editor_scenario as scenario
answers = scenario.run("lecturemath_tpu_torch", %r, full=False)
assert not [m for m in BANNED if sys.modules.get(m) is not None]
print(json.dumps(answers))
"""


def test_editors_run_without_opencv(tmp_path):
    """A GT editor session, a word/formula session and an annotation-editor
    session over a PNG image list, with cv2, PIL and matplotlib blocked (as
    on a machine without them): the same answers and the same saved files
    as the same run with them allowed."""
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
    answers, files = runs[0]
    assert answers["words_reloaded"] and answers["annotation_reloaded"]
    assert len(files) > 30
