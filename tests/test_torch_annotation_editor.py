"""The port's full-video annotation editor (utils/annotation_editor.py):
the JAX package's tests of its session (segments, keyframes, object
timelines, undo/redo), the XML round trip, frame scrubbing over image
lists and videos (the videos through OpenCV, as in the JAX package) and
the HTTP surface run on the port, and parity with the JAX package: the
same HTTP requests over a PNG image list
(``_torch_editor_scenario.annotation_editor``) get the same JSON and the
same PNG bytes from both servers, and both save the same XML."""

import json
import os
import shutil
import threading
import urllib.request
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from lecturemath_tpu_torch.eval.lecture_annotation import LectureAnnotation
from lecturemath_tpu_torch.utils.annotation_editor import (
    AnnotationEditorSession, serve)
from lecturemath_tpu_torch.utils.png import write_image

import _torch_editor_scenario as scenario

PACKAGES = ("lecturemath_tpu", "lecturemath_tpu_torch")


@pytest.fixture()
def workspace(tmp_path):
    """An image-list 'video' (12 PNG frames) + annotation path."""
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    rng = np.random.default_rng(5)
    for k in range(12):
        frame = np.full((48, 64, 3), 230, np.uint8)
        frame[10:20, 5 * k:5 * k + 8] = rng.integers(0, 80, 3)
        write_image(str(frames_dir / f"{k:04d}.png"), frame)
    return {"root": tmp_path, "frames": str(frames_dir),
            "xml": str(tmp_path / "annotations" / "ADB_lec01.xml")}


def _open(workspace):
    return AnnotationEditorSession.open(workspace["xml"], "ADB", "lec01",
                                        [workspace["frames"]])


def test_open_fresh_probes_image_list(workspace):
    session = _open(workspace)
    assert session.annotation.total_frames == 12
    assert session.state()["segments"] == [0, 12]
    frame = session.frame(3)
    assert frame.shape == (48, 64, 3)


def test_segments_keyframes_undo_redo(workspace):
    session = _open(workspace)
    session.split_segment(4)
    session.split_segment(8)
    assert session.state()["segments"] == [0, 4, 8, 12]
    session.merge_segment(4)
    assert session.state()["segments"] == [0, 8, 12]

    session.add_keyframe(2)
    session.add_keyframe(10)
    session.del_keyframe(2)
    assert session.state()["keyframes"] == [10]

    assert session.undo()            # del_keyframe back
    assert session.state()["keyframes"] == [2, 10]
    assert session.redo()
    assert session.state()["keyframes"] == [10]

    with pytest.raises(ValueError):
        session.split_segment(0)     # boundary splits rejected
    with pytest.raises(ValueError):
        session.merge_segment(5)     # no split there
    with pytest.raises(ValueError):
        session.del_keyframe(7)


def test_object_timeline_interpolation(workspace):
    session = _open(workspace)
    session.add_object("spk", "speaker", 0, 2, [[10, 10], [20, 30]])
    session.set_location("speaker", 10, [[30, 10], [40, 30]])

    mid = session.location_at("speaker", 6)   # halfway: x shifts 10 -> 20
    # 2-corner box input expands to the reference's 4-corner polygon
    # convention at ingress (gt_content_annotator.py:1177)
    np.testing.assert_allclose(mid["points"], [[20, 10], [30, 10],
                                               [30, 30], [20, 30]])
    assert session.location_at("speaker", 0) is None   # before first pose

    session.set_visible("speaker", 10, False)
    assert session.location_at("speaker", 10)["visible"] is False

    session.del_location("speaker", 10)
    assert session.state()["objects"]["spk"]["frames"] == [2]
    with pytest.raises(ValueError):
        session.del_location("speaker", 10)
    with pytest.raises(ValueError):
        session.del_location("speaker", 2)   # last keypose: refuse —
    session.state()                          # ...the object stays queryable

    session.rename_object("speaker", "spk2", "speaker2")
    assert session.state()["objects"]["spk2"]["name"] == "speaker2"
    session.remove_object("speaker2")   # lookup by new display name
    assert session.state()["objects"] == {}


def test_save_round_trip_and_eval_surface(workspace):
    """Saved XML reloads through LectureAnnotation (the eval_segments
    input) with identical segments/keyframes/objects."""
    session = _open(workspace)
    session.split_segment(6)
    session.add_keyframe(3)
    session.add_keyframe(9)
    session.add_object("spk", "speaker", 0, 1, [[5, 5], [15, 25]])
    session.set_location("speaker", 11, [[25, 5], [35, 25]])
    path = session.save()
    assert os.path.exists(path)
    ET.parse(path)

    loaded = LectureAnnotation.load(path)
    assert loaded.segments_with_bounds() == [0, 6, 12]
    assert loaded.video_segment_keyframes == [3, 9]
    speaker = loaded.video_objects["spk"]   # load keys by object id
    assert speaker.name == "speaker"
    assert [loc.frame for loc in speaker.locations] == [1, 11]

    # re-opening resumes from the saved file
    session2 = _open(workspace)
    assert session2.state()["splits"] == [6]
    assert session2.state()["keyframes"] == [3, 9]


def test_render_frame_overlays(workspace):
    session = _open(workspace)
    session.add_object("spk", "speaker", 0, 1, [[5, 5], [15, 25]])
    session.set_location("speaker", 11, [[25, 5], [35, 25]])
    session.split_segment(6)
    session.add_keyframe(6)

    plain = session.frame(6)
    rendered = session.render_frame(6)
    assert rendered.shape == plain.shape
    assert (rendered != plain).any()           # overlays drawn
    # frame 0 precedes the object's first keypose and carries no markers:
    # rendering must leave it untouched
    np.testing.assert_array_equal(session.render_frame(0),
                                  session.frame(0))


def test_http_annotation_surface(workspace):
    session = _open(workspace)
    server = serve(session, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"

    def post(path, obj):
        request = urllib.request.Request(base + path,
                                         data=json.dumps(obj).encode(),
                                         method="POST")
        with urllib.request.urlopen(request, timeout=30) as r:
            return json.loads(r.read())

    try:
        with urllib.request.urlopen(f"{base}/api/state", timeout=10) as r:
            state = json.loads(r.read())
        assert state["total_frames"] == 12

        assert post("/api/split", {"frame": 5})["ok"]
        assert not post("/api/split", {"frame": 0})["ok"]   # guarded error
        assert post("/api/keyframe", {"frame": 5, "op": "add"})["ok"]
        assert post("/api/object",
                    {"op": "add", "name": "speaker", "id": "spk",
                     "shape_type": 0, "frame": 2,
                     "points": [[4, 4], [14, 24]]})["ok"]
        assert post("/api/pose", {"op": "set", "name": "speaker",
                                  "frame": 9,
                                  "points": [[24, 4], [34, 24]]})["ok"]
        with urllib.request.urlopen(f"{base}/api/pose/speaker/5",
                                    timeout=10) as r:
            pose = json.loads(r.read())
        assert pose["points"][0][0] > 4          # interpolated

        with urllib.request.urlopen(f"{base}/img/frame/5.png",
                                    timeout=30) as r:
            assert r.read()[:4] == b"\x89PNG"

        assert post("/api/undo", {})["ok"]
        assert post("/api/redo", {})["ok"]
        saved = post("/api/save", {})
        assert saved["ok"] and os.path.exists(saved["path"])
    finally:
        server.shutdown()
        thread.join(timeout=10)


def test_video_scrub_seek_matches_sequential(tmp_path):
    """The persistent seeking capture returns the same frames as the
    sequential sampler, including backward scrubs and far jumps."""
    import cv2

    from lecturemath_tpu_torch.pipeline.video import sample_frame_indices

    video = str(tmp_path / "scrub.avi")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"),
                             30.0, (64, 48))
    for k in range(150):
        frame = np.full((48, 64, 3), 235, np.uint8)
        frame[8:40, 2 + (k % 50):12 + (k % 50)] = (k * 7) % 200
        writer.write(frame)
    writer.release()

    session = AnnotationEditorSession.open(
        str(tmp_path / "annotations" / "SDB_scrub.xml"), "SDB", "scrub",
        [video])
    probes = [140, 3, 77, 76, 139, 0]
    expected = {idx: frame for idx, frame in
                sample_frame_indices([video], probes)}
    for idx in probes:
        session._frame_cache.clear()
        got = session.frame(idx)
        np.testing.assert_array_equal(got, expected[idx])


def test_multifile_scrub_matches_sequential(tmp_path):
    """Absolute-index mapping across a two-file lecture matches the
    sequential sampler, including scrubs across the file boundary."""
    import cv2

    from lecturemath_tpu_torch.pipeline.video import sample_frame_indices

    videos = []
    for part, n in ((0, 60), (1, 40)):
        video = str(tmp_path / f"part{part}.avi")
        writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"),
                                 30.0, (64, 48))
        for k in range(n):
            frame = np.full((48, 64, 3), 235, np.uint8)
            frame[8:40, 2 + (k % 40):12 + (k % 40)] = (part * 90 + k) % 200
            writer.write(frame)
        writer.release()
        videos.append(video)

    session = AnnotationEditorSession.open(
        str(tmp_path / "annotations" / "SDB_multi.xml"), "SDB", "multi",
        videos)
    probes = [0, 59, 60, 61, 99, 30, 95, 58]
    expected = {idx: frame for idx, frame in
                sample_frame_indices(videos, probes)}
    for idx in probes:
        session._frame_cache.clear()
        np.testing.assert_array_equal(session.frame(idx), expected[idx])


def test_overreported_header_count_corrected(tmp_path):
    """A container whose header over-reports its frame count must not
    shift the file boundary: the failed read triggers an exact decode
    count and the index re-maps into the next file."""
    import cv2

    videos = []
    for part, n in ((0, 50), (1, 30)):
        video = str(tmp_path / f"part{part}.avi")
        writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"),
                                 30.0, (64, 48))
        for k in range(n):
            frame = np.full((48, 64, 3), 10 + part * 100 + k, np.uint8)
            writer.write(frame)
        writer.release()
        videos.append(video)

    session = AnnotationEditorSession.open(
        str(tmp_path / "annotations" / "SDB_over.xml"), "SDB", "over",
        videos)
    session.annotation.total_frames = 80
    session._file_counts()
    session._counts[0] = 55        # simulate an over-reporting header
    # absolute 52 maps into file 0 per the lying header; the read comes
    # up short, the count is corrected, and it re-maps to file 1 local 2
    from lecturemath_tpu_torch.pipeline.video import sample_frame_indices

    [(_, expected)] = sample_frame_indices(videos, [52])
    np.testing.assert_array_equal(session.frame(52), expected)
    assert session._counts[0] == 50


def test_box_pose_expands_and_occlusion_math_is_finite():
    """2-corner box poses from the editor expand to 4-corner polygons at
    ingress, so area/intersection/occlusion math stays finite (a 2-point
    polygon has zero area -> NaN percentages that silently drop every
    text box as occluded downstream)."""
    from lecturemath_tpu_torch.eval.lecture_annotation import TimelineObject

    speaker = TimelineObject("speaker", "speaker", 0)
    speaker.set_location_at(0, 0.0, True, [(10.0, 10.0), (60.0, 90.0)])
    text = TimelineObject("text", "text", 0)
    text.set_location_at(0, 0.0, True, [(30.0, 30.0), (50.0, 50.0)])
    sp = speaker.locations[0]
    tx = text.locations[0]
    assert sp.polygon_points.shape == (4, 2)
    assert sp.area() == (60 - 10) * (90 - 10)
    pct = tx.intersection_percentage(sp)
    assert pct == 1.0                      # text box fully inside speaker
    assert 0.0 <= sp.intersection_percentage(tx) <= 1.0

    # re-shaping a pose (4 corners -> explicit 3-vertex polygon) works
    speaker.set_location_at(0, 5.0, True,
                            [(0.0, 0.0), (10.0, 0.0), (0.0, 10.0)])
    assert speaker.locations[0].polygon_points.shape == (3, 2)
    assert speaker.locations[0].abs_time == 5.0

    # degenerate zero-area polygons yield 0.0, never NaN
    line = TimelineObject("line", "line", 0)
    line.set_location_at(0, 0.0, True,
                         [(0.0, 0.0), (5.0, 0.0), (10.0, 0.0)])
    assert line.locations[0].intersection_percentage(sp) == 0.0
    assert line.locations[0].iou(line.locations[0]) == 0.0


def test_legacy_two_point_xml_pose_normalizes_on_load(tmp_path):
    """XMLs written by early editor versions stored 2-point box poses;
    loading normalizes them to 4-corner polygons so interpolation with
    newly added poses never mixes vertex counts (observed crash)."""
    from lecturemath_tpu_torch.eval.lecture_annotation import LectureAnnotation

    annotation = LectureAnnotation("DB", "lec", str(tmp_path / "a.xml"),
                                   ["v.mp4"], 100)
    xml = annotation.to_xml().replace(
        "</VideoObjects>",
        """<VideoObject><Id>spk</Id><Name>spk</Name><Shape>0</Shape>
        <VideoObjectLocations><VideoObjectLocation>
        <Visible>1</Visible><Frame>5</Frame><AbsTime>0</AbsTime>
        <Polygon><Point><X>10</X><Y>10</Y></Point>
        <Point><X>60</X><Y>90</Y></Point></Polygon>
        </VideoObjectLocation></VideoObjectLocations>
        </VideoObject></VideoObjects>""")
    path = str(tmp_path / "legacy.xml")
    with open(path, "w") as f:
        f.write(xml)

    loaded = LectureAnnotation.load(path)
    obj = loaded.video_objects["spk"]
    assert obj.locations[0].polygon_points.shape == (4, 2)
    obj.set_location_at(40, 1.0, True,
                        [(30.0, 10.0), (80.0, 10.0), (80.0, 90.0),
                         (30.0, 90.0)])
    mid = obj.get_location_at(22, False)     # lerps 4 <-> 4 cleanly
    assert mid.polygon_points.shape == (4, 2)
    assert 10.0 < mid.polygon_points[0][0] < 30.0


# ------------------------------------------------- parity with the JAX package

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{package: (answers, saved XML, reloaded equal)} of the annotation
    editor scenario, both run in the same directory."""
    root = str(tmp_path_factory.mktemp("annotation_editor") / "run")
    out = {}
    for package in PACKAGES:
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        answers = scenario.run(package, root, parts=("annotation_editor",))
        with open(answers["annotation_xml"], "rb") as f:
            saved = f.read()
        out[package] = (answers["annotation_editor"], saved,
                        answers["annotation_reloaded"])
    return out


def test_http_answers_equal_jax(runs):
    """Every answer of the two servers for the same requests is equal: the
    state, the errors, and the rendered frames (keyframe marker, boundary
    flash, boxes and polygons at thickness 2 and 4, the labels) byte for
    byte."""
    theirs, ours = (runs[p][0] for p in PACKAGES)
    assert len(ours) == len(theirs) > 25
    for k, (a, b) in enumerate(zip(ours, theirs)):
        assert a == b, (k, a, b)
    assert sum(kind == "png" for kind, _ in ours) == 8
    assert ["error", 404] in ours


def test_saved_xml_equals_jax(runs):
    theirs, ours = (runs[p][1] for p in PACKAGES)
    assert ours == theirs
    assert b"<VideoObject>" in ours


def test_reload_equals_saved_state(runs):
    for package in PACKAGES:
        assert runs[package][2], package


def test_frames_render_without_opencv_labels(workspace, monkeypatch):
    """Without OpenCV the overlays are drawn all the same and only the
    object labels are left out: a frame without objects renders as with
    it, a frame with an object differs only in the rows of its label."""
    import sys

    session = _open(workspace)
    session.add_object("spk", "speaker", 0, 1, [[5, 5], [15, 25]])
    session.set_location("speaker", 11, [[25, 5], [35, 25]])
    session.split_segment(6)
    session.add_keyframe(6)
    with_cv2 = [session.render_frame(k) for k in (0, 1, 6)]
    monkeypatch.setitem(sys.modules, "cv2", None)
    without = [session.render_frame(k) for k in (0, 1, 6)]
    np.testing.assert_array_equal(with_cv2[0], without[0])
    for k, a, b in zip((1, 6), with_cv2[1:], without[1:]):
        rows = np.nonzero((a != b).any(axis=(1, 2)))[0]
        assert len(rows) and rows.max() <= 16     # the label at y <= 12
        assert (b != session.frame(k)).any()      # the rest is drawn
    # the exact keypose's box at frame 1, in green, with or without labels
    assert (without[0] == session.frame(0)).all()
    assert (without[1][6:25, 5] == (0, 200, 0)).all()


@pytest.mark.parametrize("size", [(50, 30), (100, 70)])
def test_forced_resolution_frames_equal_jax(workspace, size):
    """An image list at a forced resolution is resized as the JAX
    session's cv2.resize (INTER_LINEAR) resizes it, down and up."""
    from lecturemath_tpu.utils.annotation_editor import \
        AnnotationEditorSession as JaxSession

    args = (workspace["xml"], "ADB", "lec01", [workspace["frames"]], size)
    ours, theirs = AnnotationEditorSession.open(*args), JaxSession.open(*args)
    for index in (0, 5, 11):
        frame = ours.frame(index)
        assert frame.shape == (size[1], size[0], 3)
        np.testing.assert_array_equal(frame, theirs.frame(index))
