"""One editing session in each of the four browser editors, for either
package, driven through its HTTP server as the page drives it: the GT
pixel editor (threshold grid, strokes, portions, classical apply, save),
the word/formula annotator over the saved tree (projection, word trees,
unique words, unique CCs through a projection, formulas, save, reload)
and the lecture annotation editor over a PNG image list (segments,
keyframes, an object with two keyposes, undo/redo, save, reload).

``run(package, root, parts, full)`` writes everything under ``root`` and
returns every answer the servers gave, in order: JSON as decoded, images
as the sha256 of their PNG bytes, errors as their status. ``full`` adds
the views whose output depends on more than the session: the object and
formula labels (``cv2.putText``) and the unique-CC colours (``hash`` of a
group id, which the interpreter seeds per process).

Inputs are seeded numpy arrays written with the port's PNG writer, so a
run of the port needs no OpenCV. The parity tests run it for both
packages into the same path (the saved files that name their own path stay
equal); the tests without OpenCV run it for the port in a child with cv2,
PIL and matplotlib blocked."""

import hashlib
import importlib
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np

from lecturemath_tpu_torch.utils.png import write_image

DB = "EDDB"
LECTURE = "Ed01"
HEIGHT, WIDTH = 72, 120
KEYFRAMES = (10, 25, 40)
TIMES = (1000.0, 2500.0, 4000.0)
# the image-list lecture of the annotation editor
LIST_FRAMES, LIST_HEIGHT, LIST_WIDTH = 12, 48, 80
# the word annotator's edit of the second keyframe's quad: one corner
CORNER, DELTA = 2, (-9.5, 5.25)
# the unique-CC match of keyframe 1 against keyframe 0 goes through this
# projection (a shift and a mild perspective)
CC_MATRIX = [[1.0, 0.02, 1.5], [-0.01, 1.0, 0.75], [1e-4, -5e-5, 1.0]]


def _module(package, name):
    return importlib.import_module(f"{package}.{name}")


def keyframes(seed=0):
    """(binary ink=0 [H, W], raw RGB [H, W, 3]) of each keyframe: rows of
    glyph blocks, more of them in each later keyframe, the raw frame a
    lit gradient with noise and the ink dark."""
    rng = np.random.default_rng(seed)
    words = []
    out = []
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH]
    for k, _ in enumerate(KEYFRAMES):
        for _ in range(3):
            row = int(rng.integers(0, 4))
            words.append((4 + 17 * row, 6 + int(rng.integers(0, 84))))
        binary = np.full((HEIGHT, WIDTH), 255, np.uint8)
        for y, x in words:
            for g in range(int(rng.integers(2, 5))):
                gx = x + 6 * g
                binary[y:y + int(rng.integers(5, 11)),
                       gx:gx + int(rng.integers(2, 5))] = 0
        light = 150 + 60 * xx / WIDTH + 20 * yy / HEIGHT + 10 * k
        light = light[..., None] + rng.normal(0, 6, (HEIGHT, WIDTH, 3))
        ink = rng.normal(45, 10, (HEIGHT, WIDTH, 3))
        raw = np.where((binary == 0)[..., None], ink, light)
        out.append((binary, np.clip(raw, 0, 255).astype(np.uint8)))
    return out


class Client:
    """The page's side of the HTTP surface: every answer recorded."""

    def __init__(self, server):
        self.base = f"http://127.0.0.1:{server.server_address[1]}"
        self.answers = []

    def _answer(self, request):
        try:
            with urllib.request.urlopen(request, timeout=60) as r:
                body, kind = r.read(), r.headers.get("Content-Type")
        except urllib.error.HTTPError as err:
            self.answers.append(["error", err.code])
            return None
        if kind == "image/png":
            self.answers.append(["png", hashlib.sha256(body).hexdigest()])
            return body
        value = json.loads(body)
        self.answers.append(["json", value])
        return value

    def get(self, path):
        return self._answer(self.base + path)

    def post(self, path, body):
        return self._answer(urllib.request.Request(
            self.base + path, data=json.dumps(body).encode(),
            method="POST"))


def _serving(module, session):
    server = module.serve(session, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def gt_tree(package, root):
    """The exported GT tree (portions included); returns its prefix."""
    gt = _module(package, "eval.gt_authoring")
    frames = keyframes()
    return gt.export_gt_tree(
        os.path.join(root, "annotations"), DB, LECTURE, list(KEYFRAMES),
        list(TIMES), [b for b, _ in frames], [r for _, r in frames],
        video_paths=[f"{LECTURE}.mp4"], write_portions=True)


def gt_editor(package, prefix):
    """Threshold grid and points, strokes at radius 1-4 (points and
    polylines, paint and erase, one past the edge), portions from Otsu,
    the threshold surface and the current binary, move / invert / copy /
    reject, the classical methods 2 and 3, undo, every view, save."""
    module = _module(package, "utils.gt_editor")
    session = module.GTEditorSession(prefix)
    server, thread = _serving(module, session)
    client = Client(server)
    k0, k1, k2 = KEYFRAMES
    try:
        client.get("/api/state")
        client.get(f"/api/portions/{k0}")
        client.post("/api/thr_grid", {"kf": k0, "rows": 3, "cols": 4})
        client.get(f"/api/thr_state/{k0}")
        added = client.post("/api/thr_point",
                            {"kf": k0, "op": "add", "x": 33, "y": 21})
        client.post("/api/thr_point", {"kf": k0, "op": "set",
                                       "index": added["index"], "value": 140})
        client.post("/api/thr_point", {"kf": k0, "op": "add", "x": 90,
                                       "y": 50, "value": 120})
        client.get(f"/img/thr_preview/{k0}.png")
        strokes = [
            ([[12, 60]], 1, False), ([[100, 8]], 3, False),
            ([[5, 5], [30, 12], [44, 30]], 2, False),
            ([[50, 40], [70, 41], [71, 60]], 3, True),
            ([[110, 64], [125, 75], [118, 90]], 4, False),
            ([[2, 70], [2, 69], [3, 66]], 1, True),
            ([[60, 30]], 4, True)]
        for points, radius, erase in strokes:
            client.post("/api/stroke", {"kf": k1, "points": points,
                                        "radius": radius, "erase": erase})
        client.post("/api/rect", {"kf": k1, "x": 80, "y": 2, "w": 9,
                                  "h": 6, "erase": False})
        client.get(f"/img/binary/{k1}.png")
        for x, source, dark in ((8, "otsu", False), (40, "otsu", True),
                                (70, "threshold", False),
                                (100, "current", False)):
            client.post("/api/add_portion", {
                "kf": k0, "x": x, "y": 6, "w": 30, "h": 24,
                "source": source, "dark": dark})
        n = len(session.portions(k0))
        client.post("/api/move_portion", {"kf": k0, "index": n - 1,
                                          "dx": 7, "dy": 3})
        client.post("/api/invert_portion", {"kf": k0, "index": n - 2})
        client.post("/api/copy_portion", {"kf": k0, "index": 0,
                                          "direction": 1})
        client.post("/api/reject_portion", {"kf": k0, "index": 1})
        client.get(f"/api/portions/{k0}")
        client.post("/api/move_portion", {"kf": k0, "index": 99, "dx": 1,
                                          "dy": 0})
        client.post("/api/classical_apply", {"kf": k2, "method": 2})
        client.post("/api/undo", {"kf": k2})
        client.post("/api/classical_apply", {"kf": k2, "method": 3})
        client.get(f"/img/classical/{k1}.png?m=3")
        client.post("/api/thr_apply", {"kf": k0})
        client.post("/api/undo", {"kf": k0})
        for kf in KEYFRAMES:
            client.get(f"/img/binary/{kf}.png")
        client.get(f"/img/raw/{k2}.png")
        client.post("/api/save", {})
    finally:
        _stop(server, thread)
    return client.answers


def word_annotator(package, prefix, full):
    """The word tier over the saved tree: a projection with one corner
    moved, word trees split and merged, unique words matched and
    unlinked, unique CCs matched through a projection (the nearest warp)
    and directly, formulas added, tagged and deleted, undo/redo, save;
    then a fresh editor's state."""
    module = _module(package, "utils.word_editor")
    server, thread = _serving(module, module.WordTierEditor(prefix))
    client = Client(server)
    try:
        state = client.get("/api/state?tool=words")
        quad = np.asarray(state["keyframes"][1]["src_points"])
        quad[CORNER] += DELTA
        client.post("/api/words/projection_quad",
                    {"kf": 1, "points": quad.tolist()})
        for kf in range(len(KEYFRAMES)):
            x, y, w, h = client.get("/api/state?tool=words")[
                "keyframes"][kf]["words"][0]
            client.post("/api/words/auto_split",
                        {"kf": kf, "x": x + w // 2, "y": y + h // 2,
                         "normal": False})
        x, y, w, h = client.get("/api/state?tool=words")[
            "keyframes"][0]["words"][0]
        client.post("/api/words/split", {"kf": 0, "x": x + w // 2,
                                         "y": y + h // 2, "vertical": True,
                                         "normal": False})
        client.post("/api/words/merge", {"kf": 0, "x": x + 1, "y": y + 1,
                                         "normal": False})
        client.post("/api/words/auto_split", {"kf": 1, "x": 40, "y": 30,
                                              "normal": True})
        region = [0, 0, WIDTH, HEIGHT]
        client.post("/api/words/match", {"kf": 2, "region": region})
        client.post("/api/words/accept", {"min_iou": 0.1})
        client.post("/api/words/remove", {"kf": 2, "region": [0, 0, 60, 40]})
        client.post("/api/words/undo", {})
        client.post("/api/words/redo", {})
        client.post("/api/words/merge", {"kf": 0, "x": 10000, "y": 1,
                                         "normal": False})
        for view in ("normal_rgb", "normal_bin", "projected_rgb",
                     "projected_bin"):
            client.get(f"/img/words/1?view={view}")
        client.get("/api/state?tool=ccs")
        client.post("/api/ccs/remove", {"kf": 1, "region": region})
        client.post("/api/ccs/match", {"kf": 1, "source": 0,
                                       "region": region,
                                       "matrix": CC_MATRIX})
        client.post("/api/ccs/accept", {"min_recall": 0.4,
                                        "min_precision": 0.4})
        client.post("/api/ccs/match", {"kf": 2, "source": 0,
                                       "region": region})
        client.post("/api/ccs/accept", {})
        client.post("/api/ccs/undo", {})
        for view in ("raw", "binary") + (("colored",) if full else ()):
            client.get(f"/img/ccs/2?view={view}")
        # the formula session reads the unique CCs from disk when it opens
        client.post("/api/ccs/save", {})
        client.get("/api/state?tool=formulas")
        client.post("/api/formulas/add", {"kf": 0, "region": [0, 0, 70, 40],
                                          "latex": "x^2"})
        client.post("/api/formulas/add", {"kf": 1, "region": region,
                                          "latex": ""})
        client.post("/api/formulas/tag", {"index": 0,
                                          "latex": r"\frac{a}{b}"})
        client.post("/api/formulas/del", {"index": 1})
        client.post("/api/formulas/undo", {})
        client.post("/api/formulas/del", {"index": 7})
        client.get("/img/formulas/0?view=binary" if full else
                   "/api/state?tool=formulas")
        for tool in ("words", "formulas"):
            client.post(f"/api/{tool}/save", {})
        saved = [client.get(f"/api/state?tool={tool}")
                 for tool in ("words", "ccs", "formulas")]
    finally:
        _stop(server, thread)
    reopened = module.WordTierEditor(prefix)
    reloaded = [reopened.session(tool).state()
                for tool in ("words", "ccs", "formulas")]
    return client.answers, json.loads(json.dumps(reloaded)) == saved


def image_list(root):
    """The annotation editor's lecture: PNG frames with a moving block."""
    directory = os.path.join(root, "frames")
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(5)
    for k in range(LIST_FRAMES):
        frame = np.full((LIST_HEIGHT, LIST_WIDTH, 3), 230, np.uint8)
        frame[10:20, 5 * k:5 * k + 8] = rng.integers(0, 80, 3)
        frame[30:40, 60:70] = (20 * k, 200 - 10 * k, 90)
        write_image(os.path.join(directory, f"{k:04d}.png"), frame)
    return directory


def annotation_editor(package, root, frames, full):
    """Segments, keyframes, a box object with two keyposes and a polygon
    object, visibility, undo/redo, the frames without objects (a keyframe
    marker, both it and a boundary flash, none) and, with ``full``, those
    with labelled objects, save; then a fresh session's state."""
    module = _module(package, "utils.annotation_editor")
    xml = os.path.join(root, "annotations", f"{DB}_{LECTURE.lower()}.xml")
    session = module.AnnotationEditorSession.open(xml, DB, LECTURE, [frames])
    server, thread = _serving(module, session)
    client = Client(server)
    try:
        client.get("/api/state")
        client.post("/api/split", {"frame": 1})
        client.post("/api/split", {"frame": 6})
        client.post("/api/split", {"frame": 0})
        client.post("/api/merge", {"split": 6})
        client.post("/api/split", {"frame": 8})
        client.post("/api/keyframe", {"frame": 0, "op": "add"})
        client.post("/api/keyframe", {"frame": 1, "op": "add"})
        client.post("/api/keyframe", {"frame": 9, "op": "add"})
        client.post("/api/keyframe", {"frame": 9, "op": "del"})
        client.post("/api/object", {"op": "add", "name": "speaker",
                                    "id": "spk", "shape_type": 0,
                                    "frame": 3,
                                    "points": [[4, 4], [30, 40]]})
        client.post("/api/pose", {"op": "set", "name": "speaker",
                                  "frame": 10,
                                  "points": [[40, 6], [70, 44]]})
        client.post("/api/pose", {"op": "visible", "name": "speaker",
                                  "frame": 10, "visible": False})
        client.post("/api/object", {"op": "add", "name": "board",
                                    "id": "board", "shape_type": 1,
                                    "frame": 4,
                                    "points": [[2, 2], [78, 3], [77, 45],
                                               [1, 46], [-3, 20]]})
        client.post("/api/object", {"op": "rename", "name": "board",
                                    "new_id": "board2",
                                    "new_name": "Board"})
        client.get("/api/pose/speaker/6")
        client.get("/api/pose/nobody/6")
        client.post("/api/undo", {})
        client.post("/api/redo", {})
        client.post("/api/pose", {"op": "del", "name": "speaker",
                                  "frame": 7})
        for index in (0, 1, 2):   # no object there yet
            client.get(f"/img/frame/{index}.png")
        if full:
            for index in (3, 5, 8, 10, LIST_FRAMES + 5):
                client.get(f"/img/frame/{index}.png")
        saved = client.post("/api/save", {})
        state = client.get("/api/state")
    finally:
        _stop(server, thread)
    reopened = module.AnnotationEditorSession.open(xml, DB, LECTURE,
                                                   [frames])
    same = json.loads(json.dumps(reopened.state())) == state
    return client.answers, saved["path"], same


def st3d_session(package):
    """An ST3D visualizer session over the stage-02/03 computation of a
    synthetic lecture through one package, in the call sequence of
    stages.stage03_cc_grouping."""
    def module(name):
        return _module(package, name)

    frames, _, _ = module("utils.synthetic").synthetic_lecture(
        seed=11, n_frames=20, height=64, width=96, n_boards=2,
        glyphs_per_board=4)
    tracker = module("pipeline.cc_tracking").CCTracker(width=96, height=64)
    for frame in frames:
        tracker.add_frame(frame)

    tracker.split_stable_by_gaps(85, 3)
    stable = tracker.stable_cc_idxs(3)
    time_overlapping, _, _ = tracker.compute_overlapping_stable(stable, 5)
    groups, _ = tracker.compute_groups(stable, time_overlapping, 0.0)
    group_ages, groups_per_frame = tracker.compute_group_ages(groups)
    group_images, group_boundaries = \
        tracker.compute_group_images(groups, group_ages, 0.5)
    clean = tracker.clean_frames_from_groups(
        groups, group_boundaries, groups_per_frame, group_ages, group_images)

    frame_times = [float(i) for i in range(len(frames))]
    frame_indices = [i * 30 for i in range(len(frames))]
    st3d = module("data.space_time").SpaceTimeStruct(
        frame_times, frame_indices, 64, 96, group_ages, group_images,
        group_boundaries)
    return module("utils.st3d_visualizer").ST3DVisualizerSession(
        frame_times, frame_indices, tracker, st3d, clean_frames=clean,
        lecture="viz01")


PARTS = ("gt_editor", "word_annotator", "annotation_editor")


def run(package, root, parts=PARTS, full=True):
    """The named editors' sessions under ``root`` (the word annotator over
    the GT editor's saved tree where both run); returns their answers."""
    prefix = gt_tree(package, root)
    out = {}
    if "gt_editor" in parts:
        out["gt_editor"] = gt_editor(package, prefix)
    if "word_annotator" in parts:
        out["word_annotator"], out["words_reloaded"] = word_annotator(
            package, prefix, full)
    if "annotation_editor" in parts:
        (out["annotation_editor"], out["annotation_xml"],
         out["annotation_reloaded"]) = annotation_editor(
            package, root, image_list(root), full)
    return out
