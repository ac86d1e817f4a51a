"""Interactive full-video annotation editor: segments, per-segment
keyframes, and object (speaker) timelines, with a local-browser UI.

This is the launchable equivalent of the reference's GTContentAnnotator
(reference: AccessMath/annotation/gt_content_annotator.py:29 — the 2,280
LoC pygame tool that produces the full-video GT: segment boundaries at
:1915-1955, per-segment keyframes at :1957-1994, and polygon object
timelines with per-frame keyposes at :946-1005,1471-1665), re-designed as
a headless-testable session (AnnotationEditorSession) over
eval/lecture_annotation.LectureAnnotation plus a thin stdlib HTTP surface
(`serve`), launched via
``python -m lecturemath_tpu_torch.cli.annotation_editor <config> -l
<lecture>``. It reads and writes the reference's annotation XML format
unchanged, so files from the reference GUI load here and vice versa.

An image-list lecture of PNG frames needs no OpenCV: frames come through
``utils/png.py read_image`` (``resize_linear`` for a forced resolution) and
the overlays through ``utils/image.py``'s drawing. Video files (decoded by
``cv2.VideoCapture``), JPEG frames and the object labels
(``cv2.putText``, left out without OpenCV) still need it.
"""

from __future__ import annotations

import copy
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..eval.lecture_annotation import LectureAnnotation, TimelineObject
from .image import circle, polylines, rectangle, resize_linear
from .png import ImageFormatError, encode_png, read_image
from .visualizer import put_label


class AnnotationEditorSession:
    """Load-edit-save loop over one lecture's full-video annotation
    (<annotations>/<DB>_<lecture>.xml)."""

    def __init__(self, annotation: LectureAnnotation, fps: float = 30.0,
                 video_paths: Sequence[str] = (),
                 forced_resolution=None):
        self.annotation = annotation
        self.fps = float(fps)
        self.video_paths = list(video_paths)
        self.forced_resolution = forced_resolution
        self._frame_cache: Dict[int, np.ndarray] = {}
        # the persistent seeking capture (_cap/_cap_next/_offsets) is
        # mutable decode state shared by ThreadingHTTPServer handler
        # threads — serialize decodes or interleaved read()/seek()s
        # would return frames for the wrong index
        self._decode_lock = threading.Lock()
        self._undo: List[dict] = []
        self._redo: List[dict] = []

    # ------------------------------------------------------------ loading

    @classmethod
    def open(cls, annotation_path: str, db_name: str, lecture_title: str,
             video_paths: Sequence[str], forced_resolution=None
             ) -> "AnnotationEditorSession":
        """Load an existing annotation XML, or start a fresh one sized to
        the lecture's video files (frame count + fps probed with cv2)."""
        fps, total_frames = cls._probe_videos(video_paths)
        if os.path.exists(annotation_path):
            annotation = LectureAnnotation.load(annotation_path)
            annotation.output_file = annotation_path
            if total_frames and not annotation.total_frames:
                annotation.total_frames = total_frames
        else:
            annotation = LectureAnnotation(
                db_name, lecture_title, annotation_path,
                [os.path.basename(p) for p in video_paths],
                total_frames or 1)
        return cls(annotation, fps or 30.0, video_paths, forced_resolution)

    @staticmethod
    def _probe_videos(video_paths: Sequence[str]):
        fps, total = 0.0, 0
        for path in video_paths:
            if os.path.isdir(path):   # image-list lecture
                from ..pipeline.video import ImageListSource

                source = ImageListSource(path)
                if source.index is not None:
                    count = sum(1 for k in source.index if int(k) != 0)
                else:
                    count = sum(1 for f in os.listdir(path)
                                if f.endswith(source.img_extension))
                return 30.0, count
            import cv2

            capture = cv2.VideoCapture(path)
            if not capture.isOpened():
                continue
            fps = fps or (capture.get(cv2.CAP_PROP_FPS) or 30.0)
            total += int(capture.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
            capture.release()
        return fps, total

    # ------------------------------------------------------------- frames

    def frame(self, index: int) -> np.ndarray:
        """RGB frame at an absolute index (decoded on demand, cached)."""
        index = int(np.clip(index, 0, self.annotation.total_frames - 1))
        cached = self._frame_cache.get(index)
        if cached is not None:
            return cached
        if not self.video_paths:
            raise ValueError("no video paths — frame preview unavailable")
        if len(self.video_paths) == 1 and os.path.isdir(self.video_paths[0]):
            files = self._image_list_files()
            if index >= len(files):
                raise KeyError(f"frame {index} beyond image list")
            try:
                rgb = read_image(os.path.join(self.video_paths[0],
                                              files[index]), rgb=True)
            except (OSError, ImageFormatError) as err:
                raise KeyError(f"unreadable frame file {files[index]} "
                               f"({err})") from None
            if self.forced_resolution is not None:
                fw, fh = self.forced_resolution
                if (rgb.shape[1], rgb.shape[0]) != (fw, fh):
                    rgb = resize_linear(rgb, (fw, fh))
            self._put_cache(index, rgb)
            return rgb
        with self._decode_lock:
            cached = self._frame_cache.get(index)   # a parallel handler
            if cached is not None:                  # may have decoded it
                return cached                       # while we waited
            rgb = self._video_frame(index)
        self._put_cache(index, rgb)
        return rgb

    def _file_counts(self) -> list:
        """Per-file frame counts: container header values, with a
        decode-count fallback for files whose header reports 0/unknown.
        A header proven WRONG by a failed read is corrected exactly in
        _video_frame (decode-count + offset rebuild), so over-reporting
        containers cannot silently shift the file boundary. (A header
        that UNDER-reports is undetectable without a full decode scan;
        the reference's interactive players trust the same header
        properties, opencv_video_player.py.)"""
        if getattr(self, "_counts", None) is None:
            import cv2

            counts = []
            for path in self.video_paths:
                capture = cv2.VideoCapture(path)
                count = int(capture.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
                capture.release()
                counts.append(count if count > 0
                              else self._decode_count(path))
            self._counts = counts
            self._verified = set()
        return self._counts

    @staticmethod
    def _decode_count(path: str) -> int:
        import cv2

        capture = cv2.VideoCapture(path)
        count = 0
        while capture.grab():
            count += 1
        capture.release()
        return count

    def _locate(self, index: int):
        """Absolute index -> (file, local index); indices past the last
        known boundary map into the last file (its header may have
        under-reported — the read itself is the final arbiter)."""
        start = 0
        counts = self._file_counts()
        for k, count in enumerate(counts[:-1]):
            if index < start + count:
                return k, index - start
            start += count
        return len(counts) - 1, index - start

    def _video_frame(self, index: int) -> np.ndarray:
        """Decode one absolute frame with a PERSISTENT capture: grab
        forward when the target is just ahead of the last position,
        otherwise seek (CAP_PROP_POS_FRAMES) — scrubbing a long lecture
        stays O(1)-ish per request instead of re-decoding from frame 0
        each time (the reference's interactive players keep an open
        capture and set position properties the same way,
        opencv_video_player.py:play/set_position). Caller holds
        _decode_lock."""
        import cv2

        for _ in range(len(self.video_paths) + 1):
            file_idx, local = self._locate(index)
            cap = getattr(self, "_cap", None)
            if cap is None or self._cap_file != file_idx:
                if cap is not None:
                    cap.release()
                cap = cv2.VideoCapture(self.video_paths[file_idx])
                if not cap.isOpened():
                    raise IOError(
                        f"cannot open video: {self.video_paths[file_idx]}")
                self._cap, self._cap_file, self._cap_next = cap, file_idx, 0
            if not 0 <= local - self._cap_next < 120:
                cap.set(cv2.CAP_PROP_POS_FRAMES, local)
                self._cap_next = local
            frame, ok = None, True
            while self._cap_next <= local:
                ok, frame = cap.read()
                if not ok:
                    break
                self._cap_next += 1
            if ok and frame is not None:
                break
            # the read came up short of the header's promise: correct
            # this file's count by exact decode, rebuild the mapping,
            # and re-locate — unless the count was already verified,
            # in which case the index really is beyond the video end
            if file_idx in self._verified:
                raise KeyError(f"frame {index} beyond video end")
            self._verified.add(file_idx)
            actual = self._decode_count(self.video_paths[file_idx])
            cap.release()
            self._cap = None
            if actual == self._counts[file_idx]:
                raise KeyError(f"frame {index} beyond video end")
            self._counts[file_idx] = actual
        else:
            raise KeyError(f"frame {index} beyond video end")
        if self.forced_resolution is not None:
            fw, fh = self.forced_resolution
            if (frame.shape[1], frame.shape[0]) != (fw, fh):
                frame = cv2.resize(frame, (fw, fh))
        return frame[:, :, ::-1]

    def _image_list_files(self) -> list:
        """Position -> filename for an image-list lecture (one decode per
        request, not a sequential scan; same ordering as
        ImageListSource.frames)."""
        if getattr(self, "_il_files", None) is None:
            from ..pipeline.video import ImageListSource

            source = ImageListSource(self.video_paths[0])
            ext = source.img_extension.lstrip(".")
            if source.index is not None:
                frame_ids = sorted(int(k) for k in source.index if int(k))
                self._il_files = [f"{fid}.{ext}" for fid in frame_ids]
            else:
                self._il_files = sorted(
                    f for f in os.listdir(self.video_paths[0])
                    if f.endswith(source.img_extension))
        return self._il_files

    def _put_cache(self, index: int, rgb: np.ndarray) -> None:
        if len(self._frame_cache) > 64:
            self._frame_cache.pop(next(iter(self._frame_cache)))
        self._frame_cache[index] = rgb

    def abs_time(self, frame: int) -> float:
        return frame * 1000.0 / self.fps

    # -------------------------------------------------------------- state

    def state(self) -> dict:
        annotation = self.annotation
        objects = {}
        for name, obj in annotation.video_objects.items():
            objects[name] = {
                "id": obj.id, "name": obj.name,
                "shape_type": obj.shape_type,
                "frames": [loc.frame for loc in obj.locations],
                "first": obj.first_frame(), "last": obj.last_frame(),
            }
        return {
            "db": annotation.db_name, "lecture": annotation.title,
            "total_frames": annotation.total_frames, "fps": self.fps,
            "segments": annotation.segments_with_bounds(),
            "splits": list(annotation.video_segments),
            "keyframes": list(annotation.video_segment_keyframes),
            "objects": objects,
        }

    # --------------------------------------------------------------- undo

    def _snapshot(self) -> None:
        self._undo.append({
            "splits": list(self.annotation.video_segments),
            "keyframes": list(self.annotation.video_segment_keyframes),
            "objects": copy.deepcopy(self.annotation.video_objects),
        })
        del self._undo[:-30]
        self._redo.clear()

    def _restore(self, snap: dict) -> None:
        self.annotation.video_segments = snap["splits"]
        self.annotation.video_segment_keyframes = snap["keyframes"]
        self.annotation.video_objects = snap["objects"]

    def _current(self) -> dict:
        return {"splits": list(self.annotation.video_segments),
                "keyframes": list(self.annotation.video_segment_keyframes),
                "objects": copy.deepcopy(self.annotation.video_objects)}

    def undo(self) -> bool:
        if not self._undo:
            return False
        self._redo.append(self._current())
        self._restore(self._undo.pop())
        return True

    def redo(self) -> bool:
        if not self._redo:
            return False
        self._undo.append(self._current())
        self._restore(self._redo.pop())
        return True

    # ----------------------------------------------------------- segments

    def split_segment(self, frame: int) -> None:
        """Add a segment boundary at ``frame`` (reference segment_split,
        gt_content_annotator.py:1915)."""
        frame = int(frame)
        if frame <= 0 or frame >= self.annotation.total_frames:
            raise ValueError(f"split {frame} outside (0, "
                             f"{self.annotation.total_frames})")
        if frame in self.annotation.video_segments:
            return
        self._snapshot()
        self.annotation.video_segments.append(frame)
        self.annotation.video_segments.sort()

    def merge_segment(self, split: int) -> None:
        """Remove the segment boundary at ``split``, merging its
        neighbors (reference segment_merge, :1935)."""
        split = int(split)
        if split not in self.annotation.video_segments:
            raise ValueError(f"no split at {split}")
        self._snapshot()
        self.annotation.video_segments.remove(split)

    def add_keyframe(self, frame: int) -> None:
        """Mark ``frame`` as a per-segment summary keyframe (reference
        segment_keyframe_add, :1957)."""
        frame = int(frame)
        if not 0 <= frame < self.annotation.total_frames:
            raise ValueError(f"keyframe {frame} out of range")
        if frame in self.annotation.video_segment_keyframes:
            return
        self._snapshot()
        self.annotation.video_segment_keyframes.append(frame)
        self.annotation.video_segment_keyframes.sort()

    def del_keyframe(self, frame: int) -> None:
        frame = int(frame)
        if frame not in self.annotation.video_segment_keyframes:
            raise ValueError(f"no keyframe at {frame}")
        self._snapshot()
        self.annotation.video_segment_keyframes.remove(frame)

    # ------------------------------------------------------------ objects

    def add_object(self, object_id: str, name: str, shape_type: int,
                   frame: int, points: Sequence[Sequence[float]],
                   visible: bool = True) -> None:
        """Create a timeline object with its first keypose (reference
        add_object, :946). Objects are keyed by id, matching
        LectureAnnotation.load (lecture_annotation.py:275)."""
        if object_id in self.annotation.video_objects:
            raise ValueError(f"object {object_id!r} already exists")
        self._snapshot()
        obj = TimelineObject(object_id, name, int(shape_type))
        obj.set_location_at(int(frame), self.abs_time(int(frame)),
                            bool(visible),
                            [tuple(map(float, p)) for p in points])
        self.annotation.video_objects[object_id] = obj

    def rename_object(self, key: str, new_id: str, new_name: str) -> None:
        obj = self._object(key)
        if (new_id != obj.id
                and new_id in self.annotation.video_objects):
            raise ValueError(f"object {new_id!r} already exists")
        self._snapshot()
        del self.annotation.video_objects[obj.id]
        obj.id = new_id
        obj.name = new_name
        self.annotation.video_objects[new_id] = obj

    def remove_object(self, key: str) -> None:
        obj = self._object(key)
        self._snapshot()
        del self.annotation.video_objects[obj.id]

    def set_location(self, name: str, frame: int,
                     points: Sequence[Sequence[float]],
                     visible: bool = True) -> None:
        """Add/update the object's keypose at ``frame`` (reference
        btn_keyframe_add / canvas_object_edited, :1513,1169)."""
        obj = self._object(name)
        self._snapshot()
        obj.set_location_at(int(frame), self.abs_time(int(frame)),
                            bool(visible),
                            [tuple(map(float, p)) for p in points])

    def del_location(self, name: str, frame: int) -> None:
        obj = self._object(name)
        if len(obj.locations) == 1 and obj.locations[0].frame == int(frame):
            raise ValueError(
                f"object {name!r} has only this keypose — remove the "
                f"object instead (an empty timeline cannot be queried)")
        self._snapshot()
        if not obj.del_location_at(int(frame)):
            self._undo.pop()   # nothing changed
            raise ValueError(f"object {name!r} has no keypose at {frame}")

    def set_visible(self, name: str, frame: int, visible: bool) -> None:
        """Toggle visibility at an existing keypose (reference
        set_object_keyframe_visible, :1481)."""
        obj = self._object(name)
        location = next((loc for loc in obj.locations
                         if loc.frame == int(frame)), None)
        if location is None:
            raise ValueError(f"object {name!r} has no keypose at {frame}")
        self._snapshot()
        location.visible = bool(visible)

    def location_at(self, name: str, frame: int) -> Optional[dict]:
        """Interpolated pose at any frame (the same timeline interpolation
        the evaluators use; eval/lecture_annotation.py get_location_at)."""
        obj = self._object(name)
        location = obj.get_location_at(int(frame), False)
        if location is None:
            return None
        return {"frame": int(frame), "visible": bool(location.visible),
                "points": np.asarray(location.polygon_points).tolist()}

    def _object(self, key: str) -> TimelineObject:
        obj = self.annotation.video_objects.get(key)
        if obj is None:   # fall back to lookup by display name
            obj = next((o for o in self.annotation.video_objects.values()
                        if o.name == key), None)
        if obj is None:
            raise KeyError(f"unknown object {key!r}")
        return obj

    # ------------------------------------------------------------- render

    def render_frame(self, index: int) -> np.ndarray:
        """Frame with overlays: object poses (green = keypose at this
        frame, gray = interpolated, dashed-off = invisible), segment
        boundary flash, keyframe marker. The object labels need OpenCV
        (``put_label``)."""
        rgb = np.ascontiguousarray(self.frame(index).copy())
        for name, obj in self.annotation.video_objects.items():
            location = obj.get_location_at(int(index), False)
            if location is None or not location.visible:
                continue
            exact = any(loc.frame == int(index) for loc in obj.locations)
            color = (0, 200, 0) if exact else (160, 160, 160)
            pts = np.asarray(location.polygon_points, np.int32)
            if len(pts) == 2:   # bbox stored as two corners
                rectangle(rgb, tuple(pts[0]), tuple(pts[1]), color, 2)
            else:
                polylines(rgb, [pts.reshape(-1, 1, 2)], True, color, 2)
            anchor = pts.min(axis=0)
            put_label(rgb, name, (int(anchor[0]), max(12, int(anchor[1]) - 4)),
                      0.9, color)
        if int(index) in self.annotation.video_segments:
            rectangle(rgb, (0, 0), (rgb.shape[1] - 1, rgb.shape[0] - 1),
                      (255, 0, 0), 4)
        if int(index) in self.annotation.video_segment_keyframes:
            circle(rgb, (14, 14), 9, (255, 200, 0), -1)
        return rgb

    # --------------------------------------------------------------- save

    def save(self, path: Optional[str] = None) -> str:
        target = path or self.annotation.output_file
        os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
        self.annotation.save(target)
        return target


# --------------------------------------------------------------- HTTP UI

PAGE = """<!DOCTYPE html>
<html><head><title>Annotation editor</title><style>
body { font-family: sans-serif; margin: 12px; }
#frame { image-rendering: auto; cursor: crosshair; }
button.on { background: #cde; }
#timeline { width: 640px; }
</style></head><body>
<div>
  frame <input id="timeline" type="range" min="0" value="0">
  <span id="fidx">0</span>
  <button id="prev">&lt;</button><button id="next">&gt;</button>
</div>
<div>
  segments: <button id="split">split here</button>
  <button id="merge">merge here</button>
  keyframes: <button id="kfadd">mark</button>
  <button id="kfdel">unmark</button>
  <button id="undo">undo</button><button id="redo">redo</button>
  <button id="save">save</button>
  <span id="status"></span>
</div>
<div>
  objects: <select id="obj"></select>
  <input id="objname" placeholder="name" style="width:7em">
  <button id="objadd">add bbox (drag on frame)</button>
  <button id="objdel">remove</button>
  keypose: <button id="posedel">delete here</button>
  <button id="posevis">visible</button><button id="poseinvis">hidden</button>
</div>
<div><img id="frame"></div>
<pre id="info"></pre>
<script>
let st = null, idx = 0, dragStart = null, pendingAdd = false;
const img = document.getElementById('frame');
const tl = document.getElementById('timeline');
async function api(path, body) {
  const r = await fetch(path, body === undefined ? {} :
    {method: 'POST', body: JSON.stringify(body)});
  return r.json();
}
function refresh() {
  img.src = '/img/frame/' + idx + '?t=' + Date.now();
  document.getElementById('fidx').textContent = idx;
}
async function reload() {
  st = await api('/api/state');
  tl.max = st.total_frames - 1;
  const sel = document.getElementById('obj');
  sel.innerHTML = '';
  for (const name of Object.keys(st.objects)) {
    const o = document.createElement('option');
    o.value = name; o.textContent = name; sel.appendChild(o);
  }
  document.getElementById('info').textContent =
    'splits: ' + JSON.stringify(st.splits) +
    '\\nkeyframes: ' + JSON.stringify(st.keyframes);
  refresh();
}
reload();
tl.oninput = () => { idx = parseInt(tl.value); refresh(); };
document.getElementById('prev').onclick = () => {
  idx = Math.max(0, idx - 1); tl.value = idx; refresh(); };
document.getElementById('next').onclick = () => {
  idx = Math.min(st.total_frames - 1, idx + 1); tl.value = idx; refresh(); };
for (const [id, path, body] of [
    ['split', '/api/split', () => ({frame: idx})],
    ['merge', '/api/merge', () => ({split: idx})],
    ['kfadd', '/api/keyframe', () => ({frame: idx, op: 'add'})],
    ['kfdel', '/api/keyframe', () => ({frame: idx, op: 'del'})],
    ['undo', '/api/undo', () => ({})],
    ['redo', '/api/redo', () => ({})]]) {
  document.getElementById(id).onclick = async () => {
    const r = await api(path, body());
    document.getElementById('status').textContent =
      r.ok ? '' : (' ' + (r.error || 'failed'));
    reload();
  };
}
document.getElementById('save').onclick = async () => {
  const r = await api('/api/save', {});
  document.getElementById('status').textContent = ' saved ' + r.path; };
document.getElementById('objadd').onclick = () => { pendingAdd = true;
  document.getElementById('status').textContent = ' drag a box...'; };
document.getElementById('objdel').onclick = async () => {
  await api('/api/object', {op: 'remove',
    name: document.getElementById('obj').value}); reload(); };
document.getElementById('posedel').onclick = async () => {
  await api('/api/pose', {op: 'del',
    name: document.getElementById('obj').value, frame: idx}); reload(); };
document.getElementById('posevis').onclick = async () => {
  await api('/api/pose', {op: 'visible', visible: true,
    name: document.getElementById('obj').value, frame: idx}); reload(); };
document.getElementById('poseinvis').onclick = async () => {
  await api('/api/pose', {op: 'visible', visible: false,
    name: document.getElementById('obj').value, frame: idx}); reload(); };
function pos(e) {
  const r = img.getBoundingClientRect();
  return [Math.round(e.clientX - r.left), Math.round(e.clientY - r.top)];
}
img.ondragstart = () => false;
img.onmousedown = (e) => { dragStart = pos(e); };
img.onmouseup = async (e) => {
  if (!dragStart) return;
  const a = dragStart, b = pos(e); dragStart = null;
  if (Math.abs(a[0] - b[0]) < 3 && Math.abs(a[1] - b[1]) < 3) return;
  const box = [[Math.min(a[0], b[0]), Math.min(a[1], b[1])],
               [Math.max(a[0], b[0]), Math.max(a[1], b[1])]];
  if (pendingAdd) {
    pendingAdd = false;
    const name = document.getElementById('objname').value || 'speaker';
    await api('/api/object', {op: 'add', name: name, id: name,
      shape_type: 0, frame: idx, points: box});
  } else {
    const name = document.getElementById('obj').value;
    if (!name) return;
    await api('/api/pose', {op: 'set', name: name, frame: idx, points: box});
  }
  reload();
};
</script></body></html>
"""


def make_handler(session: AnnotationEditorSession):
    import json
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, body: bytes, content_type: str = "application/json"):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj):
            self._send(json.dumps(obj).encode())

        def _guard(self, fn):
            try:
                fn()
                self._json({"ok": True})
            except (ValueError, KeyError) as err:
                self._json({"ok": False, "error": str(err)})

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                self._send(PAGE.encode(), "text/html")
            elif self.path.startswith("/api/state"):
                self._json(session.state())
            elif self.path.startswith("/api/pose/"):
                name, frame = self.path.rsplit("/", 2)[-2:]
                try:
                    self._json(session.location_at(
                        name, int(frame.split("?")[0])))
                except (ValueError, KeyError) as err:
                    self.send_error(404, str(err))
            elif self.path.startswith("/img/frame/"):
                index = int(self.path.rsplit("/", 1)[1].split("?")[0]
                            .replace(".png", ""))
                try:   # unreadable file / index past end -> 404, not a
                    image = session.render_frame(index)[:, :, ::-1]
                except (KeyError, IOError, ValueError) as err:  # crash
                    self.send_error(404, str(err))
                    return
                self._send(encode_png(image), "image/png")
            else:
                self.send_error(404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if self.path.startswith("/api/split"):
                self._guard(lambda: session.split_segment(body["frame"]))
            elif self.path.startswith("/api/merge"):
                self._guard(lambda: session.merge_segment(body["split"]))
            elif self.path.startswith("/api/keyframe"):
                if body.get("op") == "del":
                    self._guard(lambda: session.del_keyframe(body["frame"]))
                else:
                    self._guard(lambda: session.add_keyframe(body["frame"]))
            elif self.path.startswith("/api/object"):
                op = body.get("op", "add")
                if op == "add":
                    self._guard(lambda: session.add_object(
                        body.get("id", body["name"]), body["name"],
                        int(body.get("shape_type", 0)), int(body["frame"]),
                        body["points"], bool(body.get("visible", True))))
                elif op == "rename":
                    self._guard(lambda: session.rename_object(
                        body["name"], body.get("new_id", body["new_name"]),
                        body["new_name"]))
                else:
                    self._guard(lambda: session.remove_object(body["name"]))
            elif self.path.startswith("/api/pose"):
                op = body.get("op", "set")
                if op == "set":
                    self._guard(lambda: session.set_location(
                        body["name"], int(body["frame"]), body["points"],
                        bool(body.get("visible", True))))
                elif op == "visible":
                    self._guard(lambda: session.set_visible(
                        body["name"], int(body["frame"]),
                        bool(body["visible"])))
                else:
                    self._guard(lambda: session.del_location(
                        body["name"], int(body["frame"])))
            elif self.path.startswith("/api/undo"):
                self._json({"ok": session.undo()})
            elif self.path.startswith("/api/redo"):
                self._json({"ok": session.redo()})
            elif self.path.startswith("/api/save"):
                self._json({"ok": True, "path": session.save()})
            else:
                self.send_error(404)

    return Handler


def serve(session: AnnotationEditorSession, port: int = 0):
    """Start the editor UI server; returns the (bound) HTTPServer — call
    serve_forever() (blocking) or run it in a thread (tests)."""
    from http.server import ThreadingHTTPServer

    return ThreadingHTTPServer(("127.0.0.1", port), make_handler(session))
