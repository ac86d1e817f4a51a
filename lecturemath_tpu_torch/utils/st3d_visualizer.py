"""Interactive ST3D structure visualizer — browser scrubber over the
stage-02/03 artifacts.

The reference ships this as a pygame GUI (reference:
AccessMath/util/ST3D_visualizer.py:16-476 over
util/ST3D_video_player.py:8-337): play/scrub the sampled lecture in three
view modes (rebuilt binary / group-reconstructed / stable grouped content)
and hover any pixel to inspect the unique CC under it (global id, bbox,
sighting count, first/last frame) and the CC group covering it (id, age
breakpoints, boundaries). This module serves the same inspection surface
as a local browser page, following the repo's other interactive tools
(utils/gt_editor.py pattern): a headless-testable session class plus a
thin ThreadingHTTPServer.

Scrubbing is in SAMPLE space (0..n_samples-1). The reference scrubs in
original-video frame numbers and maps back through frame_indices
(ST3D_visualizer.py:342); sample space addresses exactly the frames the
artifacts actually hold, so nothing is lost and off-sample positions
cannot 404.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from ..data.space_time import SpaceTimeStruct
from .png import encode_png
from .visualizer import st3d_frame_image

MODES = ("binary", "reconstructed", "stable")


class ST3DVisualizerSession:
    """Queries over one lecture's tracking + ST3D artifacts.

    ``tracker`` is the stage-02 CCTracker (the reference pickles its
    CCStabilityEstimator the same way); ``st3d`` the stage-03 structure;
    ``clean_frames`` optionally the stage-03 reconstructed binaries.
    """

    def __init__(self, frame_times: List[float], frame_indices: List[int],
                 tracker, st3d: SpaceTimeStruct,
                 clean_frames: Optional[List[np.ndarray]] = None,
                 lecture: str = ""):
        self.frame_times = frame_times
        self.frame_indices = frame_indices
        self.tracker = tracker
        self.st3d = st3d
        self.clean_frames = clean_frames
        self.lecture = lecture
        # ThreadingHTTPServer handlers share the session: serialize cache
        # mutation (same reason annotation_editor guards its frame cache)
        import threading

        self._cache_lock = threading.Lock()
        self._binary_cache: Dict[int, np.ndarray] = {}

    @classmethod
    def from_artifacts(cls, store, lecture_id: str, stability_prefix: str,
                       st3d_prefix: str,
                       reconstructed_prefix: Optional[str] = None,
                       lecture: str = "") -> "ST3DVisualizerSession":
        """Load from the stage artifact store (same files the pipeline
        CLIs relay between stages)."""
        frame_times, frame_indices, tracker = store.load(
            stability_prefix, lecture_id)
        st3d = store.load(st3d_prefix, lecture_id)
        clean = None
        if reconstructed_prefix and store.exists(reconstructed_prefix,
                                                 lecture_id):
            from ..pipeline.video import decompress_png

            _, _, compressed = store.load(reconstructed_prefix, lecture_id)
            clean = decompress_png(compressed)
        return cls(list(frame_times), list(frame_indices), tracker, st3d,
                   clean, lecture=lecture)

    # ----------------------------------------------------------- basic info

    @property
    def n_samples(self) -> int:
        return len(self.frame_indices)

    def state(self) -> Dict[str, Any]:
        return {
            "lecture": self.lecture,
            "n_samples": self.n_samples,
            "width": self.st3d.width,
            "height": self.st3d.height,
            "frame_indices": [int(i) for i in self.frame_indices],
            "frame_times": [float(t) for t in self.frame_times],
            "n_unique_ccs": len(self.tracker.unique_ccs),
            "n_groups": len(self.st3d.group_ages),
            "modes": list(MODES),
            "has_reconstructed": self.clean_frames is not None,
        }

    # ------------------------------------------------------------ rendering

    def frame_image(self, pos: int, mode: str = "binary") -> np.ndarray:
        """HxWx3 uint8 view of sample ``pos`` (reference player modes:
        ST3D_visualizer.py:325-332 binary/reconstructed/stable)."""
        if not 0 <= pos < self.n_samples:
            raise IndexError(f"sample {pos} out of range 0..{self.n_samples - 1}")
        if mode not in MODES:
            raise ValueError(f"unknown mode <{mode}>; one of {MODES}")
        if mode == "stable":
            return st3d_frame_image(self.st3d, pos)
        if mode == "reconstructed":
            if self.clean_frames is None:
                raise ValueError("no reconstructed frames loaded (stage-03 "
                                 "CC_RECONSTRUCTED_OUTPUT artifact missing)")
            gray = self.clean_frames[pos]
        else:
            gray = self._rebuilt_binary(pos)
        return np.repeat(gray[:, :, None], 3, axis=2)

    def _rebuilt_binary(self, pos: int) -> np.ndarray:
        with self._cache_lock:
            if pos not in self._binary_cache:
                from ..pipeline.cc_tracking import render_ccs

                self._binary_cache[pos] = render_ccs(
                    [cc for _, cc in self.tracker.cc_idx_per_frame[pos]],
                    self.tracker.height, self.tracker.width)
                if len(self._binary_cache) > 32:   # bound memory
                    self._binary_cache.pop(next(iter(self._binary_cache)))
            return self._binary_cache[pos]

    # -------------------------------------------------------------- queries

    def query(self, pos: int, x: int, y: int) -> Dict[str, Any]:
        """What is under pixel (x, y) at sample ``pos``: the unique CC (if
        its mask covers the pixel) and the CC group whose current age
        segment inks the pixel (reference: get_mouse_cc_info,
        ST3D_visualizer.py:340-410)."""
        if not 0 <= pos < self.n_samples:
            raise IndexError(f"sample {pos} out of range 0..{self.n_samples - 1}")
        frame_idx = self.frame_indices[pos]
        result: Dict[str, Any] = {"pos": pos, "frame_index": int(frame_idx),
                                  "x": int(x), "y": int(y),
                                  "cc": None, "group": None}

        # unique CC under the pixel — first hit in frame order, like the
        # reference's scan of cc_idx_per_frame (ST3D_visualizer.py:352-366)
        for uidx, cc in self.tracker.cc_idx_per_frame[pos]:
            if (cc.min_x <= x <= cc.max_x and cc.min_y <= y <= cc.max_y
                    and cc.img[y - cc.min_y, x - cc.min_x] > 0):
                sightings = self.tracker.unique_cc_frames[uidx]
                result["cc"] = {
                    "id": int(uidx),
                    "box": [int(cc.min_x), int(cc.min_y),
                            int(cc.max_x), int(cc.max_y)],
                    "size": int(cc.size),
                    "instances": len(sightings),
                    "first_frame": int(self.frame_indices[sightings[0][0]]),
                    "last_frame": int(self.frame_indices[sightings[-1][0]]),
                }
                break

        # group covering the pixel in its age segment for this frame
        # (reference: ST3D_visualizer.py:374-408)
        groups = self.st3d.groups_in_frame_range(frame_idx, frame_idx)
        groups = self.st3d.groups_in_space_region(x, x, y, y, groups)
        for gidx in groups:
            ages = self.st3d.group_ages[gidx]
            images = self.st3d.group_images[gidx]
            g_min_x, g_max_x, g_min_y, g_max_y = \
                self.st3d.group_boundaries[gidx]
            rel_x, rel_y = x - g_min_x, y - g_min_y
            hit = False
            for age_idx in range(len(ages) - 1):
                if (self.frame_indices[ages[age_idx]] <= frame_idx
                        <= self.frame_indices[ages[age_idx + 1]]):
                    image = images[min(age_idx, len(images) - 1)]
                    hit = image[rel_y, rel_x] > 0
                    break
            if hit:
                result["group"] = {
                    "id": int(gidx),
                    "box": [int(g_min_x), int(g_min_y),
                            int(g_max_x), int(g_max_y)],
                    "ages": [int(self.frame_indices[a]) for a in ages],
                    "segments": len(images),
                }
                break
        return result


# ------------------------------------------------------------------ server

PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>ST3D visualizer</title>
<style>
body { font-family: sans-serif; background: #50505f; color: #eee;
       margin: 12px; }
#wrap { position: relative; display: inline-block; }
#frame { border: 1px solid #222; image-rendering: pixelated; }
#overlay { position: absolute; left: 0; top: 0; pointer-events: none; }
#info { white-space: pre; font-family: monospace; background: #46465a;
        padding: 8px; min-height: 12em; width: 400px; display: inline-block;
        vertical-align: top; margin-left: 10px; }
button.mode.on { background: #cf8; }
input[type=range] { width: 640px; }
</style></head><body>
<h3 id="title">ST3D visualizer</h3>
<div>
 <div id="wrap">
  <img id="frame" width="640">
  <canvas id="overlay" width="640"></canvas>
 </div><div id="info">hover the frame...</div>
</div>
<div>
 <input type="range" id="scrub" min="0" value="0">
 <span id="label"></span>
</div>
<div>
 <button onclick="step(-1)">&lt; prev</button>
 <button onclick="step(1)">next &gt;</button>
 <button class="mode on" data-m="binary" onclick="setMode('binary')">binary</button>
 <button class="mode" data-m="reconstructed" onclick="setMode('reconstructed')">reconstructed</button>
 <button class="mode" data-m="stable" onclick="setMode('stable')">stable groups</button>
</div>
<script>
let S = null, pos = 0, mode = 'binary', lastQuery = 0;
const img = document.getElementById('frame');
const overlay = document.getElementById('overlay');
const scrub = document.getElementById('scrub');

async function init() {
  S = await (await fetch('/api/state')).json();
  document.getElementById('title').textContent =
    'ST3D ' + S.lecture + ' — ' + S.n_samples + ' samples, ' +
    S.n_unique_ccs + ' unique CCs, ' + S.n_groups + ' groups';
  scrub.max = S.n_samples - 1;
  const h = Math.round(640 * S.height / S.width);
  img.height = h; overlay.height = h;
  if (!S.has_reconstructed) {
    const b = document.querySelector('button.mode[data-m=reconstructed]');
    b.disabled = true;
    b.title = 'stage-03 reconstructed artifact not loaded';
  }
  show();
}
function show() {
  img.src = '/img/frame/' + pos + '.png?mode=' + mode + '&_=' + pos;
  document.getElementById('label').textContent =
    'sample ' + pos + ' / frame ' + S.frame_indices[pos] +
    ' / t=' + S.frame_times[pos].toFixed(2) + 's';
  scrub.value = pos;
  overlay.getContext('2d').clearRect(0, 0, overlay.width, overlay.height);
}
function step(d) {
  pos = Math.min(Math.max(pos + d, 0), S.n_samples - 1); show();
}
scrub.oninput = () => { pos = parseInt(scrub.value); show(); };
function setMode(m) {
  mode = m;
  document.querySelectorAll('button.mode').forEach(
    b => b.classList.toggle('on', b.dataset.m === m));
  show();
}
img.onmousemove = async (ev) => {
  const now = Date.now();
  if (now - lastQuery < 120) return;   // throttle
  lastQuery = now;
  const rect = img.getBoundingClientRect();
  const x = Math.floor((ev.clientX - rect.left) / rect.width * S.width);
  const y = Math.floor((ev.clientY - rect.top) / rect.height * S.height);
  const q = await (await fetch(
    '/api/query?pos=' + pos + '&x=' + x + '&y=' + y)).json();
  let text = '(X, Y) = (' + x + ', ' + y + ')\\n\\n';
  const ctx = overlay.getContext('2d');
  ctx.clearRect(0, 0, overlay.width, overlay.height);
  const sx = rect.width / S.width, sy = rect.height / S.height;
  if (q.cc) {
    text += 'Global CC ID: ' + q.cc.id + '\\n' +
      ' box: [' + q.cc.box + '] size: ' + q.cc.size + '\\n' +
      ' T: [' + q.cc.first_frame + ', ' + q.cc.last_frame + ']\\n' +
      ' -> instances: ' + q.cc.instances + '\\n\\n';
    ctx.strokeStyle = '#0f0'; ctx.lineWidth = 2;
    ctx.strokeRect(q.cc.box[0] * sx, q.cc.box[1] * sy,
      (q.cc.box[2] - q.cc.box[0] + 1) * sx,
      (q.cc.box[3] - q.cc.box[1] + 1) * sy);
  }
  if (q.group) {
    text += 'CC GROUP ID: ' + q.group.id + '\\n' +
      ' box: [' + q.group.box + ']\\n' +
      ' T: [' + q.group.ages[0] + ', ' +
      q.group.ages[q.group.ages.length - 1] + ']\\n' +
      ' ages: ' + q.group.ages.join(', ') + '\\n';
    ctx.strokeStyle = '#ff0'; ctx.lineWidth = 2;
    ctx.strokeRect(q.group.box[0] * sx, q.group.box[1] * sy,
      (q.group.box[2] - q.group.box[0] + 1) * sx,
      (q.group.box[3] - q.group.box[1] + 1) * sy);
  }
  document.getElementById('info').textContent = text;
};
init();
</script></body></html>
"""


def make_handler(session: ST3DVisualizerSession):
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):   # quiet
            pass

        def _send(self, body: bytes, content_type="application/json"):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            parsed = urlparse(self.path)
            query = parse_qs(parsed.query)
            try:
                if parsed.path == "/" or parsed.path.startswith("/index"):
                    self._send(PAGE.encode(), "text/html")
                elif parsed.path.startswith("/api/state"):
                    self._send(json.dumps(session.state()).encode())
                elif parsed.path.startswith("/api/query"):
                    result = session.query(int(query["pos"][0]),
                                           int(query["x"][0]),
                                           int(query["y"][0]))
                    self._send(json.dumps(result).encode())
                elif parsed.path.startswith("/img/frame/"):
                    pos = int(parsed.path.rsplit("/", 1)[1]
                              .replace(".png", ""))
                    mode = query.get("mode", ["binary"])[0]
                    image = session.frame_image(pos, mode)
                    self._send(encode_png(image[:, :, ::-1]), "image/png")
                else:
                    self.send_error(404)
            except (ValueError, KeyError, IndexError) as err:
                self.send_error(404, str(err))

    return Handler


def serve(session: ST3DVisualizerSession, port: int = 0):
    """Start the visualizer server; returns the bound HTTPServer — call
    serve_forever() (blocking) or run it in a thread (tests)."""
    from http.server import ThreadingHTTPServer

    return ThreadingHTTPServer(("127.0.0.1", port), make_handler(session))
