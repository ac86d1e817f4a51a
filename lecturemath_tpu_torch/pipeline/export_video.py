"""Export binarized lectures as video: expand the sampled binary frames to
full frame rate with linear interpolation and mux with the source audio via
ffmpeg.

(reference: KeyframeExporter.ExportVideo / ExpandGenerateSaveTemp /
FromUniformSample, keyframe_exporter.py:146-357)

The interpolated frames are written as PNGs by ``utils/png.py``, byte for
byte as ``cv2.imwrite`` writes them, so rendering needs no OpenCV. OpenCV
is needed only to read the source's frame rate (when ``fps`` is not given)
and to write the video where ffmpeg is not on the PATH.
"""

from __future__ import annotations

import math
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from ..core.artifacts import ArtifactStore
from ..utils.png import write_image
from .video import decompress_png
from .keyframes import export_summary


def interpolated_frames(binary_frames: Sequence[np.ndarray],
                        frame_indices: Sequence[int], start: int,
                        count: int, interp_skip: int = 0):
    """Yield (frame_idx, uint8 frame) for absolute indices [start, start+count):
    exact sampled frames pass through; in-between frames interpolate
    linearly between neighbors, refreshing every interp_skip+1 frames."""
    sampled_pos = int(np.searchsorted(frame_indices, start))
    prev_frame = (binary_frames[sampled_pos - 1].astype(np.float64)
                  if sampled_pos > 0 else None)
    next_frame = (binary_frames[sampled_pos].astype(np.float64)
                  if sampled_pos < len(frame_indices) else None)
    last_emitted = None
    refresh = 0

    for frame_idx in range(start, start + count):
        if sampled_pos < len(frame_indices):
            if frame_idx == frame_indices[sampled_pos]:
                current = binary_frames[sampled_pos]
                prev_frame = next_frame
                sampled_pos += 1
                next_frame = (binary_frames[sampled_pos].astype(np.float64)
                              if sampled_pos < len(frame_indices) else None)
                refresh = interp_skip + 1
            elif sampled_pos == 0:
                current = next_frame.astype(np.uint8)
            else:
                refresh -= 1
                if refresh <= 0:
                    refresh = interp_skip + 1
                    lo = frame_indices[sampled_pos - 1]
                    hi = frame_indices[sampled_pos]
                    w = (frame_idx - lo) / (hi - lo)
                    current = (prev_frame * (1.0 - w) +
                               next_frame * w).astype(np.uint8)
                else:
                    current = last_emitted
        else:
            current = (prev_frame.astype(np.uint8)
                       if prev_frame is not None else last_emitted)

        last_emitted = current
        yield frame_idx, current


def export_binary_video(store: ArtifactStore, binary_prefix: str,
                        lecture, video_paths: Sequence[str],
                        output_path: str, invert_binary: bool = False,
                        interp_skip: int = 0, fps: Optional[float] = None,
                        workers: int = 4, block_size: int = 200,
                        tmp_dir: Optional[str] = None) -> str:
    """Render the interpolated binary video and mux the source audio with
    ffmpeg (reference: ExportVideo, keyframe_exporter.py:295-357)."""
    frame_times, frame_indices, compressed = store.load(binary_prefix,
                                                        lecture.id)
    binary_frames = decompress_png(compressed)
    if invert_binary:
        binary_frames = [255 - frame for frame in binary_frames]

    if fps is None:
        import cv2

        capture = cv2.VideoCapture(video_paths[0])
        fps = capture.get(cv2.CAP_PROP_FPS) or 30.0
        capture.release()

    tmp_dir = tmp_dir or (output_path + "_frames")
    os.makedirs(tmp_dir, exist_ok=True)
    total_frames = frame_indices[-1] + 1

    def write_block(start):
        count = min(block_size, total_frames - start)
        for frame_idx, frame in interpolated_frames(binary_frames,
                                                    frame_indices, start,
                                                    count, interp_skip):
            write_image(os.path.join(tmp_dir, f"{frame_idx}.png"),
                        np.repeat(frame[:, :, None], 3, axis=2))

    n_blocks = int(math.ceil(total_frames / block_size))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(write_block, [b * block_size for b in range(n_blocks)]))

    import shutil as _shutil

    if _shutil.which("ffmpeg") is not None:
        audio_inputs = " ".join(f"-i {path}" for path in video_paths)
        audio_filter = " ".join(f"[{k + 1}:a:0]"
                                for k in range(len(video_paths)))
        audio_filter += f" concat=n={len(video_paths)}:v=0:a=1 [audio]"

        command = (
            f"ffmpeg -y -framerate {fps:.2f} -start_number 0 "
            f"-i {tmp_dir}/%d.png {audio_inputs} "
            f"-filter_complex \"{audio_filter}\" -map 0:0 -map \"[audio]\" "
            f"-pix_fmt yuv420p -vf \"scale=trunc(iw/2)*2:trunc(ih/2)*2\" "
            f"-c:v libx264 -r {fps:.2f} -shortest {output_path}")
        print(command)
        result = subprocess.run(command, shell=True)
        if result.returncode != 0:
            print("ffmpeg failed; interpolated frames left in " + tmp_dir)
            return output_path
    else:
        # no ffmpeg: write video-only output with OpenCV (no audio mux)
        import cv2

        print("ffmpeg not found; writing video without audio via OpenCV")
        first = cv2.imread(os.path.join(tmp_dir, "0.png"))
        writer = cv2.VideoWriter(output_path,
                                 cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                 (first.shape[1], first.shape[0]))
        for frame_idx in range(total_frames):
            frame = cv2.imread(os.path.join(tmp_dir, f"{frame_idx}.png"))
            writer.write(frame if frame is not None else first)
        writer.release()

    for frame_idx in range(total_frames):
        path = os.path.join(tmp_dir, f"{frame_idx}.png")
        if os.path.exists(path):
            os.remove(path)
    try:
        os.rmdir(tmp_dir)   # leave it if anything else landed there
    except OSError:
        pass
    return output_path


def summary_from_uniform_sample(store: ArtifactStore, binary_prefix: str,
                                database, lecture, step: int,
                                sample_name: str, summaries_root: str) -> str:
    """Baseline summary: every step-th binarized frame becomes a keyframe
    with midpoint intervals (reference: FromUniformSample,
    keyframe_exporter.py:146-193)."""
    frame_times, frame_indices, compressed = store.load(binary_prefix,
                                                        lecture.id)
    frame_times = frame_times[::step]
    frame_indices = frame_indices[::step]
    frames = decompress_png(compressed[::step])

    idx_intervals, time_intervals = [], []
    for k in range(len(frames)):
        if k == 0:
            start = frame_indices[0] // 2
            t_start = frame_times[0] / 2.0
        else:
            start = (frame_indices[k - 1] + frame_indices[k]) // 2
            t_start = (frame_times[k - 1] + frame_times[k]) / 2.0
        if k + 1 < len(frames):
            end = (frame_indices[k + 1] + frame_indices[k]) // 2
            t_end = (frame_times[k + 1] + frame_times[k]) / 2.0
        else:
            end = frame_indices[k]
            t_end = frame_times[k]
        idx_intervals.append((start, end))
        time_intervals.append((t_start, t_end))
        frames[k] = 255 - frames[k]  # artifact ink=255 -> keyframe ink=0

    prefix = os.path.join(
        summaries_root,
        f"{sample_name}_{database.name}_{lecture.title.lower()}")
    return export_summary(prefix, database.name, lecture.title,
                          [v["path"] for v in lecture.main_videos],
                          idx_intervals, time_intervals, list(frame_indices),
                          list(frame_times), frames)
