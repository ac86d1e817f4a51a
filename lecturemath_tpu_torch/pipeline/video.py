"""Video ingestion: sampled frame streams from lecture videos.

Replaces the reference VideoProcessor's per-frame worker protocol
(reference: AccessMath/preprocessing/video_processor/video_processor.py:21-200)
with a batched generator: frames are decoded on host (OpenCV), sampled at the
target FPS across multiple video files with absolute time/index accounting,
optionally resized to a forced resolution, and yielded in fixed-size batches
ready for device upload. Decode overlaps with device compute because JAX
dispatch is asynchronous.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class FrameBatch:
    frames: np.ndarray        # uint8 [B, H, W, 3] RGB
    times: List[float]        # absolute time in ms
    indices: List[int]        # absolute frame index across all files
    valid: int                # number of real frames (rest is padding)


class VideoFrameSource:
    """Decode + sample frames from a list of video files.

    ``seek_strategy``: 'grab' decodes every frame and keeps each step-th;
    'seek' jumps with CAP_PROP_POS_FRAMES; 'auto' times both on the first
    two samples and keeps the faster (the reference VideoProcessor's
    adaptive strategy, video_processor.py:100-146).

    ``alignment``: 'start' (default) samples the first frame of each
    sampling period (content frame k*step, reported with its own index and
    time). 'reference' replicates the reference VideoProcessor's accounting
    bit-for-bit (video_processor.py:40,124-166): the grab loop decodes
    jump_frames-1 then reads, so the content frame is (k+1)*step-1 while the
    reported index is CAP_PROP_POS_FRAMES after the read — (k+1)*step —
    while the reported time is CAP_PROP_POS_MSEC, which names the DECODED
    frame (one frame earlier); step uses int() truncation
    (int(video_fps/fps), video_processor.py:97) rather than rounding; and
    the very first sample of the run is consumed as ``last_frame`` without
    being handled (offset_frame starts at -1 and workers only see frames
    once it is > 0, video_processor.py:40,168-171), so it is dropped here.
    Configure via the SAMPLING_ALIGNMENT config key on the pipeline CLIs.
    """

    # class-level defaults: subclasses (ImageListSource, ArraySource)
    # define their own __init__/frames and inherit these
    alignment = "start"
    seek_strategy = "auto"

    def __init__(self, video_paths: Sequence[str], sampling_fps: float,
                 forced_resolution: Optional[Tuple[int, int]] = None,
                 seek_strategy: str = "auto", alignment: str = "start"):
        self.video_paths = list(video_paths)
        self.sampling_fps = sampling_fps
        self.forced_resolution = forced_resolution  # (width, height)
        self.seek_strategy = seek_strategy
        if alignment not in ("start", "reference"):
            raise ValueError(f"unknown sampling alignment: {alignment!r}")
        self.alignment = alignment

    def _post(self, frame: np.ndarray) -> np.ndarray:
        import cv2

        if self.forced_resolution is not None:
            fw, fh = self.forced_resolution
            if (frame.shape[1], frame.shape[0]) != (fw, fh):
                frame = cv2.resize(frame, (fw, fh))
        return frame[:, :, ::-1]  # BGR -> RGB

    def frames(self, frames_limit: int = 0) -> Iterator[Tuple[float, int, np.ndarray]]:
        import time

        import cv2

        abs_index_offset = 0
        abs_time_offset = 0.0
        emitted = 0
        # reference mode: the first sample only primes last_frame
        # (video_processor.py:40,168-171) — drop it
        skip_first = self.alignment == "reference"
        strategy = self.seek_strategy

        for path in self.video_paths:
            capture = cv2.VideoCapture(path)
            if not capture.isOpened():
                raise IOError(f"cannot open video: {path}")
            video_fps = capture.get(cv2.CAP_PROP_FPS) or 30.0
            if self.alignment == "reference":
                # reference truncates: jump_frames = int(video_fps / fps)
                step = max(1, int(video_fps / self.sampling_fps))
                # content frame (k+1)*step-1 reported as index (k+1)*step
                phase, report_shift = step - 1, 1
            else:
                step = max(1, int(round(video_fps / self.sampling_fps)))
                phase, report_shift = 0, 0
            n_frames = int(capture.get(cv2.CAP_PROP_FRAME_COUNT) or 0)

            if strategy == "auto" and step > 1 and n_frames > 2 * step:
                strategy = self._pick_strategy(capture, step)

            if strategy == "seek" and n_frames > 0:
                actual_count = None
                for frame_idx in range(phase, n_frames, step):
                    capture.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)
                    ok, frame = capture.read()
                    if not ok:
                        # decode-count correction: a truncated/corrupt file
                        # keeps its header frame count (CAP_PROP_FRAME_COUNT
                        # over-reports — observed on truncated MJPG/AVI), so
                        # a failed read means the END of real data, not of
                        # the header's claim. Count the true length with a
                        # demux-only grab pass so the multi-file index/time
                        # offsets below stay consistent with what the grab
                        # strategy (and the reference's decode loop,
                        # video_processor.py:124-166) would report.
                        actual_count = self._count_decodable(capture)
                        break
                    if skip_first:
                        skip_first = False
                        continue
                    # the reported index follows CAP_PROP_POS_FRAMES (the
                    # NEXT frame) in reference mode, but the reported time
                    # follows CAP_PROP_POS_MSEC (the DECODED frame) — they
                    # are offset by one frame in the reference artifact
                    report = frame_idx + report_shift
                    abs_time = abs_time_offset + (frame_idx / video_fps) * 1000.0
                    yield abs_time, abs_index_offset + report, self._post(frame)
                    emitted += 1
                    if frames_limit and emitted >= frames_limit:
                        capture.release()
                        return
                frame_idx = n_frames if actual_count is None else actual_count
            else:
                frame_idx = 0
                while True:
                    grabbed = capture.grab()
                    if not grabbed:
                        break
                    if frame_idx % step == phase:
                        ok, frame = capture.retrieve()
                        if not ok:
                            break
                        if skip_first:
                            skip_first = False
                            frame_idx += 1
                            continue
                        # index follows POS_FRAMES (next frame), time follows
                        # POS_MSEC (decoded frame) — see seek branch note
                        report = frame_idx + report_shift
                        abs_time = abs_time_offset + (frame_idx / video_fps) * 1000.0
                        yield abs_time, abs_index_offset + report, self._post(frame)
                        emitted += 1
                        if frames_limit and emitted >= frames_limit:
                            capture.release()
                            return
                    frame_idx += 1

            total_time = (frame_idx / video_fps) * 1000.0
            abs_index_offset += frame_idx
            abs_time_offset += total_time
            capture.release()

    @staticmethod
    def _count_decodable(capture) -> int:
        """True frame count of an already-open capture by demux-only grabs
        from frame 0 — the correction for headers whose CAP_PROP_FRAME_COUNT
        over-reports (truncated recordings). grab() does not decode pixels,
        so this is cheap even for long files."""
        import cv2

        capture.set(cv2.CAP_PROP_POS_FRAMES, 0)
        count = 0
        while capture.grab():
            count += 1
        return count

    @staticmethod
    def _pick_strategy(capture, step: int) -> str:
        """Time one grab-loop sample vs one direct seek and keep the faster
        (reference adaptive strategy, video_processor.py:100-146)."""
        import time

        import cv2

        start = time.perf_counter()
        for _ in range(step):
            if not capture.grab():
                break
        grab_time = time.perf_counter() - start

        start = time.perf_counter()
        capture.set(cv2.CAP_PROP_POS_FRAMES, 2 * step)
        capture.grab()
        seek_time = time.perf_counter() - start

        capture.set(cv2.CAP_PROP_POS_FRAMES, 0)
        return "seek" if seek_time < grab_time else "grab"

    def batches(self, batch_size: int, frames_limit: int = 0,
                pad_last: bool = True) -> Iterator[FrameBatch]:
        buffer: List[Tuple[float, int, np.ndarray]] = []
        for item in self.frames(frames_limit):
            buffer.append(item)
            if len(buffer) == batch_size:
                yield self._pack(buffer, batch_size, pad_last)
                buffer = []
        if buffer:
            yield self._pack(buffer, batch_size, pad_last)

    @staticmethod
    def _pack(buffer, batch_size: int, pad_last: bool) -> FrameBatch:
        valid = len(buffer)
        frames = np.stack([f for _, _, f in buffer])
        if pad_last and valid < batch_size:
            pad = np.repeat(frames[-1:], batch_size - valid, axis=0)
            frames = np.concatenate([frames, pad])
        return FrameBatch(frames=frames,
                          times=[t for t, _, _ in buffer],
                          indices=[i for _, i, _ in buffer],
                          valid=valid)


class ImageListSource(VideoFrameSource):
    """Frame source over a directory of pre-exported frames with an
    index.json metadata file (reference: image_list_processor.py:7-81)."""

    def __init__(self, image_dir: str, img_extension: str = ".png",
                 forced_resolution: Optional[Tuple[int, int]] = None):
        self.image_dir = image_dir
        self.img_extension = img_extension
        self.forced_resolution = forced_resolution

        index_path = os.path.join(image_dir, "index.json")
        if os.path.exists(index_path):
            with open(index_path) as f:
                self.index = json.load(f)
        else:
            self.index = None

    def frames(self, frames_limit: int = 0):
        import cv2

        ext = self.img_extension.lstrip(".")
        if self.index is not None:
            # reference index.json: {frame_id: {abs_time, frame_idx, ...}}
            # with files named <frame_id>.<ext>
            # (reference: image_list_processor.py:16-45; frame id 0 is a
            # synthetic time origin with no image file)
            frame_ids = sorted(int(k) for k in self.index)
            entries = [(self.index[str(fid)].get("abs_time", fid * 1000.0),
                        fid, f"{fid}.{ext}")
                       for fid in frame_ids if fid != 0]
        else:
            files = sorted(f for f in os.listdir(self.image_dir)
                           if f.endswith(self.img_extension))
            entries = [(k * 1000.0, k, f) for k, f in enumerate(files)]

        for count, (abs_time, abs_index, filename) in enumerate(entries):
            if frames_limit and count >= frames_limit:
                return
            frame = cv2.imread(os.path.join(self.image_dir, filename))
            if frame is None:
                continue
            if self.forced_resolution is not None:
                fw, fh = self.forced_resolution
                if (frame.shape[1], frame.shape[0]) != (fw, fh):
                    frame = cv2.resize(frame, (fw, fh))
            yield abs_time, abs_index, frame[:, :, ::-1]


class ArraySource(VideoFrameSource):
    """Frame source over an in-memory uint8 [T, H, W, 3] array (testing and
    synthetic benchmarks)."""

    def __init__(self, frames: np.ndarray, fps: float = 1.0):
        self.array = frames
        self.fps = fps
        self.forced_resolution = None

    def frames(self, frames_limit: int = 0):
        n = len(self.array)
        if frames_limit:
            n = min(n, frames_limit)
        for t in range(n):
            yield (t / self.fps) * 1000.0, t, self.array[t]


def sample_frame_indices(video_paths: Sequence[str],
                         target_indices: Sequence[int],
                         forced_resolution: Optional[Tuple[int, int]] = None
                         ) -> List[Tuple[int, np.ndarray]]:
    """Sequentially decode only the requested absolute frame indices across
    a multi-file lecture (reference: SequentialVideoSampler,
    sequential_video_sampler.py:17; VideoSegmentProcessor use case)."""
    import cv2

    wanted = sorted(set(int(i) for i in target_indices))
    results: List[Tuple[int, np.ndarray]] = []
    offset = 0
    pos = 0

    for path in video_paths:
        if pos >= len(wanted):
            break
        capture = cv2.VideoCapture(path)
        if not capture.isOpened():
            raise IOError(f"cannot open video: {path}")
        frame_idx = 0
        while pos < len(wanted):
            grabbed = capture.grab()
            if not grabbed:
                break
            if offset + frame_idx == wanted[pos]:
                ok, frame = capture.retrieve()
                if not ok:
                    break
                if forced_resolution is not None:
                    fw, fh = forced_resolution
                    if (frame.shape[1], frame.shape[0]) != (fw, fh):
                        frame = cv2.resize(frame, (fw, fh))
                results.append((wanted[pos], frame[:, :, ::-1]))
                pos += 1
            frame_idx += 1
        offset += frame_idx
        capture.release()

    return results


def extract_frames_at_times(video_paths: Sequence[str],
                            times_ms: Sequence[float],
                            forced_resolution: Optional[Tuple[int, int]] = None
                            ) -> List[Tuple[float, np.ndarray]]:
    """Decode the frames nearest to the given absolute times (ms) across a
    multi-file lecture (reference: Loader.extractFramesAbsolute/Relative,
    content/loader.py:14). Returns [(time_ms, RGB frame)]."""
    import cv2

    # map times to absolute frame indices using each file's fps/length
    remaining = sorted(float(t) for t in times_ms)
    out: List[Tuple[float, np.ndarray]] = []
    offset_ms = 0.0
    offset_frames = 0
    spans = []
    for path in video_paths:
        capture = cv2.VideoCapture(path)
        fps = capture.get(cv2.CAP_PROP_FPS) or 30.0
        n_frames = int(capture.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
        capture.release()
        spans.append((path, offset_ms, offset_frames, fps, n_frames))
        offset_ms += (n_frames / fps) * 1000.0
        offset_frames += n_frames

    wanted_indices = []
    for t in remaining:
        for path, start_ms, start_frames, fps, n_frames in spans:
            end_ms = start_ms + (n_frames / fps) * 1000.0
            if start_ms <= t < end_ms or (t >= end_ms and
                                          path == spans[-1][0]):
                local = min(int(round((t - start_ms) / 1000.0 * fps)),
                            n_frames - 1)
                wanted_indices.append((start_frames + local, t))
                break

    frames = dict(sample_frame_indices(video_paths,
                                       [i for i, _ in wanted_indices],
                                       forced_resolution))
    for index, t in wanted_indices:
        if index in frames:
            out.append((t, frames[index]))
    return out


def distribute_values(count: int, start: int, end: int) -> List[int]:
    """``count`` evenly spaced integers in [start, end] (reference:
    MiscHelper.distribute_values — used to pick alignment sample frames)."""
    if count <= 1:
        return [start]
    return [int(round(start + (end - start) * k / (count - 1)))
            for k in range(count)]


def compress_png(frames: Sequence[np.ndarray]) -> List[np.ndarray]:
    """In-memory PNG encoding for reference-compatible stage artifacts
    (reference stores stage-01 output PNG-compressed,
    FCN_lecturenet_binarizer.py:56). Each buffer is what ``cv2.imencode``
    returns, a uint8 array of shape (n, 1), with the same bytes
    (utils/png.py), so no OpenCV is needed."""
    from ..utils.png import encode_png

    return [np.frombuffer(encode_png(frame), np.uint8).reshape(-1, 1)
            for frame in frames]


def decompress_png(buffers: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Decode 8-bit grayscale PNG buffers (utils/png.py; raises
    PNGFormatError on any other PNG)."""
    from ..utils.png import decode_png_gray

    return [decode_png_gray(buf) for buf in buffers]


def grayscale_variance_map(image: np.ndarray, ksize: int) -> np.ndarray:
    """Per-pixel local variance over a (2k)x(2k) window, vectorized with
    box filters (reference: Helper.grayscale_variance_map, helper.py:12-24 —
    a per-pixel double loop there)."""
    import cv2

    img = image.astype(np.float64)
    window = 2 * ksize
    # the reference window is [y-k, y+k) x [x-k, x+k) clipped at borders;
    # normalized box filter over the same support
    mean = cv2.blur(img, (window, window),
                    borderType=cv2.BORDER_ISOLATED)
    mean_sq = cv2.blur(img * img, (window, window),
                       borderType=cv2.BORDER_ISOLATED)
    return np.maximum(mean_sq - mean * mean, 0.0)
