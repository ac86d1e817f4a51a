"""Ground-truth video length/frame accounting.

Equivalent of the reference's video metrics tier
(reference: AccessMath/annotation/video_metrics.py:5-71,
AccessMath/annotation/lecture_video_metrics.py:6-57): counts the TRUE
number of decodable frames of each lecture video by grabbing to the end
— the container-header frame count (`CAP_PROP_FRAME_COUNT`) routinely
disagrees with what actually decodes, and the sampling/accounting layers
depend on the grabbed truth. Used as a diagnostic before annotation.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field
from typing import Dict, List


def _stamp(milliseconds: float) -> str:
    return str(datetime.timedelta(milliseconds=milliseconds))


@dataclass
class VideoMetrics:
    """Per-file grab counts and end positions
    (reference: video_metrics.py:5-71)."""

    video_files: List[str] = field(default_factory=list)
    per_video_frames: List[int] = field(default_factory=list)
    per_video_last_frame: List[int] = field(default_factory=list)
    per_video_time: List[float] = field(default_factory=list)
    total_frames: int = 0
    total_time: float = 0.0

    @staticmethod
    def from_video_files(video_files: List[str]) -> "VideoMetrics":
        """Count frames by grabbing every frame to the end of each file
        (reference: video_metrics.py:36-71 FromVideoFiles)."""
        import cv2

        metrics = VideoMetrics(video_files=list(video_files))
        for video_filename in video_files:
            capture = cv2.VideoCapture(video_filename)
            total_grabs = 0
            last_frame = 0
            last_time = 0.0
            while capture.grab():
                last_frame = int(capture.get(cv2.CAP_PROP_POS_FRAMES))
                last_time = capture.get(cv2.CAP_PROP_POS_MSEC)
                total_grabs += 1
            final_frame = max(int(capture.get(cv2.CAP_PROP_POS_FRAMES)),
                              last_frame)
            final_time = max(capture.get(cv2.CAP_PROP_POS_MSEC), last_time)
            capture.release()

            metrics.per_video_frames.append(total_grabs)
            metrics.per_video_last_frame.append(final_frame)
            metrics.per_video_time.append(final_time)
            metrics.total_frames += total_grabs
            metrics.total_time += final_time
        return metrics

    def metrics_table(self) -> str:
        """(reference: video_metrics.py:16-25 print_metrics)."""
        lines = ["V.IDX\tGrabs\tEnd F\tEnd T"]
        for idx in range(len(self.video_files)):
            lines.append("{0:d}\t{1:d}\t{2:d}\t{3:s}".format(
                idx + 1, self.per_video_frames[idx],
                self.per_video_last_frame[idx],
                _stamp(self.per_video_time[idx])))
        return "\n".join(lines)

    def to_dict(self) -> dict:
        """(reference: video_metrics.py:27-35)."""
        return {
            "total_frames": self.total_frames,
            "total_time": self.total_time,
            "per_video_last_frame": self.per_video_last_frame,
            "per_video_frames": self.per_video_frames,
            "per_video_time": self.per_video_time,
            "video_files": self.video_files,
        }


def container_header_metrics(video_files: List[str]) -> List[dict]:
    """The container's OWN claims: header frame count and seek-to-end
    position (reference: lecture_video_metrics.py:16-33) — printed next
    to the grabbed truth so discrepancies are visible."""
    import cv2

    rows = []
    for video_filename in video_files:
        capture = cv2.VideoCapture(video_filename)
        frame_count = int(capture.get(cv2.CAP_PROP_FRAME_COUNT))
        capture.set(cv2.CAP_PROP_POS_AVI_RATIO, 1.0)
        rows.append({
            "frame_count": frame_count,
            "end_frame": int(capture.get(cv2.CAP_PROP_POS_FRAMES)),
            "end_time": capture.get(cv2.CAP_PROP_POS_MSEC),
        })
        capture.release()
    return rows


def header_table(rows: List[dict]) -> str:
    """(reference: lecture_video_metrics.py:35-40)."""
    lines = ["V.IDX\t# Fr\tEnd F\tEnd T"]
    for idx, row in enumerate(rows):
        lines.append("{0:d}\t{1:d}\t{2:d}\t{3:s}".format(
            idx + 1, row["frame_count"], row["end_frame"],
            _stamp(row["end_time"])))
    return "\n".join(lines)


class LectureVideosMetrics:
    """Per-lecture metrics accumulator
    (reference: lecture_video_metrics.py:6-57)."""

    def __init__(self):
        self.metrics_per_video: Dict[str, VideoMetrics] = {}

    def process_lecture(self, lecture, video_files_path: str,
                        verbose: bool = True) -> VideoMetrics:
        """(reference: lecture_video_metrics.py:10-48 process_lecture)."""
        # os.path.join so an empty/absent VIDEO_FILES_PATH keeps the
        # lecture's own paths usable instead of producing "None/<path>"
        main_videos = [os.path.join(video_files_path or "", video["path"])
                       for video in lecture.main_videos]
        if verbose:
            print("OpenCV Property Metrics")
            print(header_table(container_header_metrics(main_videos)))
            print(".... counting frames ....")

        metrics = VideoMetrics.from_video_files(main_videos)
        if verbose:
            print("\nCount by grabbing all metrics:")
            print(metrics.metrics_table())
        self.metrics_per_video[lecture.title] = metrics
        return metrics

    def to_dict(self) -> dict:
        """(reference: lecture_video_metrics.py:50-57)."""
        return {title: metrics.to_dict()
                for title, metrics in self.metrics_per_video.items()}
