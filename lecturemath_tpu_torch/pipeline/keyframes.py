"""Keyframe summary generation and export.

Extraction semantics follow the reference KeyframeExtractor
(reference: AccessMath/preprocessing/content/keyframe_extractor.py:13-144):
per video segment, take each overlapping group's last image for the segment,
resolve spatial conflicts greedily newest-first, and render one binary
keyframe (ink black on white). Export produces the same on-disk summary
format (keyframes/<idx>.png + segments.xml + gui_export.xml, reference:
keyframe_exporter.py:13-144) so the reference evaluation tooling can consume
our summaries directly.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from ..data.cc import CC
from ..data.space_time import SpaceTimeStruct
from .cc_tracking import compute_overlapping_cc_groups

Interval = Tuple[int, int]


def extract_keyframes(st3d: SpaceTimeStruct,
                      video_segments: Sequence[Interval],
                      verbose: bool = False):
    """Render one keyframe per segment. Returns (keyframes, keyframe_times):
    keyframes are uint8 [H, W, 3] (white background, black ink);
    keyframe_times are per-keyframe sorted lists of
    (start_time, min_x, max_x, min_y, max_y) for GUI jump targets."""
    keyframes = []
    keyframe_times = []

    for start_int, end_int in video_segments:
        group_ccs: List[CC] = []
        for gidx, ages in st3d.group_ages.items():
            if not (start_int <= ages[-1] and ages[0] <= end_int):
                continue
            # last age segment of this group overlapping the interval
            last_overlap = 0
            while (last_overlap + 2 < len(ages) and
                   ages[last_overlap + 2] <= end_int):
                last_overlap += 1

            min_x, max_x, min_y, max_y = st3d.group_boundaries[gidx]
            image = st3d.group_images[gidx][last_overlap]
            size = int(image.sum()) // 255
            group_ccs.append(CC(gidx, min_x, max_x, min_y, max_y, size, image))

        overlapping_groups, singletons = compute_overlapping_cc_groups(group_ccs)

        mask = np.zeros((st3d.height, st3d.width), dtype=np.int32)
        times: List[tuple] = []

        def paint(cc: CC):
            mask[cc.min_y:cc.max_y + 1, cc.min_x:cc.max_x + 1] += cc.img // 255
            start_time = st3d.frame_times[st3d.group_ages[cc.cc_id][0]]
            times.append((start_time, cc.min_x, cc.max_x, cc.min_y, cc.max_y))

        for offset in singletons:
            paint(group_ccs[offset])

        for members in overlapping_groups:
            # pairwise pixel-level incompatibility within the conflict set
            k = len(members)
            incompatible = np.zeros((k, k), dtype=bool)
            by_age = []
            for a in range(k):
                cc_a = group_ccs[members[a]]
                by_age.append((st3d.group_ages[cc_a.cc_id][0], a))
                for b in range(a + 1, k):
                    recall, _ = cc_a.overlap_recall_precision(group_ccs[members[b]])
                    if recall > 0.0:
                        incompatible[a, b] = incompatible[b, a] = True

            # newest first; accept unless it clashes with an accepted one
            accepted: List[int] = []
            for _, a in sorted(by_age, reverse=True):
                if not any(incompatible[prev, a] for prev in accepted):
                    accepted.append(a)

            for a in accepted:
                paint(group_ccs[members[a]])

        frame = np.zeros((st3d.height, st3d.width, 3), dtype=np.uint8)
        frame[mask >= 1] = 255
        keyframes.append(255 - frame)
        keyframe_times.append(sorted(times))

        if verbose:
            print(f"segment ({start_int}, {end_int}): "
                  f"{len(group_ccs)} groups, {len(singletons)} conflict-free")

    return keyframes, keyframe_times


def close_interval_gaps(st3d: SpaceTimeStruct,
                        video_segments: Sequence[Interval]):
    """Convert sample-offset intervals to absolute frame indices/times and
    close the gaps between consecutive segments at their midpoints
    (reference: pre_ST3D_v3.0_05:41-66). Returns
    (idx_intervals, time_intervals, summary_indices, summary_times)."""
    idx_intervals = []
    time_intervals = []
    summary_indices = []
    summary_times = []

    last_start = 0
    # int 0, not 0.0: the first AbsTimeStart prints as "0" in the reference
    # XML (pre_ST3D_v3.0_05:43 initializes last_time_start = 0)
    last_time_start = 0
    for pos, (seg_start, seg_end) in enumerate(video_segments):
        frame_end = st3d.frame_indices[seg_end]
        time_end = st3d.frame_times[seg_end]

        if pos + 1 < len(video_segments):
            next_start = st3d.frame_indices[video_segments[pos + 1][0]]
            next_time = st3d.frame_times[video_segments[pos + 1][0]]
            interval_end = int((frame_end + next_start) / 2)
            time_interval_end = (time_end + next_time) / 2.0
        else:
            interval_end = frame_end
            time_interval_end = time_end

        idx_intervals.append((last_start, interval_end))
        time_intervals.append((last_time_start, time_interval_end))
        last_start = interval_end
        last_time_start = time_interval_end

        summary_indices.append(frame_end)
        summary_times.append(time_end)

    return idx_intervals, time_intervals, summary_indices, summary_times


# --------------------------------------------------------------- exporting

def segments_xml(database_name: str, lecture_title: str, filename: str,
                 video_paths: Sequence[str], idx_intervals, time_intervals,
                 summary_indices, summary_times) -> str:
    lines = ["<Annotations>"]
    lines.append(f"  <Database>{database_name}</Database>")
    lines.append(f"  <Lecture>{lecture_title}</Lecture>")
    lines.append(f"  <Filename>{filename}</Filename>")
    lines.append("  <VideoFiles>")
    for path in video_paths:
        lines.append(f"  <VideoFile>{path}</VideoFile>")
    lines.append("  </VideoFiles>")

    lines.append("  <VideoSegments>")
    for (idx_start, idx_end), (t_start, t_end) in zip(idx_intervals, time_intervals):
        lines.append("    <VideoSegment>")
        lines.append(f"        <Start>{idx_start}</Start>")
        lines.append(f"        <End>{idx_end}</End>")
        lines.append(f"        <AbsTimeStart>{t_start}</AbsTimeStart>")
        lines.append(f"        <AbsTimeEnd>{t_end}</AbsTimeEnd>")
        lines.append("    </VideoSegment>")
    lines.append("  </VideoSegments>")

    lines.append("  <VideoKeyFrames>")
    for index, abs_time in zip(summary_indices, summary_times):
        lines.append("    <VideoKeyFrame>")
        lines.append(f"       <Index>{index}</Index>")
        lines.append(f"       <AbsTime>{abs_time}</AbsTime>")
        lines.append("       <VideoObjects>")
        lines.append("       </VideoObjects>")
        lines.append("    </VideoKeyFrame>")
    lines.append("  </VideoKeyFrames>")
    lines.append("</Annotations>")
    return "\n".join(lines) + "\n"


def gui_export_xml(keyframe_times) -> str:
    lines = ["<lecture_info>"]
    for times in keyframe_times:
        lines.append("\t<keyframe>")
        for abs_time, min_x, max_x, min_y, max_y in times:
            lines.append("\t\t<content>")
            lines.append(f"\t\t\t<minX>{min_x}</minX>")
            lines.append(f"\t\t\t<maxX>{max_x}</maxX>")
            lines.append(f"\t\t\t<minY>{min_y}</minY>")
            lines.append(f"\t\t\t<maxY>{max_y}</maxY>")
            lines.append(f"\t\t\t<jump>{abs_time}</jump>")
            lines.append("\t\t</content>")
        lines.append("\t</keyframe>")
    lines.append("</lecture_info>")
    return "\n".join(lines) + "\n"


def export_summary(output_prefix: str, database_name: str, lecture_title: str,
                   video_paths: Sequence[str], idx_intervals, time_intervals,
                   summary_indices, summary_times, keyframes,
                   keyframe_times=None) -> str:
    """Write keyframes/<idx>.png + segments.xml (+ gui_export.xml).
    Returns the segments.xml path. The keyframe PNGs have the bytes
    ``cv2.imwrite`` would write (utils/png.py)."""
    from ..utils.png import encode_png

    keyframes_dir = os.path.join(output_prefix, "keyframes")
    os.makedirs(keyframes_dir, exist_ok=True)
    for index, image in zip(summary_indices, keyframes):
        with open(os.path.join(keyframes_dir, f"{index}.png"), "wb") as f:
            f.write(encode_png(image))

    xml_path = os.path.join(output_prefix, "segments.xml")
    with open(xml_path, "w") as f:
        f.write(segments_xml(database_name, lecture_title, xml_path,
                             video_paths, idx_intervals, time_intervals,
                             summary_indices, summary_times))

    if keyframe_times is not None:
        with open(os.path.join(output_prefix, "gui_export.xml"), "w") as f:
            f.write(gui_export_xml(keyframe_times))

    return xml_path
