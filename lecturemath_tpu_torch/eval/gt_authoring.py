"""Scriptable ground-truth authoring: create and edit the annotation trees
the evaluators consume, without the reference's pygame GUI tower.

The reference produces GT through interactive annotators
(reference: AccessMath/annotation/gt_content_annotator.py:29 and siblings,
~17.9k LoC of pygame GUIs). This module is the headless equivalent surface:
given keyframe images/binaries, segment boundaries, and (optionally) speaker
tracks, it writes the exact file tree those GUIs would export —
``segments.xml`` + ``keyframes/`` + ``binary/`` + ``unique_ccs.xml`` (+
portions trees) — and round-trips edits through ``LectureAnnotation``.

Typical workflows (documented in README "Creating ground truth"):

  * author GT for a new lecture from per-segment binary keyframes:
    ``export_gt_tree(...)`` — the output is immediately consumable by
    ``cli.eval_summaries`` / ``eval_multiple_summaries``;
  * correct an existing tree: ``load_exported_keyframes`` + numpy edits on
    the binary images + ``export_gt_tree`` again, or portion-level edits via
    ``portions_from_binary`` / ``save_portions`` / ``load_portions``;
  * edit full-video annotations (segment splits, speaker boxes):
    ``author_lecture_annotation`` / ``add_segment_split`` /
    ``set_speaker_track`` on a ``LectureAnnotation``.

The tree's PNGs are written and read by ``utils/png.py``, byte for byte as
``cv2.imwrite`` writes them and as ``cv2.imread`` reads them, so authoring
needs no OpenCV.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.png import read_image, write_image
from .annotation import KeyframeAnnotation, UniqueCCGroup
from .lecture_annotation import LectureAnnotation, TimelineObject


# ------------------------------------------------------- summary-style GT

def export_gt_tree(output_dir: str, db_name: str, lecture_title: str,
                   keyframe_indices: Sequence[int],
                   keyframe_times: Sequence[float],
                   binary_keyframes: Sequence[np.ndarray],
                   raw_keyframes: Optional[Sequence[np.ndarray]] = None,
                   segments: Optional[Sequence[Tuple[int, int]]] = None,
                   video_paths: Sequence[str] = (),
                   chain_window: int = 3, min_recall: float = 0.8,
                   min_precision: float = 0.8,
                   write_portions: bool = False) -> str:
    """Write a complete GT annotation tree under
    ``<output_dir>/<db>_<lecture>/``: keyframe + binary PNGs, segments.xml,
    unique_ccs.xml (CC identity chains built with the production alignment
    tooling), and optionally the portions tree.

    ``binary_keyframes`` are uint8 [H, W] in the GT convention (ink=0 on a
    255 background). ``raw_keyframes`` default to the binaries rendered as
    RGB. ``segments`` default to midpoint splits between keyframes. Returns
    the tree prefix path.
    """
    from ..pipeline.keyframes import segments_xml
    from .aligner import build_unique_cc_groups

    n = len(keyframe_indices)
    assert n == len(keyframe_times) == len(binary_keyframes) and n > 0

    if segments is None:
        bounds = [0]
        for a, b in zip(keyframe_indices, list(keyframe_indices)[1:]):
            bounds.append(int((a + b) // 2))
        bounds.append(int(keyframe_indices[-1]))
        segments = list(zip(bounds, bounds[1:]))
    time_bounds = [0.0]
    for a, b in zip(keyframe_times, list(keyframe_times)[1:]):
        time_bounds.append((a + b) / 2.0)
    time_bounds.append(float(keyframe_times[-1]))
    time_intervals = list(zip(time_bounds, time_bounds[1:]))

    prefix = os.path.join(output_dir, f"{db_name}_{lecture_title.lower()}")
    os.makedirs(os.path.join(prefix, "keyframes"), exist_ok=True)
    os.makedirs(os.path.join(prefix, "binary"), exist_ok=True)

    for idx, binary, pos in zip(keyframe_indices, binary_keyframes, range(n)):
        if raw_keyframes is not None:
            # raw keyframes are RGB (the pipeline's universal in-memory
            # format); the PNG is written from BGR, as cv2 writes it
            raw = np.asarray(raw_keyframes[pos])[:, :, ::-1]
        else:
            raw = np.stack([binary] * 3, axis=-1)
        write_image(os.path.join(prefix, "keyframes", f"{idx}.png"), raw)
        write_image(os.path.join(prefix, "binary", f"{idx}.png"),
                    np.stack([binary] * 3, axis=-1))

    xml_path = os.path.join(prefix, "segments.xml")
    with open(xml_path, "w") as f:
        f.write(segments_xml(db_name, lecture_title, xml_path,
                             list(video_paths), segments, time_intervals,
                             list(keyframe_indices), list(keyframe_times)))

    keyframes = KeyframeAnnotation.load_exported_keyframes(
        xml_path, os.path.join(prefix, "keyframes") + "/", False)
    for kf in keyframes:
        kf.binary_image = read_image(
            os.path.join(prefix, "binary", f"{kf.idx}.png"))
        kf.update_binary_cc(False)
    groups, _ = build_unique_cc_groups(keyframes, local_window=chain_window,
                                       min_recall=min_recall,
                                       min_precision=min_precision)
    with open(os.path.join(prefix, "unique_ccs.xml"), "w") as f:
        f.write(UniqueCCGroup.groups_to_xml(keyframes, groups))

    if write_portions:
        from .annotation import portions_from_binary

        for kf, binary in zip(keyframes, binary_keyframes):
            kf.portions = portions_from_binary(binary)
        KeyframeAnnotation.save_portions(keyframes, prefix)

    return prefix


# --------------------------------------------------- full-video annotation

def author_lecture_annotation(db_name: str, title: str,
                              video_files: Sequence[str], total_frames: int,
                              segment_splits: Sequence[int] = (),
                              keyframes: Sequence[int] = (),
                              output_file: str = "") -> LectureAnnotation:
    """Create a full-video LectureAnnotation (the tree the reference's
    GT_ContentAnnotator edits interactively) from scratch."""
    annotation = LectureAnnotation(db_name, title, output_file,
                                   list(video_files), int(total_frames))
    annotation.video_segments = sorted(int(s) for s in segment_splits)
    annotation.video_segment_keyframes = sorted(int(k) for k in keyframes)
    return annotation


def add_segment_split(annotation: LectureAnnotation, frame: int) -> None:
    if frame <= 0 or frame >= annotation.total_frames:
        raise ValueError(f"split {frame} outside (0, total_frames)")
    if frame not in annotation.video_segments:
        annotation.video_segments.append(int(frame))
        annotation.video_segments.sort()


def remove_segment_split(annotation: LectureAnnotation, frame: int) -> None:
    annotation.video_segments.remove(int(frame))


def set_speaker_track(annotation: LectureAnnotation,
                      boxes: Dict[int, Tuple[float, float, float, float]],
                      fps: float = 30.0, name: str = "speaker",
                      visible: bool = True) -> TimelineObject:
    """Set (or replace) an axis-aligned speaker object from sparse per-frame
    boxes {frame: (x, y, w, h)}; locations between keyframes interpolate
    exactly like the reference's VideoObject (video_object_location.py)."""
    obj = annotation.video_objects.get(name)
    if obj is None:
        obj = TimelineObject(name, name,
                             TimelineObject.SHAPE_ALIGNED_RECTANGLE)
        annotation.video_objects[name] = obj
    for frame in sorted(boxes):
        x, y, w, h = boxes[frame]
        points = [(x, y), (x + w, y), (x + w, y + h), (x, y + h)]
        obj.set_location_at(int(frame), frame / fps * 1000.0, visible,
                            points)
    return obj
