"""The five pipeline stages, mirroring pre_ST3D_v3.0_01..05 (reference repo
root scripts) over the port's building blocks.

Artifact compatibility: plain-data artifacts keep the reference's exact
shapes — the stage-01 binary tuple (times, indices, PNG buffers), the
stage-04 interval list, and the stage-03 conflict dicts — so those can be
exchanged with a reference installation directly. The stage-02 tracker and
stage-03 ST3D artifacts pickle custom classes on both sides and are
implementation-specific (the reference's equally require its own package
to unpickle); exchange at those boundaries goes through the exported
summary/XML formats instead.

Stage 01 runs on the card, and so does stage 02 with
CC_ANALYSIS_DEVICE_LABELING=1, unless the driver's ``-device cpu`` asks
for the CPU. Stages 03-05 run on the host.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

import numpy as np

from ..core.config import Config
from ..core.metadata import LectureInfo
from ..data.space_time import SpaceTimeStruct
from .cc_tracking import CCTracker
from .driver import PipelineDriver
from .express import driver_device
from .keyframes import close_interval_gaps, export_summary, extract_keyframes
from .video import compress_png, decompress_png
from . import segmentation as seg

if TYPE_CHECKING:
    # torch loads with the binarizer, in stage 01 (and with K3 in stage
    # 02's device labeling): the host stages' CLIs start without it
    from .binarize import Binarizer


# --------------------------------------------------------------- stage 01

def stage01_binarize(driver: PipelineDriver, lecture: LectureInfo,
                     _inputs: Any, binarizer: Binarizer = None,
                     frames_limit: int = 0):
    """Sample frames at SAMPLING_FPS and binarize them in device batches
    (reference: pre_ST3D_v3.0_01_binarize.py:20-74). Without ``binarizer``,
    one is built on the device the driver's ``-device`` names (the card by
    default)."""
    if binarizer is None:
        from .binarize import Binarizer

        binarizer = Binarizer.from_config(driver.config,
                                          device=driver_device(driver))

    source = driver.frame_source(lecture)
    times, indices, binaries = binarizer.process_source(source, frames_limit)
    return times, indices, compress_png(binaries)


# --------------------------------------------------------------- stage 02

def stage02_cc_analysis(driver: PipelineDriver, lecture: LectureInfo,
                        inputs: Any):
    """Track unique CCs over the binarized frames
    (reference: pre_ST3D_v3.0_02_cc_analaysis.py:19-57).

    Set CC_ANALYSIS_DEVICE_LABELING=1 to run CC labeling itself on the card
    (ops/cc_label.py, kernel K3, CC_ANALYSIS_DEVICE_BATCH frames a launch;
    ``-device cpu`` runs its plain version on the CPU); labeling otherwise
    uses the fused native C++ pass. K3 and the native pass always reach the
    fixed point. The plain version keeps the JAX package's bound of 64
    propagation rounds, so on the CPU a component that winds further than
    64 rounds reach (or a frame near percolation) stays split, and the
    tracker can differ from the card's.

    Set CC_ANALYSIS_SHARDS=N (or pass ``-cc_shards N``) to shard the frame
    axis and track shard-locally with an associative cross-shard merge
    (pipeline/cc_sharded.py — bit-identical to sequential tracking);
    CC_ANALYSIS_WORKERS>1 runs shards on worker processes."""
    frame_times, frame_indices, compressed = inputs
    binaries = decompress_png(compressed)

    config = driver.config
    min_recall = config.get_float("CC_STABILITY_MIN_RECALL", 0.925)
    min_precision = config.get_float("CC_STABILITY_MIN_PRECISION", 0.925)
    max_gap = config.get_int("CC_STABILITY_MAX_GAP", 85)

    n_shards = int(driver.params.get(
        "cc_shards", config.get_int("CC_ANALYSIS_SHARDS", 0)))
    if n_shards > 1 and not config.get_bool("CC_ANALYSIS_DEVICE_LABELING",
                                            False):
        from .cc_sharded import track_sharded

        tracker = track_sharded(
            binaries, min_recall, min_precision, max_gap, n_shards=n_shards,
            n_workers=config.get_int("CC_ANALYSIS_WORKERS", 0))
        return frame_times, frame_indices, tracker

    tracker = CCTracker(
        width=binaries[0].shape[1], height=binaries[0].shape[0],
        min_recall=min_recall, min_precision=min_precision, max_gap=max_gap)

    if config.get_bool("CC_ANALYSIS_DEVICE_LABELING", False):
        from ..core.device import resolve_device
        from ..data.cc import extract_ccs
        from ..ops.cc_label import compact_labels, label_components_batch

        device = resolve_device(driver_device(driver))
        batch_size = config.get_int("CC_ANALYSIS_DEVICE_BATCH", 16)
        for start in range(0, len(binaries), batch_size):
            chunk = binaries[start:start + batch_size]
            batch = np.stack(chunk)
            device_labels = label_components_batch(
                batch, device=device).cpu().numpy()
            for labels in device_labels[:len(chunk)]:
                compacted, n_labels = compact_labels(labels)
                tracker.add_frame_ccs(
                    extract_ccs(None, labels=compacted, n_labels=n_labels))
    else:
        for frame in binaries:
            tracker.add_frame(frame)

    return frame_times, frame_indices, tracker


# --------------------------------------------------------------- stage 03

def stage03_cc_grouping(driver: PipelineDriver, lecture: LectureInfo,
                        inputs: Any):
    """Group stable CCs, compute conflicts/images, re-render clean frames
    (reference: pre_ST3D_v3.0_03_cc_grouping.py:22-118). Returns the three
    stage artifacts [cc_reconstructed, cc_conflicts, st3d]."""
    frame_times, frame_indices, tracker = inputs
    config = driver.config

    if "img_t" in driver.params:
        min_image_threshold = float(driver.params["img_t"])
    else:
        min_image_threshold = config.get_float("CC_GROUPING_MIN_IMAGE_THRESHOLD", 0.5)
    min_recall = config.get("CC_GROUPING_MIN_RECALL", 0.0)
    max_gap = config.get_int("CC_STABILITY_MAX_GAP", 85)
    min_times = config.get_int("CC_STABILITY_MIN_TIMES", 3)
    t_window = config.get_int("CC_GROUPING_TEMPORAL_WINDOW", 5)

    tracker.split_stable_by_gaps(max_gap, min_times)
    stable = tracker.stable_cc_idxs(min_times)
    time_overlapping, _, all_overlapping = \
        tracker.compute_overlapping_stable(stable, t_window)
    groups, group_of = tracker.compute_groups(stable, time_overlapping, min_recall)
    group_ages, groups_per_frame = tracker.compute_group_ages(groups)
    conflicts = tracker.compute_conflicts(stable, all_overlapping,
                                          len(groups), group_of)
    group_images, group_boundaries = \
        tracker.compute_group_images(groups, group_ages, min_image_threshold)
    clean = tracker.iter_clean_frames_from_groups(groups, group_boundaries,
                                                  groups_per_frame,
                                                  group_ages, group_images)

    cc_reconstructed = (frame_times, frame_indices, compress_png(clean))
    cc_conflict_info = (group_ages, conflicts)
    st3d = SpaceTimeStruct(frame_times, frame_indices,
                           tracker.height, tracker.width,
                           group_ages, group_images, group_boundaries)
    return [cc_reconstructed, cc_conflict_info, st3d]


# --------------------------------------------------------------- stage 04

def stage04_segmentation(driver: PipelineDriver, lecture: LectureInfo,
                         inputs: Any):
    """Temporal segmentation by the configured method
    (reference: pre_ST3D_v3.0_04_vid_segmentation.py:16-221)."""
    config = driver.config
    method = config.get_int("VIDEO_SEGMENTATION_METHOD", 3)

    if method in (2, 3):
        frame_times, frame_indices, _compressed = inputs[0]
        group_ages, conflicts = inputs[1]
    else:
        frame_times, frame_indices, _compressed = inputs

    n_frames = len(frame_indices)

    if method == 3:
        st3d: SpaceTimeStruct = inputs[2]
        intervals = seg.segments_from_deletion_events(
            group_ages, st3d.group_boundaries, n_frames,
            float(st3d.width * st3d.height),
            add_threshold=config.get_float(
                "VIDEO_SEGMENTATION_DEL_EVENT_ADD_THRESHOLD", 10),
            min_length=config.get_int(
                "VIDEO_SEGMENTATION_DEL_EVENT_MIN_LENGTH", 15),
            threshold=config.get_float(
                "VIDEO_SEGMENTATION_DEL_EVENT_THRESHOLD", 0.25))
    elif method == 2:
        def override(key, param, cast=int):
            if param in driver.params:
                return cast(driver.params[param])
            return config.get_int(key, 0)

        weight_area = override("VIDEO_SEGMENTATION_CONFLICTS_WEIGHTS", "conf_w")
        weight_pixels = override("VIDEO_SEGMENTATION_CONFLICTS_WEIGHTS_PIXELS",
                                 "conf_p")
        weight_time = override("VIDEO_SEGMENTATION_CONFLICTS_WEIGHTS_TIME",
                               "conf_t")

        if weight_area in (seg.AREA_WEIGHT_UNION, seg.AREA_WEIGHT_INTERSECTION):
            binaries = decompress_png(_compressed[:1])
            img_size = binaries[0].shape[0] * binaries[0].shape[1]
            for gidx in conflicts:
                for other in conflicts[gidx]:
                    conflicts[gidx][other]["area_intersection"] /= img_size
                    conflicts[gidx][other]["area_union"] /= img_size

        intervals = seg.segments_from_conflicts(
            n_frames, group_ages, conflicts,
            min_conflicts=config.get("VIDEO_SEGMENTATION_CONFLICTS_MIN_CONFLICTS", 3.0),
            min_split=config.get_int("VIDEO_SEGMENTATION_CONFLICTS_MIN_SPLIT", 50),
            min_len=config.get_int("VIDEO_SEGMENTATION_CONFLICTS_MIN_LENGTH", 25),
            weight_area=weight_area, weight_pixels=weight_pixels,
            weight_time=weight_time)
    else:
        binaries = decompress_png(_compressed)
        sums = seg.binary_sums(binaries)
        leaf_min = seg.leaf_min_from_config(
            config.get_int("VIDEO_SEGMENTATION_SUM_MIN_SEGMENT", 10),
            config.get_float("SAMPLING_FPS", 1.0))
        intervals = seg.segments_from_sums(
            sums, leaf_min,
            config.get_float("VIDEO_SEGMENTATION_SUM_MIN_ERASE_RATIO", 0.05))

    print(f"Total intervals: {len(intervals)}")
    return intervals


def stage04_input_keys(config: Config):
    """Input artifact keys per segmentation method
    (reference: pre_ST3D_v3.0_04:232-249).

    The reference defaults VIDEO_SEGMENTATION_METHOD to 2 here but to 3 in
    the stage body (:17 vs :232) — with the key absent it loads two
    artifacts and then indexes a third (a crash). We align both defaults
    to 3 (the stage body's choice) instead of mirroring the crash
    (PARITY.md quirks)."""
    method = config.get_int("VIDEO_SEGMENTATION_METHOD", 3)
    if method == 3:
        return ["CC_RECONSTRUCTED_OUTPUT", "CC_CONFLICTS_OUTPUT", "CC_ST3D_OUTPUT"]
    if method == 2:
        return ["CC_RECONSTRUCTED_OUTPUT", "CC_CONFLICTS_OUTPUT"]
    return "CC_RECONSTRUCTED_OUTPUT"


# --------------------------------------------------------------- stage 05

def stage05_summary(driver: PipelineDriver, lecture: LectureInfo, inputs: Any):
    """Render one keyframe per segment and export the summary
    (reference: pre_ST3D_v3.0_05_generate_summary.py:17-92)."""
    st3d: SpaceTimeStruct = inputs[0]
    video_segments = inputs[1]

    keyframes, cc_times = extract_keyframes(st3d, video_segments)
    idx_intervals, time_intervals, summary_indices, summary_times = \
        close_interval_gaps(st3d, video_segments)

    import os
    prefix = os.path.join(
        driver.summaries_dir,
        f"{driver.database.name}_{lecture.title.lower()}")
    export_summary(prefix, driver.database.name, lecture.title,
                   [v["path"] for v in lecture.main_videos],
                   idx_intervals, time_intervals, summary_indices,
                   summary_times, keyframes, cc_times)

    return ((summary_indices, summary_times, keyframes),)
