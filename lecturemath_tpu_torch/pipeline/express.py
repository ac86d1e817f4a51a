"""Express pipeline: all five stages in one pass per lecture.

The reference relays every stage through PNG-compressed pickle files on
disk (SURVEY.md §1: the pickle-file relay IS the dataflow layer). This
runner chains the same stage logic in memory — binary frames go straight
from the device into CC tracking — and only writes artifacts/summary when
asked, removing two PNG encode/decode round trips per frame.

Results are identical to running the staged CLIs (tested)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ..core.metadata import LectureInfo
from ..core.timing import span
from ..data.space_time import SpaceTimeStruct
from .cc_tracking import CCTracker
from .driver import PipelineDriver
from .keyframes import close_interval_gaps, export_summary, extract_keyframes
from .video import compress_png
from . import segmentation as seg

if TYPE_CHECKING:
    # the binarizer (and torch) load only where a lecture is binarized:
    # the host-only stage CLIs that import driver_device start without them
    from .binarize import Binarizer


def driver_device(driver: PipelineDriver) -> Optional[str]:
    """The ``-device`` CLI override (None: the card)."""
    device = driver.params.get("device")
    if device is not None and not isinstance(device, str):
        raise ValueError("-device requires a value (e.g. -device cpu)")
    return device


def run_lecture(driver: PipelineDriver, lecture: LectureInfo,
                binarizer: Optional[Binarizer] = None,
                source=None, save_artifacts: bool = False,
                export: bool = True, frames_limit: int = 0):
    """Run binarize -> CC -> grouping -> segmentation -> summary for one
    lecture in memory. Returns (summary_indices, summary_times, keyframes).
    Without ``binarizer``, one is built from the config on the device the
    driver's ``-device`` names (the card by default): with
    DEVICE_WORKER_RECYCLE_MB > 0 a recycled device worker
    (pipeline/device_worker.py), else an in-process Binarizer.

    Spans (core/timing.py): ``lecture`` over the call; under it stage 01's
    ``stage01.*`` (pipeline/binarize.py), ``stage02.track`` for each drained
    batch (``stage02.extract`` and ``stage02.match`` a frame), and
    ``stage03``, ``stage04`` and ``stage05``.
    """
    with span("lecture"):
        return _run_lecture(driver, lecture, binarizer, source,
                            save_artifacts, export, frames_limit)


def _run_lecture(driver: PipelineDriver, lecture: LectureInfo,
                 binarizer: Optional[Binarizer], source, save_artifacts: bool,
                 export: bool, frames_limit: int):
    import os

    config = driver.config

    # ------------------------------------------------- stages 01+02 fused
    # CC tracking (and artifact PNG encode) consume each drained batch while
    # the next batches are in flight on the device, so wall-clock approaches
    # max(device binarize, host track) instead of their sum
    own_binarizer = binarizer is None
    if binarizer is None:
        # DEVICE_WORKER_RECYCLE_MB > 0: run the device path in a recycled
        # child process (pipeline/device_worker.py)
        if config.get_float("DEVICE_WORKER_RECYCLE_MB", 0.0) > 0:
            from .device_worker import WorkerBinarizer

            binarizer = WorkerBinarizer.from_config(
                config, device=driver_device(driver))
        else:
            from .binarize import Binarizer

            binarizer = Binarizer.from_config(config,
                                              device=driver_device(driver))
    if source is None:
        source = driver.frame_source(lecture)

    min_recall = config.get_float("CC_STABILITY_MIN_RECALL", 0.925)
    min_precision = config.get_float("CC_STABILITY_MIN_PRECISION", 0.925)
    max_gap = config.get_int("CC_STABILITY_MAX_GAP", 85)
    n_shards = config.get_int("CC_ANALYSIS_SHARDS", 0)

    tracker = None
    sharded = None
    frame_times: list = []
    frame_indices: list = []
    compressed = [] if save_artifacts else None
    try:
        stream = binarizer.stream_source(source, frames_limit)
        for number, (times, indices, frames) in enumerate(stream):
            if tracker is None and sharded is None:
                height, width = frames[0].shape
                if n_shards > 1:
                    # sharded host tracking (CC_ANALYSIS_SHARDS>1 enables):
                    # in express, shard boundaries follow the drained device
                    # batches (or CC_ANALYSIS_CHUNK_FRAMES-sized chunks),
                    # dispatched to CC_ANALYSIS_WORKERS processes while later
                    # batches are in flight and fold-merged in order —
                    # streaming overlap is kept and results are bit-identical
                    # to sequential tracking at ANY granularity. (The staged
                    # cc_analysis CLI, which holds all frames, splits into
                    # exactly CC_ANALYSIS_SHARDS chunks instead.)
                    from .cc_sharded import StreamingShardedTracker

                    # keep_frame_masks=False: express never pickles the
                    # tracker (no stage-02 artifact) and stage-03+ only read
                    # first-seen masks — dropping per-frame crops caps RSS
                    # at full-lecture scale (~3 MB/frame at 1080p otherwise)
                    sharded = StreamingShardedTracker(
                        width, height, min_recall, min_precision, max_gap,
                        n_workers=config.get_int("CC_ANALYSIS_WORKERS", 0),
                        chunk_frames=config.get_int(
                            "CC_ANALYSIS_CHUNK_FRAMES", 0),
                        keep_frame_masks=False)
                else:
                    tracker = CCTracker(width=width, height=height,
                                        min_recall=min_recall,
                                        min_precision=min_precision,
                                        max_gap=max_gap,
                                        keep_frame_masks=False)
            frame_times.extend(times)
            frame_indices.extend(indices)
            with span("stage02.track", tag=number):
                if sharded is not None:
                    sharded.add_frames(frames)
                else:
                    for frame in frames:
                        tracker.add_frame(frame)
            if save_artifacts:
                compressed.extend(compress_png(frames))
    except BaseException:
        # an aborted stream (e.g. a backend fetch timeout mid-lecture) must
        # not leak the sharded tracker's worker pool / queued shard jobs
        if sharded is not None:
            sharded.abort()
        if own_binarizer and hasattr(binarizer, "close"):
            binarizer.close()
        raise

    if own_binarizer and hasattr(binarizer, "close"):
        binarizer.close()  # a worker created here is not reused

    if sharded is not None:
        tracker = sharded.finish()

    if tracker is None:
        raise ValueError(
            f"no frames decoded from lecture <{lecture.title}> — empty or "
            f"unreadable video / image-list input")

    if save_artifacts:
        driver.store.save((frame_times, frame_indices, compressed),
                          config.get_str("BINARIZATION_OUTPUT", "tempo_binary_"),
                          lecture.id)

    # ------------------------------------------------------------ stage 03
    with span("stage03"):
        min_image_threshold = config.get_float(
            "CC_GROUPING_MIN_IMAGE_THRESHOLD", 0.5)
        min_recall = config.get("CC_GROUPING_MIN_RECALL", 0.0)
        max_gap = config.get_int("CC_STABILITY_MAX_GAP", 85)
        min_times = config.get_int("CC_STABILITY_MIN_TIMES", 3)
        t_window = config.get_int("CC_GROUPING_TEMPORAL_WINDOW", 5)

        tracker.split_stable_by_gaps(max_gap, min_times)
        stable = tracker.stable_cc_idxs(min_times)
        time_overlapping, _, all_overlapping = \
            tracker.compute_overlapping_stable(stable, t_window)
        groups, group_of = tracker.compute_groups(stable, time_overlapping,
                                                  min_recall)
        group_ages, groups_per_frame = tracker.compute_group_ages(groups)
        conflicts = tracker.compute_conflicts(stable, all_overlapping,
                                              len(groups), group_of)
        group_images, group_boundaries = tracker.compute_group_images(
            groups, group_ages, min_image_threshold)

        st3d = SpaceTimeStruct(frame_times, frame_indices, height, width,
                               group_ages, group_images, group_boundaries)

        if save_artifacts:
            # iterator: compress each clean frame as it is rendered — the
            # uncompressed cube is ~1.9 GB at 3,600x960x540 (~7.5 GB @1080p)
            clean = tracker.iter_clean_frames_from_groups(
                groups, group_boundaries, groups_per_frame, group_ages,
                group_images)
            driver.store.save(
                (frame_times, frame_indices, compress_png(clean)),
                config.get_str("CC_RECONSTRUCTED_OUTPUT",
                               "tempo_bin_reconstructed_"),
                lecture.id)
            driver.store.save((group_ages, conflicts),
                              config.get_str("CC_CONFLICTS_OUTPUT",
                                             "tempo_cc_conflicts_"),
                              lecture.id)
            driver.store.save(st3d,
                              config.get_str("CC_ST3D_OUTPUT",
                                             "tempo_cc_ST3D_"),
                              lecture.id)

    # ------------------------------------------------------------ stage 04
    with span("stage04"):
        method = config.get_int("VIDEO_SEGMENTATION_METHOD", 3)
        n_frames = len(frame_indices)
        if method == 3:
            intervals = seg.segments_from_deletion_events(
                group_ages, group_boundaries, n_frames, float(width * height),
                config.get_float("VIDEO_SEGMENTATION_DEL_EVENT_ADD_THRESHOLD",
                                 10),
                config.get_int("VIDEO_SEGMENTATION_DEL_EVENT_MIN_LENGTH", 15),
                config.get_float("VIDEO_SEGMENTATION_DEL_EVENT_THRESHOLD",
                                 0.25))
        elif method == 2:
            def override(key, param):
                if param in driver.params:
                    return int(driver.params[param])
                return config.get_int(key, 0)

            weight_area = override("VIDEO_SEGMENTATION_CONFLICTS_WEIGHTS",
                                   "conf_w")
            weight_pixels = override(
                "VIDEO_SEGMENTATION_CONFLICTS_WEIGHTS_PIXELS", "conf_p")
            weight_time = override("VIDEO_SEGMENTATION_CONFLICTS_WEIGHTS_TIME",
                                   "conf_t")

            # the union/intersection weightings expect FRACTIONAL areas —
            # the staged CLI (stages.py stage04) and the reference
            # (pre_ST3D_v3.0_04:139-147) normalize by the frame pixel count
            # after loading the conflicts artifact. Normalizing here (after
            # the artifact save above) keeps the saved artifact raw, exactly
            # like the staged flow.
            if weight_area in (seg.AREA_WEIGHT_UNION,
                               seg.AREA_WEIGHT_INTERSECTION):
                img_size = height * width
                for gidx in conflicts:
                    for other in conflicts[gidx]:
                        conflicts[gidx][other]["area_intersection"] /= img_size
                        conflicts[gidx][other]["area_union"] /= img_size

            intervals = seg.segments_from_conflicts(
                n_frames, group_ages, conflicts,
                config.get("VIDEO_SEGMENTATION_CONFLICTS_MIN_CONFLICTS", 3.0),
                config.get_int("VIDEO_SEGMENTATION_CONFLICTS_MIN_SPLIT", 50),
                config.get_int("VIDEO_SEGMENTATION_CONFLICTS_MIN_LENGTH", 25),
                weight_area, weight_pixels, weight_time)
        else:
            clean = tracker.iter_clean_frames_from_groups(
                groups, group_boundaries, groups_per_frame, group_ages,
                group_images)
            intervals = seg.segments_from_sums(
                seg.binary_sums(clean),
                seg.leaf_min_from_config(
                    config.get_int("VIDEO_SEGMENTATION_SUM_MIN_SEGMENT", 10),
                    config.get_float("SAMPLING_FPS", 1.0)),
                config.get_float("VIDEO_SEGMENTATION_SUM_MIN_ERASE_RATIO",
                                 0.05))

        if save_artifacts:
            driver.store.save(intervals,
                              config.get_str("VIDEO_SEGMENTATION_OUTPUT",
                                             "tempo_intervals_"), lecture.id)

    # ------------------------------------------------------------ stage 05
    with span("stage05"):
        keyframes, cc_times = extract_keyframes(st3d, intervals)
        idx_intervals, time_intervals, summary_indices, summary_times = \
            close_interval_gaps(st3d, intervals)

        if export:
            prefix = os.path.join(
                driver.summaries_dir,
                f"{driver.database.name}_{lecture.title.lower()}")
            export_summary(prefix, driver.database.name, lecture.title,
                           [v["path"] for v in lecture.main_videos],
                           idx_intervals, time_intervals, summary_indices,
                           summary_times, keyframes, cc_times)

        if save_artifacts:
            driver.store.save(((summary_indices, summary_times, keyframes),),
                              config.get_str("SUMMARY_KEYFRAMES_OUTPUT",
                                             "tempo_segments_"), lecture.id)

    return summary_indices, summary_times, keyframes
