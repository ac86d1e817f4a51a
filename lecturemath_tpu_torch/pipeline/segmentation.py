"""Temporal video segmentation: three methods matching the reference
VideoSegmenter (reference: AccessMath/preprocessing/content/video_segmenter.py)
and the stage-04 driver (pre_ST3D_v3.0_04_vid_segmentation.py:16-221).

All three operate on O(T) reduced signals, so they run host-side; the heavy
lifting (producing the signals) happened on device in earlier stages.

  1. SUMS: piecewise-constant fit of per-frame ink sums (decision-tree
     regression), then contiguous descending runs above a minimum erased-pixel
     count become erase events splitting the video.
  2. CONFLICTS: recursive split at the highest-weighted conflict peak.
  3. DELETION EVENTS: per-group add/delete area signals; cumulative delete
     resets on large adds; recursive split at cumulative-delete peaks.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

Interval = Tuple[int, int]

# conflict weighting modes (reference: video_segmenter.py:7-19)
AREA_WEIGHT_NONE = 0
AREA_WEIGHT_UNION = 3
AREA_WEIGHT_INTERSECTION = 4
AREA_WEIGHT_IOU = 5

PIXEL_WEIGHT_NONE = 0
PIXEL_WEIGHT_MATCHED = 1
PIXEL_WEIGHT_UNMATCHED = 2
PIXEL_WEIGHT_IOU = 3

TIME_WEIGHT_NONE = 0
TIME_WEIGHT_GAP = 1
TIME_WEIGHT_NORMALIZED_LENGTH = 2


# ---------------------------------------------------------------- method 1

def binary_sums(frames: Sequence[np.ndarray]) -> List[float]:
    return [float(frame.sum()) / 255.0 for frame in frames]


def piecewise_constant_boundaries(sums: Sequence[float], leaf_min: int):
    """Fit a depth-unbounded regression tree on (index -> sum) and read off
    its decision boundaries (reference: create_regresor_from_sums +
    get_tree_decision_boundaries, :31-55)."""
    from sklearn.tree import DecisionTreeRegressor

    x = np.arange(len(sums), dtype=np.int32).reshape(-1, 1)
    y = np.asarray(sums, dtype=np.float64)
    tree = DecisionTreeRegressor(max_depth=None, min_samples_leaf=leaf_min)
    tree.fit(x, y)
    fitted = tree.predict(x)

    interval_idxs = [0]
    interval_vals = [fitted[0]]
    for idx in range(1, len(fitted)):
        if fitted[idx] != interval_vals[-1]:
            interval_idxs.append(idx)
            interval_vals.append(fitted[idx])
    return interval_idxs, interval_vals


def descending_intervals(interval_vals: Sequence[float],
                         min_pixels_erased: float) -> List[Interval]:
    """Runs of strictly decreasing fitted values that erase enough pixels
    (reference: identify_descend_intervals, :58-86)."""
    descents = []
    run_start = None
    for idx in range(1, len(interval_vals)):
        if interval_vals[idx] < interval_vals[idx - 1]:
            if run_start is None:
                run_start = idx
        elif run_start is not None:
            descents.append((run_start, idx - 1))
            run_start = None
    if run_start is not None:
        descents.append((run_start, len(interval_vals) - 1))

    return [(s, e) for s, e in descents
            if interval_vals[s - 1] - interval_vals[e] >= min_pixels_erased]


def segments_from_sums(sums: Sequence[float], leaf_min: int,
                       min_erase_ratio: float) -> List[Interval]:
    """Full SUMS method (reference: video_segments_from_sums, :102-130)."""
    avg = float(np.mean(np.asarray(sums))) if len(sums) else 0.0
    min_erased = avg * min_erase_ratio

    interval_idxs, interval_vals = piecewise_constant_boundaries(sums, leaf_min)
    descents = descending_intervals(interval_vals, min_erased)

    erase_events = []
    for start_idx, end_idx in descents:
        if end_idx + 1 < len(interval_idxs):
            last_x = interval_idxs[end_idx + 1]
        else:
            last_x = len(sums) - 1
        erase_events.append((interval_idxs[start_idx], last_x))

    segments: List[Interval] = []
    cursor = 0
    for erase_start, erase_end in erase_events:
        segments.append((cursor, erase_start - 1))
        cursor = erase_end + 1
    if cursor < len(sums) - 1:
        segments.append((cursor, len(sums) - 1))
    return segments


# ---------------------------------------------------------------- peaks

def find_signal_peaks(start_frame: int, end_frame: int, signal) -> List[tuple]:
    """Scan a signal for peak regions (start, highest, end)
    (reference: find_signal_peaks, :133-183): a new peak opens whenever the
    signal rises after having fallen; plateaus extend the current state."""
    peaks = []
    peak_start = None
    peak_highest = None
    going_up = True
    for idx in range(start_frame, end_frame + 1):
        if peak_start is None:
            peak_start = idx
            peak_highest = idx
            going_up = True
            continue
        if signal[idx] > signal[idx - 1]:
            if going_up:
                peak_highest = idx
            else:
                peaks.append((peak_start, peak_highest, idx - 1))
                peak_start = idx
                peak_highest = idx
                going_up = True
        elif signal[idx] < signal[idx - 1]:
            going_up = False
    if peak_start is not None:
        peaks.append((peak_start, peak_highest, end_frame))
    return peaks


def _best_peak(signal, start: int, end: int, min_len: int, threshold: float):
    candidates = []
    for _, highest, _ in find_signal_peaks(start, end, signal):
        if (signal[highest] > threshold and
                start + min_len <= highest <= end - min_len):
            candidates.append((signal[highest], highest))
    if not candidates:
        return None
    return max(candidates)[1]


# ---------------------------------------------------------------- method 3

def segments_from_deletion_events(group_ages: Dict[int, List[int]],
                                  group_boundaries: Dict[int, tuple],
                                  n_frames: int, frame_area: float,
                                  add_threshold: float, min_length: int,
                                  threshold: float) -> List[Interval]:
    """Deletion-event method (reference: pre_ST3D_v3.0_04:44-95):
    per-group normalized bbox areas enter an add signal at the group's first
    age and a delete signal at its last; cumulative delete resets when the
    add signal spikes; recursive peak split on the cumulative delete."""
    add_values = np.zeros(n_frames)
    del_values = np.zeros(n_frames)
    for gidx, ages in group_ages.items():
        g_min_x, g_max_x, g_min_y, g_max_y = group_boundaries[gidx]
        area = (g_max_x - g_min_x + 1) * (g_max_y - g_min_y + 1) / frame_area
        add_values[ages[0]] += area
        del_values[ages[-1]] += area

    cumulative = np.zeros(n_frames)
    accumulated = 0.0
    for idx in range(n_frames):
        if add_values[idx] > add_threshold:
            accumulated = 0.0
        accumulated += del_values[idx]
        cumulative[idx] = accumulated

    return _recursive_peak_split(cumulative, 0, n_frames - 1, min_length,
                                 threshold)


def _recursive_peak_split(signal, start: int, end: int, min_length: int,
                          threshold: float) -> List[Interval]:
    """(reference: split_video_from_group_deletes, video_segmenter.py:499-519)"""
    best = _best_peak(signal, start, end, min_length, threshold)
    if best is None:
        return [(start, end)]
    return (_recursive_peak_split(signal, start, best - 1, min_length, threshold) +
            _recursive_peak_split(signal, best + 1, end, min_length, threshold))


# ---------------------------------------------------------------- method 2

def segments_from_conflicts(n_frames: int, group_ages: Dict[int, List[int]],
                            conflicts: Dict[int, Dict[int, Dict[str, float]]],
                            min_conflicts: float, min_split: int, min_len: int,
                            weight_area: int = AREA_WEIGHT_NONE,
                            weight_pixels: int = PIXEL_WEIGHT_NONE,
                            weight_time: int = TIME_WEIGHT_NONE
                            ) -> List[Interval]:
    """Conflict-minimization method (reference: from_group_conflicts +
    split_video_from_group_conflicts, video_segmenter.py:186-398,457-473)."""
    return _split_by_conflicts(0, n_frames - 1, group_ages, conflicts,
                               min_conflicts, min_split, min_len,
                               weight_area, weight_pixels, weight_time,
                               n_frames)


def _split_by_conflicts(start: int, end: int, group_ages, conflicts,
                        min_conflicts, min_split, min_len,
                        weight_area, weight_pixels, weight_time,
                        n_frames) -> List[Interval]:
    if end - start + 1 < min_split:
        return [(start, end)]

    in_range = [g for g, ages in group_ages.items()
                if start <= ages[-1] and ages[0] <= end]
    in_range_set = set(in_range)

    signal = np.zeros(end - start + 1)

    for gidx in in_range:
        g_first, g_last = group_ages[gidx][0], group_ages[gidx][-1]
        for other, stats in conflicts[gidx].items():
            if gidx >= other or other not in in_range_set:
                continue
            o_first, o_last = group_ages[other][0], group_ages[other][-1]

            if g_first < o_first:
                conflict_start, conflict_end = g_last, o_first - 1
            else:
                conflict_start, conflict_end = o_last, g_first - 1

            if weight_time == TIME_WEIGHT_GAP:
                time_w = conflict_end - conflict_start + 1
            elif weight_time == TIME_WEIGHT_NORMALIZED_LENGTH:
                time_w = ((g_last - g_first + 1) + (o_last - o_first + 1)) / n_frames
            else:
                time_w = 1

            if weight_pixels == PIXEL_WEIGHT_MATCHED:
                pixel_w = stats["matched"]
            elif weight_pixels == PIXEL_WEIGHT_UNMATCHED:
                pixel_w = stats["unmatched"]
            elif weight_pixels == PIXEL_WEIGHT_IOU:
                total = stats["matched"] + stats["unmatched"]
                pixel_w = 1 - (stats["matched"] / total) if total else 1
            else:
                pixel_w = 1

            if weight_area == AREA_WEIGHT_INTERSECTION:
                area_w = stats["area_intersection"]
            elif weight_area == AREA_WEIGHT_UNION:
                area_w = stats["area_union"]
            elif weight_area == AREA_WEIGHT_IOU:
                area_w = stats["area_intersection"] / stats["area_union"]
            else:
                area_w = 1

            weight = area_w * pixel_w * time_w
            lo = max(conflict_start, start)
            hi = min(conflict_end, end)
            if lo <= hi:
                signal[lo - start:hi - start + 1] += weight

    shifted = _Shifted(signal, start)
    best = _best_peak(shifted, start, end, min_len, min_conflicts)
    if best is None:
        return [(start, end)]

    return (_split_by_conflicts(start, best - 1, group_ages, conflicts,
                                min_conflicts, min_split, min_len,
                                weight_area, weight_pixels, weight_time,
                                n_frames) +
            _split_by_conflicts(best + 1, end, group_ages, conflicts,
                                min_conflicts, min_split, min_len,
                                weight_area, weight_pixels, weight_time,
                                n_frames))


class _Shifted:
    """Index a window-local array with absolute frame indices."""

    def __init__(self, values: np.ndarray, offset: int):
        self.values = values
        self.offset = offset

    def __getitem__(self, idx):
        return self.values[idx - self.offset]


def leaf_min_from_config(sum_min_segment: int, sampling_fps: float) -> int:
    return int(math.ceil(sum_min_segment * sampling_fps))
