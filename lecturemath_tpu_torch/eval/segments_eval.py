"""Temporal-segmentation evaluation metrics.

(reference: lecturenet_eval_segments.py:14-131): 1:1 segment matching at
IOU thresholds, SIoU (best IOU per GT segment), and split-point matching at
absolute / proportional max gaps, with optional edited/non-edited splits.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_LEVELS = (0.5, 0.6, 0.7, 0.8, 0.9)
MAX_GAPS = (90, 150, 210, 300)
PROP_GAPS = (0.025, 0.05, 0.075, 0.100)


def segment_overlaps(gt_bounds: Sequence[int],
                     pred_segments: Sequence[Tuple[int, int]]):
    """Sweep temporally-overlapping (gt, pred) pairs with their IOU.
    gt_bounds is the boundary list [0, split..., total]."""
    overlaps = []
    gt_pos = pred_pos = 0
    while gt_pos < len(gt_bounds) - 1 and pred_pos < len(pred_segments):
        gt_start, gt_end = gt_bounds[gt_pos], gt_bounds[gt_pos + 1]
        pred_start, pred_end = pred_segments[pred_pos]
        if gt_start < pred_end and pred_start < gt_end:
            intersection = min(gt_end, pred_end) - max(gt_start, pred_start)
            union = max(gt_end, pred_end) - min(gt_start, pred_start)
            overlaps.append((intersection / union, gt_pos, pred_pos))
        if gt_end < pred_end:
            gt_pos += 1
        else:
            pred_pos += 1
    return overlaps


def one_to_one_matches(overlaps, iou_threshold: float) -> int:
    """Greedy best-first 1:1 matching above an IOU threshold."""
    matched_gt, matched_pred = set(), set()
    count = 0
    for iou, gt_pos, pred_pos in sorted(overlaps, reverse=True):
        if (iou >= iou_threshold and gt_pos not in matched_gt and
                pred_pos not in matched_pred):
            matched_gt.add(gt_pos)
            matched_pred.add(pred_pos)
            count += 1
    return count


def average_best_iou(overlaps) -> float:
    """SIoU: mean of each GT segment's best IOU (over GT segments that
    overlap anything)."""
    ordered = sorted(((gt, iou) for iou, gt, _ in overlaps), reverse=True)
    best: Dict[int, float] = {}
    for gt_pos, iou in ordered:
        best.setdefault(gt_pos, iou)
    if not best:
        return 0.0
    return sum(best.values()) / len(best)


def split_points_from_segments(segments: Sequence[Tuple[int, int]]) -> List[int]:
    """Midpoints between consecutive predicted segments."""
    return [int((end + next_start) / 2)
            for (_, end), (next_start, _) in zip(segments, segments[1:])]


def match_split_points(gt_splits: Sequence[int], pred_splits: Sequence[int],
                       max_gap: float) -> List[Tuple[int, int]]:
    """Greedy closest-first 1:1 split-point matching within max_gap."""
    pairs = sorted((abs(g - p), g, p) for g in gt_splits for p in pred_splits)
    matched_gt, matched_pred = set(), set()
    matches = []
    for dist, g, p in pairs:
        if dist >= max_gap:
            break
        if g not in matched_gt and p not in matched_pred:
            matched_gt.add(g)
            matched_pred.add(p)
            matches.append((g, p))
    return matches


def split_match_metrics(gt_splits, pred_splits, max_gap: float):
    matches = match_split_points(gt_splits, pred_splits, max_gap)
    recall = len(matches) / len(gt_splits) if gt_splits else 1.0
    precision = len(matches) / len(pred_splits) if pred_splits else 1.0
    f1 = (2 * recall * precision / (recall + precision)
          if recall + precision > 0 else 0.0)
    return {"matches": len(matches), "recall": recall,
            "precision": precision, "f1": f1}


def evaluate_lecture_segments(gt_bounds: Sequence[int],
                              gt_splits: Sequence[int],
                              pred_segments: Sequence[Tuple[int, int]],
                              total_frames: int,
                              iou_levels=IOU_LEVELS, max_gaps=MAX_GAPS,
                              prop_gaps=PROP_GAPS) -> Dict:
    """All segmentation metrics for one lecture."""
    overlaps = segment_overlaps(gt_bounds, pred_segments)
    n_gt = len(gt_bounds) - 1
    n_pred = len(pred_segments)

    per_iou = {}
    for iou in iou_levels:
        count = one_to_one_matches(overlaps, iou)
        recall = count / n_gt if n_gt else 0.0
        precision = count / n_pred if n_pred else 0.0
        f1 = (2 * recall * precision / (recall + precision)
              if recall + precision > 0 else 0.0)
        per_iou[iou] = {"matches": count, "recall": recall,
                        "precision": precision, "f1": f1}

    pred_splits = split_points_from_segments(pred_segments)
    per_gap = {gap: split_match_metrics(gt_splits, pred_splits, gap)
               for gap in max_gaps}
    avg_len = total_frames / n_gt if n_gt else 0.0
    per_prop = {prop: split_match_metrics(gt_splits, pred_splits,
                                          avg_len * prop)
                for prop in prop_gaps}

    return {
        "n_gt": n_gt,
        "n_pred": n_pred,
        "siou": average_best_iou(overlaps),
        "per_iou": per_iou,
        "per_gap": per_gap,
        "per_prop": per_prop,
        "pred_splits": pred_splits,
    }


def print_rollup(title: str, keys_name: str, keys, per_lecture: List[Dict],
                 table_key: str) -> None:
    print(f"\n{title}")
    print(f"{keys_name}\tRec.\tPrec.\tF-1")
    for key in keys:
        recalls = [lec[table_key][key]["recall"] for lec in per_lecture]
        precisions = [lec[table_key][key]["precision"] for lec in per_lecture]
        mean_r = float(np.mean(recalls)) if recalls else 0.0
        mean_p = float(np.mean(precisions)) if precisions else 0.0
        f1 = 2 * mean_r * mean_p / (mean_r + mean_p) if mean_r + mean_p else 0.0
        print(f"{key}\t{mean_r * 100:.2f}\t{mean_p * 100:.2f}\t{f1 * 100:.2f}")
