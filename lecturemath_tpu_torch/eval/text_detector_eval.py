"""Text-detector pretrain evaluation: per-CC IOU matching + pixel metrics
between predicted binaries and GT text masks.

(reference: lecturenet_eval_pretrain_text_detector.py:18-339): greedy
best-IOU-first 1:1 matching of connected components at a grid of IOU
thresholds; small predicted CCs (below min_iou * smallest GT CC) are not
candidates.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy import ndimage

IOU_THRESHOLDS = (0.5, 0.6, 0.7, 0.8, 0.9)


def cc_iou_matching(pred_binary: np.ndarray, gt_binary: np.ndarray,
                    iou_thresholds: Sequence[float] = IOU_THRESHOLDS):
    """Returns ({iou_t: {matches, recall, precision, f1}}, pixel_stats)."""
    pred_labels, n_pred = ndimage.label(pred_binary)
    gt_labels, n_gt = ndimage.label(gt_binary)

    pred_sizes = np.bincount(pred_labels.ravel(), minlength=n_pred + 1)
    gt_sizes = np.bincount(gt_labels.ravel(), minlength=n_gt + 1)

    min_iou = min(iou_thresholds)
    min_gt_size = gt_sizes[1:].min() if n_gt else 0
    min_pred_size = min_iou * min_gt_size

    pred_slices = ndimage.find_objects(pred_labels, n_pred)
    gt_slices = ndimage.find_objects(gt_labels, n_gt)

    candidates = []
    for pred_idx in range(1, n_pred + 1):
        if pred_sizes[pred_idx] < min_pred_size:
            continue
        py, px = pred_slices[pred_idx - 1]
        for gt_idx in range(1, n_gt + 1):
            gy, gx = gt_slices[gt_idx - 1]
            if not (px.start < gx.stop and gx.start < px.stop and
                    py.start < gy.stop and gy.start < py.stop):
                continue
            y0, y1 = min(py.start, gy.start), max(py.stop, gy.stop)
            x0, x1 = min(px.start, gx.start), max(px.stop, gx.stop)
            pred_mask = pred_labels[y0:y1, x0:x1] == pred_idx
            gt_mask = gt_labels[y0:y1, x0:x1] == gt_idx
            intersection = np.logical_and(pred_mask, gt_mask).sum()
            union = np.logical_or(pred_mask, gt_mask).sum()
            iou = intersection / union if union else 0.0
            if iou >= min_iou:
                candidates.append((iou, gt_idx, pred_idx))

    per_threshold = {iou_t: {"matches": 0} for iou_t in iou_thresholds}
    matched_gt, matched_pred = set(), set()
    for iou, gt_idx, pred_idx in sorted(candidates, reverse=True):
        if gt_idx in matched_gt or pred_idx in matched_pred:
            continue
        matched_gt.add(gt_idx)
        matched_pred.add(pred_idx)
        for iou_t in iou_thresholds:
            if iou >= iou_t:
                per_threshold[iou_t]["matches"] += 1

    for iou_t in iou_thresholds:
        matches = per_threshold[iou_t]["matches"]
        recall = matches / n_gt if n_gt else 1.0
        precision = matches / n_pred if n_pred else (1.0 if n_gt == 0 else 0.0)
        f1 = (2 * recall * precision / (recall + precision)
              if recall + precision > 0 else 0.0)
        per_threshold[iou_t].update(recall=recall, precision=precision, f1=f1)

    # pixel-level metrics
    gt_fg = int((gt_binary > 0).sum())
    pred_fg = int((pred_binary > 0).sum())
    matches_px = int(np.logical_and(gt_binary > 0, pred_binary > 0).sum())
    pixel = {
        "recall": matches_px / gt_fg if gt_fg else 1.0,
        "precision": (matches_px / pred_fg if pred_fg
                      else (0.0 if gt_fg else 1.0)),
    }
    pixel["f1"] = (2 * pixel["recall"] * pixel["precision"] /
                   (pixel["recall"] + pixel["precision"])
                   if pixel["recall"] + pixel["precision"] > 0 else 0.0)

    return per_threshold, pixel
