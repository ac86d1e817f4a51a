"""Pairwise CC mask overlap: candidate generation + exact pixel matching.

Replaces the reference's IntervalIndex sweep + per-pair Python mask crops
(reference: interval_index.py:42-99, connected_component.py:202-250,
cc_stability_estimator.py:73-106) with:

  * bbox-intersection candidate generation as one vectorized comparison
  * exact matched-pixel counts over the candidate list (crop bitwise-AND;
    memory-local and cheap on host — the counts feed order-dependent host
    logic anyway)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..data.cc import CC, bbox_array, bbox_intersections


def candidate_pairs(ccs_a: Sequence[CC], ccs_b: Sequence[CC]) -> np.ndarray:
    """Return int32 [P, 2] index pairs whose bounding boxes intersect."""
    hits = bbox_intersections(bbox_array(ccs_a), bbox_array(ccs_b))
    ia, ib = np.nonzero(hits)
    return np.stack([ia, ib], axis=1).astype(np.int32)


def self_candidate_pairs(ccs: Sequence[CC]) -> np.ndarray:
    """Upper-triangle candidate pairs (i < j) within one CC list."""
    hits = bbox_intersections(bbox_array(ccs), bbox_array(ccs))
    hits = np.triu(hits, k=1)
    ia, ib = np.nonzero(hits)
    return np.stack([ia, ib], axis=1).astype(np.int32)


def pairwise_overlap(ccs_a: Sequence[CC], ccs_b: Sequence[CC],
                     pairs: np.ndarray, use_native: bool = True) -> np.ndarray:
    """Matched-pixel counts (int64 [P]) for each candidate pair.

    Fast path: one native C++ call over packed mask crops
    (native/lecturemath_native.cpp batch_mask_overlap)."""
    if use_native and len(pairs) > 8:
        from .. import native

        if native.available():
            return native.batch_overlap(native.PackedMasks(ccs_a),
                                        native.PackedMasks(ccs_b), pairs)

    matches = np.zeros(len(pairs), dtype=np.int64)
    for k, (ia, ib) in enumerate(pairs):
        matches[k] = ccs_a[ia].matched_pixels(ccs_b[ib])
    return matches


def pairwise_recall_precision(ccs_a: Sequence[CC], ccs_b: Sequence[CC],
                              pairs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """recall = match/size_a, precision = match/size_b per pair."""
    matches = pairwise_overlap(ccs_a, ccs_b, pairs)
    sizes_a = np.array([ccs_a[ia].size for ia, _ in pairs], dtype=np.float64)
    sizes_b = np.array([ccs_b[ib].size for _, ib in pairs], dtype=np.float64)
    if len(pairs) == 0:
        return matches.astype(np.float64), matches.astype(np.float64)
    return matches / sizes_a, matches / sizes_b
