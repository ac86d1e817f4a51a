"""Translation alignment of binary keyframes.

The reference scans all (2w+1)^2 integer displacements, counting matching
ink pixels in the overlap region per displacement, and picks the best
f-score/recall (reference: aligner.py:28-83 — the evaluation hot loop, run
on 6 worker processes). Here the scan is one FFT cross-correlation: the
per-displacement match count of ink masks IS the cross-correlation of the
two indicator images, so all displacements come out of a single O(HW log HW)
transform instead of 441 full-image passes. Tie-breaking reproduces the
reference's stable sort (first maximum in dy-major, dx-minor scan order).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..data.cc import CC

AlignInfo = Tuple[float, float, float, int, int]  # fscore, recall, precision, dy, dx


def translation_alignment(first: np.ndarray, second: np.ndarray,
                          max_window: int, content_lum: int = 255,
                          sort_by: int = 0) -> AlignInfo:
    """Best integer-translation alignment of two equal-size binary images.

    Args:
      first, second: [H, W] uint8 binary frames.
      content_lum: gray level counted as ink (0 for GT keyframes).
      sort_by: 0 -> maximize f-score, 1 -> maximize recall.

    Returns (f_score, recall, precision, disp_y, disp_x); zeros when either
    image has no ink.
    """
    assert first.shape == second.shape and first.ndim == 2
    ink1 = (first == content_lum)
    ink2 = (second == content_lum)
    total_first = int(ink1.sum())
    total_second = int(ink2.sum())
    if total_first == 0 or total_second == 0:
        return 0.0, 0.0, 0.0, 0, 0

    matches = _window_cross_correlation(ink1, ink2, max_window)

    recall = matches / total_first
    precision = matches / total_second
    denom = recall + precision
    with np.errstate(divide="ignore", invalid="ignore"):
        fscore = np.where(denom > 0, 2.0 * recall * precision / denom, 0.0)

    score = fscore if sort_by == 0 else recall
    # first maximum in row-major (dy from -w, dx from -w) == the reference's
    # stable descending sort over its scan order
    flat_best = int(np.argmax(score))
    by, bx = np.unravel_index(flat_best, score.shape)
    return (float(fscore[by, bx]), float(recall[by, bx]),
            float(precision[by, bx]), int(by) - max_window,
            int(bx) - max_window)


def _window_cross_correlation(ink1: np.ndarray, ink2: np.ndarray,
                              window: int) -> np.ndarray:
    """match_count[dy + w, dx + w] = #pixels where ink1 shifted by (dy, dx)
    overlaps ink2 — via FFT cross-correlation, center-cropped."""
    h, w = ink1.shape
    size = (h + 2 * window, w + 2 * window)
    f1 = np.fft.rfft2(ink1.astype(np.float64), size)
    f2 = np.fft.rfft2(ink2.astype(np.float64), size)
    corr = np.fft.irfft2(f1 * np.conj(f2), size)
    # corr[dy mod, dx mod] = sum ink1[y, x] * ink2[y - dy, x - dx]
    out = np.empty((2 * window + 1, 2 * window + 1), dtype=np.int64)
    for dy in range(-window, window + 1):
        for dx in range(-window, window + 1):
            out[dy + window, dx + window] = int(round(corr[dy % size[0],
                                                          dx % size[1]]))
    return out


def translation_alignment_scan(first: np.ndarray, second: np.ndarray,
                               max_window: int, content_lum: int = 255,
                               sort_by: int = 0) -> AlignInfo:
    """Direct per-displacement scan (reference semantics verbatim); used as
    the parity oracle for the FFT path in tests."""
    assert first.shape == second.shape and first.ndim == 2
    h, w = first.shape
    total_first = int(np.count_nonzero(first == content_lum))
    total_second = int(np.count_nonzero(second == content_lum))
    if total_first == 0 or total_second == 0:
        return 0.0, 0.0, 0.0, 0, 0

    results = []
    for dy in range(-max_window, max_window + 1):
        f_y0, f_y1 = max(0, dy), h + min(0, dy)
        s_y0, s_y1 = max(0, -dy), h + min(0, -dy)
        for dx in range(-max_window, max_window + 1):
            f_x0, f_x1 = max(0, dx), w + min(0, dx)
            s_x0, s_x1 = max(0, -dx), w + min(0, -dx)
            cut_first = first[f_y0:f_y1, f_x0:f_x1]
            cut_second = second[s_y0:s_y1, s_x0:s_x1]
            matches = int(np.count_nonzero((cut_first == cut_second) &
                                           (cut_first == content_lum)))
            recall = matches / total_first
            precision = matches / total_second
            fscore = (2 * recall * precision / (recall + precision)
                      if recall + precision > 0 else 0.0)
            results.append((fscore, recall, precision, dy, dx))

    results.sort(key=lambda r: r[sort_by], reverse=True)
    return results[0]


def keyframe_chain_alignments(keyframes, window: int,
                              min_fscore: float) -> list:
    """Pairwise alignments of consecutive binary keyframes; rejected when the
    f-score is too low (content changed too much) (reference:
    keyframes_alignments, evaluator.py:148-165)."""
    alignments = []
    for idx in range(len(keyframes) - 1):
        curr = keyframes[idx].binary_image[:, :, 0]
        nxt = keyframes[idx + 1].binary_image[:, :, 0]
        align = translation_alignment(curr, nxt, window, 0)
        if align[0] < min_fscore:
            align = (0, 0, 0, 0, 0)
        alignments.append(align)
    return alignments


def check_equivalent_cc(cc1: CC, cc2: CC, global_align: AlignInfo,
                        window: int, min_recall: float,
                        min_precision: float) -> bool:
    """Whether two CCs match under the global alignment plus a small local
    displacement search (reference: check_equivalent_cc, evaluator.py:20-56).

    Instead of re-slicing masks per displacement ((2w+1)^2 scans), all local
    match counts come from one full cross-correlation of the two masks,
    sampled at the window offsets. Tie-break matches the reference exactly:
    it sorts candidates by f-score ONLY with a stable sort, so equal f-scores
    resolve to the first candidate in scan order (dy-major, dx-minor) —
    which is ``np.argmax``'s row-major first-maximum.
    """
    gdy, gdx = int(global_align[3]), int(global_align[4])
    loc = np.arange(-window, window + 1)

    # strict-inequality box gate per displacement (reference :31-33)
    x_ok = ((cc1.min_x + gdx + loc) < cc2.max_x) & \
           (cc2.min_x < (cc1.max_x + gdx + loc))
    y_ok = ((cc1.min_y + gdy + loc) < cc2.max_y) & \
           (cc2.min_y < (cc1.max_y + gdy + loc))
    gate = y_ok[:, None] & x_ok[None, :]
    if not gate.any():
        return False

    matched = _mask_correlation_at(
        cc1.img, cc2.img,
        base_dy=cc1.min_y + gdy - cc2.min_y,
        base_dx=cc1.min_x + gdx - cc2.min_x, window=window)

    recall = matched / float(cc1.size)
    precision = matched / float(cc2.size)
    denom = recall + precision
    with np.errstate(divide="ignore", invalid="ignore"):
        fscore = np.where(denom > 0, 2.0 * recall * precision / denom, 0.0)
    fscore = np.where(gate, fscore, -1.0)  # ungated never selected

    best = np.unravel_index(int(np.argmax(fscore)), fscore.shape)
    return bool(recall[best] >= min_recall and precision[best] >= min_precision)


def _mask_correlation_at(img1: np.ndarray, img2: np.ndarray, base_dy: int,
                         base_dx: int, window: int) -> np.ndarray:
    """matched[wy, wx] = #foreground pixels shared when img1's origin sits at
    (base_dy + wy - window, base_dx + wx - window) in img2's coordinates.

    One valid-mode correlation of img1 against a window-extended crop of
    img2 yields exactly the (2w+1)^2 grid — nothing outside the window is
    computed. Small masks (the realistic CC case) go through a single
    tensordot (one BLAS GEMV over all displacements); rare huge masks use
    raw boolean-AND popcounts per displacement."""
    m1 = img1 > 0
    h1, w1 = m1.shape
    h2, w2 = img2.shape

    # region[r, c] = img2[r + base_dy - window, c + base_dx - window] (0 OOB)
    rh, rw = h1 + 2 * window, w1 + 2 * window
    y0 = base_dy - window
    x0 = base_dx - window
    region = np.zeros((rh, rw), bool)
    sy0, sy1 = max(0, y0), min(h2, y0 + rh)
    sx0, sx1 = max(0, x0), min(w2, x0 + rw)
    if sy0 < sy1 and sx0 < sx1:
        region[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = \
            img2[sy0:sy1, sx0:sx1] > 0

    span = 2 * window + 1
    if m1.size <= 32768:
        windows = np.lib.stride_tricks.sliding_window_view(region, (h1, w1))
        corr = np.tensordot(windows.astype(np.float32),
                            m1.astype(np.float32), axes=([2, 3], [0, 1]))
        return np.rint(corr).astype(np.int64)

    out = np.empty((span, span), dtype=np.int64)
    for wy in range(span):
        for wx in range(span):
            out[wy, wx] = np.count_nonzero(region[wy:wy + h1, wx:wx + w1]
                                           & m1)
    return out


def check_equivalent_cc_scan(cc1: CC, cc2: CC, global_align: AlignInfo,
                             window: int, min_recall: float,
                             min_precision: float) -> bool:
    """Direct (2w+1)^2 displacement scan — reference semantics verbatim
    (evaluator.py:20-56); kept as the parity/timing oracle for the
    correlation path."""
    best_fscore = None
    best_rp = (0.0, 0.0)
    for loc_dy in range(-window, window + 1):
        for loc_dx in range(-window, window + 1):
            dy = global_align[3] + loc_dy
            dx = global_align[4] + loc_dx
            shifted = CC(cc1.cc_id, cc1.min_x + dx, cc1.max_x + dx,
                         cc1.min_y + dy, cc1.max_y + dy, cc1.size, cc1.img)
            if (shifted.min_x < cc2.max_x and cc2.min_x < shifted.max_x and
                    shifted.min_y < cc2.max_y and cc2.min_y < shifted.max_y):
                recall, precision = shifted.overlap_recall_precision(cc2)
                fscore = (2.0 * recall * precision / (recall + precision)
                          if recall + precision > 0 else 0.0)
                # stable sort by fscore only: first-in-scan-order wins ties
                if best_fscore is None or fscore > best_fscore:
                    best_fscore = fscore
                    best_rp = (recall, precision)
    if best_fscore is None:
        return False
    return best_rp[0] >= min_recall and best_rp[1] >= min_precision


def build_unique_cc_groups(keyframes, local_window: int, min_recall: float,
                           min_precision: float,
                           chain_window: int = 10,
                           min_chain_fscore: float = 0.3):
    """Construct GT unique-CC groups from a keyframe chain (reference:
    keyframes_unique_cc, evaluator.py:58-146): CCs of consecutive keyframes
    chain into a group when equivalent under the pairwise alignment; a group
    retires as soon as one keyframe has no match for it.

    Returns (unique_groups, cc_groups) where cc_groups[kf_idx][cc_str_id]
    maps each keyframe CC to its group. Together with
    eval.annotation.UniqueCCGroup.groups_to_xml this produces a fresh
    unique_ccs.xml tree from scratch (GT-producing tooling).
    """
    from .annotation import UniqueCCGroup, cc_str_id

    for keyframe in keyframes:
        if keyframe.binary_cc is None:
            keyframe.update_binary_cc()

    alignments = keyframe_chain_alignments(keyframes, chain_window,
                                           min_chain_fscore)

    unique_groups = []
    cc_groups = [{cc_str_id(cc): None for cc in kf.binary_cc}
                 for kf in keyframes]

    active = []
    for cc in keyframes[0].binary_cc:
        group = UniqueCCGroup(cc, 0)
        unique_groups.append(group)
        cc_groups[0][cc_str_id(cc)] = group
        active.append(group)

    for kf_idx in range(1, len(keyframes)):
        align = alignments[kf_idx - 1]
        not_yet_found = list(active)
        active = []
        for kf_cc in keyframes[kf_idx].binary_cc:
            found = False
            for nyf_idx, group in enumerate(not_yet_found):
                if check_equivalent_cc(kf_cc, group.cc_refs[-1], align,
                                       local_window, min_recall,
                                       min_precision):
                    active.append(group)
                    group.cc_refs.append(kf_cc)
                    cc_groups[kf_idx][cc_str_id(kf_cc)] = group
                    del not_yet_found[nyf_idx]
                    found = True
                    break
            if not found:
                group = UniqueCCGroup(kf_cc, kf_idx)
                unique_groups.append(group)
                cc_groups[kf_idx][cc_str_id(kf_cc)] = group
                active.append(group)

    return unique_groups, cc_groups
