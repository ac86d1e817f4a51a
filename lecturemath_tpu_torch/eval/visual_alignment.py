"""Cross-camera visual alignment: feature matching + homography between the
main and auxiliary camera views.

Role-equivalent of the reference's SURF-based path (reference:
AccessMath/preprocessing/content/aligner.py:91-253 computeVisualAlignment +
VisualAlignment helpers). SURF is patented/non-free and absent from modern
OpenCV builds; matching uses SIFT (the same scale/rotation-invariant
float-descriptor family — SURF is a fast SIFT approximation) with Lowe's
ratio test, falling back to ORB where SIFT is unavailable. The projection
is a RANSAC homography scored by projected-content overlap across all
sampled frame pairs, like the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def matching_points(image_a: np.ndarray, image_b: np.ndarray,
                    ratio_threshold: float = 0.75,
                    n_features: int = 2000):
    """SIFT (or ORB-fallback) keypoint matches (a_points, b_points) as
    float32 [N, 2] arrays."""
    import cv2

    if hasattr(cv2, "SIFT_create"):
        detector = cv2.SIFT_create(nfeatures=n_features)
        norm = cv2.NORM_L2
    else:  # pragma: no cover - depends on OpenCV build
        detector = cv2.ORB_create(nfeatures=n_features)
        norm = cv2.NORM_HAMMING
    kp_a, desc_a = detector.detectAndCompute(image_a, None)
    kp_b, desc_b = detector.detectAndCompute(image_b, None)
    if desc_a is None or desc_b is None or len(kp_a) < 4 or len(kp_b) < 4:
        return np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32)

    matcher = cv2.BFMatcher(norm)
    raw = matcher.knnMatch(desc_a, desc_b, k=2)
    points_a, points_b = [], []
    for pair in raw:
        if len(pair) == 2 and pair[0].distance < ratio_threshold * pair[1].distance:
            points_a.append(kp_a[pair[0].queryIdx].pt)
            points_b.append(kp_b[pair[0].trainIdx].pt)
    return (np.asarray(points_a, np.float32).reshape(-1, 2),
            np.asarray(points_b, np.float32).reshape(-1, 2))


def estimate_homography(points_a: np.ndarray, points_b: np.ndarray,
                        ransac_threshold: float = 5.0):
    """RANSAC homography mapping a -> b; (H, inlier_mask) or (None, None)."""
    import cv2

    if len(points_a) < 4:
        return None, None
    H, mask = cv2.findHomography(points_a, points_b, cv2.RANSAC,
                                 ransac_threshold)
    return H, (mask.ravel().astype(bool) if mask is not None else None)


def projection_score(homography: np.ndarray,
                     contents_main: Sequence[np.ndarray],
                     contents_aux: Sequence[np.ndarray]) -> float:
    """Mean pixel f-score of aux content warped into the main view across
    all sampled frame pairs (the reference's projection scoring role)."""
    import cv2

    scores = []
    for main, aux in zip(contents_main, contents_aux):
        h, w = main.shape[:2]
        warped = cv2.warpPerspective(aux, homography, (w, h))
        ink_main = main > 0
        ink_warped = warped > 0
        matches = np.logical_and(ink_main, ink_warped).sum()
        total_main = ink_main.sum()
        total_warped = ink_warped.sum()
        if total_main == 0 or total_warped == 0:
            scores.append(0.0)
            continue
        recall = matches / total_main
        precision = matches / total_warped
        scores.append(2 * recall * precision / (recall + precision)
                      if recall + precision > 0 else 0.0)
    return float(np.mean(scores)) if scores else 0.0


def compute_visual_alignment(contents_main: Sequence[np.ndarray],
                             contents_aux: Sequence[np.ndarray]
                             ) -> Tuple[Optional[np.ndarray], float]:
    """Best aux->main homography over sampled frame pairs: estimate one per
    pair, keep the highest projection score (reference flow,
    aligner.py:148-196). Returns (homography, score)."""
    best: Tuple[Optional[np.ndarray], float] = (None, 0.0)
    for main, aux in zip(contents_main, contents_aux):
        points_aux, points_main = matching_points(aux, main)
        H, _ = estimate_homography(points_aux, points_main)
        if H is None:
            continue
        score = projection_score(H, contents_main, contents_aux)
        if score > best[1]:
            best = (H, score)
    return best
