"""Classical (non-learned) binarization methods, on the host.

These are the reference's four legacy methods (reference:
AccessMath/preprocessing/content/binarizer.py:20-403), used by stage 02 when
the input isn't pre-binarized (``CCTracker.add_frame(input_binary=False)``)
and by the annotation tooling.

The background-subtraction and chalkboard methods run without OpenCV:
gray, the median blur, the ellipse and the morphological close and open are
``utils/image.py``'s, equal to OpenCV's calls. The edge-based and
subtraction-K methods need OpenCV's Canny and bilateral filter and import
cv2 when called; their CLAHE step is ``ops/clahe.py clahe_host`` and the
mask fusion ``combine_board_content`` on the CPU. Small CCs are filtered
with ``scipy.ndimage.label`` (4-connected), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from ..utils.image import (ellipse_kernel, median_blur, morph_close,
                           morph_open, rgb_to_gray)

METHOD_EDGE_BASED = 1
METHOD_BACKGROUND_SUBTRACTION = 2
METHOD_CHALKBOARD = 3
METHOD_SUBTRACTION_K = 4


def _to_gray(image: np.ndarray) -> np.ndarray:
    if image.ndim == 3:
        return rgb_to_gray(image)
    return image


def filter_small_ccs(binary: np.ndarray, min_pixels: int) -> np.ndarray:
    """Zero out connected components smaller than min_pixels
    (reference: filter_small_CC, binarizer.py:327-342)."""
    if min_pixels <= 0:
        return binary
    labels, n_labels = ndimage.label(binary)
    if n_labels == 0:
        return np.zeros_like(binary)
    sizes = ndimage.sum(binary, labels, range(n_labels + 1)) / 255.0
    remove = sizes < min_pixels
    labels[remove[labels]] = 0
    return (labels > 0).astype(np.uint8) * 255


def background_subtraction_binarize(image: np.ndarray, blur_ksize: int = 3,
                                    disk_size: int = 14,
                                    threshold: float = 0.89,
                                    min_pixels: int = 6) -> np.ndarray:
    """Median blur -> morphological-close background estimate -> ratio
    threshold -> small-CC filter (reference: :201-246). The stage-02 default
    when input frames are not pre-binarized. Returns ink=255 binary."""
    gray = _to_gray(image)
    blurred = median_blur(gray, blur_ksize)
    kernel = ellipse_kernel(disk_size)
    background = morph_close(blurred, kernel).astype("float32")
    ratio = blurred / background
    inverted = 255 - ((ratio > threshold).astype(np.uint8) * 255)
    return filter_small_ccs(inverted, min_pixels)


def chalkboard_binarize(image: np.ndarray, blur_ksize: int = 5,
                        disk_size: int = 14, threshold: float = 25,
                        min_pixels: int = 8) -> np.ndarray:
    """Chalkboard variant: morphological-open background, light-on-dark
    difference (reference: :252-287 — which, like the reference, returns the
    subtracted image; the thresholded/filtered mask is available via
    ``chalkboard_binarize_mask``)."""
    gray = _to_gray(image)
    blurred = median_blur(gray, blur_ksize)
    kernel = ellipse_kernel(disk_size)
    background = morph_open(blurred, kernel).astype("float32")
    return gray.astype("float32") - background


def chalkboard_binarize_mask(image: np.ndarray, blur_ksize: int = 5,
                             disk_size: int = 14, threshold: float = 25,
                             min_pixels: int = 8) -> np.ndarray:
    subtracted = chalkboard_binarize(image, blur_ksize, disk_size)
    thresholded = (subtracted > threshold).astype(np.uint8) * 255
    return filter_small_ccs(thresholded, min_pixels)


def subtraction_k_binarize(image: np.ndarray, dark_background: bool = False,
                           sigma_color: float = 4.0, sigma_space: float = 4.0,
                           blur_ksize: int = 51, threshold: int = 7,
                           min_pixels: int = 5) -> np.ndarray:
    """Bilateral smoothing + large median background + signed difference
    (reference: bgSubtractionKBinarization, :294-324)."""
    import cv2

    gray = _to_gray(image)
    gray = cv2.bilateralFilter(gray, -1, sigma_color, sigma_space)
    background = cv2.medianBlur(gray, blur_ksize)
    diff = gray.astype(np.int32) - background.astype(np.int32)
    if dark_background:
        diff[diff < 0] = 0
    else:
        diff[diff > 0] = 0
        diff = np.abs(diff)
    thresholded = (diff >= threshold).astype(np.uint8) * 255
    return filter_small_ccs(thresholded, min_pixels)


def edge_based_region_binarize(image: np.ndarray) -> np.ndarray:
    """CLAHE + Canny-derived board mask + dark-content threshold
    (reference: edgeBasedRegionBinarization, :139-193)."""
    import cv2

    from .clahe import clahe_host, combine_board_content

    gray = _to_gray(image)
    rows, cols = gray.shape
    tiles_y = max(1, rows // 20)
    tiles_x = max(1, cols // 20)
    equalized = clahe_host(gray, 0.04, tiles_x, tiles_y)

    edges = cv2.Canny(gray, 10, 50, apertureSize=3)
    kernel = cv2.getStructuringElement(cv2.MORPH_RECT, (5, 5))
    dilated = cv2.dilate(edges, kernel)
    board = cv2.bitwise_not(dilated)

    labels, n_labels = ndimage.label(board)
    sizes = ndimage.sum(board, labels, range(n_labels + 1)) / 255.0
    remove = sizes < (rows * cols * 0.05)
    labels[remove[labels]] = 0
    only_board = (labels > 0).astype(np.uint8) * 255
    only_board = cv2.dilate(only_board, kernel)

    return combine_board_content(torch.from_numpy(only_board),
                                 torch.from_numpy(equalized), 128).numpy()


def edge_based_frame_binarize(frame: np.ndarray):
    """Original 2013 edge-based whole-frame method: find the board region
    via Canny + large-CC analysis, then classify content
    (reference: edgeBasedFrameBinarization, :34-131). Returns
    (board_box, only_content)."""
    import cv2

    gray = _to_gray(frame)
    edges = cv2.Canny(gray, 20, 60, apertureSize=3)
    kernel = cv2.getStructuringElement(cv2.MORPH_RECT, (5, 5))
    edges = cv2.dilate(edges, kernel)
    board = cv2.bitwise_not(edges)

    labels, n_labels = ndimage.label(board)
    other_labels = labels.copy()

    dim = float(frame.shape[0] * frame.shape[1])
    sizes = ndimage.sum(board, labels, range(n_labels + 1))
    remove = (sizes / 255.0) < (dim * 0.25)
    labels[remove[labels]] = 0
    only_board = (labels > 0).astype(np.uint8) * 255

    board_y, board_x = np.nonzero(only_board)
    board_box = (board_x.min(), board_x.max(), board_y.min(), board_y.max())

    # re-attach large closed regions fully inside the board bbox
    for cc_id in range(1, n_labels):
        size = sizes[cc_id] / 255.0
        if dim * 0.005 <= size < dim * 0.25:
            component = (other_labels == cc_id).astype(np.uint8) * 255
            cc_y, cc_x = np.nonzero(component)
            if (cc_x.min() > board_box[0] and cc_y.min() > board_box[2] and
                    cc_x.max() < board_box[1] and cc_y.max() < board_box[3]):
                only_board = cv2.bitwise_or(only_board, component)

    not_board = cv2.bitwise_not(only_board)
    labels, n_labels = ndimage.label(not_board)
    sizes = ndimage.sum(not_board, labels, range(n_labels + 1))
    remove = (sizes / 255.0) > (dim * 0.05)
    labels[remove[labels]] = 0
    only_background = (labels == 0).astype(np.uint8) * 255

    only_content = cv2.bitwise_or(only_board, only_background)
    return board_box, only_content


def binarize(image: np.ndarray, method_id: int) -> np.ndarray:
    """Dispatch by method id (reference: frameContentBinarization /
    regionBinarization, :349-379)."""
    if method_id == METHOD_EDGE_BASED:
        return edge_based_region_binarize(image)
    if method_id == METHOD_BACKGROUND_SUBTRACTION:
        return background_subtraction_binarize(image)
    if method_id == METHOD_CHALKBOARD:
        return chalkboard_binarize(image)
    if method_id == METHOD_SUBTRACTION_K:
        return subtraction_k_binarize(image)
    raise ValueError(f"invalid binarization method: {method_id}")
