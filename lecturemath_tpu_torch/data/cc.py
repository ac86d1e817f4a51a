"""Connected components: the universal currency of the pipeline.

A ``CC`` carries a bounding box, a foreground pixel count, and a cropped
uint8 mask (values 0/255). Semantics match the reference's
ConnectedComponent (reference: AM_CommonTools/data/connected_component.py:21-403)
so downstream matching thresholds behave identically, but extraction is
vectorized (scipy find_objects + bincount) instead of per-pixel Python loops,
and the hot pairwise-overlap path lives in ops/overlap.py as batched array ops.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

MIN_CC_PIXELS = 20  # noise floor, matches reference Labeler.MIN_CC_PIXELS (labeler.py:22)

# Frames ``extract_ccs`` labelled by runs of ink (the native call) and by
# scipy (no native library, or labels given), the runs the native call found
# (runs a frame is runs / frames_runs) and the components both found, before
# the size filter. Read it as a delta around the work of interest.
extract_stats = dict.fromkeys(("frames_runs", "frames_scipy", "runs", "ccs"),
                              0)
_extract_stats_lock = threading.Lock()


def _count_frame(route: str, runs: int, ccs: int) -> None:
    with _extract_stats_lock:
        extract_stats[route] += 1
        extract_stats["runs"] += runs
        extract_stats["ccs"] += ccs


@dataclass
class CC:
    cc_id: int
    min_x: int
    max_x: int
    min_y: int
    max_y: int
    size: int
    img: np.ndarray  # uint8 crop, 0/255, shape (height, width)
    start_time: float = 0.0
    end_time: float = 0.0

    @property
    def width(self) -> int:
        return self.max_x - self.min_x + 1

    @property
    def height(self) -> int:
        return self.max_y - self.min_y + 1

    def box_area(self) -> int:
        return self.width * self.height

    def bbox_intersects(self, other: "CC") -> bool:
        return (self.min_x <= other.max_x and other.min_x <= self.max_x and
                self.min_y <= other.max_y and other.min_y <= self.max_y)

    def overlap_area(self, other: "CC") -> float:
        if not self.bbox_intersects(other):
            return 0.0
        o_w = min(self.max_x, other.max_x) - max(self.min_x, other.min_x) + 1
        o_h = min(self.max_y, other.max_y) - max(self.min_y, other.min_y) + 1
        return o_w * o_h

    def overlap_iou(self, other: "CC") -> float:
        inter = self.overlap_area(other)
        union = self.box_area() + other.box_area() - inter
        return inter / union

    def matched_pixels(self, other: "CC") -> int:
        """Count of foreground pixels shared by both masks (bbox-cropped)."""
        if not self.bbox_intersects(other):
            return 0
        b_min_x = max(self.min_x, other.min_x)
        b_max_x = min(self.max_x, other.max_x)
        b_min_y = max(self.min_y, other.min_y)
        b_max_y = min(self.max_y, other.max_y)

        mine = self.img[b_min_y - self.min_y:b_max_y - self.min_y + 1,
                        b_min_x - self.min_x:b_max_x - self.min_x + 1]
        theirs = other.img[b_min_y - other.min_y:b_max_y - other.min_y + 1,
                           b_min_x - other.min_x:b_max_x - other.min_x + 1]
        return int(np.count_nonzero(mine & theirs))

    def overlap_recall_precision(self, other: "CC") -> Tuple[float, float]:
        """Pixel recall (vs self.size) and precision (vs other.size).

        Mirrors reference getOverlapFMeasure(single_score=False)
        (connected_component.py:202-250).
        """
        match = self.matched_pixels(other)
        if match == 0:
            return 0.0, 0.0
        return match / float(self.size), match / float(other.size)

    def overlap_fmeasure(self, other: "CC") -> float:
        match = self.matched_pixels(other)
        return (2.0 * match) / float(self.size + other.size)

    # ----------------------------------------------------------- geometry

    def center(self) -> Tuple[float, float]:
        return ((self.min_x + self.max_x) / 2.0,
                (self.min_y + self.max_y) / 2.0)

    def center_of_mass(self) -> Tuple[int, int]:
        """Rounded foreground centroid in frame coordinates
        (reference: getCenterOfMass, connected_component.py:155-161)."""
        ys, xs = np.nonzero(self.img)
        return (self.min_x + int(round(xs.mean())),
                self.min_y + int(round(ys.mean())))

    def center_distance(self, other: "CC") -> float:
        (cx1, cy1), (cx2, cy2) = self.center(), other.center()
        return float(np.hypot(cx1 - cx2, cy1 - cy2))

    def box_distance(self, other: "CC",
                     self_offset: Tuple[int, int] = (0, 0),
                     other_offset: Tuple[int, int] = (0, 0)) -> float:
        """Distance between bounding boxes: 0 when overlapping, axis gap
        when overlapping on one axis, corner distance otherwise
        (reference: getBoxDistance(WithOffset), connected_component.py:289-366).
        """
        s_min_x = self.min_x + self_offset[0]
        s_max_x = self.max_x + self_offset[0]
        s_min_y = self.min_y + self_offset[1]
        s_max_y = self.max_y + self_offset[1]
        o_min_x = other.min_x + other_offset[0]
        o_max_x = other.max_x + other_offset[0]
        o_min_y = other.min_y + other_offset[1]
        o_max_y = other.max_y + other_offset[1]

        x_overlap = s_min_x <= o_max_x and o_min_x <= s_max_x
        y_overlap = s_min_y <= o_max_y and o_min_y <= s_max_y
        gap_x = (s_min_x - o_max_x) if s_max_x > o_max_x else (o_min_x - s_max_x)
        gap_y = (s_min_y - o_max_y) if s_max_y > o_max_y else (o_min_y - s_max_y)

        if x_overlap and y_overlap:
            return 0.0
        if x_overlap:
            return float(gap_y)
        if y_overlap:
            return float(gap_x)
        return float(np.hypot(gap_x, gap_y))

    def normalized_image(self, new_size: int = 128,
                         min_scaling_size: int = 10) -> np.ndarray:
        """Square, aspect-preserving, resized binary mask for shape features
        (reference: normalizeImage, connected_component.py:371-403)."""
        import cv2

        longest = max(self.img.shape)
        pad = 0
        if longest < min_scaling_size:
            pad = int(np.ceil((min_scaling_size - longest) / 2.0))
        side = longest + pad * 2
        square = np.zeros((side, side), dtype=np.float64)
        off_y = (longest - self.img.shape[0]) // 2 + pad
        off_x = (longest - self.img.shape[1]) // 2 + pad
        square[off_y:off_y + self.img.shape[0],
               off_x:off_x + self.img.shape[1]] = self.img
        scaled = cv2.resize(square, (new_size, new_size))
        return (scaled > 128).astype(np.uint8) * 255

    def contours(self):
        """Outer+inner contours in frame coordinates
        (reference: getContours, connected_component.py:69-88)."""
        import cv2

        padded = cv2.copyMakeBorder(self.img, 2, 2, 2, 2,
                                    cv2.BORDER_CONSTANT, value=0)
        raw, _ = cv2.findContours(padded, cv2.RETR_TREE,
                                  cv2.CHAIN_APPROX_NONE)
        out = []
        for contour in raw:
            contour = contour.reshape(-1, 2)
            contour[:, 0] += self.min_x - 2
            contour[:, 1] += self.min_y - 2
            out.append(contour)
        return out


def extract_ccs(binary: np.ndarray, ages: Optional[np.ndarray] = None,
                filter_small: bool = True,
                min_pixels: int = MIN_CC_PIXELS,
                labels: Optional[np.ndarray] = None,
                n_labels: Optional[int] = None,
                use_native: bool = True) -> List[CC]:
    """Label a binary frame (4-connectivity) and extract per-CC features.

    Replaces the reference's scipy label + ctypes C kernel CC_AgeBoundaries
    (labeler.py:117-190, accessmath_lib.c:357-413). Fast path: one C++ call
    labels the frame by its runs of ink and writes each kept CC's crop
    (native/lecturemath_native.cpp ``cc_runs_label``); fallback:
    vectorized scipy find_objects/bincount. Optionally consumes
    pre-computed labels from the device labeling kernel (ops/cc_label.py).
    ``extract_stats`` counts the frames of each route.
    """
    if labels is None and use_native:
        from .. import native

        if native.available():
            return _extract_ccs_native(binary, ages, filter_small, min_pixels)

    if labels is None:
        labels, n_labels = ndimage.label(binary)
    _count_frame("frames_scipy", 0, n_labels)
    if n_labels == 0:
        return []

    slices = ndimage.find_objects(labels, n_labels)
    counts = np.bincount(labels.ravel(), minlength=n_labels + 1)

    if ages is not None:
        min_ages = ndimage.minimum(ages, labels, index=np.arange(1, n_labels + 1))
    else:
        min_ages = np.zeros(n_labels, dtype=np.float32)

    components = []
    for cc_id in range(n_labels):
        count = int(counts[cc_id + 1])
        if filter_small and count < min_pixels:
            continue
        sl = slices[cc_id]
        if sl is None:
            continue
        sy, sx = sl
        crop = (labels[sy, sx] == cc_id + 1).view(np.uint8) * 255
        cc = CC(cc_id, int(sx.start), int(sx.stop) - 1, int(sy.start), int(sy.stop) - 1,
                count, crop, float(min_ages[cc_id]), float(min_ages[cc_id]))
        components.append(cc)

    return components


def _extract_ccs_native(binary: np.ndarray, ages: Optional[np.ndarray],
                        filter_small: bool, min_pixels: int) -> List[CC]:
    from .. import native

    min_kept = min_pixels if filter_small else 0
    n_found, n_runs, stats, min_ages, crops = native.label_runs(
        binary, ages, min_kept)
    _count_frame("frames_runs", n_runs, n_found)
    components = []
    # tolist() converts the whole stats table to python ints in one C pass —
    # per-value int() in a genexpr showed up hot at full-lecture scale
    ages_rows = min_ages.tolist() if min_ages is not None else None
    offset = 0
    for cc_id, (min_x, max_x, min_y, max_y, size) in enumerate(stats.tolist()):
        if size < min_kept:
            continue
        height, width = max_y - min_y + 1, max_x - min_x + 1
        end = offset + height * width
        # copied out, so that no crop keeps the frame's packed crops alive
        crop = crops[offset:end].reshape(height, width).copy()
        offset = end
        age = ages_rows[cc_id] if ages_rows is not None else 0.0
        components.append(CC(cc_id, min_x, max_x, min_y, max_y, size, crop,
                             age, age))
    return components


def merge_ccs(cc_list: Sequence[CC]) -> CC:
    """Union a set of CCs into one component (reference: Merge, :90-114)."""
    min_x = min(cc.min_x for cc in cc_list)
    max_x = max(cc.max_x for cc in cc_list)
    min_y = min(cc.min_y for cc in cc_list)
    max_y = max(cc.max_y for cc in cc_list)

    combined = np.zeros((max_y - min_y + 1, max_x - min_x + 1), dtype=np.uint8)
    for cc in cc_list:
        view = combined[cc.min_y - min_y:cc.max_y - min_y + 1,
                        cc.min_x - min_x:cc.max_x - min_x + 1]
        view[cc.img > 0] = 255

    merged = CC(min(cc.cc_id for cc in cc_list), min_x, max_x, min_y, max_y,
                int(np.count_nonzero(combined)), combined)
    return merged


def bbox_array(ccs: Sequence[CC]) -> np.ndarray:
    """Pack bboxes as int32 [N, 4] = (min_x, max_x, min_y, max_y)."""
    if not ccs:
        return np.zeros((0, 4), dtype=np.int32)
    return np.array([[cc.min_x, cc.max_x, cc.min_y, cc.max_y] for cc in ccs],
                    dtype=np.int32)


def bbox_intersections(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Boolean [A, B] bbox-overlap matrix; vectorized candidate generation.

    Replaces the reference's dual IntervalIndex sweep (interval_index.py:42-99,
    cc_stability_estimator.py:73-84): a pair is a candidate iff the x-intervals
    AND y-intervals both intersect, which is exactly bbox intersection.
    """
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), dtype=bool)
    a = boxes_a[:, None, :]
    b = boxes_b[None, :, :]
    x_overlap = (a[..., 0] <= b[..., 1]) & (b[..., 0] <= a[..., 1])
    y_overlap = (a[..., 2] <= b[..., 3]) & (b[..., 2] <= a[..., 3])
    return x_overlap & y_overlap


def render_ccs(ccs: Sequence[CC], height: int, width: int) -> np.ndarray:
    """Paint CC crops back onto a full frame (uint8 additive, like the
    reference's rebuilt_binary_frame, cc_stability_estimator.py:174-179)."""
    frame = np.zeros((height, width), dtype=np.uint8)
    for cc in ccs:
        frame[cc.min_y:cc.max_y + 1, cc.min_x:cc.max_x + 1] += cc.img
    return frame
