"""Minimal interactive ground-truth editor: pixel paint/erase, portion
accept/reject, and threshold-surface binarization over a GT annotation
tree, with a local-browser canvas UI.

This is the launchable equivalent of the reference's interactive pixel
annotators (reference: AccessMath/annotation/gt_pixel_binary_annotator.py:1
— 1,569 LoC pygame paint loop — and gt_binary_annotator.py:1, 1,778 LoC):
view a keyframe, paint/erase binary pixels, reject content portions, tune
a spatially-varying binarization threshold (ThresholdTool — the
GTBinaryAnnotator workflow: placed (x, y, threshold) points, KNN
inverse-distance surface, ink = preprocessed-gray <= surface), preview /
apply the classical binarization methods, and save the SAME XML/PNG tree
the reference GUIs and our eval/gt_authoring.export_gt_tree write
(segments.xml is left untouched; binary/, portions/, portions.xml, and
unique_ccs.xml are rewritten).

The edit loop is a headless-testable session object (GTEditorSession); the
UI is a thin stdlib HTTP server + embedded canvas page (`serve`), launched
via ``python -m lecturemath_tpu_torch.cli.gt_editor <config> -l <lecture>``.

Portion-tier editing (reference: gt_keyframe_annotator.py:27 — the
GTKeyFrameAnnotator screen) is covered by the portion ops: add a portion
by binarizing a selected rectangle (btn_portions_add_click:647 + the
GTBinaryAnnotator hand-off), move (:1245) / invert (:687) / delete (:671)
a portion, and copy a portion to the previous/next keyframe with the
reference's MSE-gated +-10 px offset search (copy_frame_portion:1160-1208,
``best_copy_offset`` here is that scan, same order and 900.0 MSE gate).

Every file a session saves needs no OpenCV: the strokes, the Otsu
thresholds, gray and median come from ``utils/image.py`` (each equal to its
cv2 call at every pixel) and the PNGs from ``utils/png.py``. Only the
bilateral smoothing of ``ThresholdTool`` (``sigma_color > 0``) still calls
``cv2.bilateralFilter``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .image import (circle, line, median_blur, rgb_to_gray,
                    threshold_otsu)
from .png import encode_png, read_image


class ThresholdTool:
    """Spatially-varying threshold binarization of one keyframe — the
    workflow of the reference's GTBinaryAnnotator
    (gt_binary_annotator.py:32,867,985,1057-1135), re-designed as a
    headless state object:

      * preprocess: optional bilateral smoothing, optional median-blur
        background subtraction (keeping writing darker than background;
        ``is_dark`` flips the polarity for chalkboards), grayscale
        (update_base_images step -1, :1057-1095).
      * user-placed (x, y, threshold) points; the threshold SURFACE is the
        inverse-distance-weighted mean of each pixel's K nearest labeled
        points (exact at the points themselves) — the same propagation as
        the reference's KNN cache (:1146-1176), computed with one KD-tree
        query instead of its per-pixel loop.
      * binary: ink where gray <= surface (ink=0 on 255 background, the GT
        convention, :1130-1135), then small-CC noise filtering
        (:1143-1171) via ops.classical.filter_small_ccs.

    The grid initializer places (rows+1) x (cols+1) points with per-cell
    Otsu thresholds (flat cells fall back to "no ink"), standing in for
    generate_initial_gt_adaptive_otsu (:1422-1537)."""

    def __init__(self, raw_rgb: np.ndarray, is_dark: bool = False,
                 median_k: int = 1, sigma_color: float = 0.0,
                 sigma_space: float = 1.0, knn_k: int = 4,
                 noise_size: int = 0):
        self.raw = raw_rgb
        self.is_dark = bool(is_dark)
        self.median_k = int(median_k)
        self.sigma_color = float(sigma_color)
        self.sigma_space = float(sigma_space)
        self.knn_k = max(1, int(knn_k))
        self.noise_size = int(noise_size)
        self.points: List[List[float]] = []       # [x, y]
        self.thresholds: List[float] = []
        self._gray: Optional[np.ndarray] = None

    # -- preprocessing ----------------------------------------------------

    def gray(self) -> np.ndarray:
        """Preprocessed grayscale with writing darker than background."""
        if self._gray is not None:
            return self._gray
        img = self.raw
        if self.sigma_color > 0:
            import cv2

            img = cv2.bilateralFilter(img, -1, self.sigma_color,
                                      self.sigma_space)
        if self.median_k > 1:
            background = median_blur(img, self.median_k)
            diff = img.astype(np.int32) - background.astype(np.int32)
            if self.is_dark:
                diff[diff < 0] = 0
            else:
                diff[diff > 0] = 0
                diff = np.abs(diff)
            gray = (255 - diff.max(axis=2)).astype(np.uint8)
        else:
            gray = rgb_to_gray(img)
            if self.is_dark:
                gray = 255 - gray
        self._gray = gray
        return gray

    def invalidate(self) -> None:
        self._gray = None

    # -- points -----------------------------------------------------------

    def init_grid(self, rows: int = 4, cols: int = 4) -> int:
        """Reset to a (rows+1) x (cols+1) point grid with per-cell Otsu
        initial thresholds; returns the point count."""
        gray = self.gray()
        h, w = gray.shape
        self.points, self.thresholds = [], []
        for r in range(rows + 1):
            y = round(r * (h - 1) / rows)
            for c in range(cols + 1):
                x = round(c * (w - 1) / cols)
                y0, y1 = max(0, y - h // rows), min(h, y + h // rows + 1)
                x0, x1 = max(0, x - w // cols), min(w, x + w // cols + 1)
                cell = gray[y0:y1, x0:x1]
                if cell.std() < 5.0:   # flat cell: background, no ink
                    # below the darkest pixel, WITHOUT clamping at 0: a
                    # flat black cell must get a negative threshold so
                    # gray <= surface stays false (no ink), not 0.0 which
                    # would flood the whole cell with ink
                    value = float(cell.min()) - 1.0
                else:
                    value = threshold_otsu(cell)
                self.points.append([float(x), float(y)])
                self.thresholds.append(float(value))
        return len(self.points)

    def add_point(self, x: float, y: float,
                  value: Optional[float] = None) -> int:
        """Add a labeled point; default threshold = current surface value
        there (the reference's add_point behavior, :867-911). Returns the
        new point's index."""
        if value is None:
            value = (self._surface_at(float(x), float(y)) if self.points
                     else 128.0)
        self.points.append([float(x), float(y)])
        self.thresholds.append(float(value))
        return len(self.points) - 1

    def _surface_at(self, x: float, y: float) -> float:
        """Surface value at ONE pixel — a single KD-tree query, not the
        full-image surface."""
        from scipy.spatial import cKDTree

        pts = np.asarray(self.points, np.float64)
        values = np.asarray(self.thresholds, np.float64)
        k = min(self.knn_k, len(pts))
        dist, idx = cKDTree(pts).query([[x, y]], k=k)
        dist, idx = np.atleast_2d(dist), np.atleast_2d(idx)
        if (dist == 0.0).any():   # exactly on a labeled point
            return float(values[idx[dist == 0.0][0]])
        weights = 1.0 / dist
        weights /= weights.sum()
        return float(np.rint((weights * values[idx]).sum()))

    def set_point(self, index: int, value: float) -> None:
        self.thresholds[index] = float(value)

    def delete_point(self, index: int) -> None:
        del self.points[index]
        del self.thresholds[index]

    # -- surface / binary -------------------------------------------------

    def surface(self) -> np.ndarray:
        """Threshold at every pixel: inverse-distance-weighted mean of the
        K nearest labeled points (exact at labeled points)."""
        from scipy.spatial import cKDTree

        gray = self.gray()
        h, w = gray.shape
        if not self.points:
            raise ValueError("no threshold points — call init_grid or "
                             "add_point first")
        pts = np.asarray(self.points, np.float64)
        values = np.asarray(self.thresholds, np.float64)
        k = min(self.knn_k, len(pts))
        yy, xx = np.mgrid[0:h, 0:w]
        query = np.stack([xx.ravel(), yy.ravel()], axis=-1)
        dist, idx = cKDTree(pts).query(query, k=k)
        if k == 1:
            dist, idx = dist[:, None], idx[:, None]
        dist[dist == 0.0] = 1.0   # reference: labeled pixels fixed below
        weights = 1.0 / dist
        weights /= weights.sum(axis=1, keepdims=True)
        surface = (weights * values[idx]).sum(axis=1).reshape(h, w)
        # quantize like the reference's uint8 threshold image (:1173) —
        # also keeps the IDW mean of identical thresholds exact instead of
        # a hair below the common value
        surface = np.rint(surface)
        for (x, y), value in zip(pts, values):
            surface[int(y), int(x)] = value
        return surface

    def binary(self) -> np.ndarray:
        """uint8 [H, W] ink=0 on 255 background (GT convention)."""
        from ..ops.classical import filter_small_ccs

        ink = self.gray() <= self.surface()
        if self.noise_size > 0:
            kept = filter_small_ccs(ink.astype(np.uint8) * 255,
                                    self.noise_size + 1) > 0
            ink = kept
        return np.where(ink, 0, 255).astype(np.uint8)


def load_tree_keyframes(tree_prefix: str):
    """Load keyframes + binaries from an exported GT annotation tree —
    THE loader for the tree layout every editor session shares
    (segments.xml + keyframes/ + binary/<idx>.png, blank binary when the
    tree has none yet). Used by GTEditorSession and the word-tier
    sessions (utils/word_editor.py)."""
    from ..eval.annotation import KeyframeAnnotation

    xml_path = os.path.join(tree_prefix, "segments.xml")
    keyframes = KeyframeAnnotation.load_exported_keyframes(
        xml_path, os.path.join(tree_prefix, "keyframes") + "/", False)
    if not keyframes:
        raise ValueError(f"no keyframes in {xml_path}")
    for kf in keyframes:
        path = os.path.join(tree_prefix, "binary", f"{kf.idx}.png")
        mono = (read_image(path, grayscale=True) if os.path.exists(path)
                else None)
        if mono is None:   # tree without binaries yet: start blank
            mono = np.full(kf.raw_image.shape[:2], 255, np.uint8)
        kf.binary_image = np.stack([mono] * 3, axis=-1)
    return keyframes


def best_copy_offset(source_gray: np.ndarray, target_gray: np.ndarray,
                     x: int, y: int, w: int, h: int,
                     window: int = 10,
                     max_mse: float = 900.0) -> Tuple[int, int, float]:
    """Best (dx, dy) alignment of the source rect on the target frame —
    the reference's portion-copy offset search (gt_keyframe_annotator.py:
    1160-1208): scan offsets in [-window, window]^2 (x-major, same order),
    score = mean squared grayscale error over the rect, keep the first
    strict minimum; fall back to (0, 0) when even the best exceeds the
    ``PortionCopy_MaxMSE`` gate (= 900, a 30x30 mean)."""
    fh, fw = target_gray.shape[:2]
    source_cut = source_gray[y:y + h, x:x + w].astype(np.int32)
    best = None  # (score, dx, dy)
    for dx in range(-window, window + 1):
        tx0, tx1 = x + dx, x + w + dx
        if tx0 < 0 or tx1 > fw:
            continue
        for dy in range(-window, window + 1):
            ty0, ty1 = y + dy, y + h + dy
            if ty0 < 0 or ty1 > fh:
                continue
            target_cut = target_gray[ty0:ty1, tx0:tx1].astype(np.int32)
            score = float(np.power(source_cut - target_cut, 2).mean())
            if best is None or score < best[0]:
                best = (score, dx, dy)
    if best is None or best[0] > max_mse:
        return 0, 0, (best[0] if best else float("inf"))
    return best[1], best[2], best[0]


class GTEditorSession:
    """Load-edit-save loop over one lecture's GT annotation tree
    (<annotations>/<DB>_<lecture>/)."""

    def __init__(self, tree_prefix: str):
        from ..eval.annotation import KeyframeAnnotation

        self.prefix = tree_prefix
        self.keyframes = load_tree_keyframes(tree_prefix)

        self._binaries: Dict[int, np.ndarray] = {}
        self._undo: Dict[int, List[np.ndarray]] = {}
        self._thr: Dict[int, ThresholdTool] = {}
        for kf in self.keyframes:
            self._binaries[kf.idx] = kf.binary_image[:, :, 0].copy()
            self._undo[kf.idx] = []

        portions_xml = os.path.join(tree_prefix, "portions.xml")
        if os.path.exists(portions_xml):
            KeyframeAnnotation.load_portions(
                portions_xml, self.keyframes,
                os.path.join(tree_prefix, "portions"))

    # ------------------------------------------------------------ queries

    def keyframe_ids(self) -> List[int]:
        return [kf.idx for kf in self.keyframes]

    def _kf(self, kf_idx: int):
        for kf in self.keyframes:
            if kf.idx == kf_idx:
                return kf
        raise KeyError(f"unknown keyframe index {kf_idx}")

    def binary(self, kf_idx: int) -> np.ndarray:
        """uint8 [H, W] in the GT convention: ink=0 on 255 background."""
        return self._binaries[kf_idx]

    def raw(self, kf_idx: int) -> np.ndarray:
        return self._kf(kf_idx).raw_image

    def portions(self, kf_idx: int) -> List[dict]:
        return [{"index": k, "x": p.x, "y": p.y, "w": p.w, "h": p.h,
                 "dark": bool(p.dark)}
                for k, p in enumerate(self._kf(kf_idx).portions)]

    # -------------------------------------------------------------- edits

    def _push_undo(self, kf_idx: int) -> None:
        """Snapshot the keyframe's binary AND portion list (portion ops
        edit both, so undo restores both — the reference keeps portion
        snapshots on its undo stack too, gt_keyframe_annotator.py:671)."""
        import dataclasses

        kf = self._kf(kf_idx)
        stack = self._undo[kf_idx]
        stack.append((self._binaries[kf_idx].copy(),
                      [dataclasses.replace(
                          p, binary=None if p.binary is None
                          else p.binary.copy())
                       for p in kf.portions]))
        del stack[:-20]  # bound memory

    def stroke(self, kf_idx: int, points: Sequence[Tuple[int, int]],
               radius: int = 2, erase: bool = False) -> None:
        """Paint (ink, value 0) or erase (background, 255) along a
        polyline of canvas points — the pixel-paint loop of the reference
        GTPixelBinaryAnnotator."""
        self._push_undo(kf_idx)
        img = self._binaries[kf_idx]
        value = 255 if erase else 0
        pts = [(int(x), int(y)) for x, y in points]
        if len(pts) == 1:
            circle(img, pts[0], radius, value, -1)
        for a, b in zip(pts, pts[1:]):
            line(img, a, b, value, thickness=max(1, 2 * radius))

    def fill_rect(self, kf_idx: int, x: int, y: int, w: int, h: int,
                  erase: bool = True) -> None:
        self._push_undo(kf_idx)
        value = 255 if erase else 0
        self._binaries[kf_idx][y:y + h, x:x + w] = value

    def reject_portion(self, kf_idx: int, portion_index: int) -> None:
        """Reject a content portion: clear ITS ink and drop it from the
        portion list (the accept/reject loop of the reference annotators;
        accepted portions are simply kept). Only the portion's own
        unclaimed ink is erased (_erase_portion) — clearing the whole
        rectangle would destroy overlapping portions' ink and hand-
        painted strokes inside it. Portion binaries are ink=0/bg=255
        regardless of the Dark flag (Dark only records the board tone)."""
        kf = self._kf(kf_idx)
        portion = kf.portions[portion_index]
        self._push_undo(kf_idx)
        if portion.binary is not None:
            self._erase_portion(kf_idx, kf, portion_index)
        else:   # no pixel backing recorded: rectangle clear is all we have
            x, y, w, h = portion.x, portion.y, portion.w, portion.h
            self._binaries[kf_idx][y:y + h, x:x + w] = 255
        del kf.portions[portion_index]

    # ------------------------------------------------ portion-tier editing
    # (GTKeyFrameAnnotator role — reference gt_keyframe_annotator.py:27;
    # the composed binary stays the editing source of truth, so each op
    # updates both the portion record and the affected binary pixels.)

    def _gray(self, kf_idx: int) -> np.ndarray:
        """Grayscale of the raw keyframe, matching the reference's
        update_grayscale (keyframe_annotation.py:46, RGB input)."""
        return rgb_to_gray(self.raw(kf_idx))

    def _clamp_rect(self, kf_idx: int, x: int, y: int, w: int, h: int):
        fh, fw = self._binaries[kf_idx].shape
        x = max(0, min(int(x), fw - 1))
        y = max(0, min(int(y), fh - 1))
        w = max(1, min(int(w), fw - x))
        h = max(1, min(int(h), fh - y))
        return x, y, w, h

    def _other_ink(self, kf, skip_index: int,
                   x: int, y: int, w: int, h: int) -> np.ndarray:
        """Ink claimed inside [x, y, w, h] by portions OTHER than
        skip_index (so removing one portion keeps overlapping content,
        like the reference's vote-based recomposition)."""
        mask = np.zeros((h, w), dtype=bool)
        for k, p in enumerate(kf.portions):
            if k == skip_index or p.binary is None:
                continue
            ix0, iy0 = max(x, p.x), max(y, p.y)
            ix1 = min(x + w, p.x + p.w)
            iy1 = min(y + h, p.y + p.h)
            if ix0 >= ix1 or iy0 >= iy1:
                continue
            cut = p.binary[iy0 - p.y:iy1 - p.y, ix0 - p.x:ix1 - p.x]
            mask[iy0 - y:iy1 - y, ix0 - x:ix1 - x] |= cut == 0
        return mask

    def _blit_portion(self, kf_idx: int, portion) -> None:
        region = self._binaries[kf_idx][portion.y:portion.y + portion.h,
                                        portion.x:portion.x + portion.w]
        region[portion.binary == 0] = 0

    def _erase_portion(self, kf_idx: int, kf, portion_index: int) -> None:
        p = kf.portions[portion_index]
        region = self._binaries[kf_idx][p.y:p.y + p.h, p.x:p.x + p.w]
        keep = self._other_ink(kf, portion_index, p.x, p.y, p.w, p.h)
        region[(p.binary == 0) & ~keep] = 255

    def portion_cut_binary(self, kf_idx: int, x: int, y: int, w: int,
                           h: int, dark: bool = False,
                           source="threshold") -> np.ndarray:
        """Binarize a rectangle for a new portion (ink=0/bg=255).
        ``source``: 'threshold' (the keyframe's ThresholdTool surface —
        the GTBinaryAnnotator hand-off of the reference add-portion flow),
        'otsu' (local Otsu on the cut; ink = dark side, or bright side
        when ``dark``), 'current' (the keyframe's existing binary cut),
        or a classical-method id int."""
        if source == "threshold":
            return self.threshold_preview(kf_idx)[y:y + h, x:x + w].copy()
        if source == "current":
            return self._binaries[kf_idx][y:y + h, x:x + w].copy()
        if source == "otsu":
            cut = self._gray(kf_idx)[y:y + h, x:x + w]
            thr = threshold_otsu(cut)
            ink = cut > thr if dark else cut <= thr
            return np.where(ink, 0, 255).astype(np.uint8)
        return self.classical_preview(kf_idx, int(source))[y:y + h,
                                                           x:x + w].copy()

    def add_portion(self, kf_idx: int, x: int, y: int, w: int, h: int,
                    dark: bool = False, source="threshold") -> int:
        """Add a content portion: binarize the selected rectangle and
        composite its ink (reference: btn_portions_add_click:647 +
        binarization_edition_finished:1064 -> KeyFrameAnnotation
        .add_portion). Returns the new portion index."""
        from ..eval.annotation import KeyframePortion

        x, y, w, h = self._clamp_rect(kf_idx, x, y, w, h)
        cut = self.portion_cut_binary(kf_idx, x, y, w, h, dark, source)
        kf = self._kf(kf_idx)
        self._push_undo(kf_idx)
        portion = KeyframePortion(x, y, w, h, cut, bool(dark))
        kf.portions.append(portion)
        self._blit_portion(kf_idx, portion)
        return len(kf.portions) - 1

    @staticmethod
    def _require_binary(portion) -> None:
        """Portion ops need the portion's PNG; a tree with a missing
        portions/frame_<k>/<i>.png loads binary=None — surface that as a
        ValueError (JSON error through _guard), not a dead handler."""
        if portion.binary is None:
            raise ValueError("portion has no binary image on disk")

    def move_portion(self, kf_idx: int, portion_index: int,
                     dx: int, dy: int) -> None:
        """Translate a portion (reference: EditionModeMovePortion,
        gt_keyframe_annotator.py:1245,1407-1445); its ink moves with it,
        ink shared with other portions stays."""
        kf = self._kf(kf_idx)
        p = kf.portions[portion_index]
        self._require_binary(p)
        fh, fw = self._binaries[kf_idx].shape
        nx = max(0, min(p.x + int(dx), fw - p.w))
        ny = max(0, min(p.y + int(dy), fh - p.h))
        if (nx, ny) == (p.x, p.y):
            return
        self._push_undo(kf_idx)
        self._erase_portion(kf_idx, kf, portion_index)
        p.x, p.y = nx, ny
        self._blit_portion(kf_idx, p)

    def invert_portion(self, kf_idx: int, portion_index: int) -> None:
        """Invert a portion's binary in place (reference:
        btn_portions_invert_click:687 -> KeyFramePortion.invert_region)."""
        kf = self._kf(kf_idx)
        self._require_binary(kf.portions[portion_index])
        self._push_undo(kf_idx)
        self._erase_portion(kf_idx, kf, portion_index)
        kf.portions[portion_index].invert()
        self._blit_portion(kf_idx, kf.portions[portion_index])

    def copy_portion(self, kf_idx: int, portion_index: int,
                     direction: int) -> dict:
        """Copy a portion to the previous (-1) / next (+1) keyframe with
        the reference's MSE-gated offset search (copy_frame_portion:
        1160-1208): best +-10 px grayscale alignment on the target frame,
        kept only under the 900.0 MSE gate."""
        import dataclasses

        order = [kf.idx for kf in self.keyframes]
        pos = order.index(kf_idx) + int(direction)
        if not 0 <= pos < len(order):
            raise IndexError("no keyframe in that direction")
        target_idx = order[pos]
        kf = self._kf(kf_idx)
        p = kf.portions[portion_index]
        self._require_binary(p)
        dx, dy, score = best_copy_offset(
            self._gray(kf_idx), self._gray(target_idx), p.x, p.y, p.w, p.h)
        target = self._kf(target_idx)
        self._push_undo(target_idx)
        copied = dataclasses.replace(p, x=p.x + dx, y=p.y + dy,
                                     binary=p.binary.copy())
        target.portions.append(copied)
        self._blit_portion(target_idx, copied)
        return {"target": target_idx,
                "index": len(target.portions) - 1,
                "offset": [dx, dy], "mse": score}

    def undo(self, kf_idx: int) -> bool:
        stack = self._undo[kf_idx]
        if not stack:
            return False
        self._binaries[kf_idx], self._kf(kf_idx).portions = stack.pop()
        return True

    # ------------------------------------------- threshold binarization

    _THR_PARAMS = {"is_dark": bool, "median_k": int, "sigma_color": float,
                   "sigma_space": float, "knn_k": int, "noise_size": int}

    def threshold_tool(self, kf_idx: int, **params) -> ThresholdTool:
        """The keyframe's ThresholdTool (created on first use); keyword
        arguments update the preprocessing parameters (is_dark, median_k,
        sigma_color, sigma_space, knn_k, noise_size) and invalidate the
        cached gray image."""
        tool = self._thr.get(kf_idx)
        if tool is None:
            tool = self._thr[kf_idx] = ThresholdTool(self.raw(kf_idx))
        for key, value in params.items():
            kind = self._THR_PARAMS.get(key)
            if kind is None:
                raise KeyError(f"unknown threshold parameter {key!r}")
            if kind is bool:   # accept JSON bools and 0/1/"0"/"1"
                value = value in (True, 1, "1", "true", "True")
            else:
                value = kind(value)
            setattr(tool, key, value)
        if params:
            tool.invalidate()
        return tool

    def threshold_preview(self, kf_idx: int) -> np.ndarray:
        """Binary (ink=0/bg=255) from the current threshold surface,
        without touching the keyframe's binary. A tool with no points yet
        grid-initializes itself (so 'preview' works before 'init')."""
        tool = self.threshold_tool(kf_idx)
        if not tool.points:
            tool.init_grid()
        return tool.binary()

    def threshold_apply(self, kf_idx: int) -> None:
        """Commit the threshold-surface binary to the keyframe
        (undo-able)."""
        preview = self.threshold_preview(kf_idx)
        self._push_undo(kf_idx)
        self._binaries[kf_idx] = preview

    # ---------------------------------------- classical-method preview

    def classical_preview(self, kf_idx: int, method_id: int) -> np.ndarray:
        """One of the reference's four classical binarization methods
        (ops/classical.py; reference binarizer.py:349-379) applied to the
        raw keyframe, converted to the editor's ink=0/bg=255 convention."""
        from ..ops import classical

        raw = self.raw(kf_idx)
        if method_id == classical.METHOD_CHALKBOARD:
            ink255 = classical.chalkboard_binarize_mask(raw)
        else:
            ink255 = classical.binarize(raw, method_id)
        return np.where(ink255 > 0, 0, 255).astype(np.uint8)

    def classical_apply(self, kf_idx: int, method_id: int) -> None:
        preview = self.classical_preview(kf_idx, method_id)
        self._push_undo(kf_idx)
        self._binaries[kf_idx] = preview

    # --------------------------------------------------------------- save

    @staticmethod
    def _portions_consistent(kf, mono: np.ndarray) -> bool:
        """True when the keyframe's portion list composes exactly to the
        edited binary (the reference's update_binary_image vote rule)."""
        if not kf.portions or any(p.binary is None for p in kf.portions):
            return False
        votes = np.zeros(mono.shape, dtype=np.int32)
        for p in kf.portions:
            votes[p.y:p.y + p.h, p.x:p.x + p.w] += 255 - p.binary
        composed = np.where(votes > 0, 0, 255).astype(np.uint8)
        return bool((composed == mono).all())

    def save(self, rebuild_unique_ccs: bool = True) -> str:
        """Write the edited tree back: binary/<idx>.png, portions.xml +
        portions/ (rebuilt from the edited binaries), and unique_ccs.xml
        (CC identity chains recomputed) — exactly the export_gt_tree /
        reference-GUI file set, so cli.eval_summaries consumes it as-is."""
        from ..eval.aligner import build_unique_cc_groups
        from ..eval.annotation import (KeyframeAnnotation, UniqueCCGroup,
                                       portions_from_binary)

        for kf in self.keyframes:
            mono = self._binaries[kf.idx]
            kf.binary_image = np.stack([mono] * 3, axis=-1)
            kf.update_binary_cc(False)
            # keep annotator-authored portions (add/move/copy ops) when
            # they still compose to the edited binary; pixel strokes make
            # them stale, in which case the tree is rebuilt from pixels
            if not self._portions_consistent(kf, mono):
                kf.portions = portions_from_binary(mono)
        KeyframeAnnotation.save_portions(self.keyframes, self.prefix)

        if rebuild_unique_ccs:
            groups, _ = build_unique_cc_groups(self.keyframes,
                                               local_window=3,
                                               min_recall=0.8,
                                               min_precision=0.8)
            with open(os.path.join(self.prefix, "unique_ccs.xml"), "w") as f:
                f.write(UniqueCCGroup.groups_to_xml(self.keyframes, groups))
        return self.prefix


# --------------------------------------------------------------- HTTP UI

PAGE = """<!DOCTYPE html>
<html><head><title>GT editor</title><style>
body { font-family: sans-serif; margin: 12px; }
#wrap { position: relative; display: inline-block; }
#raw, #bin { position: absolute; left: 0; top: 0; image-rendering: pixelated; }
#bin { opacity: 0.6; }
button.on { background: #cde; }
</style></head><body>
<div>
  <select id="kf"></select>
  <button id="paint" class="on">paint</button>
  <button id="erase">erase</button>
  <button id="thrpt">thr point</button>
  brush <input id="radius" type="number" value="2" min="1" max="30" style="width:3em">
  <button id="undo">undo</button>
  <button id="save">save</button>
  <span id="status"></span>
</div>
<div>
  threshold: grid
  <input id="rows" type="number" value="4" min="1" style="width:3em"> x
  <input id="cols" type="number" value="4" min="1" style="width:3em">
  <button id="grid">init</button>
  last point <input id="thrval" type="range" min="0" max="255" value="128">
  <button id="thrprev">preview</button>
  <button id="thrapply">apply</button>
  | classical
  <select id="method">
    <option value="2">bg subtraction</option>
    <option value="1">edge based</option>
    <option value="3">chalkboard</option>
    <option value="4">subtraction k</option>
  </select>
  <button id="clsprev">preview</button>
  <button id="clsapply">apply</button>
</div>
<div>
  portions <select id="plist"></select>
  <button id="prect">add rect</button>
  src <select id="psrc">
    <option value="threshold">threshold</option>
    <option value="otsu">otsu</option>
    <option value="current">current</option>
  </select>
  <label><input id="pdark" type="checkbox">dark</label>
  <button id="preject">reject</button>
  <button id="pinvert">invert</button>
  dx <input id="pdx" type="number" value="0" style="width:3.5em">
  dy <input id="pdy" type="number" value="0" style="width:3.5em">
  <button id="pmove">move</button>
  <button id="pcprev">copy&lt;</button>
  <button id="pcnext">copy&gt;</button>
</div>
<div id="wrap"><img id="raw"><img id="bin"></div>
<script>
let kf = null, erase = false, drawing = false, points = [];
let mode = 'paint', lastPoint = -1, previewing = null;
const binImg = document.getElementById('bin');
const rawImg = document.getElementById('raw');
async function api(path, body) {
  const r = await fetch(path, body === undefined ? {} :
    {method: 'POST', body: JSON.stringify(body)});
  return r.json();
}
function refresh() {
  if (previewing === 'thr')
    binImg.src = '/img/thr_preview/' + kf + '?t=' + Date.now();
  else if (previewing === 'cls')
    binImg.src = '/img/classical/' + kf + '?m=' +
      document.getElementById('method').value + '&t=' + Date.now();
  else
    binImg.src = '/img/binary/' + kf + '?t=' + Date.now();
  rawImg.src = '/img/raw/' + kf + '?t=' + Date.now();
}
api('/api/state').then(s => {
  const sel = document.getElementById('kf');
  for (const idx of s.keyframes) {
    const o = document.createElement('option');
    o.value = idx; o.textContent = 'keyframe ' + idx;
    sel.appendChild(o);
  }
  kf = s.keyframes[0]; refresh(); loadPortions();
  sel.onchange = () => { kf = parseInt(sel.value);
    lastPoint = -1; previewing = null; refresh(); loadPortions(); };
});
function setMode(m, target) {
  mode = m; erase = (m === 'erase');
  for (const id of ['paint', 'erase', 'thrpt', 'prect'])
    document.getElementById(id).classList.remove('on');
  target.classList.add('on');
}
document.getElementById('paint').onclick = (e) => setMode('paint', e.target);
document.getElementById('erase').onclick = (e) => setMode('erase', e.target);
document.getElementById('thrpt').onclick = (e) => setMode('thr', e.target);
document.getElementById('prect').onclick = (e) => setMode('prect', e.target);
async function loadPortions() {
  const ps = await api('/api/portions/' + kf);
  const sel = document.getElementById('plist');
  sel.innerHTML = '';
  for (const p of ps) {
    const o = document.createElement('option');
    o.value = p.index;
    o.textContent = p.index + ': ' + p.x + ',' + p.y + ' ' + p.w + 'x' + p.h;
    sel.appendChild(o);
  }
}
function selPortion() {
  const v = document.getElementById('plist').value;
  return v === '' ? null : parseInt(v);
}
async function portionOp(path, extra) {
  const idx = selPortion();
  if (idx === null) return;
  await api(path, Object.assign({kf: kf, index: idx}, extra || {}));
  await loadPortions(); refresh();
}
document.getElementById('preject').onclick = () =>
  portionOp('/api/reject_portion');
document.getElementById('pinvert').onclick = () =>
  portionOp('/api/invert_portion');
document.getElementById('pmove').onclick = () =>
  portionOp('/api/move_portion', {
    dx: parseInt(document.getElementById('pdx').value),
    dy: parseInt(document.getElementById('pdy').value)});
document.getElementById('pcprev').onclick = () =>
  portionOp('/api/copy_portion', {direction: -1});
document.getElementById('pcnext').onclick = () =>
  portionOp('/api/copy_portion', {direction: 1});
document.getElementById('grid').onclick = async () => {
  await api('/api/thr_grid', {kf: kf,
    rows: parseInt(document.getElementById('rows').value),
    cols: parseInt(document.getElementById('cols').value)});
  previewing = 'thr'; refresh();
};
document.getElementById('thrval').onchange = async (e) => {
  if (lastPoint < 0) return;
  await api('/api/thr_point', {kf: kf, op: 'set', index: lastPoint,
    value: parseInt(e.target.value)});
  if (previewing === 'thr') refresh();
};
document.getElementById('thrprev').onclick = () => {
  previewing = previewing === 'thr' ? null : 'thr'; refresh(); };
document.getElementById('thrapply').onclick = async () => {
  await api('/api/thr_apply', {kf: kf}); previewing = null; refresh(); };
document.getElementById('clsprev').onclick = () => {
  previewing = previewing === 'cls' ? null : 'cls'; refresh(); };
document.getElementById('clsapply').onclick = async () => {
  await api('/api/classical_apply', {kf: kf,
    method: parseInt(document.getElementById('method').value)});
  previewing = null; refresh(); };
document.getElementById('undo').onclick = async () => {
  await api('/api/undo', {kf: kf}); await loadPortions(); refresh(); };
document.getElementById('save').onclick = async () => {
  document.getElementById('status').textContent = ' saving...';
  await api('/api/save', {});
  document.getElementById('status').textContent = ' saved'; };
function pos(e) {
  const r = binImg.getBoundingClientRect();
  return [Math.round(e.clientX - r.left), Math.round(e.clientY - r.top)];
}
binImg.ondragstart = () => false;
binImg.onmousedown = async (e) => {
  if (mode === 'thr') {
    const [x, y] = pos(e);
    const r = await api('/api/thr_point', {kf: kf, op: 'add', x: x, y: y});
    lastPoint = r.index;
    document.getElementById('thrval').value = Math.round(r.value);
    if (previewing === 'thr') refresh();
    return;
  }
  drawing = true; points = [pos(e)];
};
binImg.onmousemove = (e) => { if (drawing) points.push(pos(e)); };
window.onmouseup = async () => {
  if (!drawing) return;
  drawing = false;
  if (mode === 'prect') {
    const [x0, y0] = points[0];
    const [x1, y1] = points[points.length - 1];
    const x = Math.min(x0, x1), y = Math.min(y0, y1);
    const w = Math.abs(x1 - x0), h = Math.abs(y1 - y0);
    if (w > 2 && h > 2)
      await api('/api/add_portion', {kf: kf, x: x, y: y, w: w, h: h,
        source: document.getElementById('psrc').value,
        dark: document.getElementById('pdark').checked});
    await loadPortions(); refresh();
    return;
  }
  await api('/api/stroke', {kf: kf, points: points, erase: erase,
    radius: parseInt(document.getElementById('radius').value)});
  refresh();
};
</script></body></html>
"""


def make_handler(session: GTEditorSession):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, body: bytes, content_type: str = "application/json"):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj):
            self._send(json.dumps(obj).encode())

        def _guard(self, fn):
            """Run an edit op; session errors become a JSON error response
            instead of killing the handler thread."""
            try:
                result = fn()
                self._json(result if isinstance(result, dict)
                           else {"ok": True})
            except (ValueError, KeyError, IndexError) as err:
                self._json({"ok": False, "error": str(err)})

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                self._send(PAGE.encode(), "text/html")
            elif self.path.startswith("/api/state"):
                self._json({"keyframes": session.keyframe_ids(),
                            "prefix": session.prefix})
            elif self.path.startswith("/api/portions/"):
                kf_idx = int(self.path.rsplit("/", 1)[1].split("?")[0])
                self._json(session.portions(kf_idx))
            elif self.path.startswith("/api/thr_state/"):
                kf_idx = int(self.path.rsplit("/", 1)[1].split("?")[0])
                tool = session.threshold_tool(kf_idx)
                self._json({"points": tool.points,
                            "thresholds": tool.thresholds,
                            "is_dark": tool.is_dark,
                            "median_k": tool.median_k,
                            "sigma_color": tool.sigma_color,
                            "sigma_space": tool.sigma_space,
                            "knn_k": tool.knn_k,
                            "noise_size": tool.noise_size})
            elif self.path.startswith(("/img/binary/", "/img/raw/",
                                       "/img/thr_preview/",
                                       "/img/classical/")):
                kind, name = self.path.rsplit("/", 2)[-2:]
                query = name.split("?", 1)[1] if "?" in name else ""
                kf_idx = int(name.split("?")[0].replace(".png", ""))
                try:
                    if kind == "binary":
                        image = session.binary(kf_idx)
                    elif kind == "thr_preview":
                        image = session.threshold_preview(kf_idx)
                    elif kind == "classical":
                        method = next((int(p.split("=")[1])
                                       for p in query.split("&")
                                       if p.startswith("m=")), 2)
                        image = session.classical_preview(kf_idx, method)
                    else:
                        image = session.raw(kf_idx)[:, :, ::-1]
                except (ValueError, KeyError, IndexError) as err:
                    self.send_error(404, str(err))
                    return
                self._send(encode_png(image), "image/png")
            else:
                self.send_error(404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if self.path.startswith("/api/stroke"):
                self._guard(lambda: session.stroke(
                    int(body["kf"]), body["points"],
                    radius=int(body.get("radius", 2)),
                    erase=bool(body.get("erase", False))))
            elif self.path.startswith("/api/rect"):
                self._guard(lambda: session.fill_rect(
                    int(body["kf"]), int(body["x"]),
                    int(body["y"]), int(body["w"]), int(body["h"]),
                    erase=bool(body.get("erase", True))))
            elif self.path.startswith("/api/reject_portion"):
                self._guard(lambda: session.reject_portion(
                    int(body["kf"]), int(body["index"])))
            elif self.path.startswith("/api/add_portion"):
                self._guard(lambda: {
                    "ok": True, "index": session.add_portion(
                        int(body["kf"]), int(body["x"]), int(body["y"]),
                        int(body["w"]), int(body["h"]),
                        dark=bool(body.get("dark", False)),
                        source=body.get("source", "threshold"))})
            elif self.path.startswith("/api/move_portion"):
                self._guard(lambda: session.move_portion(
                    int(body["kf"]), int(body["index"]),
                    int(body.get("dx", 0)), int(body.get("dy", 0))))
            elif self.path.startswith("/api/invert_portion"):
                self._guard(lambda: session.invert_portion(
                    int(body["kf"]), int(body["index"])))
            elif self.path.startswith("/api/copy_portion"):
                self._guard(lambda: {"ok": True, **session.copy_portion(
                    int(body["kf"]), int(body["index"]),
                    int(body.get("direction", 1)))})
            elif self.path.startswith("/api/undo"):
                self._json({"ok": session.undo(int(body["kf"]))})
            elif self.path.startswith("/api/thr_grid"):
                def _grid():
                    tool = session.threshold_tool(
                        int(body["kf"]), **body.get("params", {}))
                    count = tool.init_grid(int(body.get("rows", 4)),
                                           int(body.get("cols", 4)))
                    return {"ok": True, "points": count}
                self._guard(_grid)
            elif self.path.startswith("/api/thr_point"):
                def _point():
                    tool = session.threshold_tool(int(body["kf"]))
                    op = body.get("op", "add")
                    if op == "add":
                        index = tool.add_point(float(body["x"]),
                                               float(body["y"]),
                                               body.get("value"))
                        return {"ok": True, "index": index,
                                "value": tool.thresholds[index]}
                    if op == "set":
                        tool.set_point(int(body["index"]),
                                       float(body["value"]))
                    else:   # del
                        tool.delete_point(int(body["index"]))
                    return {"ok": True}
                self._guard(_point)
            elif self.path.startswith("/api/thr_params"):
                self._guard(lambda: session.threshold_tool(
                    int(body["kf"]), **body.get("params", {})))
            elif self.path.startswith("/api/thr_apply"):
                self._guard(lambda: session.threshold_apply(
                    int(body["kf"])))
            elif self.path.startswith("/api/classical_apply"):
                self._guard(lambda: session.classical_apply(
                    int(body["kf"]), int(body.get("method", 2))))
            elif self.path.startswith("/api/save"):
                self._json({"ok": True, "prefix": session.save()})
            else:
                self.send_error(404)

    return Handler


def serve(session: GTEditorSession, port: int = 0):
    """Start the editor UI server; returns the (bound) HTTPServer — call
    serve_forever() (blocking) or run it in a thread (tests)."""
    from http.server import ThreadingHTTPServer

    return ThreadingHTTPServer(("127.0.0.1", port), make_handler(session))
