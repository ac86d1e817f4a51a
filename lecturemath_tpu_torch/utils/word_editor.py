"""Interactive word/formula-tier GT annotators: projection editing, word
segmentation-tree editing, unique-word linking, unique-CC linking, and
formula tagging, as headless-testable sessions plus a local-browser UI.

These are the launchable equivalents of the last reference annotator
tier (reference: AccessMath/annotation/):

  * GTProjectionAnnotator (gt_projection_annotator.py:33, 782 LoC):
    per-keyframe board-plane homography editing -> projections.xml
  * GTWordAnnotator (gt_word_annotator.py:41, 929 LoC): XY-cut word
    segmentation-tree editing -> word_annotations.xml
  * GTUniqueWordAnnotator (gt_unique_word_annotator.py:51, 1,132 LoC):
    greedy-IOU word linking across keyframes -> unique_words.xml
  * GTUniqueCCAnnotator (gt_unique_cc_annotator.py:51, 1,061 LoC):
    greedy recall/precision CC linking -> unique_ccs.xml
  * GTFormulaAnnotator (gt_formula_annotator.py:35, 714 LoC):
    LaTeX-tagged formula grouping of unique CCs -> formula_ccs.xml

Re-designed like utils/gt_editor.py (GTPixelBinaryAnnotator role) and
utils/annotation_editor.py (GTContentAnnotator role): the edit operations
live on plain session classes (WordAnnotatorSession,
UniqueCCAnnotatorSession, FormulaAnnotatorSession) over the format layer
in eval/words.py + eval/annotation.py, and a thin stdlib HTTP surface
(`serve`) renders views and forwards operations. Launch with
``python -m lecturemath_tpu_torch.cli.word_annotator <config> -l <lecture>
-tool words|ccs|formulas``. All files read/write the reference schemas,
so annotations started in the reference GUIs continue here and back.

Every file a session saves needs no OpenCV: the unique-CC matching warps
its label image with ``utils/image.py warp_perspective(...,
interpolation="nearest")`` (``cv2.INTER_NEAREST``), the word boxes are drawn
with ``polylines``, and the PNGs are ``utils/png.py``'s. Only the formula
view's labels (``cv2.putText``) still call OpenCV and are left out
without it.
"""

from __future__ import annotations

import copy
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.region_tree import RegionTree
from ..eval.annotation import KeyframeAnnotation, UniqueCCGroup, cc_str_id
from ..eval.words import (FormulaCCs, KeyFrameProjection, KeyFrameWords,
                          default_word_groups, load_formulas,
                          load_projections, load_unique_words,
                          load_word_annotations, save_formulas,
                          save_projections, save_unique_words,
                          save_word_annotations, unique_words_from_root,
                          unique_words_to_xml, word_id, UniqueWordGroup)
from .image import polylines, rectangle, warp_perspective
from .png import encode_png
from .visualizer import put_label


# shared GT-tree loader (one copy of the tree-layout convention)
from .gt_editor import load_tree_keyframes  # noqa: E402  (re-export)


def base_dst_from_quad(src_points: np.ndarray) -> np.ndarray:
    """Destination rectangle for a source quad: average side lengths,
    centered on the quad's diagonal (reference update_projection_image,
    gt_projection_annotator.py:596-624)."""
    src = np.asarray(src_points, np.float64)
    top = np.linalg.norm(src[1] - src[0])
    right = np.linalg.norm(src[2] - src[1])
    bottom = np.linalg.norm(src[3] - src[2])
    left = np.linalg.norm(src[0] - src[3])
    width = (top + bottom) / 2.0
    height = (left + right) / 2.0
    x = (src[2, 0] + src[0, 0] - width) / 2
    y = (src[2, 1] + src[0, 1] - height) / 2
    return np.asarray([[x, y], [x + width, y],
                       [x + width, y + height], [x, y + height]])


def _inverted_binary(keyframe: KeyframeAnnotation) -> np.ndarray:
    binary = keyframe.binary_image
    return 255 - (binary[:, :, 0] if binary.ndim == 3 else binary)


def _warped_inverted_binary(keyframe: KeyframeAnnotation,
                            projection) -> np.ndarray:
    """See eval.words.warped_inverted_binary (single definition)."""
    from ..eval.words import warped_inverted_binary

    return warped_inverted_binary(keyframe, projection)


def _boxes_iou(a: Sequence[float], b: Sequence[float]) -> float:
    """Bbox IOU on (x, y, w, h) (reference getBoxesIOU,
    gt_unique_word_annotator.py:542-577 — union = enclosing box)."""
    ax1, ax2, ay1, ay2 = a[0], a[0] + a[2], a[1], a[1] + a[3]
    bx1, bx2, by1, by2 = b[0], b[0] + b[2], b[1], b[1] + b[3]
    iw = min(ax2, bx2) - max(ax1, bx1)
    ih = min(ay2, by2) - max(ay1, by1)
    if iw <= 0.0 or ih <= 0.0:
        return 0.0
    union = (max(ax2, bx2) - min(ax1, bx1)) * (max(ay2, by2) - min(ay1, by1))
    return (iw * ih) / union


class WordAnnotatorSession:
    """Projection + word-tree + unique-word editing over one lecture's
    GT tree (GTProjectionAnnotator + GTWordAnnotator +
    GTUniqueWordAnnotator roles). Word trees live over the
    projection-WARPED inverted binary exactly like the reference tools
    (gt_word_annotator.py:76-134 replaces raw/binary with the warped
    versions at load); the projection maps normal-view clicks into that
    segment space (node_from_click, :786-793) and word boxes are
    inverse-warped for normal-view rendering. Editing a projection
    re-anchors that keyframe's tree to the newly warped binary."""

    def __init__(self, keyframes: Sequence[KeyframeAnnotation],
                 tree_prefix: str):
        self.prefix = tree_prefix
        self.keyframes = list(keyframes)
        self.kf_words = self._load_words()
        self._load_groups()
        self._undo: List[dict] = []
        self._redo: List[dict] = []
        self.pending_matches: List[tuple] = []
        self.pending_kf: Optional[int] = None

    @classmethod
    def open(cls, tree_prefix: str) -> "WordAnnotatorSession":
        return cls(load_tree_keyframes(tree_prefix), tree_prefix)

    # ------------------------------------------------------------ loading

    def _load_words(self) -> List[KeyFrameWords]:
        proj_path = os.path.join(self.prefix, "projections.xml")
        projections = None
        if os.path.exists(proj_path):
            loaded = load_projections(proj_path)
            if len(loaded) == len(self.keyframes):
                projections = loaded
        if projections is None:
            projections = []
            for kf in self.keyframes:
                height, width = kf.raw_image.shape[:2]
                projections.append(
                    KeyFrameProjection.create_default(width, height))

        words_path = os.path.join(self.prefix, "word_annotations.xml")
        if os.path.exists(words_path):
            return load_word_annotations(words_path, self.keyframes,
                                         projections)
        out = []
        for kf, projection in zip(self.keyframes, projections):
            out.append(KeyFrameWords(
                kf, projection,
                RegionTree.from_binary(
                    _warped_inverted_binary(kf, projection))))
        return out

    def _load_groups(self) -> None:
        path = os.path.join(self.prefix, "unique_words.xml")
        if os.path.exists(path):
            self.word_group, self.groups = load_unique_words(
                path, self.kf_words)
        else:
            self.word_group, self.groups = default_word_groups(self.kf_words)

    # -------------------------------------------------------------- state

    def words(self, kf_idx: int) -> List[Tuple[int, int, int, int]]:
        return self.kf_words[kf_idx].get_words()

    def state(self) -> dict:
        kf = []
        for idx, kf_words in enumerate(self.kf_words):
            projection = kf_words.projection
            kf.append({
                "index": idx, "keyframe_idx": self.keyframes[idx].idx,
                "words": [list(w) for w in kf_words.get_words()],
                "src_points": projection.src_points.tolist(),
                "delta": [projection.delta_x, projection.delta_y],
                "leaves": len(kf_words.tree.leaves()),
            })
        return {"keyframes": kf, "unique_words": len(self.groups),
                "pending_matches": len(self.pending_matches)}

    def to_segment_space(self, kf_idx: int, x: float, y: float,
                         normal_view: bool = True) -> Tuple[float, float]:
        """Map a click to segment space: normal-view clicks go through H
        (reference node_from_click, gt_word_annotator.py:786-793)."""
        if not normal_view:
            return x, y
        warped = self.kf_words[kf_idx].projection.warp_points([[x, y]])
        return float(warped[0, 0]), float(warped[0, 1])

    # --------------------------------------------------------------- undo

    def _snapshot(self, kf_idx: Optional[int] = None) -> dict:
        """Undo/redo snapshot. Every edit op touches at most ONE
        keyframe's projection/tree (plus the global group state), so only
        that keyframe is captured — per-click cost stays independent of
        the number of keyframes."""
        snap = {"kf": kf_idx,
                "groups": unique_words_to_xml(self.kf_words, self.groups)}
        if kf_idx is not None:
            kf_words = self.kf_words[kf_idx]
            snap["projection"] = kf_words.projection.copy()
            snap["tree"] = kf_words.tree.to_xml_string()
        return snap

    def _push_undo(self, kf_idx: Optional[int] = None) -> None:
        self._undo.append(self._snapshot(kf_idx))
        del self._undo[:-30]
        self._redo.clear()

    def _restore(self, snap: dict) -> None:
        kf_idx = snap["kf"]
        if kf_idx is not None:
            kf_words = self.kf_words[kf_idx]
            kf_words.projection = snap["projection"].copy()
            kf_words.tree = RegionTree.from_xml_string(
                snap["tree"],
                _warped_inverted_binary(self.keyframes[kf_idx],
                                        kf_words.projection))
        self.word_group, self.groups = unique_words_from_root(
            ET.fromstring(snap["groups"]), self.kf_words)
        self.pending_matches = []
        self.pending_kf = None

    def undo(self) -> bool:
        if not self._undo:
            return False
        snap = self._undo.pop()
        self._redo.append(self._snapshot(snap["kf"]))
        self._restore(snap)
        return True

    def redo(self) -> bool:
        if not self._redo:
            return False
        snap = self._redo.pop()
        self._undo.append(self._snapshot(snap["kf"]))
        self._restore(snap)
        return True

    def _reconcile_groups(self) -> None:
        """Re-anchor unique-word groups after a segmentation change (the
        same repair GroupsFromXML applies on load)."""
        xml = unique_words_to_xml(self.kf_words, self.groups)
        self.word_group, self.groups = unique_words_from_root(
            ET.fromstring(xml), self.kf_words)

    # -------------------------------------------------------- projections

    def set_projection_quad(self, kf_idx: int, src_points,
                            delta_x: float = 0.0, delta_y: float = 0.0
                            ) -> None:
        """Re-fit a keyframe's projection from a 4-point source quad
        (reference ModeProjectionRegionAdjustment accept,
        gt_projection_annotator.py:568-588)."""
        src = np.asarray(src_points, np.float64).reshape(4, 2)
        self._push_undo(kf_idx)
        self.kf_words[kf_idx].projection.update_from_points(
            src, base_dst_from_quad(src), delta_x, delta_y)
        self._rebind_tree(kf_idx)

    def set_projection_delta(self, kf_idx: int, delta_x: float,
                             delta_y: float) -> None:
        """Shift the destination rectangle (reference scroll_delta_*,
        gt_projection_annotator.py:678-688)."""
        projection = self.kf_words[kf_idx].projection
        self._push_undo(kf_idx)
        projection.update_from_points(projection.src_points,
                                      projection.base_dst_points,
                                      int(delta_x), int(delta_y))
        self._rebind_tree(kf_idx)

    def copy_projection(self, kf_idx: int, direction: int) -> None:
        """Copy the previous/next keyframe's projection here (reference
        btn_projection_copy_prev/next, gt_projection_annotator.py:645-676)."""
        source = kf_idx + (1 if direction > 0 else -1)
        if not 0 <= source < len(self.kf_words):
            raise ValueError(f"no keyframe at {source}")
        self._push_undo(kf_idx)
        self.kf_words[kf_idx].projection = \
            self.kf_words[source].projection.copy()
        self._rebind_tree(kf_idx)

    def _rebind_tree(self, kf_idx: int) -> None:
        """Rebuild a keyframe's tree over the binary warped by its
        CURRENT projection. Editing a projection changes the space every
        tree coordinate lives in, so the segmentation resets to a fresh
        single-region tree and unique-word groups are reconciled (words
        that vanish drop out). This mirrors the reference workflow order
        — projections are annotated in a separate tool BEFORE word
        annotation starts (gt_word_annotator.py:90 refuses to run
        without projections); edit projections first."""
        kf_words = self.kf_words[kf_idx]
        kf_words.tree = RegionTree.from_binary(
            _warped_inverted_binary(self.keyframes[kf_idx],
                                    kf_words.projection))
        self._reconcile_groups()

    # --------------------------------------------------------- word trees

    def _tree_and_leaf(self, kf_idx: int, x: float, y: float):
        tree = self.kf_words[kf_idx].tree
        node = tree.find_region(int(round(x)), int(round(y)))
        if node is None:
            raise ValueError(f"({x:.0f}, {y:.0f}) outside the tree")
        return tree, node

    def auto_split(self, kf_idx: int, x: float, y: float,
                   alpha_x: float = -1.25, alpha_y: float = -3.0) -> None:
        """Recursive whitespace re-segmentation of the region under a
        click (reference auto_split_tempo_node,
        gt_word_annotator.py:800-808)."""
        _, node = self._tree_and_leaf(kf_idx, x, y)
        self._push_undo(kf_idx)
        node.is_leaf = True
        node.left = node.right = None
        stack = [node]
        while stack:
            current = stack.pop()
            if current.segment(alpha_x, alpha_y):
                stack.append(current.left)
                stack.append(current.right)
        self._reconcile_groups()

    def split_at(self, kf_idx: int, x: float, y: float,
                 vertical: bool) -> None:
        """Force a cut through (x, y): vertical cuts at X, horizontal at
        Y (reference ModeTreeEditSplit, gt_word_annotator.py:831-843)."""
        _, node = self._tree_and_leaf(kf_idx, x, y)
        if not node.is_leaf:
            raise ValueError("split point not inside a leaf region")
        self._push_undo(kf_idx)
        if vertical:
            node.force_segment_x(int(round(x)))
        else:
            node.force_segment_y(int(round(y)))
        self._reconcile_groups()

    def merge_at(self, kf_idx: int, x: float, y: float) -> None:
        """Collapse the split containing (x, y) (reference
        ModeTreeEditMerge -> remove_segment, gt_word_annotator.py:845-851)."""
        tree, node = self._tree_and_leaf(kf_idx, x, y)
        if node is tree.root:
            raise ValueError("cannot merge at the root region")
        parent = node.parent
        self._push_undo(kf_idx)
        parent.is_leaf = True
        parent.left = parent.right = None
        self._reconcile_groups()

    def copy_tree(self, kf_idx: int, direction: int) -> None:
        """Copy the previous/next keyframe's segmentation onto this
        keyframe's binary (reference btn_segmentation_copy_prev/next,
        gt_word_annotator.py:850-869: structure + CCs copy over, the
        image reference is replaced)."""
        source = kf_idx + (1 if direction > 0 else -1)
        if not 0 <= source < len(self.kf_words):
            raise ValueError(f"no keyframe at {source}")
        self._push_undo(kf_idx)
        self.kf_words[kf_idx].tree = RegionTree.from_xml_string(
            self.kf_words[source].tree.to_xml_string(),
            _warped_inverted_binary(self.keyframes[kf_idx],
                                    self.kf_words[kf_idx].projection))
        self._reconcile_groups()

    def reset_tree(self, kf_idx: int) -> None:
        """Fresh single-region tree (reference btn_segmentation_reset,
        gt_word_annotator.py:871-875)."""
        self._push_undo(kf_idx)
        self.kf_words[kf_idx].tree = RegionTree.from_binary(
            _warped_inverted_binary(self.keyframes[kf_idx],
                                    self.kf_words[kf_idx].projection))
        self._reconcile_groups()

    # ------------------------------------------------------- unique words

    def greedy_word_matches(self, kf_idx: int, region,
                            delta_x: int = 0, delta_y: int = 0
                            ) -> List[dict]:
        """Greedy 1:1 IOU matching of this keyframe's unmatched words in
        ``region`` = (x, y, w, h) against the previous keyframe's words
        (reference greedy_matching_scores,
        gt_unique_word_annotator.py:579-650)."""
        if kf_idx <= 0:
            raise ValueError("no previous keyframe to match against")
        rx, ry, rw, rh = (int(v) for v in region)

        curr = {word_id(w): w for w in
                self.kf_words[kf_idx].words_in_region(rx, rx + rw,
                                                      ry, ry + rh)
                if self.word_group[kf_idx][word_id(w)].start_frame == kf_idx}
        # only previous-keyframe words whose group does NOT already extend
        # into this keyframe are valid link targets — accepting one whose
        # group already has a frame-kf word would put two words on the
        # same frame and break the contiguous words_refs invariant. (The
        # reference word annotator lacks this guard; its CC annotator has
        # it, gt_unique_cc_annotator.py:679-688 — we follow the CC one.)
        prev = {word_id(w): (w[0] + delta_x, w[1] + delta_y, w[2], w[3])
                for w in self.kf_words[kf_idx - 1].words_in_region(
                    rx - delta_x, rx - delta_x + rw,
                    ry - delta_y, ry - delta_y + rh)
                if self.word_group[kf_idx - 1][word_id(w)].last_frame()
                == kf_idx - 1}

        scored = []
        for cid, cword in curr.items():
            for pid, pword in prev.items():
                iou = _boxes_iou(cword, pword)
                if iou > 0.0:
                    scored.append((iou, pid, cword))
        scored.sort(key=lambda m: m[0], reverse=True)

        matches, used_prev, used_curr = [], set(), set()
        for iou, pid, cword in scored:
            cid = word_id(cword)
            if pid in used_prev or cid in used_curr:
                continue
            matches.append((iou, pid, cword))
            used_prev.add(pid)
            used_curr.add(cid)
        self.pending_matches = matches
        self.pending_kf = kf_idx
        return [{"iou": round(iou, 4), "prev": pid, "curr": word_id(cword)}
                for iou, pid, cword in matches]

    def accept_word_matches(self, min_iou: float = 0.5) -> int:
        """Merge pending matches at/above ``min_iou`` into the previous
        keyframe's groups (reference ModeMatch_Matching accept,
        gt_unique_word_annotator.py:665-695)."""
        if self.pending_kf is None:
            raise ValueError("no pending matches — run matching first")
        kf_idx = self.pending_kf
        self._push_undo()
        merged = 0
        for iou, pid, cword in self.pending_matches:
            if iou < min_iou:
                continue
            prev_group = self.word_group[kf_idx - 1][pid]
            curr_group = self.word_group[kf_idx][word_id(cword)]
            if prev_group is curr_group:
                continue
            for offset, w in enumerate(curr_group.words_refs):
                self.word_group[kf_idx + offset][word_id(w)] = prev_group
                prev_group.words_refs.append(w)
            self.groups.remove(curr_group)
            merged += 1
        self.pending_matches = []
        self.pending_kf = None
        return merged

    def remove_word_matches(self, kf_idx: int, region) -> int:
        """Split every previously-matched word in ``region`` into its own
        group from this keyframe on (reference ModeMatch_Remove accept,
        gt_unique_word_annotator.py:698-741)."""
        rx, ry, rw, rh = (int(v) for v in region)
        targets = [word_id(w) for w in
                   self.kf_words[kf_idx].words_in_region(rx, rx + rw,
                                                         ry, ry + rh)
                   if self.word_group[kf_idx][word_id(w)].start_frame
                   < kf_idx]
        if not targets:
            return 0
        self._push_undo()
        for wid in targets:
            group = self.word_group[kf_idx][wid]
            new_group = UniqueWordGroup.split(group, kf_idx)
            if new_group is None:
                continue
            for offset, w in enumerate(new_group.words_refs):
                self.word_group[kf_idx + offset][word_id(w)] = new_group
            self.groups.append(new_group)
        return len(targets)

    # ------------------------------------------------------------- render

    def render(self, kf_idx: int, view: str = "normal_rgb") -> np.ndarray:
        """Keyframe with word-box overlay. Views mirror the reference's
        four modes; word boxes live in segment space and are
        inverse-warped for the normal views."""
        kf = self.keyframes[kf_idx]
        kf_words = self.kf_words[kf_idx]
        projected = view.startswith("projected")
        if projected:
            rgb, binary = kf_words.warped()[:2]
            base = rgb if view.endswith("rgb") else binary
        else:
            base = kf.raw_image if view.endswith("rgb") else kf.binary_image
        if base.ndim == 2:
            base = np.stack([base] * 3, axis=-1)
        out = np.ascontiguousarray(base.copy())

        for x, y, w, h in kf_words.get_words():
            corners = np.asarray([[x, y], [x + w, y],
                                  [x + w, y + h], [x, y + h]], np.float64)
            if not projected:
                corners = kf_words.projection.warp_points(corners,
                                                          inverse=True)
            wid = word_id((x, y, w, h))
            linked = self.word_group[kf_idx].get(wid)
            color = ((0, 160, 255) if linked is not None
                     and len(linked.words_refs) > 1 else (0, 200, 0))
            polylines(out, [corners.astype(np.int32).reshape(-1, 1, 2)],
                      True, color, 1)
        return out

    # --------------------------------------------------------------- save

    def save(self) -> dict:
        os.makedirs(self.prefix, exist_ok=True)
        paths = {
            "projections": os.path.join(self.prefix, "projections.xml"),
            "words": os.path.join(self.prefix, "word_annotations.xml"),
            "unique_words": os.path.join(self.prefix, "unique_words.xml"),
        }
        save_projections(paths["projections"],
                         [w.projection for w in self.kf_words])
        save_word_annotations(paths["words"], self.kf_words,
                              trees_only=True)
        save_unique_words(paths["unique_words"], self.kf_words, self.groups)
        return paths


class UniqueCCAnnotatorSession:
    """Greedy CC linking across keyframes -> unique_ccs.xml
    (GTUniqueCCAnnotator role)."""

    def __init__(self, keyframes: Sequence[KeyframeAnnotation],
                 tree_prefix: str):
        self.prefix = tree_prefix
        self.keyframes = list(keyframes)
        for kf in self.keyframes:
            if not kf.binary_cc:
                kf.update_binary_cc()
        path = os.path.join(tree_prefix, "unique_ccs.xml")
        if os.path.exists(path):
            self.cc_group, self.groups = UniqueCCGroup.groups_from_xml(
                self.keyframes, path)
        else:
            self.cc_group, self.groups = self._default_groups()
        self._undo: List[str] = []
        self._redo: List[str] = []
        self.pending_matches: List[tuple] = []
        self.pending_kf: Optional[int] = None
        self.pending_source: Optional[int] = None

    @classmethod
    def open(cls, tree_prefix: str) -> "UniqueCCAnnotatorSession":
        return cls(load_tree_keyframes(tree_prefix), tree_prefix)

    def _default_groups(self):
        cc_group, groups = [], []
        for kf_idx, kf in enumerate(self.keyframes):
            mapping = {}
            for cc in kf.binary_cc:
                group = UniqueCCGroup(cc, kf_idx)
                mapping[cc_str_id(cc)] = group
                groups.append(group)
            cc_group.append(mapping)
        return cc_group, groups

    # --------------------------------------------------------------- undo

    def _push_undo(self) -> None:
        self._undo.append(UniqueCCGroup.groups_to_xml(self.keyframes,
                                                      self.groups))
        del self._undo[:-30]
        self._redo.clear()

    def _restore(self, xml: str) -> None:
        import tempfile

        with tempfile.NamedTemporaryFile("w", suffix=".xml",
                                         delete=False) as f:
            f.write(xml)
            path = f.name
        try:
            self.cc_group, self.groups = UniqueCCGroup.groups_from_xml(
                self.keyframes, path)
        finally:
            os.unlink(path)
        self.pending_matches = []
        self.pending_kf = self.pending_source = None

    def undo(self) -> bool:
        if not self._undo:
            return False
        self._redo.append(UniqueCCGroup.groups_to_xml(self.keyframes,
                                                      self.groups))
        self._restore(self._undo.pop())
        return True

    def redo(self) -> bool:
        if not self._redo:
            return False
        self._undo.append(UniqueCCGroup.groups_to_xml(self.keyframes,
                                                      self.groups))
        self._restore(self._redo.pop())
        return True

    # ----------------------------------------------------------- matching

    def _ccs_in_region(self, kf_idx: int, region) -> List:
        rx, ry, rw, rh = (int(v) for v in region)
        return [cc for cc in self.keyframes[kf_idx].binary_cc
                if rx <= cc.min_x and cc.max_x <= rx + rw
                and ry <= cc.min_y and cc.max_y <= ry + rh]

    def _warped_source_ccs(self, source: int, kf_idx: int, region,
                           matrix: Optional[np.ndarray]) -> Dict[str, object]:
        """Source CCs warped by the matching projection, keyed by their
        ORIGINAL ids; only unmatched-beyond-source, in-region survivors
        (reference greedy_matching_scores,
        gt_unique_cc_annotator.py:651-677)."""
        from ..data.cc import CC

        kf = self.keyframes[source]
        height, width = kf.binary_image.shape[:2]
        labeled = np.zeros((height, width), np.int32)
        for idx, cc in enumerate(kf.binary_cc):
            box = labeled[cc.min_y:cc.max_y + 1, cc.min_x:cc.max_x + 1]
            box[cc.img > 0] = idx + 1
        if matrix is not None:
            labeled = warp_perspective(labeled, np.asarray(matrix,
                                                           np.float64),
                                       (width, height),
                                       interpolation="nearest")
        ys, xs = np.nonzero(labeled)
        if len(ys) == 0:
            return {}
        labels = labeled[ys, xs]
        rx, ry, rw, rh = (int(v) for v in region)
        out: Dict[str, object] = {}
        for idx in np.unique(labels):
            original = kf.binary_cc[idx - 1]
            original_id = cc_str_id(original)
            if self.cc_group[source][original_id].last_frame() >= kf_idx:
                continue   # already matched at/after the target frame
            sel = labels == idx
            min_x, max_x = int(xs[sel].min()), int(xs[sel].max())
            min_y, max_y = int(ys[sel].min()), int(ys[sel].max())
            if not (rx <= min_x and max_x <= rx + rw
                    and ry <= min_y and max_y <= ry + rh):
                continue
            img = (labeled[min_y:max_y + 1, min_x:max_x + 1]
                   == idx).astype(np.uint8) * 255
            out[original_id] = CC(original.cc_id, min_x, max_x, min_y,
                                  max_y, int(sel.sum()), img)
        return out

    def greedy_cc_matches(self, kf_idx: int, source: int, region,
                          matrix: Optional[np.ndarray] = None) -> List[dict]:
        """Greedy 1:1 pixel-overlap matching of this keyframe's unmatched
        CCs in ``region`` against an earlier source keyframe, optionally
        through a projection ``matrix`` (reference greedy_matching_scores,
        gt_unique_cc_annotator.py:626-733)."""
        if not 0 <= source < kf_idx:
            raise ValueError("source must be an earlier keyframe")
        curr = {cc_str_id(cc): cc for cc in self._ccs_in_region(kf_idx,
                                                                region)
                if self.cc_group[kf_idx][cc_str_id(cc)].start_frame
                == kf_idx}
        prev = self._warped_source_ccs(source, kf_idx, region, matrix)

        scored = []
        for cid, cc in curr.items():
            for pid, warped in prev.items():
                if cc.bbox_intersects(warped):
                    recall, precision = cc.overlap_recall_precision(warped)
                    scored.append((recall, precision, pid, cc))
        scored.sort(key=lambda m: m[0], reverse=True)

        matches, used_prev, used_curr = [], set(), set()
        for recall, precision, pid, cc in scored:
            cid = cc_str_id(cc)
            if pid in used_prev or cid in used_curr:
                continue
            matches.append((recall, precision, pid, cc))
            used_prev.add(pid)
            used_curr.add(cid)
        self.pending_matches = matches
        self.pending_kf = kf_idx
        self.pending_source = source
        return [{"recall": round(r, 4), "precision": round(p, 4),
                 "prev": pid, "curr": cc_str_id(cc)}
                for r, p, pid, cc in matches]

    def accept_cc_matches(self, min_recall: float = 0.5,
                          min_precision: float = 0.5) -> int:
        """Merge pending matches into the source groups, gap-filling with
        None (reference ModeMatch_Matching accept,
        gt_unique_cc_annotator.py:760-799)."""
        if self.pending_kf is None:
            raise ValueError("no pending matches — run matching first")
        kf_idx, source = self.pending_kf, self.pending_source
        self._push_undo()
        merged = 0
        for recall, precision, pid, cc in self.pending_matches:
            if recall < min_recall or precision < min_precision:
                continue
            prev_group = self.cc_group[source][pid]
            curr_group = self.cc_group[kf_idx][cc_str_id(cc)]
            if prev_group is curr_group:
                continue
            while prev_group.last_frame() + 1 < kf_idx:
                prev_group.cc_refs.append(None)
            for offset, member in enumerate(curr_group.cc_refs):
                if member is not None:
                    self.cc_group[kf_idx + offset][cc_str_id(member)] = \
                        prev_group
                prev_group.cc_refs.append(member)
            while prev_group.cc_refs and prev_group.cc_refs[-1] is None:
                prev_group.cc_refs.pop()
            self.groups.remove(curr_group)
            merged += 1
        self.pending_matches = []
        self.pending_kf = self.pending_source = None
        return merged

    def remove_cc_matches(self, kf_idx: int, region) -> int:
        """Split every previously-matched CC in ``region`` into its own
        group from this keyframe on (reference ModeMatch_Remove accept,
        gt_unique_cc_annotator.py:801-840)."""
        targets = [cc_str_id(cc) for cc in self._ccs_in_region(kf_idx,
                                                               region)
                   if self.cc_group[kf_idx][cc_str_id(cc)].start_frame
                   < kf_idx]
        if not targets:
            return 0
        self._push_undo()
        for cid in targets:
            group = self.cc_group[kf_idx][cid]
            new_group = UniqueCCGroup.split(group, kf_idx)
            if new_group is None:
                continue
            for offset, member in enumerate(new_group.cc_refs):
                if member is not None:
                    self.cc_group[kf_idx + offset][cc_str_id(member)] = \
                        new_group
            self.groups.append(new_group)
        return len(targets)

    # ------------------------------------------------------------- render

    def render(self, kf_idx: int, view: str = "colored") -> np.ndarray:
        """Keyframe CC overlay: colored = per-group stable colors so
        linked CCs match across keyframes (reference update_colored_cache,
        gt_unique_cc_annotator.py:476-504)."""
        kf = self.keyframes[kf_idx]
        if view == "raw":
            return np.ascontiguousarray(kf.raw_image)
        if view == "binary":
            return np.ascontiguousarray(kf.binary_image)
        out = np.full_like(kf.binary_image, 255)
        rng_colors = [(200, 40, 40), (40, 160, 40), (40, 80, 220),
                      (200, 160, 0), (160, 40, 200), (0, 170, 170)]
        for cid, group in self.cc_group[kf_idx].items():
            offset = kf_idx - group.start_frame
            cc = group.cc_refs[offset] if offset < len(group.cc_refs) \
                else None
            if cc is None:
                continue
            color = rng_colors[hash(group.str_id()) % len(rng_colors)] \
                if len(group.cc_refs) > 1 else (80, 80, 80)
            box = out[cc.min_y:cc.max_y + 1, cc.min_x:cc.max_x + 1]
            box[cc.img > 0] = color
        return out

    def state(self) -> dict:
        return {"keyframes": [{"index": idx, "keyframe_idx": kf.idx,
                               "ccs": len(kf.binary_cc)}
                              for idx, kf in enumerate(self.keyframes)],
                "unique_ccs": len(self.groups),
                "pending_matches": len(self.pending_matches)}

    def save(self) -> str:
        os.makedirs(self.prefix, exist_ok=True)
        path = os.path.join(self.prefix, "unique_ccs.xml")
        with open(path, "w") as f:
            f.write(UniqueCCGroup.groups_to_xml(self.keyframes, self.groups))
        return path


class FormulaAnnotatorSession:
    """LaTeX-tagged formula grouping over unique-CC groups ->
    formula_ccs.xml (GTFormulaAnnotator role)."""

    def __init__(self, keyframes: Sequence[KeyframeAnnotation],
                 tree_prefix: str):
        self.prefix = tree_prefix
        self.keyframes = list(keyframes)
        for kf in self.keyframes:
            if not kf.binary_cc:
                kf.update_binary_cc()
        groups_path = os.path.join(tree_prefix, "unique_ccs.xml")
        if os.path.exists(groups_path):
            self.cc_group, self.groups = UniqueCCGroup.groups_from_xml(
                self.keyframes, groups_path)
        else:
            session = UniqueCCAnnotatorSession(self.keyframes, tree_prefix)
            self.cc_group, self.groups = session.cc_group, session.groups
        path = os.path.join(tree_prefix, "formula_ccs.xml")
        self.formulas: List[FormulaCCs] = (
            load_formulas(path, self.groups) if os.path.exists(path) else [])
        self._undo: List[List[FormulaCCs]] = []
        self._redo: List[List[FormulaCCs]] = []

    @classmethod
    def open(cls, tree_prefix: str) -> "FormulaAnnotatorSession":
        return cls(load_tree_keyframes(tree_prefix), tree_prefix)

    # --------------------------------------------------------------- undo

    def _push_undo(self) -> None:
        self._undo.append([copy.copy(f) for f in self.formulas])
        del self._undo[:-30]
        self._redo.clear()

    def undo(self) -> bool:
        if not self._undo:
            return False
        self._redo.append(list(self.formulas))
        self.formulas = self._undo.pop()
        return True

    def redo(self) -> bool:
        if not self._redo:
            return False
        self._undo.append(list(self.formulas))
        self.formulas = self._redo.pop()
        return True

    # -------------------------------------------------------------- edits

    def groups_in_region(self, kf_idx: int, region) -> List[str]:
        """Ids of unique-CC groups whose member at this keyframe lies in
        ``region`` (the annotator's rectangle selection,
        gt_formula_annotator.py:689-736)."""
        rx, ry, rw, rh = (int(v) for v in region)
        out = []
        for group in self.groups:
            offset = kf_idx - group.start_frame
            if not 0 <= offset < len(group.cc_refs):
                continue
            cc = group.cc_refs[offset]
            if cc is None:
                continue
            if (rx <= cc.min_x and cc.max_x <= rx + rw
                    and ry <= cc.min_y and cc.max_y <= ry + rh):
                out.append(group.str_id())
        return out

    def add_formula(self, group_ids: Sequence[str],
                    latex_tag: str = "") -> int:
        """(reference add_new_formula, gt_formula_annotator.py:565-576)"""
        by_id = {g.str_id(): g for g in self.groups}
        members = [by_id[gid] for gid in group_ids if gid in by_id]
        if not members:
            raise ValueError("no valid unique-CC groups selected")
        self._push_undo()
        formula = FormulaCCs(members, latex_tag)
        self.formulas.append(formula)
        self.formulas.sort()
        return next(i for i, f in enumerate(self.formulas) if f is formula)

    def del_formula(self, index: int) -> None:
        if not 0 <= index < len(self.formulas):
            raise ValueError(f"no formula at {index}")
        self._push_undo()
        del self.formulas[index]

    def set_tag(self, index: int, latex_tag: str) -> None:
        """(reference btn_formula_update_tag, gt_formula_annotator.py:631)"""
        if not 0 <= index < len(self.formulas):
            raise ValueError(f"no formula at {index}")
        self._push_undo()
        self.formulas[index].latex_tag = latex_tag

    def state(self) -> dict:
        return {
            "keyframes": [{"index": idx, "keyframe_idx": kf.idx}
                          for idx, kf in enumerate(self.keyframes)],
            "unique_ccs": len(self.groups),
            "formulas": [{
                "index": idx, "latex": f.latex_tag,
                "groups": [g.str_id() for g in f.groups_refs],
                "first_visible": f.first_visible,
                "last_visible": f.last_visible,
            } for idx, f in enumerate(self.formulas)],
        }

    # ------------------------------------------------------------- render

    def render(self, kf_idx: int, view: str = "raw") -> np.ndarray:
        """Keyframe with formula bounding boxes (visible formulas solid,
        others dashed-gray; reference highlight_groups,
        gt_formula_annotator.py:416-476). The labels need OpenCV
        (``put_label``)."""
        kf = self.keyframes[kf_idx]
        base = kf.raw_image if view == "raw" else kf.binary_image
        out = np.ascontiguousarray(base.copy())
        for idx, formula in enumerate(self.formulas):
            min_x, max_x, min_y, max_y = formula.bounding_box()
            color = ((0, 180, 0) if formula.visible_at(kf_idx)
                     else (150, 150, 150))
            rectangle(out, (int(min_x) - 2, int(min_y) - 2),
                      (int(max_x) + 2, int(max_y) + 2), color, 1)
            put_label(out, formula.latex_tag or str(idx),
                      (int(min_x), max(10, int(min_y) - 4)), 0.8, color)
        return out

    def save(self) -> str:
        os.makedirs(self.prefix, exist_ok=True)
        path = os.path.join(self.prefix, "formula_ccs.xml")
        save_formulas(path, self.formulas)
        return path


# --------------------------------------------------------------- HTTP UI

PAGE = """<!DOCTYPE html>
<html><head><title>Word/formula annotator</title><style>
body { font-family: sans-serif; margin: 12px; }
#frame { cursor: crosshair; border: 1px solid #999; }
.tool { display: none; margin: 4px 0; }
.tool.on { display: block; }
input.num { width: 4em; }
</style></head><body>
<div>
  tool <select id="tool">
    <option value="words">words</option>
    <option value="ccs">unique CCs</option>
    <option value="formulas">formulas</option>
  </select>
  keyframe <button id="prev">&lt;</button><span id="kf">0</span>
  <button id="next">&gt;</button>
  view <select id="view"></select>
  <button id="undo">undo</button><button id="redo">redo</button>
  <button id="save">save</button> <span id="status"></span>
</div>
<div id="t-words" class="tool">
  tree: <button data-op="auto_split">auto-split (click)</button>
  <button data-op="split_v">split | (click)</button>
  <button data-op="split_h">split &#8212; (click)</button>
  <button data-op="merge">merge (click)</button>
  <button data-op="copy_prev">copy prev</button>
  <button data-op="copy_next">copy next</button>
  <button data-op="reset">reset</button>
  proj: <button data-op="quad">set quad (4 clicks)</button>
  dx <input id="pdx" class="num" value="0"> dy
  <input id="pdy" class="num" value="0">
  <button data-op="pdelta">apply deltas</button>
  <button data-op="pcopy_prev">copy prev</button>
  <button data-op="pcopy_next">copy next</button>
  <br>link: <button data-op="match">match region (drag)</button>
  min-IOU <input id="miniou" class="num" value="0.5">
  <button data-op="accept">accept</button>
  <button data-op="unmatch">unlink region (drag)</button>
</div>
<div id="t-ccs" class="tool">
  source kf <input id="src" class="num" value="0">
  <button data-op="cmatch">match region (drag)</button>
  minR <input id="minr" class="num" value="0.5">
  minP <input id="minp" class="num" value="0.5">
  <button data-op="caccept">accept</button>
  <button data-op="cunmatch">unlink region (drag)</button>
</div>
<div id="t-formulas" class="tool">
  latex <input id="latex" style="width:14em">
  <button data-op="fadd">add from region (drag)</button>
  formula # <input id="fidx" class="num" value="0">
  <button data-op="ftag">set tag</button>
  <button data-op="fdel">delete</button>
</div>
<div><img id="frame"></div>
<pre id="info"></pre>
<script>
let idx = 0, st = null, mode = null, quad = [], drag = null;
const img = document.getElementById('frame');
const toolSel = document.getElementById('tool');
const VIEWS = {words: ['normal_rgb', 'normal_bin', 'projected_rgb',
                       'projected_bin'],
               ccs: ['colored', 'raw', 'binary'],
               formulas: ['raw', 'binary']};
function num(id) { return parseFloat(document.getElementById(id).value); }
async function api(path, body) {
  const r = await fetch(path, body === undefined ? {} :
    {method: 'POST', body: JSON.stringify(body)});
  return r.json();
}
function tool() { return toolSel.value; }
function setStatus(t) { document.getElementById('status').textContent = t; }
function refresh() {
  img.src = '/img/' + tool() + '/' + idx + '?view=' +
    document.getElementById('view').value + '&t=' + Date.now();
  document.getElementById('kf').textContent = idx;
}
async function reload() {
  st = await api('/api/state?tool=' + tool());
  document.getElementById('info').textContent =
    JSON.stringify(st, null, 1).slice(0, 2000);
  refresh();
}
function setTool() {
  for (const d of document.querySelectorAll('.tool'))
    d.classList.remove('on');
  document.getElementById('t-' + tool()).classList.add('on');
  const vs = document.getElementById('view');
  vs.innerHTML = '';
  for (const v of VIEWS[tool()]) {
    const o = document.createElement('option');
    o.value = v; o.textContent = v; vs.appendChild(o);
  }
  reload();
}
toolSel.onchange = setTool;
document.getElementById('view').onchange = refresh;
document.getElementById('prev').onclick = () => {
  idx = Math.max(0, idx - 1); reload(); };
document.getElementById('next').onclick = () => {
  idx = Math.min(st.keyframes.length - 1, idx + 1); reload(); };
async function post(op, body) {
  const r = await api('/api/' + tool() + '/' + op, body || {});
  setStatus(r.ok === false ? (r.error || 'failed') :
    JSON.stringify(r.result !== undefined ? r.result : ''));
  reload();
}
document.getElementById('undo').onclick = () => post('undo');
document.getElementById('redo').onclick = () => post('redo');
document.getElementById('save').onclick = () => post('save');
const CLICK_OPS = {auto_split: 1, split_v: 1, split_h: 1, merge: 1,
                   quad: 4};
const DRAG_OPS = {match: 1, unmatch: 1, cmatch: 1, cunmatch: 1, fadd: 1};
for (const b of document.querySelectorAll('button[data-op]')) {
  b.onclick = () => {
    const op = b.dataset.op;
    if (CLICK_OPS[op]) { mode = op; quad = [];
      setStatus('click on the image (' + CLICK_OPS[op] + 'x)'); }
    else if (DRAG_OPS[op]) { mode = op;
      setStatus('drag a rectangle'); }
    else if (op === 'copy_prev') post('copy_tree', {kf: idx, dir: -1});
    else if (op === 'copy_next') post('copy_tree', {kf: idx, dir: 1});
    else if (op === 'reset') post('reset', {kf: idx});
    else if (op === 'pdelta') post('projection_delta',
      {kf: idx, dx: num('pdx'), dy: num('pdy')});
    else if (op === 'pcopy_prev') post('projection_copy', {kf: idx, dir: -1});
    else if (op === 'pcopy_next') post('projection_copy', {kf: idx, dir: 1});
    else if (op === 'accept') post('accept', {min_iou: num('miniou')});
    else if (op === 'caccept') post('accept',
      {min_recall: num('minr'), min_precision: num('minp')});
    else if (op === 'ftag') post('tag',
      {index: num('fidx'), latex: document.getElementById('latex').value});
    else if (op === 'fdel') post('del', {index: num('fidx')});
  };
}
function pos(e) {
  const r = img.getBoundingClientRect();
  return [Math.round(e.clientX - r.left), Math.round(e.clientY - r.top)];
}
img.ondragstart = () => false;
img.onmousedown = (e) => { if (DRAG_OPS[mode]) drag = pos(e); };
img.onmouseup = async (e) => {
  const p = pos(e);
  if (CLICK_OPS[mode]) {
    quad.push(p);
    if (quad.length < CLICK_OPS[mode]) {
      setStatus('click ' + (CLICK_OPS[mode] - quad.length) + ' more'); return;
    }
    const m = mode; mode = null;
    const normal = document.getElementById('view').value.startsWith('normal');
    if (m === 'quad')
      post('projection_quad', {kf: idx, points: quad});
    else if (m === 'split_v' || m === 'split_h')
      post('split', {kf: idx, x: p[0], y: p[1], vertical: m === 'split_v',
                     normal: normal});
    else
      post(m, {kf: idx, x: p[0], y: p[1], normal: normal});
    quad = [];
  } else if (DRAG_OPS[mode] && drag) {
    const a = drag, m = mode; drag = null; mode = null;
    const region = [Math.min(a[0], p[0]), Math.min(a[1], p[1]),
                    Math.abs(p[0] - a[0]), Math.abs(p[1] - a[1])];
    if (m === 'match') post('match', {kf: idx, region: region});
    else if (m === 'unmatch') post('remove', {kf: idx, region: region});
    else if (m === 'cmatch') post('match',
      {kf: idx, source: num('src'), region: region});
    else if (m === 'cunmatch') post('remove', {kf: idx, region: region});
    else if (m === 'fadd') post('add', {kf: idx, region: region,
      latex: document.getElementById('latex').value});
  }
};
setTool();
</script></body></html>
"""


class WordTierEditor:
    """All three sessions over one annotation tree, created lazily and
    sharing the loaded keyframes."""

    def __init__(self, tree_prefix: str,
                 keyframes: Optional[Sequence[KeyframeAnnotation]] = None):
        self.prefix = tree_prefix
        self.keyframes = (list(keyframes) if keyframes is not None
                          else load_tree_keyframes(tree_prefix))
        self._sessions: Dict[str, object] = {}

    def session(self, tool: str):
        if tool not in self._sessions:
            cls = {"words": WordAnnotatorSession,
                   "ccs": UniqueCCAnnotatorSession,
                   "formulas": FormulaAnnotatorSession}[tool]
            self._sessions[tool] = cls(self.keyframes, self.prefix)
        return self._sessions[tool]


def make_handler(editor: WordTierEditor):
    import json
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    def words_ops(session: WordAnnotatorSession, op: str, body: dict):
        kf = int(body.get("kf", 0))
        if op in ("auto_split", "split", "merge"):
            x, y = float(body["x"]), float(body["y"])
            if body.get("normal", True):
                x, y = session.to_segment_space(kf, x, y)
            if op == "auto_split":
                return session.auto_split(kf, x, y,
                                          float(body.get("alpha_x", -1.25)),
                                          float(body.get("alpha_y", -3.0)))
            if op == "split":
                return session.split_at(kf, x, y, bool(body["vertical"]))
            return session.merge_at(kf, x, y)
        if op == "copy_tree":
            return session.copy_tree(kf, int(body["dir"]))
        if op == "reset":
            return session.reset_tree(kf)
        if op == "projection_quad":
            return session.set_projection_quad(kf, body["points"],
                                               float(body.get("dx", 0)),
                                               float(body.get("dy", 0)))
        if op == "projection_delta":
            return session.set_projection_delta(kf, body["dx"], body["dy"])
        if op == "projection_copy":
            return session.copy_projection(kf, int(body["dir"]))
        if op == "match":
            return session.greedy_word_matches(kf, body["region"],
                                               int(body.get("dx", 0)),
                                               int(body.get("dy", 0)))
        if op == "accept":
            return session.accept_word_matches(
                float(body.get("min_iou", 0.5)))
        if op == "remove":
            return session.remove_word_matches(kf, body["region"])
        raise KeyError(op)

    def ccs_ops(session: UniqueCCAnnotatorSession, op: str, body: dict):
        kf = int(body.get("kf", 0))
        if op == "match":
            matrix = body.get("matrix")
            return session.greedy_cc_matches(
                kf, int(body["source"]), body["region"],
                np.asarray(matrix, np.float64) if matrix else None)
        if op == "accept":
            return session.accept_cc_matches(
                float(body.get("min_recall", 0.5)),
                float(body.get("min_precision", 0.5)))
        if op == "remove":
            return session.remove_cc_matches(kf, body["region"])
        raise KeyError(op)

    def formulas_ops(session: FormulaAnnotatorSession, op: str, body: dict):
        if op == "add":
            groups = body.get("groups")
            if groups is None:
                groups = session.groups_in_region(int(body.get("kf", 0)),
                                                  body["region"])
            return session.add_formula(groups, body.get("latex", ""))
        if op == "del":
            return session.del_formula(int(body["index"]))
        if op == "tag":
            return session.set_tag(int(body["index"]),
                                   body.get("latex", ""))
        raise KeyError(op)

    OPS = {"words": words_ops, "ccs": ccs_ops, "formulas": formulas_ops}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, body: bytes, content_type="application/json"):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj):
            self._send(json.dumps(obj).encode())

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/" or url.path.startswith("/index"):
                self._send(PAGE.encode(), "text/html")
            elif url.path.startswith("/api/state"):
                tool = parse_qs(url.query).get("tool", ["words"])[0]
                self._json(editor.session(tool).state())
            elif url.path.startswith("/img/"):
                _, _, tool, kf = url.path.split("/")
                view = parse_qs(url.query).get("view", [None])[0]
                session = editor.session(tool)
                kwargs = {"view": view} if view else {}
                image = session.render(int(kf), **kwargs)[:, :, ::-1]
                self._send(encode_png(np.ascontiguousarray(image)),
                           "image/png")
            else:
                self.send_error(404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            parts = self.path.split("?")[0].strip("/").split("/")
            if len(parts) != 3 or parts[0] != "api" or parts[1] not in OPS:
                self.send_error(404)
                return
            tool, op = parts[1], parts[2]
            session = editor.session(tool)
            try:
                if op == "undo":
                    result = session.undo()
                elif op == "redo":
                    result = session.redo()
                elif op == "save":
                    result = session.save()
                else:
                    result = OPS[tool](session, op, body)
                self._json({"ok": True, "result": result})
            except (ValueError, KeyError) as err:
                self._json({"ok": False, "error": str(err)})

    return Handler


def serve(editor: WordTierEditor, port: int = 0):
    """Start the annotator UI server; returns the bound HTTPServer —
    call serve_forever() (blocking) or run it in a thread (tests)."""
    from http.server import ThreadingHTTPServer

    return ThreadingHTTPServer(("127.0.0.1", port), make_handler(editor))
