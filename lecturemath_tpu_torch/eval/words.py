"""Word- and formula-level ground-truth formats: keyframe projections,
word segmentation trees, unique-word groups, and formula CC groups.

These are the file formats of the reference's word/formula annotation
tier (GTProjectionAnnotator -> projections.xml, GTWordAnnotator ->
word_annotations.xml, GTUniqueWordAnnotator -> unique_words.xml,
GTFormulaAnnotator -> formula XML), re-implemented as data classes over
our RegionTree/UniqueCCGroup so every file the reference annotators
write loads here and round-trips byte-compatibly in structure:

  * KeyFrameProjection (reference:
    AccessMath/annotation/keyframe_projection.py:6-197): a per-keyframe
    homography warping the raw/binary into the common board plane, with
    the source/destination polygons and translation offsets the
    annotator edits.
  * KeyFrameWords (keyframe_words.py:8-87): a projection + a word
    SegmentationTree over the warped inverted binary; words are the
    tree's leaf enclosing bboxes (margin 3).
  * UniqueWordGroup (unique_word_group.py:3-196): words chained across
    contiguous keyframes; XML load reconciles the file against the
    current segmentation (missing/added words logged, partial groups
    truncated, orphan words get singleton groups) exactly like the
    reference loader.
  * FormulaCCs (formula_ccs.py:5-154): LaTeX-tagged sets of UniqueCCGroup
    chains with visibility ranges.

The projections need no OpenCV: ``utils/image.py`` computes the homography
(``cv2.findHomography``), the warps (``cv2.warpPerspective``, bit for bit)
and the point transforms (``cv2.perspectiveTransform``).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.region_tree import RegionTree
from ..utils.image import (find_homography, perspective_transform,
                           warp_perspective)
from .annotation import UniqueCCGroup


# ------------------------------------------------------------- projection

class KeyFrameProjection:
    """Homography from a keyframe into the common board plane
    (reference: keyframe_projection.py:6-197)."""

    def __init__(self, width: int, height: int, src_points: np.ndarray,
                 base_dst_points: np.ndarray, delta_x: float, delta_y: float,
                 matrix: np.ndarray, inv_matrix: Optional[np.ndarray] = None):
        self.width = int(width)
        self.height = int(height)
        self.src_points = np.asarray(src_points, np.float64)
        self.base_dst_points = np.asarray(base_dst_points, np.float64)
        self.delta_x = delta_x
        self.delta_y = delta_y
        self.H = np.asarray(matrix, np.float64)
        self.inv_H = (np.linalg.inv(self.H) if inv_matrix is None
                      else np.asarray(inv_matrix, np.float64))

    # -- geometry ---------------------------------------------------------

    def copy(self) -> "KeyFrameProjection":
        return KeyFrameProjection(self.width, self.height,
                                  self.src_points.copy(),
                                  self.base_dst_points.copy(),
                                  self.delta_x, self.delta_y,
                                  self.H.copy(), self.inv_H.copy())

    def dst_points(self) -> np.ndarray:
        """Destination polygon with the translation offset applied."""
        return self.base_dst_points + np.array([[self.delta_x,
                                                 self.delta_y]])

    def update_from_points(self, src_points, base_dst_points,
                           delta_x: float = 0.0, delta_y: float = 0.0
                           ) -> None:
        """Recompute H from the edited polygon pair (the annotator's
        update path, gt_projection_annotator.py:633-704)."""
        src = np.asarray(src_points, np.float64)
        base_dst = np.asarray(base_dst_points, np.float64)
        dst = (base_dst + np.array([[delta_x, delta_y]])).astype(np.float64)
        # validate BEFORE assigning: a (near-)collinear quad yields a None
        # or singular homography, and a partial assignment would leave the
        # projection with a corrupt H next to a stale inv_H
        H = find_homography(src, dst)
        if H is None:
            raise ValueError("degenerate projection quad (no homography)")
        try:
            inv_H = np.linalg.inv(H)
        except np.linalg.LinAlgError:
            raise ValueError("degenerate projection quad (singular H)")
        self.src_points = src
        self.base_dst_points = base_dst
        self.delta_x = delta_x
        self.delta_y = delta_y
        self.H = H
        self.inv_H = inv_H

    def warp_keyframe(self, raw_image: np.ndarray, binary_image: np.ndarray,
                      object_mask: Optional[np.ndarray] = None):
        """Warp a keyframe's raw/binary (and optional bool mask) into the
        board plane (reference warpKeyFrame, keyframe_projection.py:33-49;
        binary border fills white = background)."""
        size = (self.width, self.height)
        proj_rgb = warp_perspective(raw_image, self.H, size)
        proj_bin = warp_perspective(binary_image, self.H, size,
                                    border_value=255)
        if object_mask is None:
            return proj_rgb, proj_bin
        mask = warp_perspective(object_mask.astype(np.uint8) * 255,
                                self.H, size) > 0
        return proj_rgb, proj_bin, mask

    def warp_binary(self, binary_image: np.ndarray) -> np.ndarray:
        """Warp only the binary into the board plane (white border =
        background) — the word tier never needs the raw warp at load."""
        return warp_perspective(binary_image, self.H,
                                (self.width, self.height), border_value=255)

    def warp_points(self, points: np.ndarray,
                    inverse: bool = False) -> np.ndarray:
        matrix = self.inv_H if inverse else self.H
        pts = np.asarray(points, np.float64).reshape(-1, 2)
        return perspective_transform(pts, matrix)

    # -- XML --------------------------------------------------------------

    @staticmethod
    def _points_xml(parent: ET.Element, tag: str,
                    points: np.ndarray) -> None:
        node = ET.SubElement(parent, tag)
        for x, y in points:
            point = ET.SubElement(node, "Point")
            ET.SubElement(point, "X").text = str(x)
            ET.SubElement(point, "Y").text = str(y)

    def to_xml_element(self) -> ET.Element:
        node = ET.Element("KeyFrameProjection")
        ET.SubElement(node, "Width").text = str(self.width)
        ET.SubElement(node, "Height").text = str(self.height)
        self._points_xml(node, "SourcePoints", self.src_points)
        self._points_xml(node, "BaseDestinationPoints", self.base_dst_points)
        ET.SubElement(node, "DeltaX").text = str(self.delta_x)
        ET.SubElement(node, "DeltaY").text = str(self.delta_y)
        projection = ET.SubElement(node, "Projection")
        for row in range(3):
            for col in range(3):
                ET.SubElement(projection,
                              f"Value_{row}_{col}").text = \
                    str(self.H[row][col])
        return node

    @staticmethod
    def _points_from_xml(node: ET.Element) -> np.ndarray:
        return np.asarray([[float(p.findtext("X")), float(p.findtext("Y"))]
                           for p in node.findall("Point")], np.float64)

    @classmethod
    def from_xml(cls, node: ET.Element) -> "KeyFrameProjection":
        matrix = np.zeros((3, 3), np.float64)
        projection = node.find("Projection")
        for row in range(3):
            for col in range(3):
                matrix[row, col] = float(
                    projection.findtext(f"Value_{row}_{col}"))
        return cls(int(node.findtext("Width")),
                   int(node.findtext("Height")),
                   cls._points_from_xml(node.find("SourcePoints")),
                   cls._points_from_xml(node.find("BaseDestinationPoints")),
                   # the reference round-trips deltas through int()
                   int(float(node.findtext("DeltaX"))),
                   int(float(node.findtext("DeltaY"))),
                   matrix)

    @classmethod
    def create_default(cls, width: int, height: int,
                       offset: float = 10.0) -> "KeyFrameProjection":
        points = np.asarray([[offset, offset], [width - offset, offset],
                             [width - offset, height - offset],
                             [offset, height - offset]], np.float64)
        return cls(width, height, points.copy(), points.copy(), 0, 0,
                   np.identity(3))


def save_projections(path: str,
                     projections: Sequence[KeyFrameProjection]) -> None:
    """projections.xml: <ProjectionAnnotations><VideoKeyFramesProjections>
    (reference: gt_projection_annotator.py:757-767)."""
    root = ET.Element("ProjectionAnnotations")
    group = ET.SubElement(root, "VideoKeyFramesProjections")
    for projection in projections:
        group.append(projection.to_xml_element())
    with open(path, "w") as f:
        f.write(ET.tostring(root, encoding="unicode"))


def load_projections(path: str) -> List[KeyFrameProjection]:
    root = ET.parse(path).getroot()
    group = root.find("VideoKeyFramesProjections")
    return [KeyFrameProjection.from_xml(node)
            for node in group.findall("KeyFrameProjection")]


# ------------------------------------------------------------------ words

WORD_BBOX_MARGIN = 3   # reference: segmentation_tree.py:406 leaf margin


def tree_word_bboxes(tree: RegionTree) -> List[Tuple[int, int, int, int]]:
    """Leaf enclosing bboxes = the word boxes (reference
    collect_all_leaves, segmentation_tree.py:399-408)."""
    words = []
    for leaf in tree.leaves():
        bbox = leaf.ccs.enclosing_bbox(leaf.height, leaf.width,
                                       WORD_BBOX_MARGIN)
        if bbox is not None:
            words.append(tuple(int(v) for v in bbox))
    return words


def word_id(word: Sequence[int]) -> str:
    """'x-y-w-h' (reference UniqueWordGroup.wordID)."""
    return "-".join(str(int(dim)) for dim in word)


class KeyFrameWords:
    """One keyframe's word annotation: a projection into the board plane
    plus a word segmentation tree over the warped inverted binary
    (reference: keyframe_words.py:8-87)."""

    def __init__(self, keyframe, projection: KeyFrameProjection,
                 tree: RegionTree):
        self.keyframe = keyframe          # eval.annotation.KeyframeAnnotation
        self.projection = projection
        self.tree = tree

    def get_words(self) -> List[Tuple[int, int, int, int]]:
        return tree_word_bboxes(self.tree)

    def words_in_region(self, min_x, max_x, min_y, max_y):
        return [(x, y, w, h) for x, y, w, h in self.get_words()
                if min_x <= x and x + w <= max_x
                and min_y <= y and y + h <= max_y]

    def warped(self):
        return self.projection.warp_keyframe(self.keyframe.raw_image,
                                             self.keyframe.binary_image)

    def to_xml_element(self) -> ET.Element:
        node = ET.Element("KeyFrameWords")
        node.append(self.projection.to_xml_element())
        node.append(self.tree.root.to_xml(ET.Element("SegmentationTree")))
        return node

    @classmethod
    def from_xml(cls, node: ET.Element, keyframe) -> "KeyFrameWords":
        projection = KeyFrameProjection.from_xml(
            node.find("KeyFrameProjection"))
        inverted = warped_inverted_binary(keyframe, projection)
        tree = RegionTree.from_xml_string(
            ET.tostring(node.find("SegmentationTree"), encoding="unicode"),
            inverted)
        return cls(keyframe, projection, tree)

    @classmethod
    def create_default(cls, keyframe,
                       proj_offset: float = 10.0) -> "KeyFrameWords":
        height, width = keyframe.raw_image.shape[:2]
        binary = keyframe.binary_image
        inverted = 255 - (binary[:, :, 0] if binary.ndim == 3 else binary)
        return cls(keyframe,
                   KeyFrameProjection.create_default(width, height,
                                                     proj_offset),
                   RegionTree.from_binary(inverted))


def warped_inverted_binary(keyframe, projection) -> np.ndarray:
    """Inverted binary in the projected board plane — the space the word
    tier lives in (reference gt_word_annotator.py:76-134 replaces the
    keyframe raw/binary with their projection-warped versions at load, so
    segmentation trees, clicks, and word boxes are all in warped space).
    Identity for default projections. Single definition for every word-
    tier loader/editor."""
    proj_bin = projection.warp_binary(keyframe.binary_image)
    return 255 - (proj_bin[:, :, 0] if proj_bin.ndim == 3 else proj_bin)


def save_word_annotations(path: str, all_words: Sequence[KeyFrameWords],
                          trees_only: bool = False) -> None:
    """word_annotations.xml: <WordAnnotations><VideoKeyFramesWords>.

    Two reference schemas exist: the rich one embedding each keyframe's
    projection (KeyFramesWordsToXML, keyframe_words.py:80-87) and the
    trees-only one the GTWordAnnotator tool actually writes
    (gt_word_annotator.py:712-724, SegmentationTreesToXML) — projections
    then live in projections.xml. ``trees_only=True`` emits the latter.
    """
    root = ET.Element("WordAnnotations")
    group = ET.SubElement(root, "VideoKeyFramesWords")
    for words in all_words:
        if trees_only:
            group.append(words.tree.root.to_xml(
                ET.Element("SegmentationTree")))
        else:
            group.append(words.to_xml_element())
    with open(path, "w") as f:
        f.write(ET.tostring(root, encoding="unicode"))


def load_word_annotations(path: str, keyframes,
                          projections=None) -> List[KeyFrameWords]:
    """Load either word_annotations.xml schema (auto-detected by child
    tag). Tree pixel backing is the projection-WARPED inverted binary —
    the space the reference annotator keeps the whole word tier in
    (gt_word_annotator.py:76-134 replaces raw/binary with warped versions
    at load, so the trees it saves at :114-124 are over warped pixels;
    identity for default projections)."""
    root = ET.parse(path).getroot()
    group = root.find("VideoKeyFramesWords")
    out = []
    for idx, node in enumerate(group):
        keyframe = keyframes[idx]
        if node.tag == "KeyFrameWords":
            out.append(KeyFrameWords.from_xml(node, keyframe))
            continue
        if projections is not None and idx < len(projections):
            projection = projections[idx]
        else:
            height, width = keyframe.raw_image.shape[:2]
            projection = KeyFrameProjection.create_default(width, height)
        inverted = warped_inverted_binary(keyframe, projection)
        tree = RegionTree.from_xml_string(
            ET.tostring(node, encoding="unicode"), inverted)
        out.append(KeyFrameWords(keyframe, projection, tree))
    return out


# ----------------------------------------------------------- unique words

class UniqueWordGroup:
    """A word tracked across contiguous keyframes
    (reference: unique_word_group.py:3-196)."""

    def __init__(self, start_word, start_frame: int):
        self.words_refs = [start_word]
        self.start_frame = int(start_frame)

    def last_frame(self) -> int:
        return self.start_frame + len(self.words_refs) - 1

    def str_id(self) -> str:
        return f"{self.start_frame}-{word_id(self.words_refs[0])}"

    @staticmethod
    def copy(original: "UniqueWordGroup") -> "UniqueWordGroup":
        group = UniqueWordGroup(original.words_refs[0],
                                original.start_frame)
        group.words_refs = list(original.words_refs)
        return group

    @staticmethod
    def split(original: "UniqueWordGroup",
              split_frame: int) -> Optional["UniqueWordGroup"]:
        offset = split_frame - original.start_frame
        if offset <= 0 or offset >= len(original.words_refs):
            return None
        group = UniqueWordGroup(original.words_refs[offset], split_frame)
        group.words_refs = original.words_refs[offset:]
        original.words_refs = original.words_refs[:offset]
        return group


def unique_words_to_xml(all_kf_words: Sequence[KeyFrameWords],
                        groups: Sequence[UniqueWordGroup]) -> str:
    """unique_words.xml body (reference GenerateGroupsXML,
    unique_word_group.py:141-170): the full per-keyframe word-id sets,
    then the group chains."""
    root = ET.Element("UniqueWords")
    video = ET.SubElement(root, "VideoWords")
    for kf_words in all_kf_words:
        kf_node = ET.SubElement(video, "KeyFrameWords")
        words_node = ET.SubElement(kf_node, "Words")
        for word in _words_of(kf_words):
            ET.SubElement(words_node, "Word").text = word_id(word)
    groups_node = ET.SubElement(root, "WordGroups")
    for group in groups:
        group_node = ET.SubElement(groups_node, "WordGroup")
        ET.SubElement(group_node, "Start").text = str(group.start_frame)
        ET.SubElement(group_node, "End").text = str(group.last_frame())
        words_node = ET.SubElement(group_node, "Words")
        for word in group.words_refs:
            ET.SubElement(words_node, "Word").text = word_id(word)
    return ET.tostring(root, encoding="unicode")


def save_unique_words(path: str, all_kf_words, groups) -> None:
    with open(path, "w") as f:
        f.write(unique_words_to_xml(all_kf_words, groups))


def _words_of(kf_words) -> List[tuple]:
    """Accept either KeyFrameWords or a plain list of (x, y, w, h)."""
    if hasattr(kf_words, "get_words"):
        return kf_words.get_words()
    return list(kf_words)


def unique_words_from_root(root: ET.Element, all_kf_words):
    """Reconcile parsed unique-word XML against the CURRENT word
    segmentation (reference GroupsFromXML, unique_word_group.py:26-139):
    words missing from the segmentation truncate their group, new
    segmentation words get singleton groups. Returns
    (word_group maps per keyframe, groups)."""
    word_group: List[Dict[str, Optional[UniqueWordGroup]]] = []
    word_index: List[Dict[str, tuple]] = []
    for kf_words in all_kf_words:
        ids = {word_id(word): word for word in _words_of(kf_words)}
        word_group.append({wid: None for wid in ids})
        word_index.append(ids)
    groups: List[UniqueWordGroup] = []
    for group_node in root.find("WordGroups").findall("WordGroup"):
        start = int(group_node.findtext("Start").strip())
        valid_ids = []
        for offset, word_node in enumerate(
                group_node.find("Words").findall("Word")):
            wid = word_node.text.strip()
            if (start + offset < len(word_group)
                    and wid in word_group[start + offset]):
                valid_ids.append(wid)
            else:
                break   # segmentation changed: truncate the chain here
        if not valid_ids:
            continue
        group = UniqueWordGroup(word_index[start][valid_ids[0]], start)
        word_group[start][valid_ids[0]] = group
        for offset in range(1, len(valid_ids)):
            group.words_refs.append(
                word_index[start + offset][valid_ids[offset]])
            word_group[start + offset][valid_ids[offset]] = group
        groups.append(group)

    for kf_idx, mapping in enumerate(word_group):   # orphans -> singletons
        for wid, owner in mapping.items():
            if owner is None:
                group = UniqueWordGroup(word_index[kf_idx][wid], kf_idx)
                mapping[wid] = group
                groups.append(group)
    return word_group, groups


def default_word_groups(all_kf_words):
    """Singleton groups for every word (the annotator's no-file default,
    gt_unique_word_annotator.py:128-148)."""
    word_group: List[Dict[str, UniqueWordGroup]] = []
    groups: List[UniqueWordGroup] = []
    for kf_idx, kf_words in enumerate(all_kf_words):
        mapping = {}
        for word in _words_of(kf_words):
            group = UniqueWordGroup(word, kf_idx)
            mapping[word_id(word)] = group
            groups.append(group)
        word_group.append(mapping)
    return word_group, groups


def load_unique_words(path: str, all_kf_words):
    """Load + reconcile unique_words.xml (see unique_words_from_root)."""
    return unique_words_from_root(ET.parse(path).getroot(), all_kf_words)


# -------------------------------------------------------------- formulas

class FormulaCCs:
    """A LaTeX-tagged formula: a set of UniqueCCGroup chains with derived
    frame/visibility ranges (reference: formula_ccs.py:5-154)."""

    def __init__(self, start_groups: Sequence[UniqueCCGroup],
                 latex_tag: str = ""):
        self.groups_refs: List[UniqueCCGroup] = list(start_groups)
        self.latex_tag = latex_tag
        self._update_frames()

    def _update_frames(self) -> None:
        if not self.groups_refs:
            self.first_frame = self.last_frame = None
            self.first_visible = self.last_visible = None
            return
        self.first_frame = min(g.start_frame for g in self.groups_refs)
        self.last_frame = max(g.last_frame() for g in self.groups_refs)
        first_visible = max(g.start_frame for g in self.groups_refs)
        last_visible = min(g.last_frame() for g in self.groups_refs)
        if first_visible > last_visible:   # no common visibility window
            self.first_visible = self.last_visible = None
        else:
            self.first_visible = first_visible
            self.last_visible = last_visible

    def str_id(self) -> str:
        return "/".join(g.str_id() for g in self.groups_refs)

    def add_group(self, group: UniqueCCGroup) -> None:
        if group not in self.groups_refs:
            self.groups_refs.append(group)
            self._update_frames()

    def remove_group(self, group: UniqueCCGroup) -> None:
        self.groups_refs.remove(group)
        self._update_frames()

    def visible_at(self, frame: int) -> bool:
        return (self.first_visible is not None
                and self.first_visible <= frame <= self.last_visible)

    def bounding_box(self):
        """Union bbox over every CC of every member group, returned as
        (min_x, max_x, min_y, max_y) (reference getBoundingBox,
        formula_ccs.py:36-51; None slots from group merges are skipped)."""
        boxes = [(cc.min_x, cc.min_y, cc.max_x, cc.max_y)
                 for group in self.groups_refs
                 for cc in group.cc_refs if cc is not None]
        arr = np.asarray(boxes)
        return (arr[:, 0].min(), arr[:, 2].max(),
                arr[:, 1].min(), arr[:, 3].max())

    def __lt__(self, other: "FormulaCCs") -> bool:
        """Reference ordering (formula_ccs.py:59-76): first-visible frame,
        then top-to-bottom / left-to-right by bounding box."""
        if self.first_visible != other.first_visible:
            return (other.first_visible is None
                    or (self.first_visible is not None
                        and self.first_visible < other.first_visible))
        l_min_x, _, l_min_y, _ = self.bounding_box()
        o_min_x, _, o_min_y, o_max_y = other.bounding_box()
        if l_min_y < o_min_y:
            return True
        if l_min_y > o_max_y:   # reference compares against max_y here
            return False
        return l_min_x < o_min_x


def formulas_to_xml(formulas: Sequence[FormulaCCs]) -> str:
    """<FormulaCCS> body (reference GenerateFormulaXML,
    formula_ccs.py:97-119)."""
    root = ET.Element("FormulaCCS")
    for formula in formulas:
        node = ET.SubElement(root, "Formula")
        ET.SubElement(node, "LatexTag").text = formula.latex_tag
        ET.SubElement(node, "FirstFrame").text = str(formula.first_frame)
        ET.SubElement(node, "LastFrame").text = str(formula.last_frame)
        ET.SubElement(node, "FirstVisible").text = str(formula.first_visible)
        ET.SubElement(node, "LastVisible").text = str(formula.last_visible)
        groups = ET.SubElement(node, "CCGroups")
        for group in formula.groups_refs:
            ET.SubElement(groups, "CCGroup").text = group.str_id()
    return ET.tostring(root, encoding="unicode")


def save_formulas(path: str, formulas: Sequence[FormulaCCs]) -> None:
    with open(path, "w") as f:
        f.write(formulas_to_xml(formulas))


def load_formulas(path: str,
                  unique_groups: Sequence[UniqueCCGroup]
                  ) -> List[FormulaCCs]:
    """Load formulas, dropping member groups that no longer exist in the
    current unique-CC set (reference FormulasFromXML,
    formula_ccs.py:121-154)."""
    by_id = {group.str_id(): group for group in unique_groups}
    root = ET.parse(path).getroot()
    formulas = []
    for node in root.findall("Formula"):
        latex_tag = (node.findtext("LatexTag") or "").strip()
        members = []
        for group_node in node.find("CCGroups").findall("CCGroup"):
            gid = group_node.text.strip()
            if gid in by_id:
                members.append(by_id[gid])
        if members:   # reference crashes on all-members-gone; we drop it
            formulas.append(FormulaCCs(members, latex_tag))
    formulas.sort()
    return formulas
