"""Hierarchical XY-cut region tree over keyframe content.

Recursive whitespace-cut segmentation of a binary keyframe into nested
regions, used by word/region-level annotation workflows. Behavior and XML
schema match the reference SegmentationTree
(reference: AccessMath/preprocessing/content/segmentation_tree.py:9-456):

  * each node holds the CC bboxes fully inside its region
  * cut candidates are zero runs of the region's horizontal/vertical pixel
    profiles; a cut is accepted when its gap exceeds
    max(mean + alpha * std, 3) of the CC widths/heights
  * the widest gap wins, Y cuts preferred on ties

The CC boxes come from ``scipy.ndimage`` in OpenCV's order, so no OpenCV is
needed; the XML is byte-identical to the JAX package's.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import List, Optional

import numpy as np
from scipy import ndimage


class RegionCCs:
    """CC bounding boxes as an int array [N, 5] = x, y, w, h, area."""

    def __init__(self, bboxes: Optional[np.ndarray] = None):
        self.bboxes = (np.zeros((0, 5), dtype=np.int64) if bboxes is None
                       else np.asarray(bboxes, dtype=np.int64).reshape(-1, bboxes.shape[-1]))

    @classmethod
    def from_binary(cls, binary: np.ndarray, connectivity: int = 8) -> "RegionCCs":
        """The stats of ``cv2.connectedComponentsWithStats(binary,
        connectivity, cv2.CV_32S)`` without the background: x, y, w, h and
        area of each component of the nonzero pixels, in OpenCV's order.
        OpenCV's 8-connected labeling scans 2x2 blocks in raster order, so a
        component's rank is that of the first block holding one of its
        pixels; 4-connected components are ranked the same way."""
        binary = np.asarray(binary)
        if connectivity not in (4, 8):
            raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
        structure = (np.ones((3, 3), bool) if connectivity == 8
                     else ndimage.generate_binary_structure(2, 1))
        labels, n_labels = ndimage.label(binary, structure=structure)
        if n_labels == 0:
            return cls()
        ys, xs = np.nonzero(labels)
        owner = labels[ys, xs]
        block = (ys // 2) * ((binary.shape[1] + 1) // 2) + xs // 2
        first = np.full(n_labels + 1, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(first, owner, block)
        areas = np.bincount(owner, minlength=n_labels + 1)
        stats = np.array([[cols.start, rows.start, cols.stop - cols.start,
                           rows.stop - rows.start, areas[k + 1]]
                          for k, (rows, cols) in enumerate(
                              ndimage.find_objects(labels))], np.int64)
        return cls(stats[np.argsort(first[1:], kind="stable")])

    def __len__(self) -> int:
        return len(self.bboxes)

    def filtered_to(self, x_limits, y_limits) -> "RegionCCs":
        """Keep bboxes fully inside the region."""
        if len(self.bboxes) == 0:
            return RegionCCs()
        x1 = self.bboxes[:, 0]
        y1 = self.bboxes[:, 1]
        x2 = x1 + self.bboxes[:, 2]
        y2 = y1 + self.bboxes[:, 3]
        keep = ((x1 >= x_limits[0]) & (x2 <= x_limits[1]) &
                (y1 >= y_limits[0]) & (y2 <= y_limits[1]))
        return RegionCCs(self.bboxes[keep])

    def enclosing_bbox(self, height: int, width: int, margin: int = 0):
        if len(self.bboxes) == 0:
            return None
        x1 = self.bboxes[:, 0].min() - margin
        y1 = self.bboxes[:, 1].min() - margin
        x2 = (self.bboxes[:, 0] + self.bboxes[:, 2]).max() + margin
        y2 = (self.bboxes[:, 1] + self.bboxes[:, 3]).max() + margin
        x1, y1 = max(x1, 0), max(y1, 0)
        x2, y2 = min(x2, width), min(y2, height)
        return (x1, y1, x2 - x1, y2 - y1)

    def to_xml(self, parent: ET.Element) -> None:
        for bbox in self.bboxes:
            cc = ET.SubElement(parent, "CC")
            for tag, value in zip(("x", "y", "w", "h", "a"), bbox):
                ET.SubElement(cc, tag).text = str(int(value))

    @classmethod
    def from_xml(cls, node: ET.Element) -> "RegionCCs":
        rows = []
        for cc in node.iter("CC"):
            rows.append([int(cc.findtext(tag)) for tag in
                         ("x", "y", "w", "h", "a")])
        return cls(np.asarray(rows, dtype=np.int64).reshape(-1, 5))


def _zero_runs(profile: np.ndarray) -> np.ndarray:
    """[start, end) ranges where the profile is zero."""
    is_zero = np.concatenate(([0], (profile == 0).astype(np.int8), [0]))
    edges = np.abs(np.diff(is_zero))
    return np.where(edges == 1)[0].reshape(-1, 2)


def _cut_thresholds(bboxes: np.ndarray, alpha_x: float, alpha_y: float):
    widths = bboxes[:, 2]
    heights = bboxes[:, 3]
    x_threshold = max(widths.mean() + alpha_x * widths.std(), 3)
    y_threshold = max(heights.mean() + alpha_y * heights.std(), 3)
    return x_threshold, y_threshold


class RegionNode:
    def __init__(self, image: Optional[np.ndarray], ccs: RegionCCs,
                 x_limits, y_limits, height: int, width: int):
        self.image = image
        self.x_limits = (int(x_limits[0]), int(x_limits[1]))
        self.y_limits = (int(y_limits[0]), int(y_limits[1]))
        self.height = height
        self.width = width
        self.ccs = ccs.filtered_to(self.x_limits, self.y_limits)
        self.is_leaf = True
        self.left: Optional[RegionNode] = None
        self.right: Optional[RegionNode] = None
        self.parent: Optional[RegionNode] = None

        self.x_intervals = np.zeros((0, 2), dtype=np.int64)
        self.y_intervals = np.zeros((0, 2), dtype=np.int64)
        if image is not None:
            self._compute_cut_intervals()

    def _compute_cut_intervals(self) -> None:
        local = self.image[self.y_limits[0]:self.y_limits[1],
                           self.x_limits[0]:self.x_limits[1]]
        self.x_intervals = _zero_runs(local.astype(np.float32).sum(axis=0))
        self.y_intervals = _zero_runs(local.astype(np.float32).sum(axis=1))
        self.x_intervals = self.x_intervals + self.x_limits[0]
        self.y_intervals = self.y_intervals + self.y_limits[0]

    def _child(self, x_limits, y_limits) -> "RegionNode":
        child = RegionNode(self.image, self.ccs, x_limits, y_limits,
                           self.height, self.width)
        child.parent = self
        return child

    def segment(self, alpha_x: float, alpha_y: float) -> bool:
        """Apply the best whitespace cut; returns whether a cut happened."""
        if len(self.ccs) == 0:
            return False
        if len(self.x_intervals) == 0 and len(self.y_intervals) == 0:
            return False

        x_threshold, y_threshold = _cut_thresholds(self.ccs.bboxes,
                                                   alpha_x, alpha_y)
        best_width = 0
        if len(self.x_intervals):
            widths = self.x_intervals[:, 1] - self.x_intervals[:, 0]
            if widths.max() >= x_threshold:
                best_width = widths.max()
                best_x_cut = self.x_intervals[int(np.argmax(widths))]
        best_height = 0
        if len(self.y_intervals):
            heights = self.y_intervals[:, 1] - self.y_intervals[:, 0]
            if heights.max() >= y_threshold:
                best_height = heights.max()
                best_y_cut = self.y_intervals[int(np.argmax(heights))]

        if best_width == 0 and best_height == 0:
            return False

        self.is_leaf = False
        if best_height >= best_width:
            y1, y2 = best_y_cut
            self.left = self._child(self.x_limits, (self.y_limits[0], y1))
            self.right = self._child(self.x_limits, (y2, self.y_limits[1]))
        else:
            x1, x2 = best_x_cut
            self.left = self._child((self.x_limits[0], x1), self.y_limits)
            self.right = self._child((x2, self.x_limits[1]), self.y_limits)
        return True

    def force_segment_y(self, y: int) -> None:
        self.is_leaf = False
        self.left = self._child(self.x_limits, (self.y_limits[0], int(y)))
        self.right = self._child(self.x_limits, (int(y) + 1, self.y_limits[1]))

    def force_segment_x(self, x: int) -> None:
        self.is_leaf = False
        self.left = self._child((self.x_limits[0], int(x)), self.y_limits)
        self.right = self._child((int(x) + 1, self.x_limits[1]), self.y_limits)

    # ---------------------------------------------------------------- XML

    def to_xml(self, parent: Optional[ET.Element] = None) -> ET.Element:
        node = ET.Element("root") if parent is None else parent
        self.ccs.to_xml(ET.SubElement(node, "CCs"))
        x_limits = ET.SubElement(node, "X_Limits")
        ET.SubElement(x_limits, "x1").text = str(self.x_limits[0])
        ET.SubElement(x_limits, "x2").text = str(self.x_limits[1])
        y_limits = ET.SubElement(node, "Y_Limits")
        ET.SubElement(y_limits, "y1").text = str(self.y_limits[0])
        ET.SubElement(y_limits, "y2").text = str(self.y_limits[1])
        ET.SubElement(node, "H").text = str(self.height)
        ET.SubElement(node, "W").text = str(self.width)
        ET.SubElement(node, "is_leaf").text = str(self.is_leaf)
        if self.left is not None:
            self.left.to_xml(ET.SubElement(node, "left"))
        if self.right is not None:
            self.right.to_xml(ET.SubElement(node, "right"))
        return node

    @classmethod
    def from_xml(cls, node: ET.Element,
                 image: Optional[np.ndarray]) -> "RegionNode":
        ccs_node = node.find("CCs")
        ccs = (RegionCCs.from_xml(ccs_node) if ccs_node is not None
               else RegionCCs())
        xl = node.find("X_Limits")
        yl = node.find("Y_Limits")
        out = cls(image, ccs,
                  (int(xl.findtext("x1")), int(xl.findtext("x2"))),
                  (int(yl.findtext("y1")), int(yl.findtext("y2"))),
                  int(node.findtext("H")), int(node.findtext("W")))
        out.ccs = ccs  # keep the serialized set verbatim
        out.is_leaf = node.findtext("is_leaf") == "True"
        if not out.is_leaf:
            out.left = cls.from_xml(node.find("left"), image)
            out.left.parent = out
            out.right = cls.from_xml(node.find("right"), image)
            out.right.parent = out
        return out


class RegionTree:
    def __init__(self, root: RegionNode):
        self.root = root
        self.root.parent = self.root

    @classmethod
    def from_binary(cls, binary: np.ndarray) -> "RegionTree":
        height, width = binary.shape
        ccs = RegionCCs.from_binary(binary)
        return cls(RegionNode(binary, ccs, (0, width), (0, height),
                              height, width))

    def segment_recursive(self, alpha_x: float = -1.25,
                          alpha_y: float = -3.0) -> None:
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node.segment(alpha_x, alpha_y):
                stack.append(node.left)
                stack.append(node.right)

    def leaves(self) -> List[RegionNode]:
        out = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node.is_leaf:
                out.append(node)
            else:
                stack.extend([child for child in (node.left, node.right)
                              if child is not None])
        return out

    def find_region(self, x: int, y: int,
                    node: Optional[RegionNode] = None) -> Optional[RegionNode]:
        node = node or self.root
        if not (node.x_limits[0] <= x <= node.x_limits[1] and
                node.y_limits[0] <= y <= node.y_limits[1]):
            return None
        if node.is_leaf:
            return node
        for child in (node.left, node.right):
            found = self.find_region(x, y, child) if child else None
            if found is not None:
                return found
        return node

    def to_xml_string(self) -> str:
        return ET.tostring(self.root.to_xml(), encoding="unicode")

    @classmethod
    def from_xml_string(cls, xml_string: str,
                        image: Optional[np.ndarray] = None) -> "RegionTree":
        return cls(RegionNode.from_xml(ET.fromstring(xml_string), image))
