"""Full-video ground-truth annotation: segment split points, per-segment
keyframe indices, and polygon video objects with keyframe-interpolated
location timelines.

XML round-trip compatible with the reference LectureAnnotation
(reference: AccessMath/annotation/lecture_annotation.py:11-379,
video_object.py:7-200, video_object_location.py:5-110, drawing_info.py).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


def polygon_area(points: np.ndarray) -> float:
    """Shoelace area of a simple polygon [N, 2]."""
    x, y = points[:, 0], points[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _is_convex(points: np.ndarray) -> bool:
    edges = np.roll(points, -1, axis=0) - points
    nxt = np.roll(edges, -1, axis=0)
    cross = edges[:, 0] * nxt[:, 1] - edges[:, 1] * nxt[:, 0]
    return not ((cross > 1e-12).any() and (cross < -1e-12).any())


def _orient_ccw(points: np.ndarray) -> np.ndarray:
    x, y = points[:, 0], points[:, 1]
    signed = 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    return points[::-1] if signed < 0 else points


def _clip_convex(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman: clip a simple polygon by a CONVEX polygon."""
    clip = _orient_ccw(np.asarray(clip, dtype=np.float64))
    out = [tuple(p) for p in np.asarray(subject, dtype=np.float64)]
    for i in range(len(clip)):
        ax, ay = clip[i]
        bx, by = clip[(i + 1) % len(clip)]
        if not out:
            break
        cur_pts, out = out, []
        for j, cur in enumerate(cur_pts):
            prev = cur_pts[j - 1]
            cur_side = (bx - ax) * (cur[1] - ay) - (by - ay) * (cur[0] - ax)
            prev_side = (bx - ax) * (prev[1] - ay) - (by - ay) * (prev[0] - ax)
            if cur_side >= 0:
                if prev_side < 0:
                    out.append(_edge_cross(prev, cur, (ax, ay), (bx, by)))
                out.append(cur)
            elif prev_side >= 0:
                out.append(_edge_cross(prev, cur, (ax, ay), (bx, by)))
    return np.array(out, dtype=np.float64).reshape(-1, 2)


def _edge_cross(p1, p2, a, b):
    d1 = (b[0] - a[0]) * (p1[1] - a[1]) - (b[1] - a[1]) * (p1[0] - a[0])
    d2 = (b[0] - a[0]) * (p2[1] - a[1]) - (b[1] - a[1]) * (p2[0] - a[0])
    t = d1 / (d1 - d2)
    return (p1[0] + t * (p2[0] - p1[0]), p1[1] + t * (p2[1] - p1[1]))


def points_in_polygon(polygon: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Even-odd inclusion of points [M, 2] in a closed polygon [N, 2]:
    ``matplotlib.path.Path(polygon).contains_points(points)``, by the same
    crossing test in the same float64 arithmetic, so points on an edge or
    a vertex fall on the same side as there. Fewer than 3 vertices
    contain nothing, as in matplotlib."""
    polygon = np.asarray(polygon, dtype=np.float64)
    points = np.asarray(points, dtype=np.float64)
    inside = np.zeros(len(points), dtype=bool)
    if len(polygon) < 3:
        return inside
    tx, ty = points[:, 0], points[:, 1]
    for (x0, y0), (x1, y1) in zip(polygon, np.roll(polygon, -1, axis=0)):
        above = y1 >= ty
        crosses = (y0 >= ty) != above
        hit = ((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == above
        inside ^= crosses & hit
    return inside


def _raster_intersection_area(p: np.ndarray, q: np.ndarray) -> float:
    """Pixel-center-sampling fallback for non-convex x non-convex:
    unbiased (no boundary inflation), resolution adapted to the overlap
    bbox so the sample count stays ~2M regardless of polygon size."""
    lo = np.maximum(p.min(axis=0), q.min(axis=0))
    hi = np.minimum(p.max(axis=0), q.max(axis=0))
    extent = hi - lo
    if (extent <= 0).any():
        return 0.0
    scale = float(np.clip(np.sqrt(2e6 / (extent[0] * extent[1])), 4, 256))
    nx, ny = (np.ceil(extent * scale).astype(np.int64) + 1)
    xs = lo[0] + (np.arange(nx) + 0.5) / scale
    ys = lo[1] + (np.arange(ny) + 0.5) / scale
    grid_x, grid_y = np.meshgrid(xs, ys)
    pts = np.column_stack([grid_x.ravel(), grid_y.ravel()])
    inside = points_in_polygon(p, pts) & points_in_polygon(q, pts)
    return float(np.count_nonzero(inside)) / (scale * scale)


def polygon_intersection_area(p: np.ndarray, q: np.ndarray) -> float:
    """Area of the intersection of two simple polygons. Exact when either
    is convex (the common case: annotation boxes are rects/quads);
    rasterized estimate otherwise (reference uses shapely, which is not
    in this image — video_object_location.py:54-56)."""
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    if len(p) < 3 or len(q) < 3:
        return 0.0
    if _is_convex(q):
        clipped = _clip_convex(p, q)
        return polygon_area(clipped) if len(clipped) >= 3 else 0.0
    if _is_convex(p):
        return polygon_intersection_area(q, p)
    return _raster_intersection_area(p, q)


def expand_box_points(polygon_points) -> np.ndarray:
    """Normalize editor-style 2-corner boxes to 4-corner polygons.

    The reference GUI always stores >=3-vertex polygons; our annotation
    editor's box tool sends two opposite corners. Zero-area 2-point
    polygons break every area/intersection computation downstream, so
    expand them at ingress."""
    points = np.asarray(polygon_points, dtype=np.float64)
    if points.shape == (2, 2):
        (x0, y0), (x1, y1) = points
        return np.asarray([[x0, y0], [x1, y0], [x1, y1], [x0, y1]],
                          dtype=np.float64)
    return points


@dataclass
class ObjectLocation:
    visible: bool
    frame: int
    abs_time: float
    polygon_points: np.ndarray  # float [N, 2]
    label: Optional[str] = None

    def area(self) -> float:
        """(reference: video_object_location.py:51-52)."""
        return polygon_area(self.polygon_points)

    def intersection_area(self, other: "ObjectLocation") -> float:
        """(reference: video_object_location.py:54-56)."""
        return polygon_intersection_area(self.polygon_points,
                                         other.polygon_points)

    def intersection_percentage(self, other: "ObjectLocation") -> float:
        """Fraction of THIS polygon's area covered by `other`
        (reference: video_object_location.py:58-62). Zero-area polygons
        (degenerate input) yield 0.0, not NaN — a NaN here silently
        fails every <= occlusion comparison downstream."""
        area = self.area()
        return self.intersection_area(other) / area if area > 0 else 0.0

    def iou(self, other: "ObjectLocation") -> float:
        """(reference: video_object_location.py:64-70)."""
        inter = self.intersection_area(other)
        union = self.area() + other.area() - inter
        return inter / union if union > 0 else 0.0

    def get_polygon_points(self) -> List[Tuple[float, float]]:
        """(reference: video_object_location.py:78-79)."""
        return [(x, y) for x, y in self.polygon_points]

    @staticmethod
    def interpolate(loc1: "ObjectLocation", loc2: "ObjectLocation",
                    frame: int) -> "ObjectLocation":
        """Linear interpolation between keyframe locations
        (reference: VideoObjectLocation.interpolate)."""
        if frame <= loc1.frame:
            return loc1
        if frame >= loc2.frame:
            return loc2
        if len(loc1.polygon_points) != len(loc2.polygon_points):
            # mismatched vertex counts cannot lerp — hold the earlier
            # keypose (nearest-before), like a step function
            return ObjectLocation(loc1.visible, frame, loc1.abs_time,
                                  loc1.polygon_points, loc1.label)
        w = (frame - loc1.frame) / float(loc2.frame - loc1.frame)
        return ObjectLocation(
            loc1.visible, frame,
            loc1.abs_time * (1.0 - w) + loc2.abs_time * w,
            loc1.polygon_points * (1.0 - w) + loc2.polygon_points * w,
            loc1.label)

    def to_xml(self, indent: str = "") -> str:
        lines = [f"{indent}<VideoObjectLocation>",
                 f"{indent}    <Visible>{1 if self.visible else 0}</Visible>",
                 f"{indent}    <Frame>{self.frame}</Frame>",
                 f"{indent}    <AbsTime>{self.abs_time}</AbsTime>"]
        if self.label is not None:
            lines.append(f"{indent}    <Label>{self.label}</Label>")
        lines.append(f"{indent}    <Polygon>")
        for x, y in self.polygon_points:
            lines.append(f"{indent}        <Point>")
            lines.append(f"{indent}            <X>{x}</X>")
            lines.append(f"{indent}            <Y>{y}</Y>")
            lines.append(f"{indent}        </Point>")
        lines.append(f"{indent}    </Polygon>")
        lines.append(f"{indent}</VideoObjectLocation>")
        return "\n".join(lines) + "\n"

    @staticmethod
    def from_xml(node: ET.Element) -> "ObjectLocation":
        points = [[float(p.findtext("X")), float(p.findtext("Y"))]
                  for p in node.find("Polygon").findall("Point")]
        return ObjectLocation(
            visible=node.findtext("Visible", "1").strip() == "1",
            frame=int(node.findtext("Frame")),
            abs_time=float(node.findtext("AbsTime", "0")),
            # 2-point legacy boxes (written by early versions of our
            # editor) normalize to the reference's 4-corner convention so
            # pose interpolation never mixes vertex counts
            polygon_points=expand_box_points(points),
            label=node.findtext("Label"))


class TimelineObject:
    """A polygon object tracked over the video via sparse keyframe
    locations; queries interpolate between them
    (reference: VideoObject.get_location_at, video_object.py:101-130)."""

    SHAPE_ALIGNED_RECTANGLE = 0
    SHAPE_QUADRILATERAL = 1
    SHAPE_POLYGON = 2

    def __init__(self, object_id: str, name: str, shape_type: int):
        self.id = object_id
        self.name = name
        self.shape_type = shape_type
        self.locations: List[ObjectLocation] = []

    def first_frame(self) -> int:
        return self.locations[0].frame

    def last_frame(self) -> int:
        return self.locations[-1].frame

    def _find_index(self, frame: int) -> int:
        frames = [loc.frame for loc in self.locations]
        return int(np.searchsorted(frames, frame, side="left"))

    def set_location_at(self, frame: int, abs_time: float, visible: bool,
                        polygon_points) -> bool:
        idx = self._find_index(frame)
        points = expand_box_points(polygon_points)
        if idx < len(self.locations) and self.locations[idx].frame == frame:
            self.locations[idx].visible = visible
            # fresh array, not slice-assign: the new pose may have a
            # different vertex count than the old one
            self.locations[idx].polygon_points = points
            self.locations[idx].abs_time = abs_time
            return False
        label = self.locations[idx - 1].label if idx >= 1 else None
        self.locations.insert(idx, ObjectLocation(visible, frame, abs_time,
                                                  points, label))
        return True

    def del_location_at(self, frame: int) -> bool:
        idx = self._find_index(frame)
        if idx < len(self.locations) and self.locations[idx].frame == frame:
            del self.locations[idx]
            return True
        return False

    def get_location_at(self, frame: int, out_range: bool,
                        interpolate: bool = True) -> Optional[ObjectLocation]:
        if not self.locations:
            raise ValueError("object has no locations")
        idx = self._find_index(frame)
        if idx < len(self.locations) and self.locations[idx].frame == frame:
            return self.locations[idx]
        if idx == 0 or idx >= len(self.locations):
            if not out_range:
                return None
            return self.locations[0] if idx == 0 else self.locations[-1]
        if interpolate:
            return ObjectLocation.interpolate(self.locations[idx - 1],
                                              self.locations[idx], frame)
        return self.locations[idx - 1]

    def to_xml(self) -> str:
        lines = ["  <VideoObject>",
                 f"    <Id>{self.id}</Id>",
                 f"    <Name>{self.name}</Name>",
                 f"    <Shape>{self.shape_type}</Shape>",
                 "    <VideoObjectLocations>"]
        body = "".join(loc.to_xml("        ") for loc in self.locations)
        tail = ["    </VideoObjectLocations>", "  </VideoObject>"]
        return "\n".join(lines) + "\n" + body + "\n".join(tail) + "\n"

    @staticmethod
    def from_xml(node: ET.Element) -> "TimelineObject":
        obj = TimelineObject(node.findtext("Id"), node.findtext("Name"),
                             int(node.findtext("Shape")))
        locations_node = node.find("VideoObjectLocations")
        if locations_node is not None:
            for loc_node in locations_node.findall("VideoObjectLocation"):
                obj.locations.append(ObjectLocation.from_xml(loc_node))
        obj.locations.sort(key=lambda loc: loc.frame)
        return obj


@dataclass
class DrawingInfo:
    """Annotation-GUI viewport geometry kept for round-trip fidelity
    (reference: drawing_info.py)."""
    canvas_bbox: Tuple[float, float, float, float] = (0, 0, 0, 0)
    player_control_bbox: Tuple[float, float, float, float] = (0, 0, 0, 0)
    player_render_bbox: Tuple[float, float, float, float] = (0, 0, 1, 1)

    @staticmethod
    def from_xml(root: ET.Element) -> "DrawingInfo":
        """Reads the reference schema (Canvas + Player/ControlArea +
        Player/RenderArea — drawing_info.py:113-129) and, for files saved
        by earlier versions of this package, the flat
        PlayerControl/PlayerRender tags."""
        node = root.find("DrawingInfo")
        if node is None:
            return DrawingInfo()

        def bbox(sub):
            if sub is None:
                return (0, 0, 1, 1)
            return tuple(float(sub.findtext(axis, "0"))
                         for axis in ("X", "Y", "W", "H"))

        player = node.find("Player")
        if player is not None:
            control, render = (player.find("ControlArea"),
                               player.find("RenderArea"))
        else:
            control, render = (node.find("PlayerControl"),
                               node.find("PlayerRender"))
        return DrawingInfo(bbox(node.find("Canvas")), bbox(control),
                           bbox(render))

    def to_xml(self) -> str:
        """Writes the reference schema (drawing_info.py:83-108)."""
        def bbox(box, indent):
            x, y, w, h = box
            return (f"{indent}<X>{x}</X>{indent}<Y>{y}</Y>"
                    f"{indent}<W>{w}</W>{indent}<H>{h}</H>")

        return ("  <DrawingInfo>\n"
                "     <Canvas>" + bbox(self.canvas_bbox, "\n         ") +
                "\n     </Canvas>\n"
                "     <Player>\n"
                "         <ControlArea>" +
                bbox(self.player_control_bbox, "\n             ") +
                "\n         </ControlArea>\n"
                "         <RenderArea>" +
                bbox(self.player_render_bbox, "\n             ") +
                "\n         </RenderArea>\n"
                "     </Player>\n"
                "  </DrawingInfo>\n")


class LectureAnnotation:
    def __init__(self, db_name: str, title: str, output_file: str,
                 video_files: List[str], total_frames: int,
                 drawing_info: Optional[DrawingInfo] = None):
        self.db_name = db_name
        self.title = title
        self.output_file = output_file
        self.video_files = video_files
        self.total_frames = total_frames
        self.drawing_info = drawing_info or DrawingInfo()

        self.video_objects: Dict[str, TimelineObject] = {}
        self.video_segments: List[int] = []          # interior split points
        self.video_segment_keyframes: List[int] = []

        self.frame_width: Optional[int] = None
        self.frame_height: Optional[int] = None

    # -------------------------------------------------------- projection

    def set_frame_resolution(self, width: int, height: int) -> None:
        """(reference: lecture_annotation.py:29-31)."""
        self.frame_width = int(width)
        self.frame_height = int(height)

    def project_object_location(self, loc: ObjectLocation) -> ObjectLocation:
        """Map annotation-canvas coordinates to frame pixels using the
        GUI viewport geometry (reference: lecture_annotation.py:135-151;
        requires set_frame_resolution first)."""
        off_x = (self.drawing_info.player_render_bbox[0]
                 - self.drawing_info.canvas_bbox[0])
        off_y = (self.drawing_info.player_render_bbox[1]
                 - self.drawing_info.canvas_bbox[1])
        scale_x = self.frame_width / self.drawing_info.player_render_bbox[2]
        scale_y = self.frame_height / self.drawing_info.player_render_bbox[3]
        points = loc.polygon_points - np.array([[off_x, off_y]])
        points[:, 0] *= scale_x
        points[:, 1] *= scale_y
        return ObjectLocation(loc.visible, loc.frame, loc.abs_time, points,
                              loc.label)

    # -------------------------------------------------------------- XML

    def segments_with_bounds(self) -> List[int]:
        return [0] + self.video_segments + [self.total_frames]

    def to_xml(self) -> str:
        lines = ["<Annotations>"]
        lines.append(f"  <Database>{self.db_name}</Database>")
        lines.append(f"  <Lecture>{self.title}</Lecture>")
        lines.append(f"  <Filename>{self.output_file}</Filename>")
        lines.append("  <VideoFiles>")
        for path in self.video_files:
            lines.append(f"     <VideoFile>{path}</VideoFile>")
        lines.append("  </VideoFiles>")

        xml = "\n".join(lines) + "\n"
        xml += self.drawing_info.to_xml()

        xml += "  <VideoObjects>\n"
        for name in sorted(self.video_objects):
            xml += self.video_objects[name].to_xml()
        xml += "  </VideoObjects>\n"

        bounds = self.segments_with_bounds()
        xml += "  <VideoSegments>\n"
        for start, end in zip(bounds, bounds[1:]):
            xml += ("    <VideoSegment>\n"
                    f"        <Start>{start}</Start>\n"
                    f"        <End>{end}</End>\n"
                    "    </VideoSegment>\n")
        xml += "  </VideoSegments>\n"

        xml += "  <VideoKeyFrames>\n"
        for frame_idx in self.video_segment_keyframes:
            xml += ("    <VideoKeyFrame>\n"
                    f"       <Index>{frame_idx}</Index>\n"
                    "    </VideoKeyFrame>\n")
        xml += "  </VideoKeyFrames>\n"
        xml += "</Annotations>\n"
        return xml

    def save(self, path: Optional[str] = None) -> None:
        with open(path or self.output_file, "w") as f:
            f.write(self.to_xml())

    @staticmethod
    def load(filename: str, verbose: bool = False) -> "LectureAnnotation":
        root = ET.parse(filename).getroot()
        video_files = [n.text for n in
                       root.find("VideoFiles").findall("VideoFile")]

        starts, ends = [], []
        for node in root.find("VideoSegments").findall("VideoSegment"):
            starts.append(int(node.findtext("Start")))
            ends.append(int(node.findtext("End")))
        total_frames = max(ends) if ends else 0
        split_points = sorted(s for s in starts if s != 0)

        annotation = LectureAnnotation(
            root.findtext("Database"), root.findtext("Lecture"),
            root.findtext("Filename"), video_files, total_frames,
            DrawingInfo.from_xml(root))
        annotation.video_segments = split_points

        objects_node = root.find("VideoObjects")
        if objects_node is not None:
            for obj_node in objects_node.findall("VideoObject"):
                obj = TimelineObject.from_xml(obj_node)
                annotation.video_objects[obj.id] = obj
                if verbose:
                    print(f"loaded object {obj.name} "
                          f"({len(obj.locations)} keyframes)")

        keyframes_node = root.find("VideoKeyFrames")
        if keyframes_node is not None:
            annotation.video_segment_keyframes = sorted(
                int(n.findtext("Index"))
                for n in keyframes_node.findall("VideoKeyFrame"))

        return annotation
