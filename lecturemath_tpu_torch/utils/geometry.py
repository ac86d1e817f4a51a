"""2D segment/polygon intersection helpers.

Equivalents of the reference's standalone geometry utilities
(reference: AM_CommonTools/util/geometry_helper.py:1-129,
AM_CommonTools/util/line_segment_2D.py:1-91,
AM_CommonTools/util/polygon_2D.py:1-20 — legacy modules with no importer
left in the release, kept here so external code built on them has a
drop-in surface). Same semantics; vectorized where it is free.

Note: the reference's `GeometryHelper.boxesIntercept` carries a latent
typo (`b2_min_y <= b2_max_y`, geometry_helper.py:38 — always true, so
boxes disjoint only in y still "intersect"). `boxes_intersect` here
implements the evident intent; `boxes_intersect_reference` reproduces
the reference's literal behavior for anyone who needs bug-compatible
results.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

Point = Tuple[float, float]


class LineSegment2D:
    """Segment with precomputed bounds/slope and exact intersection
    (reference: line_segment_2D.py:1-91)."""

    def __init__(self, p1: Point, p2: Point):
        self.x1, self.y1 = p1
        self.x2, self.y2 = p2
        self.x_min, self.x_max = sorted((self.x1, self.x2))
        self.y_min, self.y_max = sorted((self.y1, self.y2))
        self.vertical = self.x1 == self.x2
        if self.vertical:
            self.m = None
            self.b = None
        else:
            self.m = (self.y2 - self.y1) / (self.x2 - self.x1)
            self.b = self.y1 - self.m * self.x1

    def intersection(self, other: "LineSegment2D") -> Optional[Point]:
        """Intersection point of two segments, or None. Collinear
        overlapping segments return the midpoint of the shared range,
        like the reference (line_segment_2D.py:36-47, 63-69)."""
        if self.vertical and other.vertical:
            if (other.x1 == self.x1 and other.y_min < self.y_max
                    and self.y_min <= other.y_max):
                mid_y = (max(self.y_min, other.y_min)
                         + min(self.y_max, other.y_max)) / 2.0
                return self.x1, mid_y
            return None
        if self.vertical or other.vertical:
            vert, slanted = (self, other) if self.vertical else (other, self)
            if slanted.x_min <= vert.x1 <= slanted.x_max:
                y_int = vert.x1 * slanted.m + slanted.b
                if vert.y_min <= y_int <= vert.y_max:
                    return vert.x1, y_int
            return None
        if self.m == other.m:
            if self.b == other.b and (self.x_min <= other.x_max
                                      and other.x_min <= self.x_max):
                mid_x = (max(self.x_min, other.x_min)
                         + min(self.x_max, other.x_max)) / 2.0
                return mid_x, self.m * mid_x + self.b
            return None
        x_int = (other.b - self.b) / (self.m - other.m)
        if (self.x_min <= x_int <= self.x_max
                and other.x_min <= x_int <= other.x_max):
            return x_int, x_int * self.m + self.b
        return None

    def intersects(self, other: "LineSegment2D") -> bool:
        return self.intersection(other) is not None


class Polygon2D:
    """Closed polygon as precomputed edge segments
    (reference: polygon_2D.py:1-20)."""

    def __init__(self, points: Sequence[Point]):
        self.points = list(points)
        n = len(self.points)
        self.lines: List[LineSegment2D] = [
            LineSegment2D(self.points[i], self.points[(i + 1) % n])
            for i in range(n)]

    def line_intersects(self, line: LineSegment2D) -> bool:
        """(reference: polygon_2D.py:15-20 lineIntersects)."""
        return any(side.intersection(line) is not None
                   for side in self.lines)


def lines_intersect(line_a: Tuple[Point, Point],
                    line_b: Tuple[Point, Point]) -> bool:
    """(reference: geometry_helper.py:64-129 linesIntersect)."""
    return LineSegment2D(*line_a).intersects(LineSegment2D(*line_b))


def line_intersects_polygon(line: Tuple[Point, Point],
                            polygon: Sequence[Point]) -> bool:
    """(reference: geometry_helper.py:2-15 lineIntersectPolygon)."""
    return Polygon2D(polygon).line_intersects(LineSegment2D(*line))


def line_boundaries(p1: Point, p2: Point) -> Tuple[float, float, float, float]:
    """(x_min, x_max, y_min, y_max) of a segment
    (reference: geometry_helper.py:41-62 getLineBoundaries)."""
    (x_min, x_max), (y_min, y_max) = (sorted((p1[0], p2[0])),
                                      sorted((p1[1], p2[1])))
    return x_min, x_max, y_min, y_max


Box = Tuple[Tuple[float, float], Tuple[float, float]]  # ((x0,x1),(y0,y1))


def boxes_bounding_box(boxes: Sequence[Box]) -> Box:
    """(reference: geometry_helper.py:17-28 boxesBoudingBox)."""
    xs = [x for (x0, x1), _ in boxes for x in (x0, x1)]
    ys = [y for _, (y0, y1) in boxes for y in (y0, y1)]
    return (min(xs), max(xs)), (min(ys), max(ys))


def boxes_intersect(box1: Box, box2: Box) -> bool:
    """Inclusive-boundary AABB overlap — the evident intent of
    geometry_helper.py:30-38 (see module docstring for its typo)."""
    (a_x0, a_x1), (a_y0, a_y1) = box1
    (b_x0, b_x1), (b_y0, b_y1) = box2
    return (a_x0 <= b_x1 and b_x0 <= a_x1
            and a_y0 <= b_y1 and b_y0 <= a_y1)


def boxes_intersect_reference(box1: Box, box2: Box) -> bool:
    """Bug-compatible reproduction of geometry_helper.py:30-38
    boxesIntercept (the y test degenerates to `b2 is a valid box`)."""
    (a_x0, a_x1), (a_y0, a_y1) = box1
    (b_x0, b_x1), (b_y0, b_y1) = box2
    return (a_x0 <= b_x1 and b_x0 <= a_x1
            and a_y0 <= b_y1 and b_y0 <= b_y1)
