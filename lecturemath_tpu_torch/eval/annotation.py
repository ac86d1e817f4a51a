"""Ground-truth annotation data model: keyframes, portions, unique-CC
groups, polygon video objects.

File-format compatible with the reference's annotation XML/PNG trees
(reference: AccessMath/annotation/keyframe_annotation.py:17-564,
unique_cc_group.py:5-201, keyframe_portion.py, video_object.py) so GT
produced by the reference's annotation GUIs evaluates unchanged.

Binary convention: keyframe binary images are white background (255) with
ink at 0; CCs are extracted from the inverted image with NO small-size
filter (keyframe_annotation.py:145 passes filter_small=False).

Images are read and written without OpenCV: PNGs through ``utils/png.py``
(as ``cv2.imread`` reads them, BGR, and byte for byte as ``cv2.imwrite``
writes them) and the object mask through ``utils/image.py fill_poly``
(equal to ``cv2.fillPoly``). A GT image that is not a PNG needs OpenCV.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.cc import CC, extract_ccs
from ..utils.image import fill_poly
from ..utils.png import read_image, write_image


def cc_str_id(cc: CC) -> str:
    """Value identity of a CC (reference: ConnectedComponent.strID)."""
    return f"{cc.min_x}-{cc.max_x}-{cc.min_y}-{cc.max_y}-{cc.size}"


# --------------------------------------------------------------- portions

@dataclass
class KeyframePortion:
    x: int
    y: int
    w: int
    h: int
    binary: Optional[np.ndarray] = None  # uint8, ink=0 / bg=255
    dark: bool = False

    def get_xml_string(self, indent: str = "") -> str:
        lines = [f"{indent}<KeyFramePortion>",
                 f"{indent}    <X>{self.x}</X>",
                 f"{indent}    <Y>{self.y}</Y>",
                 f"{indent}    <W>{self.w}</W>",
                 f"{indent}    <H>{self.h}</H>",
                 f"{indent}    <Dark>{'1' if self.dark else '0'}</Dark>",
                 f"{indent}</KeyFramePortion>"]
        return "\n".join(lines) + "\n"

    def invert(self) -> None:
        self.binary = 255 - self.binary


def portions_from_binary(binary_ink0: np.ndarray, margin: int = 2,
                         merge_distance: int = 12) -> List[KeyframePortion]:
    """Create a fresh portions tree from a binary keyframe (ink=0/bg=255)
    — the headless equivalent of the reference's GTPixelBinaryAnnotator
    output: one rectangular KeyFramePortion per spatial cluster of content,
    whose combination reproduces the keyframe exactly (round-trip tested).

    Clusters are connected components of the CC bbox-proximity graph
    (boxes expanded by ``merge_distance``), so nearby symbols share a
    portion like hand-drawn annotation regions do.
    """
    h, w = binary_ink0.shape
    ccs = extract_ccs(255 - binary_ink0, filter_small=False)
    if not ccs:
        return []

    boxes = np.array([[cc.min_x, cc.max_x, cc.min_y, cc.max_y] for cc in ccs],
                     dtype=np.int64)
    grown = boxes + np.array([-merge_distance, merge_distance,
                              -merge_distance, merge_distance])
    x_hit = (grown[:, None, 0] <= grown[None, :, 1]) & \
            (grown[None, :, 0] <= grown[:, None, 1])
    y_hit = (grown[:, None, 2] <= grown[None, :, 3]) & \
            (grown[None, :, 2] <= grown[:, None, 3])
    adjacency = x_hit & y_hit

    parent = list(range(len(ccs)))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, j in zip(*np.nonzero(adjacency)):
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            parent[rj] = ri

    clusters: Dict[int, List[int]] = {}
    for idx in range(len(ccs)):
        clusters.setdefault(find(idx), []).append(idx)

    portions = []
    for members in clusters.values():
        min_x = max(0, int(boxes[members, 0].min()) - margin)
        max_x = min(w - 1, int(boxes[members, 1].max()) + margin)
        min_y = max(0, int(boxes[members, 2].min()) - margin)
        max_y = min(h - 1, int(boxes[members, 3].max()) + margin)
        pw = max_x - min_x + 1
        ph = max_y - min_y + 1
        # portion crop keeps only this cluster's ink (ink=0 convention)
        crop = np.full((ph, pw), 255, dtype=np.uint8)
        for idx in members:
            cc = ccs[idx]
            oy, ox = cc.min_y - min_y, cc.min_x - min_x
            region = crop[oy:oy + cc.height, ox:ox + cc.width]
            region[cc.img > 0] = 0
        portions.append(KeyframePortion(min_x, min_y, pw, ph, crop))

    portions.sort(key=lambda p: (p.y, p.x))
    return portions


# ------------------------------------------------------------ video objects

class VideoObject:
    SHAPE_ALIGNED_RECTANGLE = 0
    SHAPE_QUADRILATERAL = 1
    SHAPE_POLYGON = 2

    def __init__(self, object_id, name: str, shape_type: int,
                 polygon_points: Optional[np.ndarray] = None):
        self.id = object_id
        self.name = name
        self.shape_type = shape_type
        # single-keyframe polygon (full per-frame location timelines live in
        # lecture_annotation; eval only needs the keyframe polygon)
        self.polygon_points = (np.asarray(polygon_points, dtype=np.float64)
                               if polygon_points is not None else None)


# ---------------------------------------------------------------- keyframe

class KeyframeAnnotation:
    def __init__(self, database: str, lecture: str, idx: int, time: float,
                 objects: Sequence[VideoObject],
                 raw_image: Optional[np.ndarray]):
        self.database = database
        self.lecture = lecture
        self.idx = idx
        self.time = time
        self.objects = list(objects)
        self.portions: List[KeyframePortion] = []

        self.raw_image = raw_image
        self.binary_image: Optional[np.ndarray] = None  # uint8 [H, W, 3]
        self.binary_cc: Optional[List[CC]] = None
        self.object_mask: Optional[np.ndarray] = None

        if raw_image is not None:
            self.update_object_mask()
            self.update_binary_image(False)

    # ------------------------------------------------------------- updates

    def update_object_mask(self) -> None:
        h, w = self.raw_image.shape[:2]
        mask = np.zeros((h, w), dtype=np.uint8)
        for obj in self.objects:
            if obj.polygon_points is not None:
                fill_poly(mask, obj.polygon_points.astype(np.int32), 255)
        self.object_mask = mask > 0

    def update_binary_image(self, update_cc: bool = False) -> None:
        h, w = self.raw_image.shape[:2]
        binary = np.full((h, w, 3), 255, dtype=np.uint8)

        if self.portions:
            ink_votes = np.zeros((h, w), dtype=np.int32)
            for portion in self.portions:
                region = ink_votes[portion.y:portion.y + portion.h,
                                   portion.x:portion.x + portion.w]
                region += 255 - portion.binary
            combined = np.where(ink_votes > 0, 0, 255).astype(np.uint8)
            binary[:, :, 0] = combined
            binary[:, :, 1] = combined
            binary[:, :, 2] = combined

        self.binary_image = binary
        if update_cc:
            self.update_binary_cc()

    def update_binary_cc(self, verbose: bool = False) -> None:
        ink = 255 - self.binary_image[:, :, 0]
        self.binary_cc = extract_ccs(ink, filter_small=False)
        if verbose:
            print(f"frame {self.idx}: {len(self.binary_cc)} CCs")

    def ccs_by_id(self) -> Dict[str, CC]:
        return {cc_str_id(cc): cc for cc in (self.binary_cc or [])}

    def check_cc_overlaps_background(self, cc: CC,
                                     disp_x: int = 0, disp_y: int = 0) -> bool:
        """Whether the (optionally displaced) CC touches an annotated
        object region (reference: check_cc_overlaps_background, :80-100)."""
        mask = self.object_mask
        min_x, max_x = cc.min_x + disp_x, cc.max_x + disp_x
        min_y, max_y = cc.min_y + disp_y, cc.max_y + disp_y
        if max_x < 0 or min_x >= mask.shape[1] or max_y < 0 or min_y >= mask.shape[0]:
            return True  # fully out of bounds counts as background

        mask_cut = mask[max(0, min_y):max_y + 1, max(0, min_x):max_x + 1]
        cc_start_x = max(0, -min_x)
        cc_start_y = max(0, -min_y)
        cc_cut = cc.img[cc_start_y:cc_start_y + mask_cut.shape[0],
                        cc_start_x:cc_start_x + mask_cut.shape[1]]
        return bool(np.count_nonzero(cc_cut[:mask_cut.shape[0],
                                            :mask_cut.shape[1]]
                                     & mask_cut[:cc_cut.shape[0],
                                                :cc_cut.shape[1]]))

    # -------------------------------------------------------------- loading

    @staticmethod
    def load_exported_keyframes(xml_filename: str, image_prefix: str,
                                load_segments: bool = False,
                                swap_red_blue: bool = True,
                                binary_mode: bool = False):
        """Read a segments.xml + keyframes/<idx>.png tree (ours or the
        reference exporter's; reference: LoadExportedKeyframes, :200-301)."""
        root = ET.parse(xml_filename).getroot()
        database_name = root.findtext("Database")
        lecture_name = root.findtext("Lecture")

        keyframes = []
        object_ids: Dict[str, int] = {}
        for kf_node in root.find("VideoKeyFrames").findall("VideoKeyFrame"):
            frame_idx = int(kf_node.findtext("Index"))
            frame_time = float(kf_node.findtext("AbsTime"))

            frame_objects = []
            for obj_node in kf_node.find("VideoObjects").findall("VideoObject"):
                name = obj_node.findtext("Name")
                shape_node = obj_node.find("Shape")
                if shape_node is None:
                    x = float(obj_node.findtext("X"))
                    y = float(obj_node.findtext("Y"))
                    w = float(obj_node.findtext("W"))
                    h = float(obj_node.findtext("H"))
                    points = [[x, y], [x + w, y], [x + w, y + h], [x, y + h]]
                    shape_type = VideoObject.SHAPE_ALIGNED_RECTANGLE
                else:
                    shape_type = int(shape_node.text)
                    points = [[float(p.findtext("X")), float(p.findtext("Y"))]
                              for p in obj_node.find("Polygon").findall("Point")]

                object_ids.setdefault(name, len(object_ids) + 1)
                frame_objects.append(VideoObject(object_ids[name], name,
                                                 shape_type, points))

            image = read_image(image_prefix + f"{frame_idx}.png")
            if not binary_mode:
                if swap_red_blue:
                    image = image[:, :, ::-1].copy()
                keyframe = KeyframeAnnotation(database_name, lecture_name,
                                              frame_idx, frame_time,
                                              frame_objects, image)
            else:
                keyframe = KeyframeAnnotation(database_name, lecture_name,
                                              frame_idx, frame_time,
                                              frame_objects, None)
                keyframe.binary_image = image
            keyframes.append(keyframe)

        if load_segments:
            segments = [(int(s.findtext("Start")), int(s.findtext("End")))
                        for s in root.find("VideoSegments").findall("VideoSegment")]
            return keyframes, segments
        return keyframes

    @staticmethod
    def load_portions(xml_filename: str,
                      keyframes: Sequence["KeyframeAnnotation"],
                      portions_path: str) -> None:
        """Read portions.xml + portions/frame_<idx>/<k>.png (reference:
        LoadKeyframesPortions, :350-404)."""
        by_idx = {kf.idx: kf for kf in keyframes}
        root = ET.parse(xml_filename).getroot()
        for kf_node in root.find("KeyFrames").findall("KeyFrame"):
            kf_idx = int(kf_node.findtext("Index"))
            if kf_idx not in by_idx:
                print(f"unknown keyframe in portions: {kf_idx}")
                continue
            keyframe = by_idx[kf_idx]
            h, w = keyframe.raw_image.shape[:2]

            portions = []
            nodes = kf_node.find("Portions").findall("KeyFramePortion")
            for offset, p_node in enumerate(nodes):
                binary = read_image(
                    os.path.join(portions_path, f"frame_{kf_idx}",
                                 f"{offset}.png"))
                px = int(p_node.findtext("X"))
                py = int(p_node.findtext("Y"))
                pw = min(int(p_node.findtext("W")), w - px)
                ph = min(int(p_node.findtext("H")), h - py)
                dark = p_node.findtext("Dark") == "1"
                portions.append(KeyframePortion(px, py, pw, ph,
                                                binary[:, :, 0], dark))
            keyframe.portions = portions
            keyframe.update_binary_image(True)

    @staticmethod
    def save_portions(keyframes: Sequence["KeyframeAnnotation"],
                      output_path: str,
                      xml_filename: str = "portions.xml") -> str:
        """Write portions.xml + binary/<idx>.png + portions/frame_<idx>/
        (reference: SaveKeyframesPortions, :307-347)."""
        os.makedirs(os.path.join(output_path, "binary"), exist_ok=True)
        os.makedirs(os.path.join(output_path, "portions"), exist_ok=True)

        lines = ["<Annotations>", "    <KeyFrames>"]
        for keyframe in keyframes:
            lines.append(" " * 8 + "<KeyFrame>")
            lines.append(" " * 12 + f"<Index>{keyframe.idx}</Index>")
            lines.append(" " * 12 + "<Portions>")
            frame_dir = os.path.join(output_path, "portions",
                                     f"frame_{keyframe.idx}")
            os.makedirs(frame_dir, exist_ok=True)
            for offset, portion in enumerate(keyframe.portions):
                lines.append(portion.get_xml_string(" " * 12).rstrip("\n"))
                write_image(os.path.join(frame_dir, f"{offset}.png"),
                            portion.binary)
            lines.append(" " * 12 + "</Portions>")
            lines.append(" " * 8 + "</KeyFrame>")
            write_image(os.path.join(output_path, "binary",
                                     f"{keyframe.idx}.png"),
                        keyframe.binary_image)
        lines += ["    </KeyFrames>", "</Annotations>"]

        out_path = os.path.join(output_path, xml_filename)
        with open(out_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return out_path

    # ---------------------------------------------------------- combining

    @staticmethod
    def combine_per_segment(keyframes: Sequence["KeyframeAnnotation"],
                            segments: Sequence[Tuple[int, int]],
                            use_portions: bool):
        """One combined keyframe per segment (reference:
        CombineKeyframesPerSegment, :406-513): AND the binary images
        (white background), keep common objects at their last location,
        synthesize empty keyframes for empty segments."""
        from scipy.interpolate import interp1d

        per_segment: List[List[KeyframeAnnotation]] = [[] for _ in segments]
        all_times, all_idxs = [], []
        segment_pos = 0
        for keyframe in keyframes:
            while keyframe.idx > segments[segment_pos][1]:
                segment_pos += 1
            per_segment[segment_pos].append(keyframe)
            all_times.append(keyframe.time)
            all_idxs.append(keyframe.idx)

        combined = []
        for segment_idx, group in enumerate(per_segment):
            if len(group) == 1:
                combined.append(group[0])
                continue

            if len(group) == 0:
                time_f = interp1d(all_idxs, all_times, fill_value="extrapolate")
                mid_idx = (segments[segment_idx][0] + segments[segment_idx][1]) // 2
                mid_time = float(time_f([mid_idx])[0])
                template = keyframes[0]
                shape = (template.raw_image.shape if template.raw_image is not None
                         else template.binary_image.shape)
                empty = np.zeros(shape, dtype=np.uint8)
                new_kf = KeyframeAnnotation(template.database, template.lecture,
                                            mid_idx, mid_time, [], empty)
                if use_portions:
                    new_kf.update_binary_image(True)
                else:
                    new_kf.binary_image = np.full(
                        keyframes[0].binary_image.shape, 255, np.uint8)
                    new_kf.update_binary_cc()
                combined.append(new_kf)
                continue

            last = group[-1]

            # keep only objects present in every keyframe of the segment
            instances: Dict[int, List[VideoObject]] = {}
            for keyframe in group:
                for obj in keyframe.objects:
                    instances.setdefault(obj.id, []).append(obj)
            comb_objects = [
                VideoObject(objs[0].id, objs[0].name, objs[0].shape_type,
                            objs[-1].polygon_points)
                for objs in instances.values() if len(objs) == len(group)]

            new_kf = KeyframeAnnotation(last.database, last.lecture, last.idx,
                                        last.time, comb_objects, last.raw_image)
            if use_portions:
                new_kf.portions = [p for kf in group for p in kf.portions]
                new_kf.update_binary_image(True)
            else:
                merged = np.full(keyframes[0].binary_image.shape, 255, np.uint8)
                for keyframe in group:
                    merged = (np.logical_and(merged, keyframe.binary_image)
                              .astype(np.uint8) * 255)
                new_kf.binary_image = merged
                new_kf.update_binary_cc()
            combined.append(new_kf)

        return combined

    @staticmethod
    def generate_fake_keyframe_info(keyframes: Sequence["KeyframeAnnotation"]):
        """One fake segment + singleton unique-CC groups per keyframe, for
        per-frame-only evaluation (reference: GenerateFakeKeyframeInfo,
        :549-564 — the lecturenet_eval_keyframe_bin protocol)."""
        fake_groups: List[UniqueCCGroup] = []
        fake_cc_group: List[Dict[str, UniqueCCGroup]] = []
        fake_segments: List[Tuple[int, int]] = []
        for kf_idx, keyframe in enumerate(keyframes):
            fake_segments.append((kf_idx * 5 + 1, kf_idx * 5 + 4))
            fake_cc_group.append({})
            for cc in keyframe.binary_cc:
                group = UniqueCCGroup(cc, kf_idx)
                fake_groups.append(group)
                fake_cc_group[kf_idx][cc_str_id(cc)] = group
        return fake_groups, fake_cc_group, fake_segments


# ------------------------------------------------------------- CC groups

class UniqueCCGroup:
    """A symbol tracked across consecutive GT keyframes
    (reference: unique_cc_group.py:5-201)."""

    def __init__(self, start_cc: CC, start_frame: int):
        self.cc_refs: List[Optional[CC]] = [start_cc]
        self.start_frame = start_frame

    def last_frame(self) -> int:
        return self.start_frame + len(self.cc_refs) - 1

    def str_id(self) -> str:
        return f"{self.start_frame}-{cc_str_id(self.cc_refs[0])}"

    @staticmethod
    def copy(original: "UniqueCCGroup") -> "UniqueCCGroup":
        group = UniqueCCGroup(original.cc_refs[0], original.start_frame)
        group.cc_refs = list(original.cc_refs)
        return group

    @staticmethod
    def split(original: "UniqueCCGroup",
              split_frame: int) -> Optional["UniqueCCGroup"]:
        """Split a group at a frame: the original keeps [start, split) and a
        new group takes [split, end] (reference: unique_cc_group.py:178-201).
        Returns None when the split point is outside the group."""
        offset = split_frame - original.start_frame
        if offset <= 0 or offset >= len(original.cc_refs):
            return None
        new_group = UniqueCCGroup(original.cc_refs[offset], split_frame)
        new_group.cc_refs = original.cc_refs[offset:]
        original.cc_refs = original.cc_refs[:offset]
        while original.cc_refs and original.cc_refs[-1] is None:
            original.cc_refs.pop()
        return new_group

    @staticmethod
    def groups_from_xml(keyframes: Sequence[KeyframeAnnotation],
                        xml_filename: str, verbose: bool = False):
        """Load unique_ccs.xml with the reference's consistency repair:
        group members that no longer exist truncate the group; CCs without a
        group get singleton groups (reference: GroupsFromXML, :25-134)."""
        cc_group: List[Dict[str, Optional[UniqueCCGroup]]] = []
        cc_index: List[Dict[str, CC]] = []
        for keyframe in keyframes:
            ids = {cc_str_id(cc): cc for cc in keyframe.binary_cc}
            cc_index.append(ids)
            cc_group.append({cc_id: None for cc_id in ids})

        root = ET.parse(xml_filename).getroot()
        unique_groups: List[UniqueCCGroup] = []

        for group_node in root.find("CCGroups").findall("CCGroup"):
            start = int(group_node.findtext("Start").strip())
            member_ids: List[Optional[str]] = []
            for cc_node in group_node.find("CCs").findall("CC"):
                if cc_node.text is None:
                    member_ids.append(None)
                    continue
                cc_id = cc_node.text.strip()
                if (start + len(member_ids) < len(cc_group) and
                        cc_id in cc_group[start + len(member_ids)]):
                    member_ids.append(cc_id)
                else:
                    break  # mismatch: truncate the group here

            if not member_ids:
                continue
            group = UniqueCCGroup(cc_index[start][member_ids[0]], start)
            cc_group[start][member_ids[0]] = group
            for offset, cc_id in enumerate(member_ids[1:], start=1):
                if cc_id is not None:
                    group.cc_refs.append(cc_index[start + offset][cc_id])
                    cc_group[start + offset][cc_id] = group
                else:
                    group.cc_refs.append(None)
            unique_groups.append(group)

        # orphan CCs become singleton groups
        for kf_idx in range(len(keyframes)):
            for cc_id, group in cc_group[kf_idx].items():
                if group is None:
                    new_group = UniqueCCGroup(cc_index[kf_idx][cc_id], kf_idx)
                    cc_group[kf_idx][cc_id] = new_group
                    unique_groups.append(new_group)

        if verbose:
            print(f"Loaded {len(unique_groups)} unique-CC groups")
        return cc_group, unique_groups

    @staticmethod
    def groups_to_xml(keyframes: Sequence[KeyframeAnnotation],
                      groups: Sequence["UniqueCCGroup"]) -> str:
        """(reference: GenerateGroupsXML, :136-172)"""
        lines = ["<UniqueCCS>", "  <KeyFrames>"]
        for keyframe in keyframes:
            lines.append("    <KeyFrame>")
            lines.append("      <CCs>")
            for cc in keyframe.binary_cc:
                lines.append(f"         <CC>{cc_str_id(cc)}</CC>")
            lines.append("      </CCs>")
            lines.append("    </KeyFrame>")
        lines.append("  </KeyFrames>")
        lines.append("  <CCGroups>")
        for group in groups:
            lines.append("    <CCGroup>")
            lines.append(f"        <Start>{group.start_frame}</Start>")
            lines.append(f"        <End>{group.last_frame()}</End>")
            lines.append("        <CCs>")
            for cc in group.cc_refs:
                if cc is not None:
                    lines.append(f"          <CC>{cc_str_id(cc)}</CC>")
                else:
                    lines.append("          <CC></CC>")
            lines.append("        </CCs>")
            lines.append("    </CCGroup>")
        lines.append("  </CCGroups>")
        lines.append("</UniqueCCS>")
        return "\n".join(lines) + "\n"
