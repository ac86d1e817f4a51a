"""Text-region ground-truth export from full-video annotations, plus the
text-detection evaluation built on it.

Exports the per-frame (or unique-box) text-region GT that the reference
derives from `LectureAnnotation` timelines — projecting annotation-canvas
polygons to frame pixels, dropping boxes occluded by the speaker — and
scores detector bboxes against that GT with pixel-level recall/precision.

(reference: AccessMath/annotation/text_annotation_exporter.py:12-397,
 AccessMath/evaluation/text_detection_evaluator.py:6-251)

PNG frames, region crops and masks go through ``utils/png.py`` (byte for
byte as ``cv2.imwrite`` / ``cv2.imencode`` write them, decoded as
``cv2.imdecode`` decodes them) and the masks through ``utils/image.py
fill_poly`` (``cv2.fillPoly``), so only the JPEG export needs OpenCV.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.image import fill_poly
from ..utils.png import (decode_png_color, decode_png_grayscale, encode_png,
                         write_image)
from .lecture_annotation import LectureAnnotation, ObjectLocation


class TextAnnotationExporter:
    """Filters a `LectureAnnotation`'s timeline objects into text regions
    (by id prefix) and a speaker, then exports visible / non-occluded
    boxes per frame (reference: text_annotation_exporter.py:12-227)."""

    ALL_PER_FRAME = 0
    UNIQUE_BOXES = 1
    FULL_SYNTHETIC = 2

    def __init__(self, annotation: LectureAnnotation,
                 object_prefixes: Sequence[str], speaker_name: str,
                 max_speaker_intersection: float, export_mode: int,
                 export_dir: Optional[str], export_images: bool = False):
        self.export_mode = export_mode
        self.img_width: Optional[int] = None
        self.img_height: Optional[int] = None

        self.export_dir = export_dir
        self.export_img_dir = f"{export_dir}/JPEGImages" if export_dir else None
        self.export_xml_dir = f"{export_dir}/Annotations" if export_dir else None
        self.export_bin_dir = f"{export_dir}/Binary" if export_dir else None
        self.export_images = export_images
        self.export_img_format = "png"

        self.annotation = annotation
        self.object_prefixes = list(object_prefixes)
        self.speaker_name = speaker_name
        self.max_speaker_inter = max_speaker_intersection

        # filter text annotations vs the speaker object
        # (reference: text_annotation_exporter.py:56-66)
        self.text_objects = []
        self.speaker = None
        for object_id in annotation.video_objects:
            video_object = annotation.video_objects[object_id]
            if self.is_text_object(video_object, self.object_prefixes):
                self.text_objects.append(video_object)
            elif video_object.id.lower() == speaker_name.lower():
                self.speaker = video_object

        # for unique-objects export mode
        self.exported_text_objects: Optional[Dict[str, list]] = None
        self.unique_objects_xml_root: Optional[ET.Element] = None

    @staticmethod
    def is_text_object(video_object, object_prefixes) -> bool:
        """(reference: text_annotation_exporter.py:330-339 CheckTextObject)."""
        return any(video_object.id[:len(prefix)].lower() == prefix.lower()
                   for prefix in object_prefixes)

    def initialize(self, width: int, height: int,
                   prepare_dirs: bool = True) -> None:
        """(reference: text_annotation_exporter.py:68-86)."""
        self.img_width = width
        self.img_height = height
        self.annotation.set_frame_resolution(width, height)

        if self.export_mode == self.UNIQUE_BOXES:
            self.exported_text_objects = {}
            self.unique_objects_xml_root = ET.Element("annotation")

        if prepare_dirs:
            os.makedirs(self.export_img_dir, exist_ok=True)
            os.makedirs(self.export_xml_dir, exist_ok=True)
            if self.export_mode == self.FULL_SYNTHETIC:
                os.makedirs(self.export_bin_dir, exist_ok=True)

    # ------------------------------------------------------- per-frame GT

    def frame_visible_bboxes_state(self, frame_idx: int):
        """Interpolated text-object polygons at `frame_idx`, projected to
        frame pixels and split by speaker occlusion. Returns
        (speaker_loc, not_occluded, occluded) where each box entry is
        (object_name, projected polygon point list)
        (reference: text_annotation_exporter.py:91-133)."""
        if self.speaker is None:
            speaker_loc = None
        else:
            speaker_loc = self.speaker.get_location_at(frame_idx, False)

        not_occluded, occluded = [], []
        for text_object in self.text_objects:
            text_loc = text_object.get_location_at(frame_idx, False)
            if text_loc is None or not text_loc.visible:
                continue

            if speaker_loc is None or not speaker_loc.visible:
                int_area_prc = 0.0
            else:
                int_area_prc = text_loc.intersection_percentage(speaker_loc)

            proj_loc = self.annotation.project_object_location(text_loc)
            entry = (text_object.name, proj_loc.get_polygon_points())
            if int_area_prc <= self.max_speaker_inter:
                not_occluded.append(entry)
            else:
                occluded.append(entry)

        return speaker_loc, not_occluded, occluded

    # ----------------------------------------------------------- exports

    def export_all_by_frame(self, frame: Optional[np.ndarray],
                            frame_idx: int, not_occluded_polygons,
                            binary: Optional[np.ndarray] = None) -> None:
        """One frame image + one XML of all its visible boxes
        (reference: text_annotation_exporter.py:163-185)."""
        ext = self.export_img_format
        out_img = f"{self.export_img_dir}/{frame_idx}.{ext}"
        out_bin = f"{self.export_bin_dir}/{frame_idx}.{ext}"
        out_xml = f"{self.export_xml_dir}/{frame_idx}.xml"

        xml_tree = self.generate_xml_objects(
            out_img, self.img_width, self.img_height, not_occluded_polygons)
        xml_tree.write(out_xml)

        if self.export_images:
            if ext.lower() == "png":
                write_image(out_img, frame)
                # cv2.imwrite writes nothing where the folder is missing, and
                # initialize makes Binary/ only for FULL_SYNTHETIC
                if binary is not None and os.path.isdir(self.export_bin_dir):
                    write_image(out_bin, binary)
            else:
                import cv2

                cv2.imwrite(out_img, frame, (cv2.IMWRITE_JPEG_QUALITY, 100))
                if binary is not None:
                    cv2.imwrite(out_bin, binary,
                                (cv2.IMWRITE_JPEG_QUALITY, 100))

    def export_unique_objects(self, frame: np.ndarray, frame_idx: int,
                              not_occluded_polygons) -> None:
        """Collect each visible instance of every text object (region crop
        + polygon mask) for best-image selection at finalize
        (reference: text_annotation_exporter.py:187-209)."""
        for text_name, polygon in not_occluded_polygons:
            array_poly = np.array(polygon, dtype=np.int32).reshape((-1, 1, 2))

            x1 = max(0, int(array_poly[:, 0, 0].min()))
            y1 = max(0, int(array_poly[:, 0, 1].min()))
            x2 = min(int(self.img_width), int(array_poly[:, 0, 0].max()))
            y2 = min(int(self.img_height), int(array_poly[:, 0, 1].max()))

            mask = np.zeros((self.img_height, self.img_width), dtype=np.uint8)
            fill_poly(mask, array_poly, 255)

            region_img = encode_png(frame[y1:y2, x1:x2])
            region_mask = encode_png(mask[y1:y2, x1:x2])
            instance = (frame_idx, (x1, y1, x2, y2), array_poly,
                        region_img, region_mask)
            self.exported_text_objects.setdefault(text_name, []).append(
                instance)

    def handle_frame(self, frame: Optional[np.ndarray],
                     frame_idx: int) -> None:
        """(reference: text_annotation_exporter.py:211-227 handleFrame)."""
        _, not_occluded, _ = self.frame_visible_bboxes_state(frame_idx)

        if self.export_mode == self.ALL_PER_FRAME:
            self.export_all_by_frame(frame, frame_idx, not_occluded)
        elif self.export_mode == self.UNIQUE_BOXES:
            self.export_unique_objects(frame, frame_idx, not_occluded)
        else:
            raise ValueError("invalid export mode")

    # ------------------------------------------- unique-boxes finalization

    def _append_xml_unique_object(self, filepath: str, object_name: str,
                                  polygon: np.ndarray) -> None:
        """(reference: text_annotation_exporter.py:229-247)."""
        object_xml = ET.SubElement(self.unique_objects_xml_root, "object")

        folder_name, image_filename = os.path.split(filepath)
        ET.SubElement(object_xml, "filename").text = image_filename
        ET.SubElement(object_xml, "folder").text = folder_name
        ET.SubElement(object_xml, "name").text = object_name

        polygon_xml = ET.SubElement(object_xml, "polygon")
        for p_idx, (px, py) in enumerate(polygon):
            ET.SubElement(polygon_xml, f"x{p_idx}").text = str(px)
            ET.SubElement(polygon_xml, f"y{p_idx}").text = str(py)

    def finalize_unique_text_boxes(self) -> None:
        """For each unique text object pick the instance closest (MSE) to
        the masked average of all its instances; save that crop + one XML
        of all final polygons (reference: text_annotation_exporter.py:249-324).

        Vectorized: the per-instance accumulation and MSE scans are summed
        arrays over an instance stack rather than python loops per pixel.
        """
        for text_name, instances in self.exported_text_objects.items():
            # BGR, as cv2.imdecode(img, cv2.IMREAD_COLOR) gives it
            images = [decode_png_color(img)[:, :, ::-1]
                      for _, _, _, img, _ in instances]
            masks = [decode_png_grayscale(mask)
                     for _, _, _, _, mask in instances]
            boxes = np.array([bbox for _, bbox, _, _, _ in instances])

            gb_x1, gb_y1 = boxes[:, 0].min(), boxes[:, 1].min()
            gb_x2, gb_y2 = boxes[:, 2].max(), boxes[:, 3].max()

            avg_img = np.zeros((gb_y2 - gb_y1, gb_x2 - gb_x1, 3), np.float64)
            avg_count = np.zeros((gb_y2 - gb_y1, gb_x2 - gb_x1), np.int64)
            for (x1, y1, _, _), img, mask in zip(boxes, images, masks):
                oy, ox = y1 - gb_y1, x1 - gb_x1
                avg_img[oy:oy + img.shape[0], ox:ox + img.shape[1]] += img
                avg_count[oy:oy + img.shape[0],
                          ox:ox + img.shape[1]] += (mask // 255)
            covered = avg_count > 0
            avg_img[covered] /= avg_count[covered][:, None]
            avg_img = avg_img.astype(np.uint8)

            all_mse = []
            for idx, ((x1, y1, _, _), img) in enumerate(zip(boxes, images)):
                oy, ox = y1 - gb_y1, x1 - gb_x1
                window = avg_img[oy:oy + img.shape[0], ox:ox + img.shape[1]]
                diff = window.astype(np.int64) - img.astype(np.int64)
                all_mse.append((float(np.mean(diff * diff)), idx))

            final_idx = sorted(all_mse)[0][1]
            final_poly = instances[final_idx][2]
            out_img = f"{self.export_img_dir}/{text_name}.png"
            self._append_xml_unique_object(out_img, text_name,
                                           final_poly[:, 0, :])
            write_image(out_img, images[final_idx])

        out_xml = f"{self.export_xml_dir}/text_objects.xml"
        ET.ElementTree(self.unique_objects_xml_root).write(out_xml)

    def finalize(self) -> None:
        if self.export_mode == self.UNIQUE_BOXES:
            self.finalize_unique_text_boxes()

    # -------------------------------------------------------------- misc

    @staticmethod
    def generate_xml_objects(filepath: str, frame_width: int,
                             frame_height: int, polygons) -> ET.ElementTree:
        """Per-frame GT XML: size + filename + one <object> per box, with
        <name>text</name>, the object id, and x{i}/y{i} polygon tags —
        byte-compatible with the reference writer
        (reference: text_annotation_exporter.py:341-378)."""
        annotation = ET.Element("annotation")

        size = ET.SubElement(annotation, "size")
        ET.SubElement(size, "width").text = str(frame_width)
        ET.SubElement(size, "height").text = str(frame_height)
        ET.SubElement(size, "depth").text = str(3)

        folder_name, image_filename = os.path.split(filepath)
        ET.SubElement(annotation, "filename").text = image_filename
        ET.SubElement(annotation, "folder").text = folder_name

        for object_name, polygon in polygons:
            obj = ET.SubElement(annotation, "object")
            ET.SubElement(obj, "name").text = "text"
            ET.SubElement(obj, "ID").text = object_name
            polygon_xml = ET.SubElement(obj, "polygon")
            for p_idx, (px, py) in enumerate(polygon):
                ET.SubElement(polygon_xml, f"x{p_idx}").text = str(px)
                ET.SubElement(polygon_xml, f"y{p_idx}").text = str(py)

        return ET.ElementTree(annotation)

    @staticmethod
    def from_annotation_xml(export_mode: int, export_prefixes,
                            export_speaker_name: str,
                            export_max_speaker_intersection: float,
                            output_dir: str, database, lecture,
                            export_dir: Optional[str],
                            export_images: bool = False
                            ) -> "TextAnnotationExporter":
        """Build from the standard per-lecture annotation file location
        (reference: text_annotation_exporter.py:380-396 FromAnnotationXML;
        note the reference's own evaluator calls this with a long-stale
        2-arg signature — text_detection_evaluator.py:115)."""
        path = (f"{output_dir}/{database.output_annotations}/"
                f"{database.name}_{lecture.title.lower()}.xml")
        annotation = LectureAnnotation.load(path)
        return TextAnnotationExporter(
            annotation, export_prefixes, export_speaker_name,
            export_max_speaker_intersection, export_mode, export_dir,
            export_images=export_images)


class TextDetectionEvaluator:
    """Scores detector bboxes against exporter-derived per-frame GT with
    pixel-coverage recall/precision/f-score, averaged per lecture
    (reference: text_detection_evaluator.py:6-251)."""

    def __init__(self, min_confidence: Optional[float] = None):
        self.min_confidence = min_confidence
        self.training_thresholds = np.arange(0.05, 1.0, 0.05)
        self.results_per_lecture: Dict[str, dict] = {}

    @staticmethod
    def generate_per_frame_gt(key_frame_ids, text_exporter) -> dict:
        """Rasterized axis-aligned GT mask per keyframe from the exporter's
        visible boxes (reference: text_detection_evaluator.py:81-101;
        the reference unpacks its (name, polygon) tuples as 4 floats —
        latent bug in orphan code — we take the polygon's bbox, which is
        the evident intent)."""
        all_gt_frames = {}
        for frame_idx in key_frame_ids:
            _, not_occluded, occluded = \
                text_exporter.frame_visible_bboxes_state(frame_idx)

            gt_frame = np.zeros(
                (text_exporter.img_height, text_exporter.img_width), bool)
            for _, polygon in not_occluded:
                pts = np.asarray(polygon)
                x1, y1 = pts.min(axis=0)
                x2, y2 = pts.max(axis=0)
                # clamp BOTH ends (reference text_annotation_exporter.py:
                # 192-195) and skip boxes fully off-frame — a negative end
                # would wrap the slice and mark most of the frame as GT
                x1, y1 = max(0, int(x1)), max(0, int(y1))
                x2 = min(text_exporter.img_width, int(x2))
                y2 = min(text_exporter.img_height, int(y2))
                if x2 > x1 and y2 > y1:
                    gt_frame[y1:y2, x1:x2] = True

            all_gt_frames[frame_idx] = {
                "total_occluded": len(occluded),
                "total_visible": len(not_occluded),
                "pixel_visible": gt_frame,
            }
        return all_gt_frames

    @staticmethod
    def get_text_det_metrics(text_detection: dict, keyframe_gt: dict,
                             min_confidence: Optional[float] = None) -> dict:
        """Pixel recall/precision/f-score of detected boxes vs GT masks,
        averaged over keyframes (reference: text_detection_evaluator.py:12-79;
        empty GT/detection count as perfect recall/precision, as there)."""
        all_recall, all_precision, all_fscore = [], [], []
        all_gt_counts, all_det_counts = [], []
        for keyframe_id in sorted(text_detection.keys()):
            frame_results = text_detection[keyframe_id]
            gt_frame = keyframe_gt[keyframe_id]["pixel_visible"]
            gt_count = keyframe_gt[keyframe_id]["total_visible"]

            det_frame = np.zeros(gt_frame.shape, bool)
            # a frame without per-box confidences cannot be filtered —
            # treat its boxes as all-valid rather than crashing on None
            confidences = (frame_results.get("confidences")
                           if min_confidence is not None else None)
            total_valid = 0
            for bbox_idx, (x1, y1, x2, y2) in \
                    enumerate(frame_results["bboxes"]):
                if (min_confidence is None or confidences is None
                        or confidences[bbox_idx] >= min_confidence):
                    total_valid += 1
                    det_frame[int(y1):int(y2), int(x1):int(x2)] = True

            matched = np.count_nonzero(gt_frame & det_frame)
            n_gt = np.count_nonzero(gt_frame)
            n_det = np.count_nonzero(det_frame)
            recall = matched / n_gt if n_gt > 0 else 1.0
            precision = matched / n_det if n_det > 0 else 1.0
            fscore = ((2.0 * recall * precision) / (recall + precision)
                      if recall + precision > 0 else 0.0)

            all_recall.append(recall)
            all_precision.append(precision)
            all_fscore.append(fscore)
            all_gt_counts.append(gt_count)
            all_det_counts.append(total_valid)

        return {
            "avg_recall": float(np.mean(all_recall)),
            "avg_precision": float(np.mean(all_precision)),
            "avg_fscore": float(np.mean(all_fscore)),
            "avg_gt_count": float(np.mean(all_gt_counts)),
            "avg_det_count": float(np.mean(all_det_counts)),
        }

    # ------------------------------------------------------- lecture runs

    def evaluate_lecture(self, lecture_title: str, text_exporter,
                         raw_text_detection: dict,
                         refined_text_detection: dict) -> dict:
        """Raw + refined detection metrics for one lecture
        (reference: text_detection_evaluator.py:103-133 process_input)."""
        keyframe_ids = sorted(raw_text_detection.keys())
        keyframe_gt = self.generate_per_frame_gt(keyframe_ids, text_exporter)

        current = {
            "raw": self.get_text_det_metrics(
                raw_text_detection, keyframe_gt, self.min_confidence),
            "refined": self.get_text_det_metrics(
                refined_text_detection, keyframe_gt, None),
        }
        self.results_per_lecture[lecture_title] = current
        return current

    def evaluate_lecture_thresholds(self, lecture_title: str, text_exporter,
                                    raw_text_detection: dict) -> dict:
        """Confidence-threshold sweep for one lecture
        (reference: text_detection_evaluator.py:135-165 process_train_input)."""
        keyframe_ids = sorted(raw_text_detection.keys())
        keyframe_gt = self.generate_per_frame_gt(keyframe_ids, text_exporter)

        current = {}
        for conf_threshold in self.training_thresholds:
            current[conf_threshold] = self.get_text_det_metrics(
                raw_text_detection, keyframe_gt, conf_threshold)
        self.results_per_lecture[lecture_title] = current
        return current

    # ----------------------------------------------------------- reports

    def totals_table(self) -> str:
        """Raw-vs-refined per-lecture table plus averages
        (reference: text_detection_evaluator.py:167-212 print_totals)."""
        lines = [" \t \tRaw\t \t \t \tRefined",
                 "Lectures\tGT Box\tBoxes\tRec.\tPrec.\tF.Score"
                 "\tBoxes\tRec.\tPrec.\tF.Score"]
        row = ("{0:s}\t{1:.2f}\t{2:.2f}\t{3:.2f}\t{4:.2f}\t{5:.2f}"
               "\t{6:.2f}\t{7:.2f}\t{8:.2f}\t{9:.2f}")

        acc = {key: [] for key in ("gt", "raw_r", "raw_p", "raw_f", "raw_n",
                                   "ref_r", "ref_p", "ref_f", "ref_n")}
        for lecture_id in sorted(self.results_per_lecture.keys()):
            raw = self.results_per_lecture[lecture_id]["raw"]
            ref = self.results_per_lecture[lecture_id]["refined"]
            acc["gt"].append(raw["avg_gt_count"])
            for prefix, res in (("raw", raw), ("ref", ref)):
                acc[f"{prefix}_r"].append(res["avg_recall"])
                acc[f"{prefix}_p"].append(res["avg_precision"])
                acc[f"{prefix}_f"].append(res["avg_fscore"])
                acc[f"{prefix}_n"].append(res["avg_det_count"])
            lines.append(row.format(
                lecture_id, raw["avg_gt_count"], raw["avg_det_count"],
                raw["avg_recall"] * 100, raw["avg_precision"] * 100,
                raw["avg_fscore"] * 100, ref["avg_det_count"],
                ref["avg_recall"] * 100, ref["avg_precision"] * 100,
                ref["avg_fscore"] * 100))

        lines.append(row.format(
            "Averages", float(np.mean(acc["gt"])), float(np.mean(acc["raw_n"])),
            np.mean(acc["raw_r"]) * 100, np.mean(acc["raw_p"]) * 100,
            np.mean(acc["raw_f"]) * 100, float(np.mean(acc["ref_n"])),
            np.mean(acc["ref_r"]) * 100, np.mean(acc["ref_p"]) * 100,
            np.mean(acc["ref_f"]) * 100))
        return "\n".join(lines)

    def train_totals(self) -> Tuple[str, float]:
        """Threshold-sweep summary table and the best (max mean f-score)
        threshold (reference: text_detection_evaluator.py:214-250)."""
        lines = ["\nSummary of confidence thresholds\n",
                 "\nTh\tGT Box\tBoxes\tRec.\tPrec.\tF.Score"]
        row = "{0:.4f}\t{1:.4f}\t{2:.4f}\t{3:.4f}\t{4:.4f}\t{5:.4f}"

        mean_fscores = []
        for conf_threshold in self.training_thresholds:
            stats = {key: [] for key in ("gt", "n", "r", "p", "f")}
            for lecture_id in sorted(self.results_per_lecture.keys()):
                raw = self.results_per_lecture[lecture_id][conf_threshold]
                stats["gt"].append(raw["avg_gt_count"])
                stats["n"].append(raw["avg_det_count"])
                stats["r"].append(raw["avg_recall"])
                stats["p"].append(raw["avg_precision"])
                stats["f"].append(raw["avg_fscore"])
            mean_fscores.append(float(np.mean(stats["f"])))
            lines.append(row.format(
                conf_threshold, float(np.mean(stats["gt"])),
                float(np.mean(stats["n"])), float(np.mean(stats["r"])),
                float(np.mean(stats["p"])), mean_fscores[-1]))

        best = float(self.training_thresholds[int(np.argmax(mean_fscores))])
        lines.append("\nBest threshold: " + str(best))
        return "\n".join(lines), best
