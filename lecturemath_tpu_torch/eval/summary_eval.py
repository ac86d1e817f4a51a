"""Per-lecture summary evaluation driver + dataset keyframe loading.

(reference: AccessMath/evaluation/summary_evaluator.py:14-186,
keyframe_annotation.py:515-547, eval_multiple_summaries.py:8-27)

GT images are read as ``cv2.imread`` reads them, by ``utils/png.py``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..core.config import Config
from ..core.metadata import MetaDataDB
from .annotation import KeyframeAnnotation, UniqueCCGroup
from ..utils.png import read_image
from .evaluator import EvalParams, Evaluator


def load_dataset_keyframes(output_root: str, database: MetaDataDB,
                           dataset_name: str = "training"):
    """Load GT keyframes (+ binary annotations + portions) for a dataset;
    returns (annotated_keyframes, raw_copies_for_binarization)
    (reference: LoadDatasetKeyframes, keyframe_annotation.py:515-547)."""
    all_keyframes: List[KeyframeAnnotation] = []
    binarized_keyframes: List[KeyframeAnnotation] = []

    dataset = database.get_dataset(dataset_name)
    for lecture in dataset.lectures:
        prefix = os.path.join(output_root, database.output_annotations,
                              f"{database.name}_{lecture.title.lower()}")
        keyframes = KeyframeAnnotation.load_exported_keyframes(
            os.path.join(prefix, "segments.xml"),
            os.path.join(prefix, "keyframes") + "/", False, False)
        KeyframeAnnotation.load_portions(
            os.path.join(prefix, "portions.xml"), keyframes,
            os.path.join(prefix, "portions"))

        all_keyframes += keyframes
        for kf in keyframes:
            kf.binary_image = read_image(
                os.path.join(prefix, "binary", f"{kf.idx}.png"))
            kf.update_binary_cc(False)
            binarized_keyframes.append(
                KeyframeAnnotation(kf.database, kf.lecture, kf.idx, kf.time,
                                   kf.objects, kf.raw_image))

    return all_keyframes, binarized_keyframes


class SummaryEvaluator:
    """Evaluate generated summaries against GT annotations per lecture and
    print per-lecture / average tables."""

    def __init__(self, params: Optional[EvalParams] = None):
        self.params = params or EvalParams()
        self.evaluator = Evaluator(self.params)
        self.per_lecture_metrics: Dict[str, dict] = {}
        self.keyframe_counts: Dict[str, int] = {}
        self.ranges_per_lecture: Dict[str, list] = {}

    def percentile_range_names(self) -> List[str]:
        bounds = [0.0] + [float(p) for p in self.params.size_percentiles] + [100.0]
        names = [f"{bounds[i]:.2f}% to {bounds[i + 1]:.2f}%"
                 for i in range(len(bounds) - 1)]
        return names + ["all"]

    def evaluate_lecture(self, config: Config, database: MetaDataDB, lecture,
                         baseline_prefix: str = "", verbose: bool = False):
        output_root = config.get_str("OUTPUT_PATH")
        suffix = f"{database.name}_{lecture.title.lower()}"
        summary_prefix = os.path.join(output_root, database.output_summaries,
                                      baseline_prefix + suffix)
        annotation_prefix = os.path.join(output_root,
                                         database.output_annotations, suffix)

        # ground truth
        gt_keyframes, gt_segments = KeyframeAnnotation.load_exported_keyframes(
            os.path.join(annotation_prefix, "segments.xml"),
            os.path.join(annotation_prefix, "keyframes") + "/", True)
        for kf in gt_keyframes:
            kf.binary_image = read_image(
                os.path.join(annotation_prefix, "binary", f"{kf.idx}.png"))
            kf.update_binary_cc(False)
        gt_keyframes = KeyframeAnnotation.combine_per_segment(
            gt_keyframes, gt_segments, False)
        gt_cc_group, gt_groups = UniqueCCGroup.groups_from_xml(
            gt_keyframes, os.path.join(annotation_prefix, "unique_ccs.xml"))

        # generated summary
        summ_keyframes, summ_segments = \
            KeyframeAnnotation.load_exported_keyframes(
                os.path.join(summary_prefix, "segments.xml"),
                os.path.join(summary_prefix, "keyframes") + "/", True,
                False, True)
        for kf in summ_keyframes:
            kf.update_binary_cc(False)
        summ_keyframes = KeyframeAnnotation.combine_per_segment(
            summ_keyframes, summ_segments, False)

        metrics, ranges = self.evaluator.compute_summary_metrics(
            gt_segments, gt_keyframes, gt_groups, gt_cc_group,
            summ_segments, summ_keyframes, verbose)

        self.per_lecture_metrics[lecture.title] = metrics
        self.keyframe_counts[lecture.title] = len(summ_keyframes)
        self.ranges_per_lecture[lecture.title] = ranges
        return metrics

    # ----------------------------------------------------------- rollups

    def totals_per_min_rp(self) -> Dict[str, dict]:
        """(reference: basic_totals_per_minRP, summary_evaluator.py:102-143)"""
        stats: Dict[str, dict] = {}
        range_names = self.percentile_range_names()

        for lecture_id, lecture_metrics in self.per_lecture_metrics.items():
            for range_key, entries in lecture_metrics.items():
                if range_key == "all":
                    range_name = "all"
                else:
                    range_idx = self.ranges_per_lecture[lecture_id].index(range_key)
                    range_name = range_names[range_idx]

                for entry in entries:
                    level_key = (f"{entry['min_cc_recall'] * 100:.2f}\t"
                                 f"{entry['min_cc_precision'] * 100:.2f}")
                    level = stats.setdefault(level_key, {})
                    level.setdefault(range_name, {})[lecture_id] = {
                        "global": {
                            "recall": entry["recall_metrics"]["recall"] * 100,
                            "precision": entry["precision_metrics"]["precision"] * 100,
                        },
                        "per_frame": {
                            "recall": entry["recall_metrics"]["avg_recall"] * 100,
                            "precision": entry["precision_metrics"]["avg_precision"] * 100,
                        },
                    }
        return stats

    def print_totals(self, all_ranges: bool = False) -> None:
        stats = self.totals_per_min_rp()
        row = "{0:s}\t{1:.2f}\t{2:.2f}\t{3:.2f}\t{4:.2f}\t{5:.2f}"

        for level_key in sorted(stats):
            print("\n" + "=" * 50)
            print("Min CC recall - Min CC precision: " + level_key)
            ranges = (self.percentile_range_names() if all_ranges else ["all"])
            for range_name in ranges:
                if range_name not in stats[level_key]:
                    continue
                range_stats = stats[level_key][range_name]
                print(f"\nSize Range: {range_name}")
                print(" \t \tGlob.\t \tAVG\t")
                print("Lect.\tFrames\tRec.\tPrec.\tRec.\tPrec.")

                columns = {k: [] for k in ("count", "r", "p", "ar", "ap")}
                for lecture_id in sorted(range_stats):
                    ls = range_stats[lecture_id]
                    count = self.keyframe_counts[lecture_id]
                    columns["count"].append(count)
                    columns["r"].append(ls["global"]["recall"])
                    columns["p"].append(ls["global"]["precision"])
                    columns["ar"].append(ls["per_frame"]["recall"])
                    columns["ap"].append(ls["per_frame"]["precision"])
                    print(row.format(lecture_id, count, ls["global"]["recall"],
                                     ls["global"]["precision"],
                                     ls["per_frame"]["recall"],
                                     ls["per_frame"]["precision"]))
                print(row.format("Averages",
                                 float(np.mean(columns["count"])),
                                 float(np.mean(columns["r"])),
                                 float(np.mean(columns["p"])),
                                 float(np.mean(columns["ar"])),
                                 float(np.mean(columns["ap"]))))
                print("")
