"""Segmentation evaluation CLI.

Usage: python -m lecturemath_tpu_torch.cli.eval_segments <config> <training 0|1>
[edited_gt.json]
(reference equivalent: lecturenet_eval_segments.py)
"""

import json
import os
import sys

import numpy as np

from ..core.artifacts import ArtifactStore
from ..core.config import Config
from ..core.metadata import MetaDataDB
from ..eval.lecture_annotation import LectureAnnotation
from ..eval import segments_eval as se


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if len(argv) < 3:
        print(f"Usage: python {argv[0]} config training [edited_gt]")
        print("\ttraining: 1 for training set, 0 for testing set")
        return

    config = Config.from_file(argv[1])
    database = MetaDataDB.from_file(config.get_str("VIDEO_DATABASE_PATH"))
    dataset_name = "training" if int(argv[2]) > 0 else "testing"

    edited_gt = None
    if len(argv) >= 4:
        with open(argv[3]) as f:
            edited_gt = json.load(f)

    output_root = config.get_str("OUTPUT_PATH")
    store = ArtifactStore(os.path.join(output_root, database.output_temporal))
    segments_prefix = config.get_str("VIDEO_SEGMENTATION_OUTPUT")
    binary_prefix = config.get_str("BINARIZATION_OUTPUT")

    groups = {"all": []}
    if edited_gt is not None:
        groups["edited"] = []
        groups["non_edited"] = []

    for lecture in database.get_dataset(dataset_name).lectures:
        print(f"Processing: {lecture.title}")
        pred_offsets = store.load(segments_prefix, lecture.title)
        frame_times, frame_indices, _ = store.load(binary_prefix, lecture.title)

        annotation_path = os.path.join(
            output_root, database.output_annotations,
            f"{database.name}_{lecture.title.lower()}.xml")
        annotation = LectureAnnotation.load(annotation_path)

        pred_segments = [(frame_indices[s], frame_indices[e])
                         for s, e in pred_offsets]

        result = se.evaluate_lecture_segments(
            annotation.segments_with_bounds(), annotation.video_segments,
            pred_segments, annotation.total_frames)
        result["title"] = lecture.title
        groups["all"].append(result)
        if edited_gt is not None:
            key = ("edited" if edited_gt[lecture.title]["edited"]
                   else "non_edited")
            groups[key].append(result)

        print(f"GT segments: {result['n_gt']}, predicted: {result['n_pred']}, "
              f"SIoU: {result['siou']:.4f}")

    for group_name, lectures in groups.items():
        if not lectures:
            continue
        print(f"\nPer-lecture summary ({group_name})")
        print("Lecture\tGT\tPred.\tMatch@.5\tSIoU")
        for lec in lectures:
            print(f"{lec['title']}\t{lec['n_gt']}\t{lec['n_pred']}\t"
                  f"{lec['per_iou'][0.5]['matches']}\t{lec['siou']:.4f}")
        print(f"AVG segments GT: {np.mean([l['n_gt'] for l in lectures]):.2f}"
              f"  Pred: {np.mean([l['n_pred'] for l in lectures]):.2f}")

        se.print_rollup(f"Segment matching by IOU ({group_name})", "IOU",
                        se.IOU_LEVELS, lectures, "per_iou")
        se.print_rollup(f"Split matching by max gap ({group_name})", "Mx_Gap",
                        se.MAX_GAPS, lectures, "per_gap")
        se.print_rollup(f"Split matching by proportional gap ({group_name})",
                        "Pr_Gap", se.PROP_GAPS, lectures, "per_prop")


if __name__ == "__main__":
    main()
