"""Smoke tool: plot per-frame ink sums against GT segment boundaries.

Usage: python -m lecturemath_tpu_torch.cli.vis_gt_intervals config [-l lecture]
(reference equivalent: vis_gt_invervals.py)
"""

import os
import sys

import numpy as np

from ..eval.lecture_annotation import LectureAnnotation
from ..pipeline.driver import PipelineDriver, usage_check
from ..pipeline.segmentation import binary_sums
from ..pipeline.video import decompress_png
from ..utils.visualizer import signal_plot


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if not usage_check(argv):
        return

    driver = PipelineDriver.from_config_path(argv[1], argv[2:],
                                             "BINARIZATION_OUTPUT", None)
    for lecture in driver.iter_lectures():
        frame_times, frame_indices, compressed = driver.load_inputs(lecture)
        sums = np.asarray(binary_sums(decompress_png(compressed)))

        annotation_path = os.path.join(
            driver.output_root, driver.database.output_annotations,
            f"{driver.database.name}_{lecture.title.lower()}.xml")
        intervals = None
        if os.path.exists(annotation_path):
            annotation = LectureAnnotation.load(annotation_path)
            bounds = annotation.segments_with_bounds()
            # map absolute GT boundaries to sample offsets
            offsets = np.searchsorted(frame_indices, bounds)
            intervals = list(zip(offsets[:-1], offsets[1:] - 1))

        os.makedirs(driver.images_dir, exist_ok=True)
        out_path = os.path.join(driver.images_dir,
                                f"gt_intervals_{lecture.title}.png")
        signal_plot({"ink sum": sums}, out_path, intervals,
                    f"Content sums vs GT segments: {lecture.title}")
        print(f"Wrote {out_path}")


if __name__ == "__main__":
    main()
