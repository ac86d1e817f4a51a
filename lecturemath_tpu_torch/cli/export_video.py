"""Export a lecture's binarized output as a full-rate video with the
source audio (reference: KeyframeExporter.ExportVideo,
AccessMath/preprocessing/content/keyframe_exporter.py:295-357 — library-
only there; this gives it a first-class CLI).

Usage: python -m lecturemath_tpu_torch.cli.export_video <config> -l <lecture>
[-o out.mp4] [-invert 1] [-interp N] [-fps F]

Reads the stage-01 artifact (<BINARIZATION_OUTPUT>), expands the sampled
binary frames to full frame rate with linear interpolation, and muxes the
source video's audio via ffmpeg (silent video fallback when ffmpeg or the
source is unavailable).
"""

import os
import sys

from ..pipeline.driver import PipelineDriver, usage_check
from ..pipeline.export_video import export_binary_video


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if not usage_check(argv):
        return

    driver = PipelineDriver.from_config_path(
        argv[1], argv[2:], "BINARIZATION_OUTPUT", None)

    lectures = list(driver.iter_lectures())
    if "o" in driver.params and len(lectures) > 1:
        raise ValueError("-o names one output file; select one lecture "
                         "with -l when using it")
    exported = []
    for lecture in lectures:
        if not driver.store.exists(driver.input_prefixes, lecture.id):
            raise FileNotFoundError(
                f"stage-01 artifact for <{lecture.title}> not found under "
                f"{driver.temporal_dir} — run cli.binarize first")
        out_path = str(driver.params.get(
            "o", os.path.join(driver.output_root, "videos",
                              f"{driver.database.name}_{lecture.id}"
                              f"_binary.mp4")))
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        result = export_binary_video(
            driver.store, driver.input_prefixes, lecture,
            driver.video_paths(lecture), out_path,
            invert_binary=str(driver.params.get("invert", "0")) == "1",
            interp_skip=int(driver.params.get("interp", 0)),
            fps=(float(driver.params["fps"])
                 if "fps" in driver.params else None))
        print(f"Exported <{lecture.title}> -> {result}")
        exported.append(result)
    if not exported:
        print("No matching lecture (use -l <lecture> / -d <dataset>)")
    print("Finished")


if __name__ == "__main__":
    main()
