"""Video length/frame accounting tool: compare the container's claimed
frame counts against the grabbed truth for each lecture video.

Usage: python -m lecturemath_tpu_torch.cli.video_metrics config [-l lecture]
       [-d dataset] [-json out.json]
(reference equivalent: AccessMath/annotation/lecture_video_metrics.py
driven through ConsoleUIProcess)
"""

import json
import sys

from ..pipeline.driver import PipelineDriver, usage_check
from ..pipeline.video_metrics import LectureVideosMetrics


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if not usage_check(argv):
        return

    json_path = None
    args = argv[2:]
    if "-json" in args:
        at = args.index("-json")
        json_path = args[at + 1]
        args = args[:at] + args[at + 2:]

    driver = PipelineDriver.from_config_path(argv[1], args, None, None)
    accumulator = LectureVideosMetrics()
    for lecture in driver.iter_lectures():
        accumulator.process_lecture(
            lecture, driver.config.get_str("VIDEO_FILES_PATH", ""))

    if json_path is not None:
        with open(json_path, "w") as out:
            json.dump(accumulator.to_dict(), out, indent=2)
        print(f"Wrote {json_path}")


if __name__ == "__main__":
    main()
