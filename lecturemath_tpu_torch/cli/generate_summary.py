"""Stage 05 CLI — keyframe summary generation + export.

Usage: python -m lecturemath_tpu_torch.cli.generate_summary <config> [options]
(reference equivalent: pre_ST3D_v3.0_05_generate_summary.py)
"""

import sys

from ..pipeline.driver import PipelineDriver, usage_check
from ..pipeline.stages import stage05_summary


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if not usage_check(argv):
        return

    driver = PipelineDriver.from_config_path(
        argv[1], argv[2:], ["CC_ST3D_OUTPUT", "VIDEO_SEGMENTATION_OUTPUT"],
        "SUMMARY_KEYFRAMES_OUTPUT")
    driver.run(stage05_summary)
    print("Finished")


if __name__ == "__main__":
    main()
