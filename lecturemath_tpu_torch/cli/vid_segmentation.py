"""Stage 04 CLI — temporal video segmentation.

Usage: python -m lecturemath_tpu_torch.cli.vid_segmentation <config> [options]
(reference equivalent: pre_ST3D_v3.0_04_vid_segmentation.py)
"""

import sys

from ..core.config import Config
from ..pipeline.driver import PipelineDriver, usage_check
from ..pipeline.stages import stage04_input_keys, stage04_segmentation


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if not usage_check(argv):
        return

    config = Config.from_file(argv[1])
    driver = PipelineDriver.from_config_path(argv[1], argv[2:],
                                             stage04_input_keys(config),
                                             "VIDEO_SEGMENTATION_OUTPUT")
    driver.run(stage04_segmentation)
    print("Finished")


if __name__ == "__main__":
    main()
