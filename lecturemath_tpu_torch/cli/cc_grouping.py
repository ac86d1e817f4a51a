"""Stage 03 CLI — spatio-temporal CC grouping + conflicts + ST3D.

Usage: python -m lecturemath_tpu_torch.cli.cc_grouping <config> [options]
(reference equivalent: pre_ST3D_v3.0_03_cc_grouping.py)
"""

import sys

from ..pipeline.driver import PipelineDriver, usage_check
from ..pipeline.stages import stage03_cc_grouping


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if not usage_check(argv):
        return

    driver = PipelineDriver.from_config_path(
        argv[1], argv[2:], "CC_STABILITY_OUTPUT",
        ["CC_RECONSTRUCTED_OUTPUT", "CC_CONFLICTS_OUTPUT", "CC_ST3D_OUTPUT"])
    driver.run(stage03_cc_grouping)
    print("Finished")


if __name__ == "__main__":
    main()
