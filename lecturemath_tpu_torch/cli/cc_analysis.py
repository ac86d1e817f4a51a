"""Stage 02 CLI — unique-CC tracking over binarized frames.

Usage: python -m lecturemath_tpu_torch.cli.cc_analysis <config> [options]
[-device cpu]
(reference equivalent: pre_ST3D_v3.0_02_cc_analaysis.py.) With
CC_ANALYSIS_DEVICE_LABELING = 1 the labeling runs on the card (kernel K3)
unless ``-device cpu`` is given; without a card it raises up front.
``-device cpu`` can change the result: the plain labeler keeps the JAX
package's bound of 64 propagation rounds and may leave a long winding
component split, where the card's kernel always reaches the fixed point.
"""

import sys

from ..pipeline.driver import PipelineDriver, usage_check
from ..pipeline.express import driver_device
from ..pipeline.stages import stage02_cc_analysis


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if not usage_check(argv):
        return

    driver = PipelineDriver.from_config_path(argv[1], argv[2:],
                                             "BINARIZATION_OUTPUT",
                                             "CC_STABILITY_OUTPUT")
    if driver.config.get_bool("CC_ANALYSIS_DEVICE_LABELING", False):
        from ..core.device import resolve_device

        resolve_device(driver_device(driver))    # this mode touches the card
    driver.run(stage02_cc_analysis)
    print("Finished")


if __name__ == "__main__":
    main()
