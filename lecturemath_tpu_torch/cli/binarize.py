"""Stage 01 CLI — batched binarization of lecture videos on the card.

Usage: python -m lecturemath_tpu_torch.cli.binarize <config> [-l lecture]
[-d dataset] [-device cpu]
(reference equivalent: pre_ST3D_v3.0_01_binarize.py.) Stage 01 runs on the
card unless ``-device cpu`` is given; without a card it raises. Frame
sharding over several cards (``-mesh`` / the TPU_MESH config key) is not
ported yet and raises.
"""

import sys

from ..core.device import resolve_device
from ..pipeline.binarize import Binarizer
from ..pipeline.driver import PipelineDriver, usage_check
from ..pipeline.express import driver_device
from ..pipeline.stages import stage01_binarize


def check_no_mesh(params, config) -> None:
    """-mesh / TPU_MESH ask for frame sharding over several cards."""
    value = params.get("mesh")
    if value is None:
        value = config.get("TPU_MESH", None)
    if value not in (None, "", 0, "0", "none", "1", 1):
        raise NotImplementedError(
            "mesh sharding over several cards (-mesh / TPU_MESH) is not "
            "ported yet (ROADMAP queue 1, item 10)")


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if not usage_check(argv):
        return

    driver = PipelineDriver.from_config_path(argv[1], argv[2:], None,
                                             "BINARIZATION_OUTPUT")
    check_no_mesh(driver.params, driver.config)
    device = resolve_device(driver_device(driver))
    binarizer = Binarizer.from_config(driver.config, device=device)
    driver.run(lambda d, lecture, inputs:
               stage01_binarize(d, lecture, inputs, binarizer))
    print("Finished")


if __name__ == "__main__":
    main()
