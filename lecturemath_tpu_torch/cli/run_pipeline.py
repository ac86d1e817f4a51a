"""Express pipeline CLI: all five stages in one pass per lecture, no
inter-stage PNG pickle relay. Stage 01 runs on the card unless
``-device cpu`` is given.

Usage: python -m lecturemath_tpu_torch.cli.run_pipeline <config>
[-l lecture] [-d dataset] [-shard i/n] [-save 1] [-device cpu]
"""

import sys

from ..pipeline.binarize import Binarizer
from ..pipeline.driver import PipelineDriver, usage_check
from ..pipeline.express import check_no_device_worker, driver_device, run_lecture


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if not usage_check(argv):
        return

    driver = PipelineDriver.from_config_path(argv[1], argv[2:], None, None)
    check_no_device_worker(driver.config)
    binarizer = Binarizer.from_config(driver.config,
                                      device=driver_device(driver))
    save_artifacts = str(driver.params.get("save", "0")) == "1"

    for lecture in driver.iter_lectures():
        with driver.timer.measure(lecture.title):
            indices, times, keyframes = run_lecture(
                driver, lecture, binarizer, save_artifacts=save_artifacts)
        print(f"{lecture.title}: {len(keyframes)} keyframes in "
              f"{driver.timer.totals[lecture.title]:.2f}s")
    print("Finished")


if __name__ == "__main__":
    main()
