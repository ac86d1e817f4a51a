"""Express pipeline CLI: all five stages in one pass per lecture, no
inter-stage PNG pickle relay. Stage 01 runs on the card unless
``-device cpu`` is given.

Usage: python -m lecturemath_tpu_torch.cli.run_pipeline <config>
[-l lecture] [-d dataset] [-shard i/n] [-save 1] [-mesh D|DxM] [-device cpu]
[-trace dir]

``-mesh D`` / TPU_MESH shard stage 01's frames over D devices, ``-mesh
DxM`` also the model's channels over M devices of each data position, and
the LM_* env contract joins the processes of several hosts, as for the
stage-01 CLI (cli/binarize.py). Without a mesh,
DEVICE_WORKER_RECYCLE_MB > 0 runs stage 01 in a
recycled device worker process (pipeline/device_worker.py), one shared by
every lecture of the run. ``-trace <dir>`` writes a torch profiler trace of
the lectures, with the port's spans on its threads, to ``<dir>/trace.json``
(``PipelineDriver.trace``).
"""

import sys

from ..pipeline.binarize import Binarizer
from ..pipeline.driver import PipelineDriver, usage_check
from ..pipeline.express import driver_device, run_lecture
from .binarize import resolve_mesh


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if not usage_check(argv):
        return

    driver = PipelineDriver.from_config_path(argv[1], argv[2:], None, None)
    from ..parallel.mesh import shutdown_distributed

    device = driver_device(driver)
    # finally: a process that fails mid-run still joins the shutdown
    # barrier its peers wait at
    binarizer = None
    try:
        mesh = resolve_mesh(driver.params, driver.config, device)
        recycle_mb = driver.config.get_float("DEVICE_WORKER_RECYCLE_MB", 0.0)
        if recycle_mb > 0 and mesh is None:
            # recycled child device process (pipeline/device_worker.py),
            # shared across lectures so a healthy child stays warm between
            # them
            from ..pipeline.device_worker import WorkerBinarizer

            binarizer = WorkerBinarizer.from_config(driver.config,
                                                    device=device)
        else:
            binarizer = Binarizer.from_config(driver.config, device=device,
                                              mesh=mesh)
        save_artifacts = str(driver.params.get("save", "0")) == "1"

        with driver.trace():
            for lecture in driver.iter_lectures():
                with driver.timer.measure(lecture.title):
                    indices, times, keyframes = run_lecture(
                        driver, lecture, binarizer,
                        save_artifacts=save_artifacts)
                print(f"{lecture.title}: {len(keyframes)} keyframes in "
                      f"{driver.timer.totals[lecture.title]:.2f}s")
    finally:
        if binarizer is not None and hasattr(binarizer, "close"):
            binarizer.close()
        shutdown_distributed()
    print("Finished")


if __name__ == "__main__":
    main()
