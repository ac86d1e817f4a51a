"""Stage 01 CLI — batched binarization of lecture videos on the card.

Usage: python -m lecturemath_tpu_torch.cli.binarize <config> [-l lecture]
[-d dataset] [-mesh D|DxM] [-device cpu]
(reference equivalent: pre_ST3D_v3.0_01_binarize.py.) Stage 01 runs on the
card unless ``-device cpu`` is given; without a card it raises. ``-mesh D``
/ the TPU_MESH config key shard the frames over D devices (one replica of
the model a card; on the CPU, D replicas); ``-mesh DxM`` also shards the
model's channels over M devices of each data position (the model axis,
parallel/model_axis.py; D·M cards, or D·M CPU shards with ``-device
cpu``). Under the LM_COORDINATOR / LM_NUM_PROCESSES / LM_PROCESS_ID
contract the same CLI on every host joins one world and the mesh spans
every process's devices. The training CLIs take ``-mesh DxM`` too
(cli/train_binarizer.py).
"""

import sys

from ..core.device import resolve_device
from ..pipeline.binarize import Binarizer
from ..pipeline.driver import PipelineDriver, usage_check
from ..pipeline.express import driver_device
from ..pipeline.stages import stage01_binarize


def resolve_mesh(params, config, device=None):
    """Build the device mesh a CLI run asked for (-mesh / TPU_MESH) on
    ``device`` (None: the card), or None for the default single-device
    path. Joins a multi-process world first when the LM_COORDINATOR env
    contract is set (several hosts: the same CLI on every host with its
    own LM_PROCESS_ID)."""
    from ..parallel.mesh import (initialize_distributed_from_env, make_mesh,
                                 mesh_devices, mesh_spec_from,
                                 warmup_collectives)

    initialize_distributed_from_env(device)
    spec = mesh_spec_from(params, config)
    if spec is None:
        return None
    mesh = make_mesh(spec, mesh_devices(device, spec))
    warmup_collectives(mesh)  # communicators before the first batch
    return mesh


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if not usage_check(argv):
        return

    driver = PipelineDriver.from_config_path(argv[1], argv[2:], None,
                                             "BINARIZATION_OUTPUT")
    from ..parallel.mesh import shutdown_distributed

    device = resolve_device(driver_device(driver))
    # finally: a process that fails mid-run still joins the shutdown
    # barrier its peers wait at
    try:
        binarizer = Binarizer.from_config(
            driver.config, device=device,
            mesh=resolve_mesh(driver.params, driver.config, device))
        driver.run(lambda d, lecture, inputs:
                   stage01_binarize(d, lecture, inputs, binarizer))
    finally:
        shutdown_distributed()
    print("Finished")


if __name__ == "__main__":
    main()
