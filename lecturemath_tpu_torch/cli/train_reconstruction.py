"""Med-PT: pretrain the reconstruction branch against median-blurred targets.

Usage: python -m lecturemath_tpu_torch.cli.train_reconstruction <config>
[-device cpu] [-mesh D|DxM]
(reference equivalent: lecturenet_train_00_pretrain_reconstruction.py.)
Trains on the card unless ``-device cpu`` is given; without a card it
raises.

``-mesh D`` / TPU_MESH trains data-parallel over D devices, one process a
device: without LM_COORDINATOR this process starts D workers of itself on
this host (parallel/launch.py), each on one card through
CUDA_VISIBLE_DEVICES (or on the CPU with ``-device cpu``), and exits with
the first non-zero code of theirs; under the LM_* contract (a process per
card on each host) it joins that world. Each process that preloads keeps
at most its share of half the host's available memory as pixels, split
over the launcher's workers of this host (``LM_LOCAL_PROCESSES``), or under
the contract over the world's processes. ``-mesh DxM`` also shards the
model's channels over M devices of each data position, as the JAX
package's trainer does (train/trainer.py): ``-mesh 1xM`` trains in this
process over M cards (or M CPU shards with ``-device cpu``); with D > 1
it starts D x M workers, one card each (on the CPU D workers of M shards
each). Live BatchNorms normalize over the data group, the processes that
hold the same channels. Only process 0 writes the checkpoints, ``.bak``
files and resume file, each holding the full model, the others waiting at
a barrier: unlike the JAX package, whose processes each write the same
bytes, processes sharing one file system would tear the file.
"""

import sys

from ..core.backend_probe import ensure_backend
from ..core.config import Config, parse_cli_overrides
from ..parallel.launch import launch_if_needed
from ..parallel.mesh import mesh_spec_from, shutdown_distributed
from ..train.dataset import LectureNetDataset, find_images
from ..train.trainer import run_phase


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if len(argv) < 2:
        print(f"Usage: python {argv[0]} config [-device cpu]")
        return

    params = parse_cli_overrides(argv[2:])
    device = params.get("device")
    config = Config.from_file(argv[1])
    mesh_spec = mesh_spec_from(params, config)
    if launch_if_needed(__spec__.name, argv, mesh_spec, device):
        return
    ensure_backend(device=device)
    images = find_images(config.get_str("FCN_BINARIZER_PRETRAIN_REC_IMAGES_DIR"))
    print(f"Training reconstruction on {len(images)} images")

    dataset = LectureNetDataset.from_config(
        config, images, None, reconstruction_mode=True,
        reconstruct_median=config.get_bool("FCN_BINARIZER_PRETRAIN_REC_MEDIAN",
                                           True))
    if config.get_bool("FCN_BINARIZER_PRETRAIN_PRELOAD_IMAGES", False):
        dataset.preload(verbose=True)

    try:
        out = run_phase(config, "reconstruction", dataset,
                        mesh_spec=mesh_spec,
                        device=device)
    finally:
        shutdown_distributed()
    print(f"Saved: {out}")


if __name__ == "__main__":
    main()
