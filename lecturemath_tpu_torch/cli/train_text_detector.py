"""TD-PT: pretrain all three branches on text-detection data.

Usage: python -m lecturemath_tpu_torch.cli.train_text_detector <config>
[-device cpu] [-mesh D|DxM]
(reference equivalent: lecturenet_train_01_pretrain_text_detector.py.)
Trains on the card unless ``-device cpu`` is given; without a card it
raises.

``-mesh D`` / TPU_MESH trains data-parallel over D devices, one process a
device: without LM_COORDINATOR this process starts D workers of itself on
this host (parallel/launch.py), each on one card through
CUDA_VISIBLE_DEVICES (or on the CPU with ``-device cpu``), and exits with
the first non-zero code of theirs; under the LM_* contract (a process per
card on each host) it joins that world. ``-mesh DxM`` also shards the
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

import os
import sys

from ..core.backend_probe import ensure_backend
from ..core.config import Config, parse_cli_overrides
from ..parallel.launch import launch_if_needed
from ..parallel.mesh import mesh_spec_from, shutdown_distributed
from ..train.dataset import LectureNetDataset, find_image_mask_pairs
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
    images, masks = find_image_mask_pairs(
        config.get_str("FCN_BINARIZER_PRETRAIN_IMAGES_DIR"),
        config.get_str("FCN_BINARIZER_PRETRAIN_MASKS_DIR"))
    print(f"Training text detector on {len(images)} image/mask pairs")

    dataset = LectureNetDataset.from_config(
        config, images, masks, reconstruction_mode=False,
        reconstruct_median=config.get_bool("FCN_BINARIZER_PRETRAIN_REC_MEDIAN",
                                           True),
        # reference train_01 always builds text-region masks (expansion 0
        # when unconfigured, lecturenet_train_01:90)
        text_mask_expansion=config.get(
            "FCN_BINARIZER_TRAIN_TEXT_MASK_EXPANSION", 0))
    if config.get_bool("FCN_BINARIZER_PRETRAIN_PRELOAD_IMAGES", False):
        dataset.preload(verbose=True)

    warm_start = None
    if config.get_bool("FCN_BINARIZER_PRETRAIN_USE_RECONSTRUCTION_OUTPUT",
                       False):
        warm_start = os.path.join(
            config.get_str("OUTPUT_PATH"),
            config.get_str("FCN_BINARIZER_PRETRAIN_RECONSTRUCTION_OUTPUT"))

    try:
        out = run_phase(config, "text_detector", dataset,
                        warm_start_path=warm_start,
                        warm_start_is_reconstruction=True,
                        mesh_spec=mesh_spec,
                        device=device)
    finally:
        shutdown_distributed()
    print(f"Saved: {out}")


if __name__ == "__main__":
    main()
