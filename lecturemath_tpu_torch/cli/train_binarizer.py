"""Final phase: train the binarizer on annotated keyframe/binary-GT pairs.

Usage: python -m lecturemath_tpu_torch.cli.train_binarizer <config>
[dataset] [-device cpu] [-mesh D|DxM]
(reference equivalent: lecturenet_train_02_train_binarizer.py.) Trains on
the card unless ``-device cpu`` is given; without a card it raises.

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
from ..core.metadata import MetaDataDB
from ..parallel.launch import launch_if_needed
from ..parallel.mesh import mesh_spec_from, shutdown_distributed
from ..train.dataset import LectureNetDataset
from ..train.trainer import run_phase


def keyframe_binary_pairs(output_root: str, database: MetaDataDB,
                          dataset_name: str):
    """Discover (keyframe image, binary GT) path pairs in the annotation
    tree (reference: extract_kf_image_binary_annotation_pairs,
    lecturenet_train_02:23-48)."""
    images, gts = [], []
    dataset = database.get_dataset(dataset_name)
    if dataset is None:
        raise ValueError(f"invalid dataset name <{dataset_name}> "
                         f"(database defines: "
                         f"{sorted(database.datasets)})")
    for lecture in dataset.lectures:
        prefix = os.path.join(output_root, database.output_annotations,
                              f"{database.name}_{lecture.title.lower()}")
        image_dir = os.path.join(prefix, "keyframes")
        binary_dir = os.path.join(prefix, "binary")
        if not os.path.isdir(image_dir) or not os.path.isdir(binary_dir):
            continue
        binary_files = set(os.listdir(binary_dir))
        for name in sorted(os.listdir(image_dir)):
            if name.lower().endswith(".png") and name in binary_files:
                images.append(os.path.join(image_dir, name))
                gts.append(os.path.join(binary_dir, name))
    return images, gts


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if len(argv) < 2:
        print(f"Usage: python {argv[0]} config [dataset] [-device cpu]")
        return

    params = parse_cli_overrides(argv[2:])
    device = params.get("device")
    config = Config.from_file(argv[1])
    mesh_spec = mesh_spec_from(params, config)
    if launch_if_needed(__spec__.name, argv, mesh_spec, device):
        return
    ensure_backend(device=device)
    dataset_name = (argv[2] if len(argv) > 2
                    and not argv[2].startswith("-") else "training")
    database = MetaDataDB.from_file(config.get_str("VIDEO_DATABASE_PATH"))
    output_root = config.get_str("OUTPUT_PATH")

    images, gts = keyframe_binary_pairs(output_root, database, dataset_name)
    print(f"Training binarizer on {len(images)} keyframe/GT pairs")

    dataset = LectureNetDataset.from_config(
        config, images, gts, reconstruction_mode=False,
        # reference train_02 defaults the text-region expansion to 10
        # (lecturenet_train_02:104), so the text head always co-trains
        text_mask_expansion=config.get(
            "FCN_BINARIZER_TRAIN_TEXT_MASK_EXPANSION", 10))
    if config.get_bool("FCN_BINARIZER_PRETRAIN_PRELOAD_IMAGES", False):
        dataset.preload(verbose=True)

    warm_start = None
    from_reconstruction = False
    if config.get_bool("FCN_BINARIZER_TRAIN_USE_PRETRAIN_OUTPUT", False):
        warm_start = os.path.join(
            config.get_str("OUTPUT_PATH"),
            config.get_str("FCN_BINARIZER_TRAIN_PRETRAIN_OUTPUT"))
        from_reconstruction = config.get_bool(
            "FCN_BINARIZER_TRAIN_FROM_RECONSTRUCTION_PRETRAIN", False)

    try:
        out = run_phase(config, "binarizer", dataset, warm_start_path=warm_start,
                        warm_start_is_reconstruction=from_reconstruction,
                        mesh_spec=mesh_spec,
                        device=device)
    finally:
        shutdown_distributed()
    print(f"Saved: {out}")


if __name__ == "__main__":
    main()
