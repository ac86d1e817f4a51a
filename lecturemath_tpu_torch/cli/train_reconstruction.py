"""Med-PT: pretrain the reconstruction branch against median-blurred targets.

Usage: python -m lecturemath_tpu_torch.cli.train_reconstruction <config>
[-device cpu]
(reference equivalent: lecturenet_train_00_pretrain_reconstruction.py.)
Trains on the card unless ``-device cpu`` is given; without a card it
raises. A ``-mesh`` / TPU_MESH request for more than one device raises
(ROADMAP queue 1, item 10).
"""

import sys

from ..core.backend_probe import ensure_backend
from ..core.config import Config, parse_cli_overrides
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
    ensure_backend(device=device)
    config = Config.from_file(argv[1])
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
                        mesh_spec=mesh_spec_from(params, config),
                        device=device)
    finally:
        shutdown_distributed()
    print(f"Saved: {out}")


if __name__ == "__main__":
    main()
