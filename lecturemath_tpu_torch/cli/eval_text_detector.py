"""Text-detector pretrain evaluation CLI: binarize pretrain eval images with
the model and match predicted CCs to GT text-mask CCs at IOU thresholds.

Usage: python -m lecturemath_tpu_torch.cli.eval_text_detector <config>
       <model> [-device cpu]
(reference equivalent: lecturenet_eval_pretrain_text_detector.py)

Each image runs through ``Binarizer.full_outputs`` on the card (kernel K2
on the head convs) unless ``-device cpu`` is given. PNG images and masks
are read without OpenCV (``utils/png.py``, as ``cv2.imread`` reads them);
JPEG ones need OpenCV.
"""

import os
import sys

import numpy as np

from ..core.config import Config
from ..eval.text_detector_eval import IOU_THRESHOLDS, cc_iou_matching
from ..pipeline.binarize import Binarizer
from ..train.dataset import find_image_mask_pairs
from ..utils.png import read_image


def main(argv=None):
    import torch

    from ..core.device import cli_args, resolve_device

    argv = sys.argv if argv is None else argv
    positional, device = cli_args(argv[1:])
    if len(positional) < 2:
        print(f"Usage: python {argv[0]} config model [-device cpu]")
        return

    from ..core.backend_probe import ensure_backend

    device = resolve_device(device)
    ensure_backend(device=device)

    config = Config.from_file(positional[0])
    images, masks = find_image_mask_pairs(
        config.get_str("FCN_BINARIZER_PRETRAIN_EVAL_IMAGES_DIR"),
        config.get_str("FCN_BINARIZER_PRETRAIN_EVAL_MASKS_DIR"))
    threshold = config.get_int("FCN_BINARIZER_PRETRAIN_EVAL_BIN_TRESHOLD", 128)

    model_dir, model_file = os.path.split(positional[1])
    config.set("BINARIZATION_FCN_LECTURENET_DIR", model_dir or ".")
    config.set("BINARIZATION_FCN_LECTURENET_FILENAME", model_file)
    binarizer = Binarizer.from_config(config, threshold=threshold,
                                      device=device)

    rollup = {iou_t: {"recall": [], "precision": [], "f1": []}
              for iou_t in IOU_THRESHOLDS}
    pixel_rollup = {"recall": [], "precision": [], "f1": []}

    for img_path, mask_path in zip(images, masks):
        print(f"Processing: {img_path}", flush=True)
        image = read_image(img_path)[:, :, ::-1]
        gt_mask = read_image(mask_path, grayscale=True)

        binary, _, _ = binarizer.full_outputs(
            torch.from_numpy(image[None].copy()).to(binarizer.device))
        pred_ink = 255 - binary[0].cpu().numpy()  # model output: ink = 0

        per_threshold, pixel = cc_iou_matching(pred_ink, gt_mask)
        for iou_t in IOU_THRESHOLDS:
            for key in ("recall", "precision", "f1"):
                rollup[iou_t][key].append(per_threshold[iou_t][key])
        for key in pixel_rollup:
            pixel_rollup[key].append(pixel[key])

    print("\nIOU\tRec.\tPrec.\tF-1")
    for iou_t in IOU_THRESHOLDS:
        print(f"{iou_t:.2f}\t"
              f"{np.mean(rollup[iou_t]['recall']) * 100:.2f}\t"
              f"{np.mean(rollup[iou_t]['precision']) * 100:.2f}\t"
              f"{np.mean(rollup[iou_t]['f1']) * 100:.2f}")
    print("\nPixel\tRec.\tPrec.\tF-1")
    print(f"\t{np.mean(pixel_rollup['recall']) * 100:.2f}\t"
          f"{np.mean(pixel_rollup['precision']) * 100:.2f}\t"
          f"{np.mean(pixel_rollup['f1']) * 100:.2f}")


if __name__ == "__main__":
    main()
