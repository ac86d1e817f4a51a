"""Rasterize polygon text annotations (LSVT/ArT-style JSON) into binary
mask PNGs for text-detector pretraining.

Usage: python -m lecturemath_tpu_torch.cli.prepare_text_masks gt_json img_dir out_dir
(reference equivalent: lecturenet_data_00_prepare_binary_text_masks.py)

The masks are drawn by ``utils/image.py fill_poly`` (``cv2.fillPoly``) and
written by ``utils/png.py`` (byte for byte as ``cv2.imwrite``); OpenCV reads
the JPEG images, for their size.
"""

import json
import os
import sys

import numpy as np

from ..utils.image import fill_poly
from ..utils.png import write_image


def rasterize_text_regions(gt_entries, height: int, width: int) -> np.ndarray:
    mask = np.zeros((height, width), dtype=np.uint8)
    for region in gt_entries:
        polygon = np.asarray(region["points"], dtype=np.int32)
        fill_poly(mask, polygon, 255)
    return mask


def main(argv=None):
    import cv2

    argv = sys.argv if argv is None else argv
    if len(argv) < 4:
        print(f"Usage: python {argv[0]} gt_json img_dir out_dir")
        return

    json_path, img_dir, out_dir = argv[1], argv[2], argv[3]
    with open(json_path, "r", encoding="utf-8") as f:
        all_gt = json.load(f)
    print(f"{len(all_gt)} annotated images")

    os.makedirs(out_dir, exist_ok=True)
    n_small = 0
    for img_id, entries in all_gt.items():
        image = cv2.imread(os.path.join(img_dir, f"{img_id}.jpg"))
        if image is None:
            print(f"missing image: {img_id}")
            continue
        if image.shape[0] < 256 or image.shape[1] < 256:
            n_small += 1
        mask = rasterize_text_regions(entries, image.shape[0], image.shape[1])
        write_image(os.path.join(out_dir, f"{img_id}.png"), mask)

    print(f"{n_small} images below 256px")


if __name__ == "__main__":
    main()
