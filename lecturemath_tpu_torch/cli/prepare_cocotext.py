"""Prepare COCO-Text: rasterize text polygons to masks and split images
into train/val/test directories.

Usage: python -m lecturemath_tpu_torch.cli.prepare_cocotext in_img_dir in_json \
    train_img train_mask valid_img valid_mask test_img test_mask
(reference equivalent: TEXT_ICDAR2017_COCOText_prepare.py)

The masks are drawn by ``utils/image.py fill_poly`` (``cv2.fillPoly``) and
written by ``utils/png.py`` (byte for byte as ``cv2.imwrite``); OpenCV reads
the JPEG images, for their size.
"""

import json
import os
import shutil
import sys
from collections import Counter

import numpy as np

from ..utils.image import fill_poly
from ..utils.png import write_image


def coco_polygon_mask(annotations, anns_table, height, width) -> np.ndarray:
    mask = np.zeros((height, width), dtype=np.uint8)
    for region_id in annotations:
        flat = np.asarray(anns_table[str(region_id)]["polygon"])
        polygon = flat.round(0).astype(np.int32).reshape(-1, 2)
        fill_poly(mask, polygon, 255)
    return mask


def main(argv=None):
    import cv2

    argv = sys.argv if argv is None else argv
    if len(argv) < 9:
        print(f"Usage: python {argv[0]} in_img_dir in_json train_img "
              "train_mask valid_img valid_mask test_img test_mask")
        return

    in_dir, json_path = argv[1], argv[2]
    split_dirs = {"train": (argv[3], argv[4]), "val": (argv[5], argv[6]),
                  "test": (argv[7], argv[8])}
    for img_dir, mask_dir in split_dirs.values():
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(mask_dir, exist_ok=True)

    with open(json_path) as f:
        gt = json.load(f)

    set_counts = Counter()
    region_counts = Counter()
    for img_id, ann_ids in gt["imgToAnns"].items():
        image_set = gt["imgs"][img_id]["set"].lower()
        set_counts[image_set] += 1
        if image_set not in split_dirs:
            continue

        stem = f"COCO_train2014_{img_id.zfill(12)}"
        source = os.path.join(in_dir, stem + ".jpg")
        if not os.path.exists(source):
            print(f"missing: {source}")
            continue

        region_counts[len(ann_ids)] += 1
        image = cv2.imread(source)
        mask = coco_polygon_mask(ann_ids, gt["anns"], image.shape[0],
                                 image.shape[1])

        img_dir, mask_dir = split_dirs[image_set]
        shutil.copy(source, os.path.join(img_dir, stem + ".jpg"))
        write_image(os.path.join(mask_dir, stem + ".png"), mask)

    for n_regions in sorted(region_counts):
        print(f"images with {n_regions} text regions: {region_counts[n_regions]}")
    for image_set, count in set_counts.items():
        print(f"{image_set}: {count} images")


if __name__ == "__main__":
    main()
