"""Flag unloadable or too-small training images.

Usage: python -m lecturemath_tpu_torch.cli.validate_dataset img_dir [min_size]
(reference equivalent: TEXT_dataset_validate_files.py)

A PNG is read by ``utils/png.py``, and one it cannot decode counts as
unloadable, as ``cv2.imread``'s None does; a JPEG needs OpenCV.
"""

import os
import sys

from ..utils.png import SIGNATURE, ImageFormatError, read_image


def _load(path: str):
    """The image as ``cv2.imread(path)`` loads it, or None: a PNG (by its
    signature, as OpenCV tells formats) through ``read_image``, any other
    file through OpenCV."""
    with open(path, "rb") as f:
        head = f.read(len(SIGNATURE))
    if head == SIGNATURE:
        try:
            return read_image(path)
        except ImageFormatError:
            return None
    import cv2

    return cv2.imread(path)


def validate_images(img_dir: str, min_size: int = 256):
    bad, small = [], []
    for name in sorted(os.listdir(img_dir)):
        if not name.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        path = os.path.join(img_dir, name)
        image = _load(path)
        if image is None:
            bad.append(name)
        elif image.shape[0] < min_size or image.shape[1] < min_size:
            small.append((name, image.shape[:2]))
    return bad, small


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if len(argv) < 2:
        print(f"Usage: python {argv[0]} img_dir [min_size]")
        return

    min_size = int(argv[2]) if len(argv) > 2 else 256
    bad, small = validate_images(argv[1], min_size)
    for name in bad:
        print(f"UNLOADABLE: {name}")
    for name, shape in small:
        print(f"TOO SMALL ({shape[0]}x{shape[1]}): {name}")
    print(f"{len(bad)} unloadable, {len(small)} below {min_size}px")


if __name__ == "__main__":
    main()
