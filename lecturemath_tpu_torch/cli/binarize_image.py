"""Smoke tool: binarize a single image with a model checkpoint and write
the binary / text-mask / reconstruction outputs next to it.

Usage: python -m lecturemath_tpu_torch.cli.binarize_image config model image
       [out_prefix] [-device cpu]
(reference equivalent: test_FCN_binarizer.py)

The image is read as the serving surface reads a request body (PNG in
numpy; other formats through OpenCV where it is installed), runs through
``Binarizer.full_outputs`` (kernel K2 on the head convs on the card), and the
three PNGs are written by ``utils/png.py``, byte for byte as ``cv2.imwrite``
writes them. It runs on the card unless ``-device cpu`` is given.
"""

import os
import sys


def main(argv=None):
    import torch

    from ..core.backend_probe import ensure_backend
    from ..core.config import Config
    from ..core.device import cli_args, resolve_device
    from ..pipeline.binarize import Binarizer
    from ..pipeline.server import decode_image
    from ..utils.png import write_image

    argv = sys.argv if argv is None else argv
    positional, device = cli_args(argv[1:])
    if len(positional) < 3:
        print(f"Usage: python {argv[0]} config model image [out_prefix] "
              f"[-device cpu]")
        return
    device = resolve_device(device)

    ensure_backend(device=device)
    config = Config.from_file(positional[0])
    model_dir, model_file = os.path.split(positional[1])
    config.set("BINARIZATION_FCN_LECTURENET_DIR", model_dir or ".")
    config.set("BINARIZATION_FCN_LECTURENET_FILENAME", model_file)
    binarizer = Binarizer.from_config(config, device=device)

    with open(positional[2], "rb") as f:
        rgb = decode_image(f.read())
    binary, text_mask, rec = binarizer.full_outputs(
        torch.from_numpy(rgb[None].copy()).to(device))

    prefix = (positional[3] if len(positional) > 3
              else os.path.splitext(positional[2])[0])
    for suffix, image in (("_BIN.png", binary[0]), ("_text.png", text_mask[0]),
                          ("_bg.png", rec[0].flip(-1))):
        write_image(prefix + suffix, image.cpu().numpy())
    print(f"Wrote {prefix}_BIN.png / _text.png / _bg.png")


if __name__ == "__main__":
    main()
