"""Data augmentation for binarizer training, as pure numpy functions.

The menu matches the reference LectureNet_DataSet.__getitem__ chain
(reference: AccessMath/lecturenet_v1/FCN_lecturenet_dataset.py:220-409):
random h/v flips, random crop with min-foreground retry, color inversion,
hue shift, gaussian noise, brightness/contrast/gamma/saturation jitter,
eroded text-region masks, median-blur reconstruction targets, and per-pixel
weight maps. GT polarity: ink = 0, background = 255.

The JAX package's module with each OpenCV call replaced by its bit-exact
counterpart in ``utils/image.py`` (``rgb_to_hsv``/``hsv_to_rgb``,
``rgb_to_gray``, ``ellipse_kernel``, ``erode``, ``median_blur``); every
function draws from the generator in the same order, so the same seed gives
the same samples. ``hue_shift`` and ``gaussian_noise`` are each a draw
(``hue_draw``, ``rng.standard_normal``) and the pixel work on it
(``hue_rotate``, ``add_noise``), which the training batches make apart: the
draws on the host, the pixels in kernel K5 where there is a card
(``ops/augment.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..utils.image import (ellipse_kernel, erode, hsv_to_rgb, median_blur,
                           rgb_to_gray, rgb_to_hsv)


def random_flips(rng: np.random.Generator, img: np.ndarray,
                 gt: Optional[np.ndarray], chance: float):
    if rng.random() < chance:
        img = img[:, ::-1]
        gt = gt[:, ::-1] if gt is not None else None
    if rng.random() < chance:
        img = img[::-1, :]
        gt = gt[::-1, :] if gt is not None else None
    return img, gt


def random_crop_min_fg(rng: np.random.Generator, img: np.ndarray,
                       gt: Optional[np.ndarray], crop_size: Tuple[int, int],
                       min_fg_prc: Optional[float], max_tries: int = 6):
    """Random crop; when a GT is given, retry until the crop holds at least
    ``min_fg_prc`` ink pixels (ink == 0), up to ``max_tries``."""
    ch, cw = crop_size
    h, w = img.shape[:2]
    for attempt in range(max_tries):
        top = int(rng.integers(0, max(1, h - ch + 1)))
        left = int(rng.integers(0, max(1, w - cw + 1)))
        crop_img = img[top:top + ch, left:left + cw]
        if gt is None or min_fg_prc is None:
            return crop_img, (gt[top:top + ch, left:left + cw]
                              if gt is not None else None)
        crop_gt = gt[top:top + ch, left:left + cw]
        # the count of ink (== 0) pixels, without a temporary mask
        fg_prc = (crop_gt.size - np.count_nonzero(crop_gt)) / (ch * cw)
        if fg_prc >= min_fg_prc or attempt == max_tries - 1:
            return crop_img, crop_gt
    return crop_img, crop_gt


def color_invert(img: np.ndarray) -> np.ndarray:
    return 255 - img


def hue_draw(rng: np.random.Generator) -> int:
    """The shift ``hue_shift`` draws: a rotation in [-0.45, 0.45) of the hue
    circle, in whole steps of OpenCV's hue (which spans [0, 180))."""
    return int((rng.random() * 0.9 - 0.45) * 180.0)


def hue_rotate(img: np.ndarray, shift: int) -> np.ndarray:
    """The hue of each pixel moved by ``shift`` steps, through OpenCV's
    8-bit HSV."""
    hsv = rgb_to_hsv(np.ascontiguousarray(img)).astype(np.int16)
    hsv[:, :, 0] = (hsv[:, :, 0] + shift) % 180
    return hsv_to_rgb(hsv.astype(np.uint8))


def hue_shift(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Random hue rotation in [-0.45, 0.45) of the hue circle."""
    return hue_rotate(img, hue_draw(rng))


def add_noise(img: np.ndarray, noise: np.ndarray, level: float) -> np.ndarray:
    """``img`` plus ``level`` times the float64 ``noise``, clipped to uint8."""
    noisy = img.astype(np.float64) + noise * level
    return np.clip(noisy, 0, 255).astype(np.uint8)


def gaussian_noise(rng: np.random.Generator, img: np.ndarray,
                   level: float) -> np.ndarray:
    return add_noise(img, rng.standard_normal(img.shape), level)


def luminosity_jitter(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Brightness/contrast/gamma/saturation jitter with the reference's
    asymmetric ranges (dataset.py:293-322)."""
    out = img.astype(np.float32) / 255.0

    # brightness: x in [0.75, 1.0] or [1.0, 1.5]
    if rng.standard_normal() < 0:
        out *= 1.0 - rng.random() * 0.25
    else:
        out *= 1.0 + rng.random() * 0.50
    out = np.clip(out, 0.0, 1.0)

    # contrast around the grayscale mean: [0.5, 1.0] or [1.0, 2.0]
    gray_mean = rgb_to_gray((out * 255).astype(np.uint8)).mean() / 255.0
    if rng.standard_normal() < 0:
        factor = 1.0 - rng.random() * 0.5
    else:
        factor = 1.0 + rng.random() * 1.0
    out = np.clip(gray_mean + (out - gray_mean) * factor, 0.0, 1.0)

    # gamma: [0.5, 1.0] or [1.0, 2.0]
    if rng.standard_normal() < 0:
        gamma = 1.0 - rng.random() * 0.50
    else:
        gamma = 1.0 + rng.random() * 1.00
    out = np.power(out, gamma)

    # saturation: [0.25, 1.0] or [1.0, 5.0]
    if rng.standard_normal() < 0:
        factor = 1.0 - rng.random() * 0.75
    else:
        factor = 1.0 + rng.random() * 4.0
    gray = rgb_to_gray((out * 255).astype(np.uint8))
    gray = (gray.astype(np.float32) / 255.0)[:, :, None]
    out = np.clip(gray + (out - gray) * factor, 0.0, 1.0)

    return (out * 255).astype(np.uint8)


def _ellipse_kernel(expansion: int) -> np.ndarray:
    return ellipse_kernel(expansion * 2 + 1)


def text_region_mask(gt: np.ndarray, expansion: int) -> np.ndarray:
    """255 - erode(gt): dilated ink regions become the text mask target
    (dataset.py:324-331)."""
    return 255 - erode(gt, _ellipse_kernel(expansion))


def weight_map(gt: np.ndarray, expansion: int, fg_extra: float) -> np.ndarray:
    """Per-pixel loss weights: 1 everywhere, 1 + fg_extra on eroded ink
    (dataset.py:381-407)."""
    eroded = erode(gt, _ellipse_kernel(expansion))
    weights = np.ones(eroded.shape, dtype=np.float32)
    weights[eroded == 0] += fg_extra
    return weights


def median_target(img: np.ndarray, ksize: int) -> np.ndarray:
    """Median-blurred image as the background-reconstruction target
    (dataset.py:347-358)."""
    return median_blur(np.ascontiguousarray(img), ksize)
