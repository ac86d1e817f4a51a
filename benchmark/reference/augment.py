"""The binarizer phase's training samples, worked out again in plain NumPy
and PyTorch from the keyframes and the data seed: the reference's side of
the training cell's data path.

It follows the published augmentation menu (AccessMath
FCN_lecturenet_dataset.py: random flips, a random crop retried until it
holds the least share of ink, colour inversion, a hue rotation, gaussian
noise, and the text mask as the ink dilated by an ellipse) in the order in
which the port's dataset draws from its ``numpy`` generator, so the same
seed gives the same crops and coins, and the hue rotation converts to and
from HSV as OpenCV's 8-bit conversions do. It imports nothing of the
program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def ellipse(size: int) -> np.ndarray:
    """The elliptic structuring element of OpenCV's documented formula:
    row i spans c +- round(c * sqrt(1 - ((i - r) / r)^2)), with r = c =
    size // 2."""
    r = c = size // 2
    kernel = np.zeros((size, size), np.float32)
    for i in range(size):
        dy = i - r
        dx = int(np.rint(c * np.sqrt((r * r - dy * dy) / (r * r)))) if r else 0
        kernel[i, max(c - dx, 0):min(c + dx + 1, size)] = 1
    return kernel


def text_mask(gt: np.ndarray, expansion: int) -> np.ndarray:
    """1 where an ink pixel (gt == 0) lies under the ellipse of side
    2 * expansion + 1 centred there, else 0: 255 - erode(gt), over 255."""
    kernel = torch.from_numpy(ellipse(2 * expansion + 1))[None, None]
    ink = torch.from_numpy((gt == 0).astype(np.float32))[None, None]
    near = F.conv2d(ink, kernel, padding=expansion)[0, 0] > 0.5
    return near.numpy().astype(np.float32)


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB -> uint8 HSV (hue in [0, 180)) in OpenCV's 8-bit fixed
    point (imgproc color_hsv: 12 fraction bits, the saturation and hue
    divisions as rounded reciprocal tables)."""
    shift, half = 12, 1 << 11
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.rint((255 << shift) / i), 0).astype(np.int64)
        hdiv = np.where(i > 0, np.rint((180 << shift) / (6.0 * i)),
                        0).astype(np.int64)
    r, g, b = (rgb[..., c].astype(np.int64) for c in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = (diff * sdiv[v] + half) >> shift
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> shift
    h = np.where(h < 0, h + 180, h)
    return np.stack([np.clip(h, 0, 255), s, v], axis=-1).astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """uint8 HSV (hue in [0, 180)) -> uint8 RGB as OpenCV's 8-bit
    conversion computes it: in float32, the sector's (v, v(1-s), v(1-sh),
    v(1-s(1-h))) with each product under one rounding, times 255; its
    vector code, over each row's whole blocks of 32 pixels, truncates, and
    its scalar code, over the rest of the row, rounds."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h)
    h = h - sector
    sector = sector.astype(np.int64) % 6
    s64, h64 = s.astype(np.float64), h.astype(np.float64)
    tab = np.stack([v, v * (f32(1.0) - s),
                    v * (1.0 - s64 * h64).astype(f32),
                    v * (1.0 - s64 * (f32(1.0) - h).astype(np.float64)
                         ).astype(f32)], axis=-1)
    # (b, g, r) of each sector, as indices into tab
    order = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                      [2, 1, 0]])
    bgr = np.take_along_axis(tab, order[sector], axis=-1) * f32(255.0)
    whole = hsv.shape[1] // 32 * 32
    out = np.empty(bgr.shape, np.uint8)
    out[:, :whole] = np.clip(np.trunc(bgr[:, :whole]), 0, 255)
    out[:, whole:] = np.clip(np.rint(bgr[:, whole:]), 0, 255)
    return np.ascontiguousarray(out[..., ::-1])


def sample(rng: np.random.Generator, img: np.ndarray, gt: np.ndarray,
           cfg: Dict) -> Dict[str, np.ndarray]:
    """One training sample of keyframe ``img`` and ground truth ``gt``."""
    chance = cfg["flip_chance"]
    if rng.random() < chance:
        img, gt = img[:, ::-1], gt[:, ::-1]
    if rng.random() < chance:
        img, gt = img[::-1], gt[::-1]
    ch, cw = cfg["crop_size"]
    h, w = img.shape[:2]
    tries = 6
    for attempt in range(tries):
        top = int(rng.integers(0, max(1, h - ch + 1)))
        left = int(rng.integers(0, max(1, w - cw + 1)))
        crop_img = img[top:top + ch, left:left + cw]
        crop_gt = gt[top:top + ch, left:left + cw]
        share = (crop_gt == 0).sum() / (ch * cw)
        if share >= cfg["crop_min_foreground"] or attempt == tries - 1:
            break
    img, gt = crop_img, crop_gt
    if rng.random() < cfg["color_invert_chance"]:
        img = 255 - img
    if rng.random() < cfg["color_change_chance"]:
        shift = (rng.random() * 0.9 - 0.45) * 180.0
        hsv = rgb_to_hsv(np.ascontiguousarray(img)).astype(np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(shift)) % 180
        img = hsv_to_rgb(hsv.astype(np.uint8))
    if rng.random() < cfg["gaussian_noise_chance"]:
        noisy = (img.astype(np.float64) + rng.standard_normal(img.shape)
                 * cfg["gaussian_noise_level"])
        img = np.clip(noisy, 0, 255).astype(np.uint8)
    gt = np.ascontiguousarray(gt)
    image = np.ascontiguousarray(img).astype(np.float32) / 127.5 - 1.0
    return {"image": image,
            "target": (gt.astype(np.float32) / 255.0)[..., None],
            "text_mask": text_mask(gt, cfg["text_mask_expansion"])[..., None]}


def first_batches(images: List[np.ndarray], truths: List[np.ndarray],
                  cfg: Dict, seed: int, count: int) -> List[Dict]:
    """The first ``count`` batches of the first epoch: the order shuffled
    by the data seed's generator, then each sample drawn from it in turn."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(images))
    rng.shuffle(order)
    size = cfg["batch_size"]
    batches = []
    for k in range(count):
        samples = [sample(rng, images[i], truths[i], cfg)
                   for i in order[k * size:(k + 1) * size]]
        batches.append({key: np.stack([s[key] for s in samples])
                        for key in samples[0]})
    return batches
