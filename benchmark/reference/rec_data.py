"""The reconstruction phase's training samples, worked out again in plain
NumPy and PyTorch from the lecture's frames and the data seed: the
reference's side of the reconstruction cell's data path.

A sample follows the published augmentation menu without ground truth
(AccessMath FCN_lecturenet_dataset.py: random flips, a random crop, colour
inversion, a hue rotation, gaussian noise), drawn from a ``numpy``
generator in the order in which the port's dataset draws, so the same seed
gives the same crops and coins. Its target is the crop's median blur
(lecturenet_train_00 with FCN_BINARIZER_PRETRAIN_REC_MEDIAN: OpenCV's
``medianBlur`` with k = 35, the border replicated), worked out here by
sorting each window. It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.augment import hsv_to_rgb, rgb_to_hsv

# window values sorted at once in a band of rows (a float32 each)
BAND_VALUES = 1 << 24


def median(img: np.ndarray, k: int, device="cpu") -> np.ndarray:
    """The exact median of each k x k window of uint8 [H, W, C] ``img``,
    each channel on its own, the border replicated: the (k * k // 2)-th of
    the window's sorted values (k odd, so it is the median), by
    ``torch.kthvalue`` over the windows of a band of rows at a time."""
    r = k // 2
    planes = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    planes = planes.permute(2, 0, 1).float()[None]
    padded = F.pad(planes, (r, r, r, r), mode="replicate")[0]
    channels, height, width = planes.shape[1:]
    band = max(1, BAND_VALUES // (channels * width * k * k))
    out = torch.empty((channels, height, width), dtype=torch.uint8,
                      device=device)
    for y0 in range(0, height, band):
        y1 = min(height, y0 + band)
        windows = padded[:, y0:y1 + 2 * r].unfold(1, k, 1).unfold(2, k, 1)
        values = windows.reshape(channels, y1 - y0, width, k * k)
        out[:, y0:y1] = values.kthvalue(k * k // 2 + 1, dim=-1).values.to(
            torch.uint8)
    return out.permute(1, 2, 0).cpu().numpy()


def augment(rng: np.random.Generator, img: np.ndarray,
            cfg: Dict) -> np.ndarray:
    """The augmented uint8 crop of frame ``img``."""
    chance = cfg["flip_chance"]
    if rng.random() < chance:
        img = img[:, ::-1]
    if rng.random() < chance:
        img = img[::-1]
    ch, cw = cfg["crop_size"]
    h, w = img.shape[:2]
    top = int(rng.integers(0, max(1, h - ch + 1)))
    left = int(rng.integers(0, max(1, w - cw + 1)))
    img = img[top:top + ch, left:left + cw]
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
    return np.ascontiguousarray(img)


def first_batches(frames: List[np.ndarray], cfg: Dict, seed: int,
                  count: int, device="cpu") -> List[Dict]:
    """The first ``count`` batches of the first epoch: the order shuffled by
    the data seed's generator, then each crop drawn from it in turn. Each
    batch holds ``image`` and ``median`` (its target), NHWC float32 in
    [-1, 1]."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(frames))
    rng.shuffle(order)
    size = cfg["batch_size"]
    batches = []
    for k in range(count):
        crops = [augment(rng, frames[i], cfg)
                 for i in order[k * size:(k + 1) * size]]
        targets = [median(c, cfg["median_k"], device) for c in crops]
        batches.append({
            "image": np.stack(crops).astype(np.float32) / 127.5 - 1.0,
            "median": np.stack(targets).astype(np.float32) / 127.5 - 1.0})
    return batches
