"""Training dataset: image(+GT) pairs with the reference augmentation menu,
yielding numpy batches ready for device upload.

Covers the reference LectureNet_DataSet behaviors
(reference: FCN_lecturenet_dataset.py:16-409): border-crop to the inked
region, auto-upscale of small images, preloading into RAM with fg/bg pixel
accounting, and the per-sample augmentation chain (train/augment.py).

``preload`` keeps each pair as its decoded uint8 pixels, read-only, while
their total stays within half of the host memory available when it starts,
split over the host's training processes (``preload_budget``); the pairs
past that keep PNG copies, as the reference keeps them all, and are decoded
again each time they are drawn. The PNG round trip is lossless and the
generator's draws do not depend on the form, so both forms give the same
samples; kept pixels spare each sample the decode of a whole frame.
``data_stats`` counts the pairs and bytes kept in each form and the samples
served from each.

The median targets of a reconstruction batch are made together once its
samples are drawn (``batches``): in one launch of kernel K4 on the card
where the process sees one (``ops/median.py``), else on the host a crop at
a time (``utils/image.py median_route``). Both give the exact median, so
the batch is the same either way; ``data_stats`` counts the samples whose
target each route made.

Each sample dict has: image [H,W,3] float32 in [-1,1] NHWC, target (gt mask
or normalized image in reconstruction mode), weights, text_mask, median.
Samples stay NHWC numpy; the trainer makes NCHW tensors of them.

Images are read without OpenCV: PNGs of every kind through
``utils/png.py`` (as ``cv2.imread`` reads them), the upscale through
``utils/image.py`` (INTER_LINEAR and INTER_NEAREST, bit-exact). JPEG files
are found as before but only OpenCV decodes them: where it is not
installed, loading one raises ``ImageFormatError``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.config import Config
from ..core.timing import span
from ..utils.image import median_route, resize_linear, resize_nearest
from ..utils import png
from ..utils.png import (ImageFormatError, decode_png_color, decode_png_gray,
                         encode_png)
from ..ops.median import median_u8_pinned
from . import augment


def available_memory() -> int:
    """The bytes of host memory available now."""
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def preload_budget() -> int:
    """The most bytes ``LectureNetDataset.preload`` keeps as decoded pixels:
    half of the host memory available now, split evenly over the host's
    training processes, which start together and so all read about the same
    free memory. Their count is ``LM_LOCAL_PROCESSES``, which
    ``parallel/launch.py`` sets for the workers it starts. A process that
    joined a world of ``LM_NUM_PROCESSES`` under the LM_* contract without
    it splits over the whole world, which no host's share exceeds; a
    process alone keeps all of it."""
    processes = os.environ.get("LM_LOCAL_PROCESSES",
                               os.environ.get("LM_NUM_PROCESSES", "1"))
    processes = max(1, int(processes))
    return available_memory() // 2 // processes


def _kept(array: np.ndarray) -> np.ndarray:
    """A read-only contiguous copy: a border-crop view would hold the whole
    frame, and a write through it would change every later epoch."""
    array = array.copy()
    array.setflags(write=False)
    return array


def read_image(path: str) -> np.ndarray:
    """``cv2.imread(path)[:, :, ::-1]``: the file as uint8 RGB [H, W, 3].
    PNGs of every kind decode without OpenCV; any other file needs it."""
    return png.read_image(path, rgb=True)


def find_images(directory: str, extensions=(".png", ".jpg", ".jpeg")) -> List[str]:
    """Reference: LectureNet_Util.get_images_from_directory (util.py:5-32)."""
    out = []
    for name in sorted(os.listdir(directory)):
        if name.lower().endswith(extensions):
            out.append(os.path.join(directory, name))
    return out


def find_image_mask_pairs(image_dir: str, mask_dir: str):
    images, masks = [], []
    for path in find_images(image_dir):
        name = os.path.splitext(os.path.basename(path))[0]
        for ext in (".png", ".jpg", ".jpeg"):
            mask_path = os.path.join(mask_dir, name + ext)
            if os.path.exists(mask_path):
                images.append(path)
                masks.append(mask_path)
                break
    return images, masks


class LectureNetDataset:
    def __init__(self, image_list: Sequence[str],
                 ground_truth_list: Optional[Sequence[str]] = None,
                 reconstruction_mode: bool = False,
                 crop_size: Optional[Tuple[int, int]] = (256, 256),
                 crop_remove_empty_borders: bool = False,
                 crop_min_fg_prc: Optional[float] = None,
                 flip_chance: Optional[float] = None,
                 color_invert_chance: Optional[float] = None,
                 color_change_chance: Optional[float] = None,
                 luminosity_change_chance: Optional[float] = None,
                 gaussian_noise_chance: Optional[float] = None,
                 gaussian_noise_level: float = 5.0,
                 weight_expansion: Optional[int] = None,
                 weight_fg_extra: float = 1.0,
                 text_mask_expansion: Optional[int] = None,
                 reconstruct_median: bool = False,
                 reconstruct_median_k: int = 35,
                 seed: int = 0):
        if ground_truth_list is not None:
            assert len(image_list) == len(ground_truth_list)
        self.image_list = list(image_list)
        self.ground_truth_list = (list(ground_truth_list)
                                  if ground_truth_list is not None else None)
        self.reconstruction_mode = reconstruction_mode
        self.crop_size = crop_size
        self.crop_remove_empty_borders = crop_remove_empty_borders
        self.crop_min_fg_prc = crop_min_fg_prc
        self.flip_chance = flip_chance
        self.color_invert_chance = color_invert_chance
        self.color_change_chance = color_change_chance
        self.luminosity_change_chance = luminosity_change_chance
        self.gaussian_noise_chance = gaussian_noise_chance
        self.gaussian_noise_level = gaussian_noise_level
        self.weight_expansion = weight_expansion
        self.weight_fg_extra = weight_fg_extra
        self.text_mask_expansion = text_mask_expansion
        self.reconstruct_median = reconstruct_median
        self.reconstruct_median_k = reconstruct_median_k
        self.rng = np.random.default_rng(seed)

        self._preloaded: Optional[List] = None
        self.total_foreground = 0
        self.total_background = 0
        # pairs and bytes kept by preload in each form, samples served from
        # each (the hit share is from_pixels / (from_pixels + from_png)), and
        # samples whose median target the card or the host made (the card's
        # share is median_card / (median_card + median_host))
        self.data_stats = dict.fromkeys(
            ("pairs_pixels", "pairs_png", "bytes_kept", "from_pixels",
             "from_png", "median_card", "median_host"), 0)

    @classmethod
    def from_config(cls, config: Config, image_list, ground_truth_list,
                    reconstruction_mode: bool, **overrides):
        """Wire the FCN_BINARIZER_TRAIN_* augmentation keys
        (reference: configs/FCN_LectureNet.conf:69-89)."""
        kwargs = dict(
            crop_size=config.get("FCN_BINARIZER_TRAIN_CROP_SIZE", (256, 256)),
            crop_remove_empty_borders=config.get_bool(
                "FCN_BINARIZER_TRAIN_CROP_REMOVE_EMPTY_BORDERS", False),
            crop_min_fg_prc=config.get("FCN_BINARIZER_TRAIN_CROP_MIN_FOREGROUND"),
            flip_chance=config.get("FCN_BINARIZER_TRAIN_CROP_FLIP_CHANCE"),
            color_invert_chance=config.get("FCN_BINARIZER_TRAIN_COLOR_INVERT_CHANGE"),
            color_change_chance=config.get("FCN_BINARIZER_TRAIN_COLOR_CHANGE_CHANCE"),
            luminosity_change_chance=config.get(
                "FCN_BINARIZER_TRAIN_LUMINOSITY_CHANGE_CHANCE"),
            gaussian_noise_chance=config.get("FCN_BINARIZER_TRAIN_GAUSSIAN_NOISE_CHANCE"),
            gaussian_noise_level=config.get(
                "FCN_BINARIZER_TRAIN_GAUSSIAN_NOISE_LEVEL", 5.0),
            weight_expansion=config.get("FCN_BINARIZER_TRAIN_WEIGHT_EXPANSION"),
            weight_fg_extra=config.get(
                "FCN_BINARIZER_TRAIN_WEIGHT_FOREGROUND_EXTRA", 1.0),
            text_mask_expansion=config.get("FCN_BINARIZER_TRAIN_TEXT_MASK_EXPANSION"),
            reconstruct_median=config.get_bool(
                "FCN_BINARIZER_PRETRAIN_REC_MEDIAN", False),
            reconstruct_median_k=config.get(
                "FCN_BINARIZER_PRETRAIN_REC_MEDIAN_BLUR_K", 35),
        )
        kwargs.update(overrides)
        return cls(image_list, ground_truth_list, reconstruction_mode, **kwargs)

    # ------------------------------------------------------------- loading

    def __len__(self) -> int:
        return len(self.image_list)

    def load_pair(self, index: int):
        img = read_image(self.image_list[index])
        gt = None
        if self.ground_truth_list is not None:
            # cv2.imread(...)[:, :, 0]: the BLUE channel of an RGB GT
            gt = np.ascontiguousarray(
                read_image(self.ground_truth_list[index])[:, :, 2])

        h, w = img.shape[:2]

        # crop to the inked region with a small margin (dataset.py:85-120)
        if self.crop_remove_empty_borders and gt is not None:
            ink = 255 - gt
            cols = np.nonzero(ink.max(axis=0))[0]
            rows = np.nonzero(ink.max(axis=1))[0]
            if len(cols) and len(rows):
                margin = 10
                x0, x1 = max(0, cols[0] - margin), min(w, cols[-1] + margin)
                y0, y1 = max(0, rows[0] - margin), min(h, rows[-1] + margin)
                if self.crop_size is not None:
                    ch, cw = self.crop_size
                    if x1 - x0 < cw:
                        mid = (x0 + x1) // 2
                        x0 = max(0, mid - cw // 2 - 1)
                        x1 = min(w, x0 + cw)
                    if y1 - y0 < ch:
                        mid = (y0 + y1) // 2
                        y0 = max(0, mid - ch // 2 - 1)
                        y1 = min(h, y0 + ch)
                img = img[y0:y1, x0:x1]
                gt = gt[y0:y1, x0:x1]
                h, w = img.shape[:2]

        # auto-upscale small images to at least the crop size (dataset.py:123-138)
        if self.crop_size is not None and (h < self.crop_size[0] or w < self.crop_size[1]):
            scale = max(self.crop_size[0] / h, self.crop_size[1] / w)
            new_w, new_h = int(round(w * scale)), int(round(h * scale))
            new_w = max(new_w, self.crop_size[1])
            new_h = max(new_h, self.crop_size[0])
            img = resize_linear(img, (new_w, new_h))
            if gt is not None:
                gt = resize_nearest(gt, (new_w, new_h))

        return img, gt

    def preload(self, verbose: bool = False) -> None:
        """Keep every pair in RAM + count fg/bg pixels (dataset.py:145-179):
        as read-only decoded pixels while their total stays within
        ``preload_budget()``, and from the first pair that would pass it on
        as PNG copies (the reference's form for them all), which the round
        trip gives back unchanged."""
        budget = preload_budget()
        self._preloaded = []
        self.total_foreground = 0
        self.total_background = 0
        stats = self.data_stats = dict.fromkeys(self.data_stats, 0)
        for index in range(len(self)):
            img, gt = self.load_pair(index)
            if gt is not None:
                fg = int((gt == 0).sum())
                self.total_foreground += fg
                self.total_background += gt.size - fg
            size = img.nbytes + (gt.nbytes if gt is not None else 0)
            if not stats["pairs_png"] and stats["bytes_kept"] + size <= budget:
                pair = (_kept(img), _kept(gt) if gt is not None else None)
                stats["pairs_pixels"] += 1
            else:
                pair = (encode_png(img[:, :, ::-1]),
                        encode_png(gt) if gt is not None else None)
                stats["pairs_png"] += 1
                size = len(pair[0]) + (len(pair[1]) if gt is not None else 0)
            stats["bytes_kept"] += size
            self._preloaded.append(pair)
            if verbose:
                print(f"preloaded {index + 1}/{len(self)}", end="\r")

    def _get_pair(self, index: int):
        """(form, img, gt): the preloaded pair as kept (form "pixels") or
        decoded from its PNG copies ("png"), or read from its files (None)."""
        if self._preloaded is None:
            return (None, *self.load_pair(index))
        img, gt = self._preloaded[index]
        if isinstance(img, np.ndarray):
            self.data_stats["from_pixels"] += 1
            return "pixels", img, gt
        self.data_stats["from_png"] += 1
        return ("png", decode_png_color(img),
                decode_png_gray(gt) if gt is not None else None)

    # ------------------------------------------------------------ sampling

    def sample(self, index: int) -> Dict[str, np.ndarray]:
        """One augmented sample (see ``_draw``), its median target made on
        its own (``_medians``)."""
        sample = self._draw(index)
        if "median" in sample:
            sample["median"] = self._medians([sample["median"]])[0]
        return sample

    def _draw(self, index: int) -> Dict[str, np.ndarray]:
        """One augmented sample, with the uint8 crop in place of its median
        target; its spans ``data.decode`` (tagged with the pair's form),
        ``data.augment`` and ``data.masks`` (core/timing.py)."""
        rng = self.rng
        with span("data.decode", cpu=False) as decode:
            decode.tag, img, gt = self._get_pair(index)

        with span("data.augment", cpu=False):
            if self.flip_chance is not None:
                img, gt = augment.random_flips(rng, img, gt, self.flip_chance)

            if self.crop_size is not None:
                img, gt = augment.random_crop_min_fg(rng, img, gt,
                                                     self.crop_size,
                                                     self.crop_min_fg_prc)

            if (self.color_invert_chance is not None and
                    rng.random() < self.color_invert_chance):
                img = augment.color_invert(img)
            if (self.color_change_chance is not None and
                    rng.random() < self.color_change_chance):
                img = augment.hue_shift(rng, img)
            if (self.gaussian_noise_chance is not None and
                    rng.random() < self.gaussian_noise_chance):
                img = augment.gaussian_noise(rng, img,
                                             self.gaussian_noise_level)
            if (self.luminosity_change_chance is not None and
                    rng.random() < self.luminosity_change_chance):
                img = augment.luminosity_jitter(rng, img)

            img = np.ascontiguousarray(img)
            sample = {"image": img.astype(np.float32) / 127.5 - 1.0}

        with span("data.masks", cpu=False):
            if self.text_mask_expansion is not None and gt is not None:
                mask = augment.text_region_mask(np.ascontiguousarray(gt),
                                                self.text_mask_expansion)
                sample["text_mask"] = (mask.astype(np.float32)
                                       / 255.0)[..., None]

            if self.reconstruct_median:
                sample["median"] = img

            if self.reconstruction_mode:
                sample["target"] = sample["image"]
            elif gt is not None:
                sample["target"] = (gt.astype(np.float32) / 255.0)[..., None]

            if self.weight_expansion is not None and gt is not None:
                sample["weights"] = augment.weight_map(
                    np.ascontiguousarray(gt), self.weight_expansion,
                    self.weight_fg_extra)[..., None]

        return sample

    def _medians(self, crops) -> np.ndarray:
        """The float32 median targets of uint8 crops, a batch in one span
        ``data.median`` tagged with the route that made them
        (``utils/image.py median_route``): one launch of K4 on the card, or
        a crop at a time on the host."""
        route = median_route()
        with span("data.median", cpu=False, tag=route):
            if route == "cuda":
                median = median_u8_pinned(crops, self.reconstruct_median_k)
                self.data_stats["median_card"] += len(crops)
            else:
                median = np.stack([augment.median_target(
                    crop, self.reconstruct_median_k) for crop in crops])
                self.data_stats["median_host"] += len(crops)
            return median.astype(np.float32) / 127.5 - 1.0

    def batches(self, batch_size: int, shuffle: bool = True):
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            with span("data.batch"):
                samples = [self._draw(int(i))
                           for i in order[start:start + batch_size]]
                batch = {}
                for key in samples[0]:
                    parts = [s[key] for s in samples]
                    batch[key] = (self._medians(parts) if key == "median"
                                  else np.stack(parts))
            yield batch
