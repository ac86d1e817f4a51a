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

A batch is made in two parts (``batches``). On the host, each sample's
plan (``_plan``): every draw from the generator in the order the
reference's chain draws them (the flips, the crop with its retries on the
ground truth, the inversion, hue and noise coins, the hue shift and the
noise's normals) and its crops. Then the batch's pixels at once (``_make``):
the colour chain, the float image and the ground truth's targets, in one
launch of kernel K5 on a card (``ops/augment.py``), else by K5's plain
version on the host; then the median targets of a batch that has them,
from K5's crops where they lie, by kernel K4 (``ops/median.py``) or on the
host a crop at a time. The device is the trainer's where the dataset is
routed (``route``, which ``run_phase`` calls): the host's route for the
CPU, that card for a card. A dataset never routed takes the card where the
process sees one (``pixel_device``). A sample that draws the luminosity
jitter runs its whole colour chain on the host (its ``np.power`` is not
the card's), and K5 only converts it. Every route gives
the same bytes, so the batch is the same either way; ``data_stats`` counts
the samples whose pixels and median target each route made.

Each batch dict has: image [B,H,W,3] float32 in [-1,1] NHWC, target (gt
mask or the image itself in reconstruction mode), weights, text_mask,
median. On the card's route they are CUDA tensors, on the host's numpy
arrays; the trainer makes NCHW tensors of them.

Images are read without OpenCV: PNGs of every kind through
``utils/png.py`` (as ``cv2.imread`` reads them), the upscale through
``utils/image.py`` (INTER_LINEAR and INTER_NEAREST, bit-exact). JPEG files
are found as before but only OpenCV decodes them: where it is not
installed, loading one raises ``ImageFormatError``.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import native
from ..core.config import Config
from ..core.timing import span
from ..utils.image import median_route, resize_linear, resize_nearest
from ..utils import png
from ..utils.png import (ImageFormatError, decode_png_color, decode_png_gray,
                         encode_png)
from ..ops.augment import MAX_RADIUS, augment_batch
from ..ops.median import median_unit_batch
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
        # the device the batches are made on (``route``); None: by what the
        # process sees (``pixel_device``)
        self.device: Optional[torch.device] = None

        self._preloaded: Optional[List] = None
        self.total_foreground = 0
        self.total_background = 0
        # pairs and bytes kept by preload in each form, samples served from
        # each (the hit share is from_pixels / (from_pixels + from_png)),
        # samples whose median target the card or the host made (the card's
        # share is median_card / (median_card + median_host)), and samples
        # whose colour chain the card (K5) or the host made (the card's share
        # is pixels_card / (pixels_card + pixels_host))
        self.data_stats = dict.fromkeys(
            ("pairs_pixels", "pairs_png", "bytes_kept", "from_pixels",
             "from_png", "median_card", "median_host", "pixels_card",
             "pixels_host"), 0)

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

    def route(self, device: Union[str, torch.device]) -> None:
        """Make the batches' pixels and median targets on ``device``, the
        trainer's: the host's route for the CPU, that card for a card
        (``cuda`` without an index: the calling thread's current card, as
        the trainer's model goes there)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device

    # ------------------------------------------------------------ sampling

    def sample(self, index: int) -> Dict[str, np.ndarray]:
        """One augmented sample: ``batches``' work on a batch of one, as
        numpy arrays."""
        batch = self._make([self._plan(index)])
        return {key: (value[0].cpu().numpy() if isinstance(value, torch.Tensor)
                      else value[0]) for key, value in batch.items()}

    def _plan(self, index: int) -> _Plan:
        """Every draw of one sample from ``self.rng``, in the order the
        reference's chain draws them, and its crops; the pixel work is left
        to the batch (``_make``). Its spans ``data.decode`` (tagged with the
        pair's form), ``data.augment`` and ``data.masks``
        (core/timing.py)."""
        rng = self.rng
        with span("data.decode", cpu=False) as decode:
            decode.tag, img, gt = self._get_pair(index)

        def coin(chance):
            return chance is not None and rng.random() < chance

        with span("data.augment", cpu=False):
            if self.flip_chance is not None:
                img, gt = augment.random_flips(rng, img, gt, self.flip_chance)

            if self.crop_size is not None:
                img, gt = augment.random_crop_min_fg(rng, img, gt,
                                                     self.crop_size,
                                                     self.crop_min_fg_prc)

            invert = coin(self.color_invert_chance)
            hue = (augment.hue_draw(rng) if coin(self.color_change_chance)
                   else None)
            noise = (rng.standard_normal(img.shape)
                     if coin(self.gaussian_noise_chance) else None)
            on_host = coin(self.luminosity_change_chance)
            if on_host:
                # its chain ends in np.power, which the card does not round
                # as the host does: the host runs the whole chain
                if invert:
                    img = augment.color_invert(img)
                if hue is not None:
                    img = augment.hue_rotate(img, hue)
                if noise is not None:
                    img = augment.add_noise(img, noise,
                                            self.gaussian_noise_level)
                img = augment.luminosity_jitter(rng, img)
                invert, hue, noise = False, None, None

        with span("data.masks", cpu=False):
            gt = gt if self._gt_targets else None
        return _Plan(img, gt, invert, hue, noise, on_host)

    @property
    def _gt_targets(self) -> bool:
        """Whether a sample's ground truth makes any of its targets."""
        return self.ground_truth_list is not None and (
            not self.reconstruction_mode
            or self.text_mask_expansion is not None
            or self.weight_expansion is not None)

    def _make(self, plans: Sequence[_Plan]):
        """The batch of ``plans``: its pixels in one span ``data.pixels``,
        tagged with the route (``_pixel_device``): staged into one buffer,
        uploaded and made by one launch of kernel K5 on the card (the
        arrays stay there, NHWC tensors), or by K5's plain version on the
        host (numpy arrays); then its median targets (``_medians``)."""
        device = self._pixel_device() if self._fits_k5 else None
        stats = self.data_stats
        with span("data.pixels", cpu=False,
                  tag="host" if device is None else "cuda"):
            staged = _stage(plans, device)
            truths = staged.get("truths")
            out = augment_batch(
                staged["images"], staged["params"], staged["noise"],
                self.gaussian_noise_level, truths,
                target=truths is not None and not self.reconstruction_mode,
                text_mask_expansion=(None if truths is None
                                     else self.text_mask_expansion),
                weight_expansion=(None if truths is None
                                  else self.weight_expansion),
                weight_fg_extra=self.weight_fg_extra,
                keep_crops=self.reconstruct_median)
            on_host = len(plans) if device is None else sum(
                plan.on_host for plan in plans)
            stats["pixels_host"] += on_host
            stats["pixels_card"] += len(plans) - on_host
        batch = {"image": out["image"]}
        if "text_mask" in out:
            batch["text_mask"] = out["text_mask"]
        if self.reconstruct_median:
            batch["median"] = self._medians(out["crops"], device)
        if self.reconstruction_mode:
            batch["target"] = out["image"]
        elif "target" in out:
            batch["target"] = out["target"]
        if "weights" in out:
            batch["weights"] = out["weights"]
        if device is None:
            batch = {key: value.numpy() for key, value in batch.items()}
        return batch

    def _pixel_device(self) -> Optional[torch.device]:
        """The card the batch's pixels are made on, or None: the host. The
        routed device's (``route``), else ``pixel_device``'s."""
        if self.device is None:
            return pixel_device()
        return self.device if self.device.type == "cuda" else None

    @property
    def _fits_k5(self) -> bool:
        """Whether K5 takes this dataset's erosions (a radius of at most
        ``ops/augment.py MAX_RADIUS``); past that the host makes them."""
        return all(e is None or e <= MAX_RADIUS for e in
                   (self.text_mask_expansion, self.weight_expansion))

    def _medians(self, crops: torch.Tensor, device):
        """The float32 median targets of the batch's uint8 crops, in one
        span ``data.median`` tagged with the route that made them: one
        launch of K4 on the card where the crops lie (``"cuda"``), or a
        crop at a time on the host (``utils/image.py median_blur``'s
        route, ``"native"`` or ``"numpy"``)."""
        route = "cuda" if device is not None else (
            "native" if native.available() else "numpy")
        with span("data.median", cpu=False, tag=route):
            if device is not None:
                self.data_stats["median_card"] += len(crops)
                return median_unit_batch(crops, self.reconstruct_median_k)
            self.data_stats["median_host"] += len(crops)
            median = np.stack([augment.median_target(
                crop, self.reconstruct_median_k) for crop in crops.numpy()])
            return torch.from_numpy(median.astype(np.float32) / 127.5 - 1.0)

    def batches(self, batch_size: int, shuffle: bool = True):
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            with span("data.batch"):
                batch = self._make([self._plan(int(i))
                                    for i in order[start:start + batch_size]])
            yield batch


class _Plan(NamedTuple):
    """One sample as drawn: its uint8 crops and the draws of its colour
    chain. ``on_host``: a luminosity jitter was drawn, so ``img`` holds the
    whole chain's result and nothing of the chain is left."""
    img: np.ndarray                # [H, W, 3]
    gt: Optional[np.ndarray]       # [H, W], where a target needs it
    invert: bool
    hue: Optional[int]             # the hue shift drawn, or None
    noise: Optional[np.ndarray]    # float64 [H, W, 3] normals, or None
    on_host: bool


def pixel_device() -> Optional[torch.device]:
    """The card an unrouted dataset makes a batch's pixels on (kernel K5),
    or None: the host. The card where the process sees one and was not
    forked after using it (``utils/image.py median_route``): the calling
    thread's."""
    if median_route() != "cuda":
        return None
    return torch.device("cuda", torch.cuda.current_device())


def _stage(plans: Sequence[_Plan], device: Optional[torch.device]):
    """The plans' crops, per-sample parameters (``ops/augment.py``) and
    noise rows, copied into one buffer (pinned, for a card) and moved to
    ``device`` in one copy (none for the host): a dict of views of it."""
    img, gt = plans[0].img, plans[0].gt
    batch, (height, width) = len(plans), img.shape[:2]
    noisy = [plan for plan in plans if plan.noise is not None]
    parts = [("images", np.uint8, (batch, height, width, 3)),
             ("truths", np.uint8, (batch, height, width)),
             ("params", np.int32, (batch, 4)),
             ("noise", np.float64, (len(noisy), height, width, 3))]
    if gt is None:
        del parts[1]
    layout, size = {}, 0
    for name, dtype, shape in parts:
        layout[name] = (size, dtype, shape)
        size += -(-int(np.prod(shape)) * np.dtype(dtype).itemsize // 16) * 16
    buffer = torch.empty(size, dtype=torch.uint8,
                         pin_memory=device is not None
                         and device.type == "cuda")

    def view(source, name):
        offset, dtype, shape = layout[name]
        count = int(np.prod(shape))
        return source[offset:offset + count * np.dtype(dtype).itemsize]

    host = buffer.numpy()

    def host_view(name):
        _, dtype, shape = layout[name]
        return view(host, name).view(dtype).reshape(shape)

    np.stack([plan.img for plan in plans], out=host_view("images"))
    if gt is not None:
        np.stack([plan.gt for plan in plans], out=host_view("truths"))
    params = host_view("params")
    rows = host_view("noise")
    row = 0
    for k, plan in enumerate(plans):
        params[k] = (plan.invert, plan.hue is not None, plan.hue or 0,
                     row if plan.noise is not None else -1)
        if plan.noise is not None:
            rows[row] = plan.noise
            row += 1
    moved = buffer if device is None else buffer.to(device, non_blocking=True)
    dtypes = {np.uint8: torch.uint8, np.int32: torch.int32,
              np.float64: torch.float64}
    return {name: view(moved, name).view(dtypes[dtype]).view(shape)
            for name, (_, dtype, shape) in layout.items()}
