"""The training data path without OpenCV: the OpenCV-exact image functions
of ``lecturemath_tpu_torch.utils.image`` against cv2, each augmentation
against the JAX package's from the same seed, and the port's dataset
samples and batches against the JAX package's ``LectureNetDataset``, key
for key. The port's calls run with cv2, PIL and msgpack unimportable."""

import contextlib
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lecturemath_tpu.train import augment as jaug
from lecturemath_tpu.train.dataset import LectureNetDataset as JAXDataset
from lecturemath_tpu.utils.synthetic import synthetic_rgb_lecture
from lecturemath_tpu_torch import native
from lecturemath_tpu_torch.core import timing
from lecturemath_tpu_torch.ops.median import median_unit_batch
from lecturemath_tpu_torch.train import augment as taug
from lecturemath_tpu_torch.train import dataset as dataset_module
from lecturemath_tpu_torch.train.dataset import (ImageFormatError,
                                                 LectureNetDataset)
from lecturemath_tpu_torch.utils import image as timage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def no_opencv():
    """cv2, PIL and msgpack unimportable for the port's calls inside."""
    names = ("cv2", "PIL", "PIL.Image", "msgpack")
    saved = {name: sys.modules.get(name, False) for name in names}
    for name in names:
        sys.modules[name] = None
    try:
        yield
    finally:
        for name, module in saved.items():
            if module is False:
                del sys.modules[name]
            else:
                sys.modules[name] = module


def _every_colour():
    codes = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(codes >> 16) & 255, (codes >> 8) & 255, codes & 255],
                    axis=-1).astype(np.uint8).reshape(4096, 4096, 3)


# ------------------------------------------------------- image functions

@pytest.mark.parametrize("seed", range(4))
def test_resize_linear_equals_cv2(seed):
    rng = np.random.default_rng(seed)
    for case in range(60):
        h, w = (int(v) for v in rng.integers(1, 50, 2))
        if case < 6:        # 1-pixel sides
            h, w = (1, w) if case % 2 else (h, 1)
        dh, dw = (int(v) for v in rng.integers(0, 120, 2))
        channels = (0, 1, 3)[case % 3]
        img = rng.integers(0, 256, (h, w) + ((channels,) if channels else ()),
                           dtype=np.uint8)
        size = (w + dw, h + dh)
        if case % 4 == 3:   # down along one axis or both, halvings too
            size = (max(1, w * int(rng.integers(1, 4)) // 6) if dw % 2
                    else w + dw, max(1, h // 2))
        with no_opencv():
            ours = timage.resize_linear(img, size)
        theirs = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(ours.reshape(theirs.shape), theirs,
                                      err_msg=f"{img.shape} -> {size}")


def test_rgb_to_gray_and_hsv_every_colour():
    rgb = _every_colour()
    with no_opencv():
        gray = timage.rgb_to_gray(rgb)
        hsv = timage.rgb_to_hsv(rgb)
    np.testing.assert_array_equal(gray, cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
    np.testing.assert_array_equal(hsv, cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("width", [256, 33, 16])
def test_hsv_to_rgb_every_triple(width):
    """All 180 x 256 x 256 HSV triples, in rows of ``width`` pixels (OpenCV
    takes whole blocks of 32 of a row on its vector path, the rest on its
    scalar path)."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                          indexing="ij")
    hsv = np.stack([h, s, v], axis=-1).astype(np.uint8).reshape(-1, 3)
    hsv = hsv[:len(hsv) // width * width].reshape(-1, width, 3)
    with no_opencv():
        ours = timage.hsv_to_rgb(hsv)
    np.testing.assert_array_equal(ours, cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_ellipse_kernel_and_erode_equal_cv2():
    rng = np.random.default_rng(0)
    for size in range(1, 42):
        kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size))
        with no_opencv():
            ours = timage.ellipse_kernel(size)
        np.testing.assert_array_equal(ours, kernel, err_msg=str(size))
    for case in range(40):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        size = 3 + 2 * (case % 20)
        img = np.where(rng.random((h, w)) < 0.8, 255,
                       rng.integers(0, 256, (h, w))).astype(np.uint8)
        kernel = timage.ellipse_kernel(size)
        with no_opencv():
            ours = timage.erode(img, kernel)
        np.testing.assert_array_equal(ours, cv2.erode(img, kernel),
                                      err_msg=f"{img.shape} k={size}")


@pytest.fixture(params=["native", "numpy"])
def native_or_numpy(request, monkeypatch):
    if request.param == "native":
        assert native.available()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("ksize", [3, 5, 7, 9, 15, 21, 35])
def test_median_blur_equals_cv2(ksize, native_or_numpy):
    rng = np.random.default_rng(ksize)
    for shape in ((1, 1, 3), (7, 40, 3), (45, 37), (33, 50, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        with no_opencv():
            ours = timage.median_blur(img, ksize)
        np.testing.assert_array_equal(ours, cv2.medianBlur(img, ksize),
                                      err_msg=f"{shape} k={ksize}")


# ---------------------------------------------------- the augmentations

def _crop(seed, shape=(70, 90)):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    rgb[10:40, 20:70] = rng.integers(0, 60, (30, 50, 3), dtype=np.uint8)
    gt = np.full(shape, 255, np.uint8)
    gt[12:38, 25:65] = np.where(rng.random((26, 40)) < 0.5, 0, 255)
    return rgb, gt


@pytest.mark.parametrize("seed", range(6))
def test_augmentations_equal_jax_package(seed):
    img, gt = _crop(seed)
    pairs = [
        ("random_flips", lambda m, r: m.random_flips(r, img, gt, 0.5)),
        ("random_crop_min_fg", lambda m, r: m.random_crop_min_fg(
            r, img, gt, (48, 64), 0.2)),
        ("color_invert", lambda m, r: m.color_invert(img)),
        ("hue_shift", lambda m, r: m.hue_shift(r, img[:, 3:])),
        ("gaussian_noise", lambda m, r: m.gaussian_noise(r, img, 5.0)),
        ("luminosity_jitter", lambda m, r: m.luminosity_jitter(r, img)),
        ("text_region_mask", lambda m, r: m.text_region_mask(gt, seed + 1)),
        ("weight_map", lambda m, r: m.weight_map(gt, seed + 1, 2.0)),
        ("median_target", lambda m, r: m.median_target(img, 2 * seed + 3)),
    ]
    for name, call in pairs:
        rng_jax = np.random.default_rng(100 + seed)
        rng_port = np.random.default_rng(100 + seed)
        theirs = call(jaug, rng_jax)
        with no_opencv():
            ours = call(taug, rng_port)
        ours, theirs = (list(x) if isinstance(x, tuple) else [x]
                        for x in (ours, theirs))
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b, err_msg=name)
        # the same draws, in the same order
        assert rng_port.random() == rng_jax.random(), name


# ---------------------------------------------------------- the dataset

@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """Frames and GTs as cv2 writes them: two larger than the crop, two
    smaller (upscaled), GTs as RGB PNGs whose blue channel differs from
    the others (cv2.imread(...)[:, :, 0] takes blue)."""
    root = tmp_path_factory.mktemp("train_pngs")
    rgb, binary, _, _ = synthetic_rgb_lecture(seed=0, n_frames=4, height=96,
                                              width=128)
    images, gts = [], []
    for k in range(4):
        frame, ink = rgb[k], binary[k]
        if k >= 2:
            frame, ink = frame[:40 + 5 * k, :50 + 3 * k], ink[:40 + 5 * k,
                                                              :50 + 3 * k]
        gt = np.stack([255 - ink] * 3, axis=-1)
        gt[..., 1] = 128
        images.append(str(root / f"img_{k}.png"))
        gts.append(str(root / f"gt_{k}.png"))
        cv2.imwrite(images[-1], frame[:, :, ::-1])
        cv2.imwrite(gts[-1], gt)
    return images, gts


ALL_ON = dict(crop_size=(64, 64), crop_min_fg_prc=0.01, flip_chance=0.5,
              color_invert_chance=0.5, color_change_chance=0.5,
              luminosity_change_chance=0.5, gaussian_noise_chance=0.5,
              weight_expansion=2, weight_fg_extra=1.5, text_mask_expansion=3,
              reconstruct_median=True, reconstruct_median_k=5)


@pytest.mark.parametrize("preload", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_dataset_batches_equal_jax_package(image_files, seed, preload):
    images, gts = image_files
    theirs = JAXDataset(images, gts, seed=seed, **ALL_ON)
    with no_opencv():
        ours = LectureNetDataset(images, gts, seed=seed, **ALL_ON)
    if preload:
        theirs.preload()
        with no_opencv():
            ours.preload()
        assert (ours.total_foreground, ours.total_background) == (
            theirs.total_foreground, theirs.total_background)
    for epoch in range(2):
        with no_opencv():
            our_batches = list(ours.batches(2))
        their_batches = list(theirs.batches(2))
        assert len(our_batches) == len(their_batches) == 2
        for a, b in zip(our_batches, their_batches):
            assert sorted(a) == sorted(b)
            for key in b:
                np.testing.assert_array_equal(a[key], b[key],
                                              err_msg=f"{epoch} {key}")


def _epochs(dataset, epochs=2):
    with no_opencv():
        return [list(dataset.batches(2)) for _ in range(epochs)]


def _assert_same_batches(ours, theirs):
    for epoch, (a_epoch, b_epoch) in enumerate(zip(ours, theirs)):
        assert len(a_epoch) == len(b_epoch) == 2
        for a, b in zip(a_epoch, b_epoch):
            assert sorted(a) == sorted(b)
            for key in b:
                np.testing.assert_array_equal(a[key], b[key],
                                              err_msg=f"{epoch} {key}")


def _preload_options(reconstruction):
    """ALL_ON with border cropping (binarizer mode) or without the GT's
    masks (reconstruction mode); the two small frames are upscaled."""
    if reconstruction:
        return dict(ALL_ON, weight_expansion=None, text_mask_expansion=None)
    return dict(ALL_ON, crop_remove_empty_borders=True)


def _preloaded(images, gts, reconstruction, seed, budget, monkeypatch):
    """The port's dataset preloaded with ``preload_budget`` returning
    ``budget`` (None: the host's own)."""
    if budget is not None:
        monkeypatch.setattr(dataset_module, "preload_budget", lambda: budget)
    with no_opencv():
        ours = LectureNetDataset(images, gts,
                                 reconstruction_mode=reconstruction,
                                 seed=seed, **_preload_options(reconstruction))
        ours.preload()
    monkeypatch.undo()
    return ours


def _pixel_bytes(dataset, count):
    """The bytes of the first ``count`` pairs as decoded pixels."""
    total = 0
    for index in range(count):
        img, gt = dataset.load_pair(index)
        total += img.nbytes + (gt.nbytes if gt is not None else 0)
    return total


@pytest.mark.parametrize("reconstruction", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_preloaded_pixels_equal_png_form_and_jax_package(
        image_files, monkeypatch, seed, reconstruction):
    """Kept pixels, PNG copies and the JAX package's preloaded dataset give
    the same batches over two epochs, and the same fg/bg counts."""
    images, gts = image_files
    gts = None if reconstruction else gts
    theirs = JAXDataset(images, gts, reconstruction_mode=reconstruction,
                        seed=seed, **_preload_options(reconstruction))
    theirs.preload()
    pixels = _preloaded(images, gts, reconstruction, seed, None, monkeypatch)
    pngs = _preloaded(images, gts, reconstruction, seed, 0, monkeypatch)
    assert pixels.data_stats["pairs_pixels"] == 4
    assert pngs.data_stats["pairs_png"] == 4
    for ours in (pixels, pngs):
        assert (ours.total_foreground, ours.total_background) == (
            theirs.total_foreground, theirs.total_background)
    expected = [list(theirs.batches(2)) for _ in range(2)]
    _assert_same_batches(_epochs(pixels), expected)
    _assert_same_batches(_epochs(pngs), expected)


def test_preloaded_pixels_are_read_only_copies(image_files):
    """Each kept array owns its contiguous data (a border crop holds no
    view of its whole frame) and refuses a write."""
    images, gts = image_files
    with no_opencv():
        ours = LectureNetDataset(images, gts, seed=0,
                                 **_preload_options(False))
        ours.preload()
    for index in range(len(ours)):
        img, gt = ours.load_pair(index)
        for kept, loaded in zip(ours._preloaded[index], (img, gt)):
            assert kept.base is None and kept.flags.c_contiguous
            assert not kept.flags.writeable
            np.testing.assert_array_equal(kept, loaded)
            with pytest.raises(ValueError, match="read-only"):
                kept[0, 0] = 1
        if index < 2:   # the large frames, cropped to their ink: views
            assert img.base is not None and img.shape[:2] != (96, 128)


@pytest.mark.parametrize("kept_pairs", [0, 2])
@pytest.mark.parametrize("reconstruction", [False, True])
def test_preload_keeps_pixels_within_its_budget(image_files, monkeypatch,
                                                reconstruction, kept_pairs):
    """A budget of nothing keeps every pair as PNG; one that fits the first
    two pairs keeps those as pixels and the rest as PNG. The batches, the
    fg/bg counts and the counters follow the split."""
    images, gts = image_files
    gts = None if reconstruction else gts
    whole = _preloaded(images, gts, reconstruction, 3, None, monkeypatch)
    budget = _pixel_bytes(whole, kept_pairs)
    split = _preloaded(images, gts, reconstruction, 3, budget, monkeypatch)
    forms = [isinstance(img, np.ndarray) for img, _ in split._preloaded]
    assert forms == [True] * kept_pairs + [False] * (4 - kept_pairs)
    stats = split.data_stats
    assert (stats["pairs_pixels"], stats["pairs_png"]) == (kept_pairs,
                                                           4 - kept_pairs)
    png_bytes = sum(len(img) + (len(gt) if gt is not None else 0)
                    for img, gt in split._preloaded[kept_pairs:])
    assert stats["bytes_kept"] == budget + png_bytes
    assert whole.data_stats["bytes_kept"] == _pixel_bytes(whole, 4)
    assert (split.total_foreground, split.total_background) == (
        whole.total_foreground, whole.total_background)
    _assert_same_batches(_epochs(split), _epochs(whole))
    # two epochs draw every pair twice
    assert (stats["from_pixels"], stats["from_png"]) == (2 * kept_pairs,
                                                         2 * (4 - kept_pairs))
    assert whole.data_stats["from_pixels"] == 8
    assert whole.data_stats["from_png"] == 0


def test_decode_span_names_the_pairs_form(image_files, monkeypatch):
    """While a profiler traces, each ``data.decode`` span carries the form
    its pair was served from; a dataset that reads its files tags none."""
    images, gts = image_files
    split = _preloaded(images, gts, False, 0, 1, monkeypatch)
    split_stats = dict(split.data_stats)
    files = LectureNetDataset(images, gts, seed=0, **_preload_options(False))
    timing.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        _epochs(split, 1)
        _epochs(files, 1)
    records, dropped = timing.take_spans()
    tags = [r.tag for r in records if r.name == "data.decode"]
    assert dropped == 0 and len(tags) == 8
    assert sorted(tags[:4]) == ["png"] * 4 and tags[4:] == [None] * 4
    assert split_stats["pairs_png"] == 4
    # a dataset reading its files counts no pair's form, only the medians
    # and pixels its four samples were given on the host
    assert files.data_stats == dict(dict.fromkeys(files.data_stats, 0),
                                    median_host=4, pixels_host=4)


@pytest.mark.parametrize("seed", [0, 3])
def test_median_targets_count_their_route_and_agree_across_routes(
        image_files, monkeypatch, seed):
    """Without a card every sample's median target is made on the host and
    counted under ``median_host``. The card's route, its device stood in
    for by the CPU (K5 and K4 by their plain versions, on the batch's
    staged tensors), gives the same batches over two epochs from one K4
    call a batch, and counts ``median_card``."""
    images, _ = image_files
    options = _preload_options(True)
    host = LectureNetDataset(images, None, reconstruction_mode=True,
                             seed=seed, **options)
    host_epochs = _epochs(host)
    assert (host.data_stats["median_host"],
            host.data_stats["median_card"]) == (8, 0)
    calls = []

    def plain_unit(crops, k):
        calls.append(len(crops))
        return median_unit_batch(crops, k)

    monkeypatch.setattr(dataset_module, "pixel_device",
                        lambda: torch.device("cpu"))
    monkeypatch.setattr(dataset_module, "median_unit_batch", plain_unit)
    card = LectureNetDataset(images, None, reconstruction_mode=True,
                             seed=seed, **options)
    card_epochs = [[{key: value.numpy() for key, value in batch.items()}
                    for batch in epoch] for epoch in _epochs(card)]
    _assert_same_batches(card_epochs, host_epochs)
    assert calls == [2] * 4
    assert (card.data_stats["median_host"],
            card.data_stats["median_card"]) == (0, 8)


def test_preload_budget_is_half_the_available_memory():
    available = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    budget = dataset_module.preload_budget()
    assert 0 < budget <= available // 2 + (64 << 20)


@pytest.mark.parametrize("reconstruction", [False, True])
def test_dataset_samples_equal_jax_package(image_files, reconstruction):
    images, gts = image_files
    gts = None if reconstruction else gts
    options = dict(ALL_ON, crop_size=(72, 80),
                   crop_remove_empty_borders=not reconstruction)
    if reconstruction:
        options.update(weight_expansion=None, text_mask_expansion=None)
    theirs = JAXDataset(images, gts, reconstruction_mode=reconstruction,
                        seed=5, **options)
    with no_opencv():
        ours = LectureNetDataset(images, gts,
                                 reconstruction_mode=reconstruction, seed=5,
                                 **options)
    for index in (2, 0, 3, 1, 2):
        with no_opencv():
            a = ours.sample(index)
        b = theirs.sample(index)
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_jpeg_needs_opencv(tmp_path):
    path = str(tmp_path / "frame.jpg")
    cv2.imwrite(path, np.full((40, 50, 3), 200, np.uint8))
    dataset = LectureNetDataset([path], None, crop_size=None)
    img, _ = dataset.load_pair(0)       # OpenCV decodes it where installed
    assert img.shape == (40, 50, 3)
    with no_opencv():
        with pytest.raises(ImageFormatError, match="JPEG.*OpenCV"):
            dataset.load_pair(0)


_TRAIN_NO_OPENCV = r"""
import sys
for name in ("cv2", "PIL", "PIL.Image", "msgpack"):
    sys.modules[name] = None
sys.path.insert(0, %r)
import numpy as np
from lecturemath_tpu_torch.core.config import Config
from lecturemath_tpu_torch.models.convert import load_checkpoint
from lecturemath_tpu_torch.train.dataset import LectureNetDataset
from lecturemath_tpu_torch.train.trainer import run_phase
images, gts = %r, %r
config = Config({
    **{f"FCN_BINARIZER_NET_{key}_{i}": v
       for key in ("DOWN_CONV_FILTERS", "UPSAMPLE_FILTERS", "UP_CONV_FILTERS")
       for i, v in enumerate((2, 3, 4, 5, 6), 1)},
    "FCN_BINARIZER_NET_MIDDLE_CONV_FILTERS_MIDDLE": 6,
    "FCN_BINARIZER_NET_PIXEL_FEATURES_1": 4,
    "FCN_BINARIZER_NET_PIXEL_FEATURES_2": 3,
    "FCN_BINARIZER_NET_PIXEL_KERNEL_SIZE": 3,
    "FCN_BINARIZER_PRETRAIN_RECONSTRUCTION_OUTPUT": %r,
    "FCN_BINARIZER_TRAIN_OUTPUT": %r})
rec = LectureNetDataset(images, None, reconstruction_mode=True,
                        crop_size=(32, 32), reconstruct_median=True,
                        reconstruct_median_k=5, color_change_chance=0.5,
                        luminosity_change_chance=0.5)
rec.preload()
rec_path = run_phase(config, "reconstruction", rec, epochs_override=1,
                     batch_size_override=2, verbose=False, device="cpu")
data = LectureNetDataset(images, gts, crop_size=(32, 32),
                         text_mask_expansion=2, weight_expansion=1,
                         flip_chance=0.5)
path = run_phase(config, "binarizer", data, warm_start_path=rec_path,
                 warm_start_is_reconstruction=True, epochs_override=1,
                 batch_size_override=2, verbose=False, device="cpu")
assert len(load_checkpoint(path)) > 100
print("trained without OpenCV")
"""


def test_training_path_needs_no_opencv(image_files, tmp_path):
    """PNG reading, upscaling, every augmentation, preload, both training
    phases and the .msgpack checkpoints with cv2, PIL and msgpack
    unimportable."""
    images, gts = image_files
    script = _TRAIN_NO_OPENCV % (REPO, images, gts,
                                 str(tmp_path / "rec.msgpack"),
                                 str(tmp_path / "bin.msgpack"))
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                            capture_output=True, text=True, timeout=300,
                            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert result.returncode == 0, result.stderr[-3000:]
    assert "trained without OpenCV" in result.stdout
