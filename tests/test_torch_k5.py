"""Kernel K5's plain version (``ops/augment.py augment_plain``) against the
host functions of ``train/augment.py`` it stands for, and the training
batches that the dataset plans on the host and makes in one batch
(``LectureNetDataset.batches``) against the JAX package's, sample by sample
as it draws them. The card's route runs here with its device stood in for
by the CPU: the staging, the per-sample parameters and the noise rows it
hands K5 go through the plain version. K5 itself runs on the card only
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from lecturemath_tpu.train.dataset import LectureNetDataset as JAXDataset
from lecturemath_tpu.utils.synthetic import synthetic_rgb_lecture
from lecturemath_tpu_torch.ops import augment as k5
from lecturemath_tpu_torch.train import augment as taug
from lecturemath_tpu_torch.train import dataset as dataset_module
from lecturemath_tpu_torch.train.dataset import LectureNetDataset
from lecturemath_tpu_torch.utils.image import ellipse_kernel
from lecturemath_tpu_torch.utils.png import encode_png

LEVEL = 5.0
FG_EXTRA = 1.5


def _crops(seed, batch, height, width):
    """Random colour crops with a dark block, and ground truths with ink
    sprinkled, a line across, and ink on every edge of the crop."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (batch, height, width, 3), dtype=np.uint8)
    images[:, height // 3:, :width // 2] = rng.integers(
        0, 40, (batch, height - height // 3, width // 2, 3), dtype=np.uint8)
    truths = np.where(rng.random((batch, height, width)) < 0.03, 0,
                      255).astype(np.uint8)
    truths[:, height // 2] = 0
    truths[:, 0, ::7] = truths[:, -1, 3::5] = 0
    truths[:, ::6, 0] = truths[:, 2::9, -1] = 0
    return rng, images, truths


def _plain(images, params, noise=None, truths=None, **options):
    height, width = images.shape[1:3]
    if noise is None:
        noise = np.zeros((0, height, width, 3))
    out = k5.augment_plain(
        torch.from_numpy(images), torch.from_numpy(np.asarray(params,
                                                              np.int32)),
        torch.from_numpy(noise), LEVEL,
        None if truths is None else torch.from_numpy(truths), **options)
    return {key: value.numpy() for key, value in out.items()}


def _unit(img):
    return img.astype(np.float32) / 127.5 - 1.0


@pytest.mark.parametrize("op", ["invert", "hue", "noise", "text_mask",
                                "weights"])
@pytest.mark.parametrize("shape", [(3, 40, 70), (2, 20, 25)])
def test_plain_version_equals_the_host_functions(op, shape):
    """Each operation alone, byte for byte with ``train/augment.py``'s own
    call on each crop: the inversion, the hue rotation and the noise from
    the same draws as ``hue_shift`` and ``gaussian_noise`` take, the text
    mask at e = 15 and the weights at w = 1 with ink on the crop's edges,
    also on a crop narrower than the 31-pixel ellipse."""
    batch, height, width = shape
    rng, images, truths = _crops(sum(shape), batch, height, width)
    seeds = [int(rng.integers(1 << 30)) for _ in range(batch)]
    if op == "invert":
        out = _plain(images, [(1, 0, 0, -1)] * batch, keep_crops=True)
        want = [taug.color_invert(img) for img in images]
    elif op == "hue":
        shifts = [taug.hue_draw(np.random.default_rng(s)) for s in seeds]
        out = _plain(images, [(0, 1, shift, -1) for shift in shifts],
                     keep_crops=True)
        want = [taug.hue_shift(np.random.default_rng(s), img)
                for s, img in zip(seeds, images)]
    elif op == "noise":
        noise = np.stack([np.random.default_rng(s).standard_normal(
            images.shape[1:]) for s in seeds])
        out = _plain(images, [(0, 0, 0, k) for k in range(batch)], noise,
                     keep_crops=True)
        want = [taug.gaussian_noise(np.random.default_rng(s), img, LEVEL)
                for s, img in zip(seeds, images)]
    if op in ("invert", "hue", "noise"):
        np.testing.assert_array_equal(out["crops"], np.stack(want))
        np.testing.assert_array_equal(out["image"], _unit(np.stack(want)))
        return
    params = [(0, 0, 0, -1)] * batch
    if op == "text_mask":
        out = _plain(images, params, truths=truths, text_mask_expansion=15)
        want = [taug.text_region_mask(gt, 15).astype(np.float32) / 255.0
                for gt in truths]
    else:
        out = _plain(images, params, truths=truths, weight_expansion=1,
                     weight_fg_extra=FG_EXTRA)
        want = [taug.weight_map(gt, 1, FG_EXTRA) for gt in truths]
    np.testing.assert_array_equal(out[op], np.stack(want)[..., None])
    np.testing.assert_array_equal(out["image"], _unit(images))
    assert sorted(out) == ["image", op]


def test_plain_version_runs_the_chain_in_the_hosts_order():
    """Every mix of inversion, hue and noise on one batch, with the
    targets: each sample equals the host's chain on it, and the samples
    take their noise rows in order."""
    mixes = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    rng, images, truths = _crops(11, len(mixes), 36, 50)
    noise = rng.standard_normal((4, 36, 50, 3))
    params, row = [], 0
    for invert, hue, noisy in mixes:
        params.append((invert, hue, -40 + 11 * row if hue else 0,
                       row if noisy else -1))
        row += noisy
    out = _plain(images, params, noise, truths, target=True,
                 text_mask_expansion=15, weight_expansion=1,
                 weight_fg_extra=FG_EXTRA, keep_crops=True)
    for k, (invert, hue, shift, row) in enumerate(params):
        img = taug.color_invert(images[k]) if invert else images[k]
        img = taug.hue_rotate(img, shift) if hue else img
        img = taug.add_noise(img, noise[row], LEVEL) if row >= 0 else img
        np.testing.assert_array_equal(out["crops"][k], img)
        np.testing.assert_array_equal(out["image"][k], _unit(img))
        np.testing.assert_array_equal(
            out["target"][k, ..., 0], truths[k].astype(np.float32) / 255.0)
    assert out["text_mask"].shape == out["weights"].shape == (8, 36, 50, 1)


@pytest.mark.parametrize("expansion", [0, 1, 2, 15, 64])
def test_run_widths_are_the_ellipses_rows(expansion):
    widths = k5.run_widths(expansion)
    kernel = ellipse_kernel(2 * expansion + 1)
    np.testing.assert_array_equal(2 * widths + 1, kernel.sum(axis=1))
    assert widths.dtype == np.int32 and widths[expansion] == expansion


def test_augment_batch_refuses_what_it_does_not_take():
    images = torch.zeros(2, 8, 8, 3, dtype=torch.uint8)
    params = torch.zeros(2, 4, dtype=torch.int32)
    noise = torch.zeros(0, 8, 8, 3, dtype=torch.float64)
    truths = torch.zeros(2, 8, 8, dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8"):
        k5.augment_batch(images.float(), params, noise, LEVEL)
    with pytest.raises(ValueError, match=r"\[B, H, W, 3\]"):
        k5.augment_batch(images[..., :1].contiguous(), params, noise, LEVEL)
    with pytest.raises(ValueError, match=r"\[2, 4\]"):
        k5.augment_batch(images, params[:1], noise, LEVEL)
    with pytest.raises(ValueError, match="contiguous"):
        k5.augment_batch(images.transpose(1, 2), params, noise, LEVEL)
    with pytest.raises(ValueError, match="noise"):
        k5.augment_batch(images, params, noise[:, :4].contiguous(), LEVEL)
    with pytest.raises(ValueError, match="ground truth"):
        k5.augment_batch(images, params, noise, LEVEL, target=True)
    with pytest.raises(ValueError, match="whole number"):
        k5.augment_batch(images, params, noise, LEVEL, truths,
                         text_mask_expansion=-1)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Four frames with their ground truth as PNG files."""
    root = tmp_path_factory.mktemp("k5_pngs")
    rgb, binary, _, _ = synthetic_rgb_lecture(seed=4, n_frames=4, height=96,
                                              width=128)
    images, truths = [], []
    for k in range(4):
        images.append(str(root / f"img_{k}.png"))
        truths.append(str(root / f"gt_{k}.png"))
        with open(images[-1], "wb") as f:
            f.write(encode_png(np.ascontiguousarray(rgb[k][:, :, ::-1])))
        with open(truths[-1], "wb") as f:
            f.write(encode_png(np.ascontiguousarray(255 - binary[k])))
    return images, truths


# both cells' menu (the binarizer phase's, example.conf:188-195) with the
# hue rotation drawn more often, at a crop the tests can afford
MENU = dict(crop_size=(64, 64), flip_chance=0.5, color_invert_chance=0.5,
            color_change_chance=0.5, gaussian_noise_chance=0.5,
            gaussian_noise_level=LEVEL)
PHASES = {
    "binarizer": dict(MENU, crop_min_fg_prc=0.1, text_mask_expansion=15,
                      weight_expansion=1, weight_fg_extra=FG_EXTRA),
    "reconstruction": dict(MENU, reconstruction_mode=True,
                           reconstruct_median=True, reconstruct_median_k=5),
}


def _datasets(frames, phase, seed, **extra):
    images, truths = frames
    truths = None if phase == "reconstruction" else truths
    options = dict(PHASES[phase], **extra)
    return (JAXDataset(images, truths, seed=seed, **options),
            LectureNetDataset(images, truths, seed=seed, **options))


def _as_numpy(batch):
    return {key: value.numpy() if isinstance(value, torch.Tensor) else value
            for key, value in batch.items()}


def _assert_equal_epochs(ours, theirs, epochs=2):
    for epoch in range(epochs):
        a_epoch, b_epoch = list(ours.batches(2)), list(theirs.batches(2))
        assert len(a_epoch) == len(b_epoch) == 2
        for a, b in zip(a_epoch, b_epoch):
            a = _as_numpy(a)
            assert sorted(a) == sorted(b)
            for key in b:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key],
                                              err_msg=f"{epoch} {key}")


@pytest.mark.parametrize("route", ["host", "card"])
@pytest.mark.parametrize("phase", ["binarizer", "reconstruction"])
@pytest.mark.parametrize("seed", [1, 2, 7])
def test_planned_batches_equal_the_drawn_ones(frames, monkeypatch, seed,
                                              phase, route):
    """Two epochs of ``batches(2)``, planned on the host and made a batch
    at a time, equal the JAX package's batches, drawn and made a sample at
    a time, key for key, on the host's route and on the card's (its device
    the CPU here); every sample's pixels count under their route."""
    if route == "card":
        monkeypatch.setattr(dataset_module, "pixel_device",
                            lambda: torch.device("cpu"))
    theirs, ours = _datasets(frames, phase, seed)
    _assert_equal_epochs(ours, theirs)
    stats = ours.data_stats
    assert (stats["pixels_card"], stats["pixels_host"]) == (
        (8, 0) if route == "card" else (0, 8))
    if phase == "reconstruction":
        assert stats["median_card" if route == "card" else "median_host"] == 8


@pytest.mark.parametrize("chance", [0.5, 1.0])
def test_a_luminosity_sample_takes_the_hosts_route(frames, monkeypatch,
                                                   chance):
    """On the card's route a sample that draws the luminosity jitter runs
    its whole colour chain on the host and counts under ``pixels_host``;
    the others count under ``pixels_card``. The batches equal the JAX
    package's either way."""
    monkeypatch.setattr(dataset_module, "pixel_device",
                        lambda: torch.device("cpu"))
    theirs, ours = _datasets(frames, "binarizer", 5,
                             luminosity_change_chance=chance)
    _assert_equal_epochs(ours, theirs)
    stats = ours.data_stats
    assert stats["pixels_card"] + stats["pixels_host"] == 8
    if chance == 1.0:
        assert stats["pixels_card"] == 0
    else:
        assert 0 < stats["pixels_host"] < 8


def test_an_erosion_past_k5s_reach_takes_the_hosts_route(frames,
                                                        monkeypatch):
    """A text mask eroded further than K5's halo holds (e = 65) is made on
    the host for every sample, where a card is seen too, and equals the
    JAX package's."""
    monkeypatch.setattr(dataset_module, "pixel_device",
                        lambda: torch.device("cpu"))
    theirs, ours = _datasets(frames, "binarizer", 6,
                             text_mask_expansion=k5.MAX_RADIUS + 1)
    _assert_equal_epochs(ours, theirs, epochs=1)
    assert (ours.data_stats["pixels_card"],
            ours.data_stats["pixels_host"]) == (0, 4)


def test_batches_on_the_cards_route_are_tensors_and_the_image_is_the_target(
        frames, monkeypatch):
    """The card's route yields NHWC tensors on its device; in the
    reconstruction phase the image and the target are one tensor."""
    monkeypatch.setattr(dataset_module, "pixel_device",
                        lambda: torch.device("cpu"))
    _, ours = _datasets(frames, "reconstruction", 3)
    batch = next(ours.batches(2))
    assert all(isinstance(value, torch.Tensor) for value in batch.values())
    assert batch["target"] is batch["image"]
    assert batch["image"].shape == (2, 64, 64, 3)
    assert batch["median"].dtype == torch.float32
