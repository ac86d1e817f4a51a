"""The text-detector phase (TD-PT) against its plain reference
(``benchmark/reference/text_data.py``, ``text_train.py``) on the CPU at tiny
widths, batch 2 and 64x64 crops: three frozen-BN steps with the fold on and
off, each of the loss's three terms left out, the batches of the dataset's
host route; the dataset's routing by the trainer's device; the
``train-text-b8`` cell's checks, sound and with each planted fault; its
scenes; and the readers of the step's spans. The reference imports nothing
of the port; this test imports both."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.drivers.train_text import start_state
from benchmark.harness import HERE, execute, load_module
from benchmark.reference import text_data, text_train, train
from benchmark.traffic import pngio, scenes
from lecturemath_tpu_torch import native
from lecturemath_tpu_torch.core.config import Config
from lecturemath_tpu_torch.core.timing import SpanRecord
from lecturemath_tpu_torch.models.fcn_lecturenet import (FCNConfig,
                                                         FCNLectureNet)
from lecturemath_tpu_torch.train import dataset as dataset_module
from lecturemath_tpu_torch.train import trainer as trainer_module
from lecturemath_tpu_torch.train.dataset import LectureNetDataset
from lecturemath_tpu_torch.train.trainer import Trainer, run_phase

torch.set_num_threads(1)

TINY = {"in_channels": 3, "down_filters": [8, 16, 16, 32, 32],
        "mid_filters": 32, "upsample_filters": [8, 8, 16, 16, 32],
        "up_filters": [8, 8, 16, 16, 32], "pixel_features": [8, 8],
        "kernel_size": 3, "pixel_kernel_size": 7}
# scenes a little larger than the crop, as COCO-Text's are than 256x256
TRAFFIC = {"sizes_hw": [[96, 128], [128, 96], [85, 128]], "shapes": [1, 4],
           "words_mean": 3.8, "words_max": 8, "glyph_height": [8, 30]}
# the cell's recipe at batch 2 and 64x64 crops; the hue and noise coins
# raised so that each lands within a few samples
RECIPE = {"batch_size": 2, "crop_size": [64, 64], "crop_min_foreground": 0.1,
          "flip_chance": 0.5, "color_invert_chance": 0.5,
          "color_change_chance": 0.5, "gaussian_noise_chance": 0.5,
          "gaussian_noise_level": 5.0, "text_mask_expansion": 15,
          "weight_expansion": 1, "median_k": 35, "learning_rate": 0.01}
SEED = 2 ** 33 + 31
STEPS = 3


STEP_GAPS = ("loss_gap", "grad_gap", "change_gap")
RESET_GAPS = ("reset_kept_gap", "reset_fresh_gap")


def limits(names=STEP_GAPS):
    with open(os.path.join(HERE, "workloads", "train-text-b8.json")) as f:
        found = json.load(f)["limits"]
    return {name: found[name] for name in names}


def net_config():
    return FCNConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in TINY.items()})


def warm_state(seed=SEED):
    """The cell's start: a seeded state with the heads drawn afresh."""
    return start_state(TINY, seed, "cpu")[0]


def scene_pairs(count=12):
    pairs = [scenes.scene(SEED, k, TRAFFIC) for k in range(count)]
    return [img for img, _ in pairs], [mask for _, mask in pairs]


def reference_batches():
    images, masks = scene_pairs()
    return text_data.first_batches(images, masks, RECIPE, SEED, STEPS)


def port_steps(state, batches, fold=True):
    """The port's frozen-BN steps on ``batches``: (losses, the parameters
    after each step)."""
    model = FCNLectureNet(net_config(), compute_dtype=torch.float32,
                          bn_dtype=torch.float32)
    model.load_state_dict(state)
    trainer = Trainer(model, RECIPE["learning_rate"], phase="text_detector",
                      freeze_bn=True, fold_frozen_bn=fold, prefetch_depth=0,
                      device="cpu")
    losses, after = [], []
    for batch in batches:
        losses.append(float(trainer.step(batch)["total"]))
        after.append({k: v.detach().clone()
                      for k, v in trainer.model.named_parameters()})
    return losses, after


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "bn"])
def test_three_frozen_steps_match_the_reference(fold):
    batches = reference_batches()
    state = warm_state()
    losses, after = port_steps(state, batches, fold)
    ref_losses, ref_after = text_train.steps(state, TINY, batches,
                                             RECIPE["learning_rate"])
    # float32 on both sides, the same convs in the same order on the CPU;
    # the fold only rounds the folded weights, so the losses agree to
    # within a few float32 steps
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    for ours, theirs in zip(after, ref_after):
        assert sorted(ours) == sorted(theirs)
        for key, value in theirs.items():
            # w - lr * g rounds to a float32 of w: a gradient a few float32
            # steps apart moves it by at most one step of a weight near 1
            np.testing.assert_allclose(ours[key].numpy(), value.numpy(),
                                       rtol=1e-6, atol=1.2e-7, err_msg=key)
    found = train.gaps(state, RECIPE["learning_rate"], losses, after[0],
                       after[-1], ref_losses, ref_after)
    for name, limit in limits().items():
        assert found[name] <= limit, (name, found[name])


@pytest.mark.parametrize("term", text_train.TERMS)
def test_a_term_left_out_fails_the_comparison(term, monkeypatch):
    """The port's loss without one of its three terms fails at least one of
    the cell's limits against the whole reference."""
    real = trainer_module.phase_losses

    def without(*args, **kwargs):
        terms = real(*args, **kwargs)
        assert term in terms
        return {k: v for k, v in terms.items() if k != term}

    monkeypatch.setattr(trainer_module, "phase_losses", without)
    batches = reference_batches()
    state = warm_state()
    losses, after = port_steps(state, batches)
    ref_losses, ref_after = text_train.steps(state, TINY, batches,
                                             RECIPE["learning_rate"])
    found = train.gaps(state, RECIPE["learning_rate"], losses, after[0],
                       after[-1], ref_losses, ref_after)
    assert any(found[name] > limit for name, limit in limits().items()), found


def text_dataset(directory, count):
    """The dataset of ``cli/train_text_detector.py`` over the first
    ``count`` scenes, written as the cell writes them."""
    return LectureNetDataset(
        *scenes.write(SEED, count, TRAFFIC, str(directory)),
        reconstruction_mode=False, crop_size=tuple(RECIPE["crop_size"]),
        crop_min_fg_prc=RECIPE["crop_min_foreground"],
        flip_chance=RECIPE["flip_chance"],
        color_invert_chance=RECIPE["color_invert_chance"],
        color_change_chance=RECIPE["color_change_chance"],
        gaussian_noise_chance=RECIPE["gaussian_noise_chance"],
        gaussian_noise_level=RECIPE["gaussian_noise_level"],
        text_mask_expansion=RECIPE["text_mask_expansion"],
        weight_expansion=RECIPE["weight_expansion"],
        reconstruct_median=True, reconstruct_median_k=RECIPE["median_k"],
        seed=SEED)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_host_route_batches_equal_the_references(tmp_path, monkeypatch,
                                                 route):
    """A TD-PT batch of the dataset routed to the CPU (K5's and K4's plain
    versions) equals the reference's: the image, the raw mask over 255,
    the eroded text mask and the exact k = 35 median of the crop."""
    if route == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    images, masks = scene_pairs()
    dataset = text_dataset(tmp_path, len(images))
    dataset.preload()
    dataset.route("cpu")
    ours = dataset.batches(RECIPE["batch_size"])
    for batch in text_data.first_batches(images, masks, RECIPE, SEED, STEPS):
        got = next(ours)
        for key in ("image", "target", "text_mask", "median"):
            assert isinstance(got[key], np.ndarray)
            np.testing.assert_array_equal(got[key], batch[key], err_msg=key)
    made = STEPS * RECIPE["batch_size"]
    stats = dataset.data_stats
    assert (stats["pixels_host"], stats["median_host"]) == (made, made)
    assert stats["pixels_card"] == stats["median_card"] == 0


def test_a_cpu_run_makes_its_batches_on_the_host_where_a_card_is_seen(
        tmp_path, monkeypatch):
    """With a card in view (``median_route`` stubbed to ``"cuda"``),
    ``run_phase`` on the CPU routes the dataset to the trainer's device:
    every sample's pixels and median target are made on the host."""
    monkeypatch.setattr(dataset_module, "median_route", lambda: "cuda")
    dataset = text_dataset(tmp_path, 8)
    dataset.preload()
    config = Config({
        **{f"FCN_BINARIZER_NET_{key}_{i}": v
           for key in ("DOWN_CONV_FILTERS", "UPSAMPLE_FILTERS",
                       "UP_CONV_FILTERS")
           for i, v in enumerate((2, 3, 4, 5, 6), 1)},
        "FCN_BINARIZER_NET_MIDDLE_CONV_FILTERS_MIDDLE": 6,
        "FCN_BINARIZER_NET_PIXEL_FEATURES_1": 4,
        "FCN_BINARIZER_NET_PIXEL_FEATURES_2": 3,
        "FCN_BINARIZER_NET_PIXEL_KERNEL_SIZE": 3,
        "FCN_BINARIZER_PRETRAIN_TEXT_OUTPUT": str(tmp_path / "text.msgpack")})
    run_phase(config, "text_detector", dataset, epochs_override=1,
              batch_size_override=2, verbose=False, device="cpu")
    assert dataset.device == torch.device("cpu")
    stats = dataset.data_stats
    assert stats["pixels_host"] == stats["median_host"] == 8
    assert stats["pixels_card"] == stats["median_card"] == 0


def test_route_names_the_card_and_an_unrouted_dataset_asks_the_process(
        tmp_path, monkeypatch):
    dataset = text_dataset(tmp_path, 2)
    seen = torch.device("cuda", 3)
    monkeypatch.setattr(dataset_module, "pixel_device", lambda: seen)
    assert dataset.device is None and dataset._pixel_device() == seen
    dataset.route("cuda:1")
    assert dataset._pixel_device() == torch.device("cuda", 1)
    dataset.route(torch.device("cpu"))
    assert dataset._pixel_device() is None


# the cell on the CPU at tiny sizes (the harness's look for a card skipped)
SIZES = {"config": dict(TINY, images=24, crop_size=[64, 64]),
         "traffic": {"sizes_hw": TRAFFIC["sizes_hw"],
                     "glyph_height": TRAFFIC["glyph_height"]}}


def _bf16(trainer):
    """The steps under bf16 autocast, the precision below the convs' (the
    card's TF32 has no CPU form)."""
    step = trainer.step

    def low(batch):
        with torch.autocast(trainer.device.type, dtype=torch.bfloat16):
            return step(batch)

    trainer.step = low


def _batch_fault(change):
    def plant(trainer):
        upload = trainer.to_device
        trainer.to_device = lambda batch: upload(change(dict(batch)))
    return plant


# the reconstruction's MSE term left out (no median target reaches the loss)
_no_mse = _batch_fault(lambda b: {k: v for k, v in b.items()
                                  if k != "median"})
# each median target replaced by its crop
_crop_median = _batch_fault(lambda b: dict(b, median=b["image"]))
# half of the batch left out, the mean taken over the rest
_half_rows = _batch_fault(lambda b: {k: v[:len(v) // 2]
                                     for k, v in b.items()})


def _heads_left(monkeypatch):
    """The program's head reset leaving the heads as they were."""
    monkeypatch.setattr(trainer_module, "reset_main_branches",
                        lambda state, *_: dict(state))


@pytest.mark.parametrize("fault", [None, _bf16, _no_mse, _crop_median,
                                   _half_rows, _heads_left],
                         ids=["sound", "bf16", "no_mse", "crop_median",
                              "half_rows", "heads_left"])
def test_cell_checks_pass_sound_and_fail_each_fault(fault, monkeypatch):
    if fault is _heads_left:
        fault(monkeypatch)
    result = execute("train-text-b8", 2 ** 33 + 17, 0.1, False, device="cpu",
                     overrides=dict(SIZES, driver={
                         "fault": None if fault is _heads_left else fault}))
    assert set(result["checks"]) == set(STEP_GAPS + RESET_GAPS)
    assert result["attempted"] >= 3 and result["failed"] == 0
    assert result["correct"] == (fault is None), result["checks"]


def test_control_readings_part_the_sound_steps_from_the_faults():
    """``control_text.py``'s readings at tiny sizes: the port's own steps
    pass every limit; the bf16 control and each planted fault fail one."""
    from benchmark import control_text
    from benchmark.harness import make_context

    ctx = make_context("train-text-b8", 2 ** 33 + 23, 0.0, False, "cpu",
                       {"config": SIZES["config"],
                        "traffic": SIZES["traffic"]})
    found = control_text.readings(ctx)
    assert set(found) == {"port", "bf16", "no_mse", "crop_median",
                          "half_batch"}
    for side, gaps in found.items():
        failed = [name for name, limit in limits().items()
                  if gaps[name] > limit]
        assert bool(failed) == (side != "port"), (side, gaps)


def test_reset_readings_part_the_programs_reset_from_the_faults():
    """``control_text.py``'s readings of the head reset at tiny widths: the
    program's ``reset_main_branches`` keeps the trunk and draws each head
    afresh; leaving the heads, PyTorch's own init, redrawing
    ``conv_reconstruct`` too and keeping one head each fail a limit."""
    from benchmark import control_text
    from benchmark.harness import make_context

    ctx = make_context("train-text-b8", 2 ** 33 + 29, 0.0, False, "cpu",
                       {"config": SIZES["config"]})
    found = control_text.reset_readings(ctx)
    assert set(found) == {"port", "left", "torch_init", "reconstruct_too",
                          "head_kept"}
    for side, gaps in found.items():
        failed = [name for name, limit in limits(RESET_GAPS).items()
                  if gaps[name] > limit]
        assert bool(failed) == (side != "port"), (side, gaps)
    assert found["port"]["reset_kept_gap"] == 0.0


def test_the_cells_start_is_the_checkpoint_with_fresh_heads():
    """``start_state``: the checkpoint's trunk and ``conv_reconstruct``
    as they are, each head drawn afresh from a seed of its own, which the
    reset's own check reads as sound."""
    from benchmark.drivers.train_text import head_part, redraw_gaps

    start, checkpoint = start_state(TINY, SEED, "cpu")
    assert set(start) == set(checkpoint)
    for key, value in checkpoint.items():
        if head_part(key) is None:
            assert start[key] is value, key
        elif head_part(key) == "0.weight":
            assert not torch.equal(start[key], value), key
    gaps = redraw_gaps(checkpoint, start)
    assert all(gaps[name] <= limit
               for name, limit in limits(RESET_GAPS).items()), gaps
    other = start_state(TINY, SEED + 1, "cpu")[0]
    assert not torch.equal(other["conv_out.0.weight"],
                           start["conv_out.0.weight"])


def test_scenes_are_seeded_by_index_in_coco_texts_shape(tmp_path):
    """A scene is the same written to its files, rendered alone
    or read through ``Scenes``; its size is one of the traffic's, its mask
    255 on rows of word boxes at least ``glyph_height``'s least high, and
    0 elsewhere."""
    count = 16
    paths = scenes.write(SEED, count, TRAFFIC, str(tmp_path))
    made = scenes.Scenes(SEED, count, TRAFFIC)
    assert len(made.images) == len(made.masks) == count
    words = 0
    for k in range(count):
        img, mask = (pngio.decode(open(path, "rb").read())
                     for path in (paths[0][k], paths[1][k]))
        np.testing.assert_array_equal(img, made.images[k])
        np.testing.assert_array_equal(mask, made.masks[k])
        np.testing.assert_array_equal(img, scenes.scene(SEED, k, TRAFFIC)[0])
        assert img.dtype == mask.dtype == np.uint8 and img.ndim == 3
        assert list(img.shape[:2]) in TRAFFIC["sizes_hw"]
        assert mask.shape == img.shape[:2]
        assert set(np.unique(mask)) <= {0, 255}
        rows = np.flatnonzero((mask == 255).any(axis=1))
        if len(rows):
            words += 1
            runs = np.split(rows, np.flatnonzero(np.diff(rows) > 1) + 1)
            assert all(len(run) >= TRAFFIC["glyph_height"][0]
                       for run in runs)
    assert words >= 8
    assert not np.array_equal(made.images[0],
                              scenes.scene(SEED + 1, 0, TRAFFIC)[0])


def reader(name):
    return load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                       f"reader_{name.replace('.', '_')}")


@pytest.mark.parametrize("part", ["forward", "backward", "update"])
def test_step_readers_read_their_spans_a_step(part):
    """``train.<part>_ms``: the spans ``train.<part>`` summed over the
    steps' ``train.step`` spans, in ms; None without the spans (an
    untraced run, or a program that records none)."""
    def record(seq, name, start_ms, end_ms):
        return SpanRecord(seq, name, 1, int(start_ms * 1e6),
                          int(end_ms * 1e6), None, None, None)

    spans = [record(0, "train.step", 0, 10), record(1, f"train.{part}", 1, 4),
             record(2, "train.step", 10, 20),
             record(3, f"train.{part}", 11, 12)]
    read = reader(f"train.{part}_ms").read
    assert read(SimpleNamespace(program_spans=spans)) == pytest.approx(2.0)
    assert read(SimpleNamespace(program_spans=spans[::2])) is None
    assert read(SimpleNamespace(trace=None)) is None
