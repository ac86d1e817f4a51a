"""The reconstruction phase's plain reference (``benchmark/reference/rec_data.py``,
``rec_train.py``) against the port on the CPU at tiny widths: three steps
with live BatchNorm (losses, parameters, running buffers), the median
target on both of the port's routes, the samples of the dataset; and the
``train-rec-b8`` cell's checks, sound and with each planted fault. The
reference imports nothing of the port; this test imports both."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import count, live_bn
from benchmark.harness import HERE, execute, load_module
from benchmark.reference import rec_data, rec_train
from benchmark.traffic import pngio
from benchmark.traffic.lecture import Lecture
from benchmark.traffic.weights import net_widths
from lecturemath_tpu_torch import native
from lecturemath_tpu_torch.models.fcn_lecturenet import (FCNConfig,
                                                         FCNLectureNet,
                                                         init_weights)
from lecturemath_tpu_torch.train import augment
from lecturemath_tpu_torch.train.dataset import LectureNetDataset
from lecturemath_tpu_torch.train.trainer import Trainer
from lecturemath_tpu_torch.utils import image as image_module

torch.set_num_threads(1)

TINY = {"in_channels": 3, "down_filters": [8, 16, 16, 32, 32],
        "mid_filters": 32, "upsample_filters": [8, 8, 16, 16, 32],
        "up_filters": [8, 8, 16, 16, 32], "pixel_features": [8, 8],
        "kernel_size": 3, "pixel_kernel_size": 7}
# the cell's recipe at a crop the CPU turns round quickly; every coin of
# the augmentation lands on both sides within a few samples
RECIPE = {"batch_size": 4, "crop_size": [64, 64], "flip_chance": 0.5,
          "color_invert_chance": 0.5, "color_change_chance": 0.5,
          "gaussian_noise_chance": 0.5, "gaussian_noise_level": 5.0,
          "median_k": 35, "learning_rate": 0.01}
SEED = 2 ** 33 + 29


def frames():
    lecture = Lecture(11, n_frames=16, height=120, width=160, n_boards=2,
                      glyphs_per_board=12, glyph_size=(20, 30))
    return lecture.frames


def port_model():
    model = FCNLectureNet(FCNConfig(**{k: tuple(v) if isinstance(v, list)
                                       else v for k, v in TINY.items()}),
                          reconstruction_mode=True,
                          compute_dtype=torch.float32,
                          bn_dtype=torch.float32)
    return init_weights(model, torch.Generator().manual_seed(SEED))


def test_three_live_bn_steps_match_the_reference():
    batches = rec_data.first_batches(frames(), RECIPE, SEED, 3)
    model = port_model()
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, RECIPE["learning_rate"], phase="reconstruction",
                      prefetch_depth=0, device="cpu")
    losses, after = [], []
    for batch in batches:
        losses.append(float(trainer.step(dict(batch,
                                               target=batch["image"]))["mse"]))
        after.append({k: v.detach().clone()
                      for k, v in trainer.model.named_parameters()})
    ref_losses, ref_after, ref_buffers = rec_train.steps(
        state, TINY, batches, RECIPE["learning_rate"])
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-6)
    for ours, theirs in zip(after, ref_after):
        assert sorted(ours) == sorted(theirs)
        for key, value in theirs.items():
            np.testing.assert_allclose(ours[key].numpy(), value.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
    buffers = {k: v for k, v in trainer.model.named_buffers()
               if k.endswith(rec_train.BUFFERS)}
    assert sorted(buffers) == sorted(ref_buffers) and len(buffers) == 34
    for key, value in ref_buffers.items():
        np.testing.assert_allclose(buffers[key].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert rec_train.stat_gap(buffers, ref_buffers) < 1e-5


def board(shape, seed):
    """A uint8 image with flat runs (ties in every window) beside noise."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[: shape[0] // 3] = 200
    img[:, : shape[1] // 4] //= 16
    return img


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("k", [3, 35])
@pytest.mark.parametrize("shape", [(64, 64, 3), (37, 53, 3)],
                         ids=["square", "odd"])
def test_reference_median_equals_the_ports(route, k, shape, monkeypatch):
    if route == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    assert image_module.median_route() == route
    img = board(shape, k)
    ours = augment.median_target(img, k)
    theirs = rec_data.median(img, k)
    assert ours.dtype == theirs.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)
    # a corner's window by hand: the border replicated, the middle value
    r = k // 2
    window = np.pad(img, ((r, r), (r, r), (0, 0)), mode="edge")[:k, :k]
    for c in range(3):
        assert theirs[0, 0, c] == np.sort(window[..., c].ravel())[k * k // 2]


def test_reference_samples_equal_the_datasets(tmp_path):
    lecture = frames()
    paths = []
    for k, frame in enumerate(lecture):
        paths.append(os.path.join(tmp_path, f"{k:02d}.png"))
        with open(paths[-1], "wb") as f:
            f.write(pngio.encode(frame))
    dataset = LectureNetDataset(
        paths, None, reconstruction_mode=True,
        crop_size=tuple(RECIPE["crop_size"]),
        flip_chance=RECIPE["flip_chance"],
        color_invert_chance=RECIPE["color_invert_chance"],
        color_change_chance=RECIPE["color_change_chance"],
        gaussian_noise_chance=RECIPE["gaussian_noise_chance"],
        gaussian_noise_level=RECIPE["gaussian_noise_level"],
        reconstruct_median=True, reconstruct_median_k=RECIPE["median_k"],
        seed=SEED)
    dataset.preload()
    ours = dataset.batches(RECIPE["batch_size"])
    theirs = rec_data.first_batches(lecture, RECIPE, SEED, 3)
    for batch in theirs:
        got = next(ours)
        for key in ("image", "median"):
            np.testing.assert_array_equal(got[key], batch[key], err_msg=key)
        np.testing.assert_array_equal(got["target"], batch["image"])


# the cell on the CPU at tiny sizes (the harness's look for a card skipped)
SIZES = {"config": dict(TINY, frame_height=300, frame_width=400, frames=24,
                        crop_size=[64, 64]),
         "traffic": {"glyphs_per_board": 30, "glyph_size": [20, 30]}}


def _eval_bn(trainer):
    """BatchNorm run from its running statistics."""
    trainer.freeze_bn = True


def _half_rows(trainer):
    """Half of the batch left out, the mean taken over the rest."""
    upload = trainer.to_device
    trainer.to_device = lambda batch: upload(
        {k: v[:len(v) // 2] for k, v in batch.items()})


def _unchanged(trainer):
    """A step that leaves the parameters as they were."""
    trainer.optimizer.step = lambda *args, **kwargs: None


def _bf16(trainer):
    """The steps under bf16 autocast, a precision below the configuration's
    float32 (the card's TF32 has no CPU form)."""
    step = trainer.step

    def low(batch):
        with torch.autocast(trainer.device.type, dtype=torch.bfloat16):
            return step(batch)

    trainer.step = low


@pytest.mark.parametrize("fault", [None, _bf16, _eval_bn, _half_rows,
                                   _unchanged],
                         ids=["sound", "bf16", "eval_bn", "half_rows",
                              "unchanged"])
def test_cell_checks_pass_sound_and_fail_each_fault(fault):
    result = execute("train-rec-b8", 2 ** 33 + 17, 0.1, False, device="cpu",
                     overrides=dict(SIZES, driver={"fault": fault}))
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                     "stat_gap"}
    assert result["attempted"] >= 3 and result["failed"] == 0
    assert result["correct"] == (fault is None), result["checks"]


def test_the_cell_steps_with_tf32_off(monkeypatch):
    """The configuration's float32 is what the steps run in: the driver
    turns cuDNN's and cuBLAS's TF32 off before it builds the trainer."""
    seen = []
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    result = execute("train-rec-b8", 2 ** 33 + 19, 0.1, False, device="cpu",
                     overrides=dict(SIZES, driver={"fault": lambda trainer:
                                                   seen.append((
                                                       torch.backends.cudnn
                                                       .allow_tf32,
                                                       torch.backends.cuda
                                                       .matmul.allow_tf32))}))
    assert seen == [(False, False)] and result["correct"]


def test_live_bn_count_is_the_networks():
    """``live_bn``'s elements a pixel are the 17 BatchNorms' inputs in the
    port's reconstruction-mode forward; the least bytes read or write each
    once, 2 passes forward and 3 backward, in float32."""
    model = port_model().train()
    seen = []
    for module in model.modules():
        if isinstance(module, torch.nn.BatchNorm2d):
            module.register_forward_hook(
                lambda m, inputs, out: seen.append(inputs[0].numel()))
    model(torch.zeros(2, 3, 64, 96))
    assert len(seen) == 17
    assert sum(seen) == 2 * 64 * 96 * live_bn.bn_elements_per_pixel(TINY)
    assert live_bn.live_bn_bytes(TINY, 2, 64, 96) == 5 * 4 * sum(seen)


def reader(name):
    return load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                       f"reader_{name.replace('.', '_')}")


def test_bn_readers_read_the_batchnorm_kernels():
    """``train_rec.bn_ms`` and ``bn_roofline`` sum the cuDNN BatchNorm
    kernels of a trace and nothing else, and read None without a trace or
    without such a kernel (a program whose BatchNorms run elsewhere)."""
    with open(os.path.join(HERE, "configs",
                           "lecturenet-train-rec.json")) as f:
        cfg = json.load(f)
    device = [(0.0, 1000.0, "kernel",
               "void cudnn::batchnorm_fwtr_nhwc_semiPersist<float>", {}),
              (1000.0, 3000.0, "kernel",
               "void cudnn::batchnorm_bwtr_nhwc_semiPersist<float>", {}),
              (3000.0, 9000.0, "kernel", "sm90_xmma_fprop_implicit_gemm", {}),
              (9000.0, 9500.0, "gpu_memcpy", "Memcpy HtoD", {})]
    run = SimpleNamespace(trace=SimpleNamespace(device=device),
                          counters={"steps": 2}, config=cfg)
    assert reader("train_rec.bn_ms").read(run) == pytest.approx(1.5)
    least = 2 * live_bn.live_bn_bytes(net_widths(cfg), 8, 256,
                                      256) / count.PEAK_BYTES
    assert reader("train_rec.bn_roofline").read(run) == pytest.approx(
        100 * least / 0.003)
    for empty in (SimpleNamespace(trace=None, counters={"steps": 2},
                                  config=cfg),
                  SimpleNamespace(trace=SimpleNamespace(device=device[2:]),
                                  counters={"steps": 2}, config=cfg)):
        assert reader("train_rec.bn_ms").read(empty) is None
        assert reader("train_rec.bn_roofline").read(empty) is None
