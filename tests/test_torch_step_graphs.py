"""When the Trainer's step runs as CUDA graphs, on the CPU: which steps may
(``Trainer._graphable``), which batches and rates a captured step fits
(``_StepGraphs.fits``), and that a CPU trainer steps eagerly. The graphs
themselves are held against the eager steps on the card
(tests/test_torch_cuda.py ``test_step_graphs_equal_the_eager_steps``)."""

from types import SimpleNamespace

import pytest
import torch

from lecturemath_tpu_torch.models.fcn_lecturenet import (FCNConfig,
                                                         FCNLectureNet,
                                                         init_weights)
from lecturemath_tpu_torch.train.trainer import (DeviceBatch, Trainer,
                                                 _StepGraphs)

torch.set_num_threads(1)

TINY = FCNConfig(down_filters=(8, 8, 16, 16, 32), mid_filters=32,
                 upsample_filters=(8, 8, 16, 16, 32),
                 up_filters=(8, 8, 16, 16, 32), pixel_features=(8, 8),
                 kernel_size=3, pixel_kernel_size=7)

# a step that may run as graphs, and each way one may not
GRAPHABLE = {"device": torch.device("cuda", 0), "_fold_model": object(),
             "mesh": None, "clip_norm": None, "phase": "text_detector"}
NOT_GRAPHABLE = {"cpu": {"device": torch.device("cpu")},
                 "live_bn": {"_fold_model": None},
                 "mesh": {"mesh": object()},
                 "clip": {"clip_norm": 1.0},
                 "reconstruction": {"phase": "reconstruction"}}


def _model(compute_dtype=torch.float32):
    with torch.device("meta"):
        return FCNLectureNet(TINY, compute_dtype=compute_dtype)


def test_a_folded_float32_step_on_a_card_may_run_as_graphs():
    assert Trainer._graphable(SimpleNamespace(**GRAPHABLE), _model())
    assert Trainer._graphable(SimpleNamespace(**dict(
        GRAPHABLE, phase="binarizer")), _model())


@pytest.mark.parametrize("case", sorted(NOT_GRAPHABLE))
def test_other_steps_run_eagerly(case):
    fake = SimpleNamespace(**dict(GRAPHABLE, **NOT_GRAPHABLE[case]))
    assert not Trainer._graphable(fake, _model())


def test_a_bfloat16_step_runs_eagerly():
    assert not Trainer._graphable(SimpleNamespace(**GRAPHABLE),
                                  _model(torch.bfloat16))


def _batch(size=16, dtype=torch.float32, channels_last=True):
    image = torch.zeros(2, 3, size, size, dtype=dtype)
    if channels_last:
        image = image.contiguous(memory_format=torch.channels_last)
    return DeviceBatch(image=image, target=torch.zeros(2, 1, size, size))


def _optimizer(lr=0.01, momentum=0.0):
    return torch.optim.SGD([torch.nn.Parameter(torch.zeros(3))], lr=lr,
                           momentum=momentum)


def _captured():
    return _StepGraphs(_batch(), {}, (None, None, None), "text_detector",
                       _StepGraphs._rates(_optimizer()))


def test_a_captured_step_fits_a_batch_like_its_own():
    assert _captured().fits(_batch(), _optimizer())


@pytest.mark.parametrize("batch, optimizer", [
    (_batch(size=8), _optimizer()),
    (_batch(dtype=torch.float64), _optimizer()),
    (_batch(channels_last=False), _optimizer()),
    (DeviceBatch(_batch(), median=torch.zeros(2, 3, 16, 16)), _optimizer()),
    (_batch(), _optimizer(lr=0.001)),
    (_batch(), _optimizer(momentum=0.9)),
], ids=["size", "dtype", "layout", "keys", "lr", "momentum"])
def test_a_captured_step_fits_no_other_batch_or_rate(batch, optimizer):
    assert not _captured().fits(batch, optimizer)


def test_a_cpu_trainer_steps_eagerly():
    model = init_weights(FCNLectureNet(TINY),
                         torch.Generator().manual_seed(0))
    trainer = Trainer(model, 0.01, phase="text_detector", freeze_bn=True,
                      fold_frozen_bn=True, prefetch_depth=0, device="cpu")
    batch = {"image": torch.zeros(2, 64, 64, 3).numpy(),
             "target": torch.zeros(2, 64, 64, 1).numpy(),
             "text_mask": torch.zeros(2, 64, 64, 1).numpy()}
    for _ in range(3):
        trainer.step(batch)
    assert trainer._graphs is False
    assert trainer.step_count == 3
