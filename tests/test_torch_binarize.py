"""Stage 01 of the port (lecturemath_tpu_torch.pipeline.binarize.Binarizer)
against the JAX package's Binarizer: the same synthetic RGB lecture and the
same threshold weights give identical frames, times and indices, fp32 on the
CPU at TINY widths, with an odd batch tail."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lecturemath_tpu.models import fcn_lecturenet as jfcn
from lecturemath_tpu.pipeline.binarize import Binarizer as JaxBinarizer
from lecturemath_tpu.pipeline.video import ArraySource as JaxArraySource
from lecturemath_tpu.utils.synthetic import (synthetic_rgb_lecture,
                                             threshold_binarizer_variables)
from lecturemath_tpu_torch.models import fcn_lecturenet as tfcn
from lecturemath_tpu_torch.models.convert import state_dict_from_flax
from lecturemath_tpu_torch.pipeline import binarize as port_binarize
from lecturemath_tpu_torch.pipeline.binarize import Binarizer, default_batch_size
from lecturemath_tpu_torch.pipeline.video import ArraySource

torch.set_num_threads(1)

TINY = dict(down_filters=(2, 3, 4, 5, 6), mid_filters=6,
            upsample_filters=(2, 3, 4, 5, 6), up_filters=(2, 3, 4, 5, 6),
            pixel_features=(4, 3), kernel_size=3, pixel_kernel_size=3)
N_FRAMES = 7     # batches of 3: the last one holds 1 valid frame
BATCH = 3


@pytest.fixture(scope="module")
def lecture():
    rgb, _, _, _ = synthetic_rgb_lecture(seed=4, n_frames=N_FRAMES,
                                         height=96, width=128)
    return rgb


@pytest.fixture(scope="module")
def weights():
    cfg = jfcn.FCNConfig(**TINY)
    variables = threshold_binarizer_variables(cfg)
    return cfg, variables, state_dict_from_flax(variables)


def _port_model(state_dict):
    model = tfcn.FCNLectureNet(tfcn.FCNConfig(**TINY))
    model.load_state_dict(state_dict, strict=True)
    return model


@pytest.mark.parametrize("upload_format,downscale,max_pixels,async_drain", [
    ("rgb", "host", 2_500_000, True),
    ("rgb", "host", 5_000, False),       # host LANCZOS halving 128x96 -> 64x48
    ("yuv420", "host", 2_500_000, True),
    ("rgb", "device", 5_000, True),      # box halving on the device
])
def test_process_source_matches_jax(lecture, weights, upload_format,
                                    downscale, max_pixels, async_drain,
                                    monkeypatch):
    cfg, variables, state_dict = weights
    kwargs = dict(batch_size=BATCH, upload_format=upload_format,
                  downscale=downscale, max_model_pixels=max_pixels)
    jax_bin = JaxBinarizer(jfcn.FCNLectureNet(cfg, dtype=jnp.float32),
                           variables, async_drain=async_drain, **kwargs)
    if not async_drain:
        # the port drains inline in a world of more than one process
        monkeypatch.setattr(port_binarize, "process_count", lambda: 2)
    port_bin = Binarizer(_port_model(state_dict), device="cpu", **kwargs)
    assert port_bin.upload_format == jax_bin.upload_format == upload_format

    j_times, j_indices, j_frames = jax_bin.process_source(
        JaxArraySource(lecture, fps=1.0))
    t_times, t_indices, t_frames = port_bin.process_source(
        ArraySource(lecture, fps=1.0))
    assert t_times == j_times
    assert t_indices == j_indices == list(range(N_FRAMES))
    assert len(t_frames) == len(j_frames) == N_FRAMES
    for ours, theirs in zip(t_frames, j_frames):
        assert ours.shape == (96, 128)
        np.testing.assert_array_equal(ours, theirs)
    # the frames carry ink (threshold weights binarize the glyphs)
    assert any((frame == 255).any() for frame in t_frames)
    assert set(port_bin.stream_stats) >= {"source_s", "dispatch_s",
                                          "drain_s", "downscale_s"}


def test_auto_batch_size_and_device(lecture, weights):
    _, _, state_dict = weights
    binarizer = Binarizer(_port_model(state_dict), device="cpu")
    _, _, frames = binarizer.process_source(ArraySource(lecture, fps=1.0))
    assert len(frames) == N_FRAMES
    assert binarizer.batch_size == default_batch_size(128, 96,
                                                      torch.device("cpu"))
    assert binarizer.model.dtype == torch.float32
    assert binarizer.model.fold_bn


def test_binarize_frames_matches_jax(lecture, weights):
    cfg, variables, state_dict = weights
    jax_bin = JaxBinarizer(jfcn.FCNLectureNet(cfg, dtype=jnp.float32),
                           variables, batch_size=BATCH)
    port_bin = Binarizer(_port_model(state_dict), batch_size=BATCH,
                         device="cpu")
    np.testing.assert_array_equal(port_bin.binarize_frames(lecture[:2]),
                                  jax_bin.binarize_frames(lecture[:2]))


def test_cuda_without_a_card_raises(weights):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, _, state_dict = weights
    with pytest.raises(RuntimeError, match="CUDA"):
        Binarizer(_port_model(state_dict))
    # a model-axis mesh over the cards this process sees: there are none
    from lecturemath_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    with pytest.raises(ValueError, match="no devices"):
        make_mesh(MeshSpec(1, 2))


def test_binarizer_model_axis_on_cpu_shards(weights):
    """A 1x2 mesh of CPU devices channel-shards the Binarizer, and its
    threshold heads give the meshless frames."""
    from lecturemath_tpu_torch.parallel.mesh import Mesh

    _, _, state_dict = weights
    cpu = torch.device("cpu")
    model_axis = Mesh(shape={"data": 1, "model": 2},
                      devices=((0, cpu), (0, cpu)), local_devices=(cpu, cpu),
                      rank=0, world_size=1, device_count=2)
    meshed = Binarizer(_port_model(state_dict), device="cpu",
                       mesh=model_axis, batch_size=BATCH)
    assert [r.model_index for r in meshed._replicas] == [0, 1]
    rgb, _, _, _ = synthetic_rgb_lecture(seed=4, n_frames=2, height=96,
                                         width=128)
    np.testing.assert_array_equal(
        meshed.binarize_frames(rgb),
        Binarizer(_port_model(state_dict), device="cpu",
                  batch_size=BATCH).binarize_frames(rgb))


class _FramesOnly:
    """A frame source that defines ``frames`` and nothing else."""

    def __init__(self, array):
        self.array = array

    def frames(self, frames_limit: int = 0):
        n = min(len(self.array), frames_limit or len(self.array))
        for t in range(n):
            yield t * 1000.0, t, self.array[t]


@pytest.mark.parametrize("batch_size", [None, BATCH])
def test_a_source_with_only_frames_streams(lecture, weights, batch_size):
    """Stage 01 reads nothing of a source but ``frames``: with the batch
    sized from the first frame and with a fixed one, the stream equals
    ArraySource's, limit and padded last batch included."""
    _, _, state_dict = weights
    ours = Binarizer(_port_model(state_dict), device="cpu",
                     batch_size=batch_size)
    theirs = Binarizer(_port_model(state_dict), device="cpu",
                       batch_size=BATCH)
    for limit in (0, 5):
        got = ours.process_source(_FramesOnly(lecture), limit)
        want = theirs.process_source(ArraySource(lecture, fps=1.0), limit)
        assert got[0] == want[0] and got[1] == want[1]
        assert len(got[2]) == (limit or N_FRAMES)
        for a, b in zip(got[2], want[2]):
            np.testing.assert_array_equal(a, b)
