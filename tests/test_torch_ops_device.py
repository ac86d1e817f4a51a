"""The port's device ops (ops/clahe.py, ops/frame_diff.py, ops/ckmeans.py)
against the JAX package's on the CPU, in f32, on the same seeded inputs.

CLAHE gray levels are compared modulo 256 (``min(|d|, 256 - |d|)``): the C
kernel's unsigned-char wrap turns one rounding step at 255.5 into 255
against 0. The port's f32 CLAHE follows the C recurrence of the contrast
limit, which the JAX ``clahe_host`` runs: it stays within one gray level of
it on at most 0.1% of the pixels, where the JAX device ``clahe`` (whose
recurrence clips against the unclipped CDF) does not."""

import numpy as np
import pytest
import torch

from lecturemath_tpu.ops.ckmeans import ConvolutionalKMeans as JaxKMeans
from lecturemath_tpu.ops.clahe import (clahe as jax_clahe,
                                       clahe_batch as jax_clahe_batch,
                                       clahe_host as jax_clahe_host,
                                       combine_board_content as jax_combine)
from lecturemath_tpu.ops.frame_diff import motion_stats as jax_motion_stats
from lecturemath_tpu_torch.ops import (MotionStats, clahe, clahe_batch,
                                       clahe_host, combine_board_content,
                                       motion_stats)
from lecturemath_tpu_torch.ops.ckmeans import ConvolutionalKMeans

torch.set_num_threads(1)

# share of pixels that may sit one gray level from clahe_host (f32 against
# f64 rounding at a .5 boundary); none may sit further
MAX_OFF_BY_ONE = 1e-3
STAT_RTOL = 1e-5


def board_frame(seed, height=540, width=960):
    """A board-like gray frame: mean 200, sigma 8, 5% dark ink at 40 — its
    histograms are narrow, so the contrast limit clips."""
    rng = np.random.default_rng(seed)
    gray = np.clip(rng.normal(200, 8, (height, width)), 0, 255)
    gray[rng.random((height, width)) < 0.05] = 40
    return gray.astype(np.uint8)


def noise_frame(seed, height=270, width=480):
    return np.random.default_rng(seed).integers(0, 256, (height, width),
                                                dtype=np.uint8)


def mod256(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return np.minimum(d, 256 - d)


def assert_near_host(ours, gray, slope, grid_x, grid_y):
    ref = jax_clahe_host(gray, slope, grid_x, grid_y)
    d = mod256(np.asarray(ours), ref)
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= MAX_OFF_BY_ONE, (d > 0).mean()


@pytest.mark.parametrize("grid", [(8, 8), (48, 27)])
@pytest.mark.parametrize("kind", ["board", "noise"])
def test_clahe_within_one_level_of_host(kind, grid):
    gray = board_frame(3) if kind == "board" else noise_frame(4)
    out = clahe(gray, 0.04, *grid, device="cpu")
    assert out.dtype == torch.uint8 and out.device.type == "cpu"
    assert_near_host(out.numpy(), gray, 0.04, *grid)


@pytest.mark.parametrize("grid", [(8, 8), (48, 27), (5, 3)])
def test_clahe_batch_within_one_level_of_host(grid):
    frames = np.stack([board_frame(s, 180, 320) for s in range(3)]
                      + [noise_frame(9, 180, 320)])
    out = clahe_batch(frames, 0.04, *grid, device="cpu").numpy()
    for k in range(len(frames)):
        assert_near_host(out[k], frames[k], 0.04, *grid)
    # one loop for the batch gives what each frame gives alone
    for k in range(len(frames)):
        np.testing.assert_array_equal(
            out[k], clahe(torch.from_numpy(frames[k]), 0.04, *grid).numpy())


def test_jax_device_clahe_diverges_on_board_frame():
    """The documented quirk of the reference: the JAX device ``clahe``
    clips each bin against the unclipped previous CDF value, so on a
    board-like frame it sits several gray levels from the C recurrence of
    ``clahe_host`` on most pixels; the port does not copy it."""
    gray = board_frame(0)
    ref = jax_clahe_host(gray, 0.04, 8, 8)
    theirs = mod256(np.asarray(jax_clahe(gray, 0.04, 8, 8)), ref)
    ours = mod256(clahe(gray, 0.04, 8, 8, device="cpu").numpy(), ref)
    assert theirs.max() >= 5 and (theirs > 0).mean() > 0.5
    assert ours.max() <= 1 and (ours > 0).mean() <= MAX_OFF_BY_ONE


@pytest.mark.parametrize("kind", ["board", "noise"])
def test_clahe_without_slope_matches_jax_device(kind):
    """With slope 0 nothing clips, so the two recurrences agree and the
    port equals the JAX device ``clahe`` within one level."""
    gray = board_frame(5, 180, 320) if kind == "board" else noise_frame(6)
    theirs = np.asarray(jax_clahe(gray, 0.0, 4, 4))
    ours = clahe(gray, 0.0, 4, 4, device="cpu").numpy()
    assert mod256(ours, theirs).max() <= 1
    batch = np.stack([gray, gray[::-1]])
    np.testing.assert_array_equal(
        clahe_batch(batch, 0.0, 4, 4, device="cpu").numpy(),
        np.stack([ours, clahe(gray[::-1].copy(), 0.0, 4, 4,
                              device="cpu").numpy()]))
    assert mod256(np.asarray(jax_clahe_batch(batch, 0.0, 4, 4)),
                  clahe_batch(batch, 0.0, 4, 4, device="cpu").numpy()
                  ).max() <= 1


@pytest.mark.parametrize("seed", range(6))
def test_clahe_host_equals_jax(seed):
    """Fuzzed as tests/test_classical_ops.py:203 fuzzes the JAX one against
    the C kernel: shapes, grids, slopes and three intensity flavours."""
    rng = np.random.default_rng(200 + seed)
    h, w = int(rng.integers(20, 150)), int(rng.integers(20, 150))
    grid_x = int(rng.integers(2, 11))
    grid_y = int(rng.integers(2, 11))
    slope = float(rng.choice([0.0, 0.01, 0.04, 0.1, 0.5]))
    flavor = seed % 3
    if flavor == 0:
        gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
    elif flavor == 1:
        gray = np.clip(rng.normal(215, 8, (h, w)), 0, 255).astype(np.uint8)
        gray[h // 3:h // 2, w // 4:w // 2] = 35
    else:
        gray = np.where(rng.random((h, w)) < 0.5, 0, 255).astype(np.uint8)
    ours = clahe_host(gray, slope, grid_x, grid_y)
    np.testing.assert_array_equal(ours,
                                  jax_clahe_host(gray, slope, grid_x, grid_y))
    # and the device version stays within a level of it on every flavour
    d = mod256(clahe(gray, slope, grid_x, grid_y, device="cpu").numpy(), ours)
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


def test_combine_board_content_equals_jax():
    rng = np.random.default_rng(7)
    board = rng.integers(0, 256, (60, 80), dtype=np.uint8)
    equalized = rng.integers(0, 256, (60, 80), dtype=np.uint8)
    for threshold in (128, 60):
        ours = combine_board_content(board, equalized, threshold,
                                     device="cpu")
        assert ours.dtype == torch.uint8
        np.testing.assert_array_equal(
            ours.numpy(), np.asarray(jax_combine(board, equalized,
                                                 threshold)))


def _motion_pairs():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    moved = base.copy()
    moved[20:50, 30:70] = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    speckle = base.copy()
    mask = rng.random(base.shape[:2]) < 0.1
    speckle[mask] = 255 - speckle[mask]
    return [(moved, base), (speckle, base), (base, base.copy())]


@pytest.mark.parametrize("pair", range(3))
@pytest.mark.parametrize("threshold,jump", [(15, 1), (30, 3), (0, 2)])
def test_motion_stats_equals_jax(pair, threshold, jump):
    frame, last = _motion_pairs()[pair]
    ours = motion_stats(frame, last, threshold, jump, device="cpu")
    theirs = jax_motion_stats(frame, last, threshold, jump)
    assert isinstance(ours, MotionStats)
    assert ours.total_changes.dtype == torch.int32
    assert int(ours.total_changes) == int(theirs.total_changes)
    np.testing.assert_array_equal(ours.bbox.numpy(), np.asarray(theirs.bbox))
    np.testing.assert_allclose(ours.centroid.numpy(),
                               np.asarray(theirs.centroid), rtol=STAT_RTOL)
    np.testing.assert_allclose(ours.deviation.numpy(),
                               np.asarray(theirs.deviation), rtol=STAT_RTOL)


def _clustered(seed, n, dim, clusters, noise):
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 1, (clusters, dim))
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    data = means[rng.integers(0, clusters, n)] + rng.normal(0, noise,
                                                             (n, dim))
    return data.astype(np.float32), means.astype(np.float32)


@pytest.mark.parametrize("case", ["directions", "clustered", "init_vectors"])
def test_ckmeans_equals_jax(case):
    if case == "directions":
        # tests/test_region_tree.py's two direction clusters
        rng = np.random.default_rng(0)
        a = rng.normal(0, 0.05, (50, 8)) + np.eye(8)[0]
        b = rng.normal(0, 0.05, (50, 8)) + np.eye(8)[1]
        data = np.concatenate([a, b]).astype(np.float32)
        kwargs, k = {"seed": 1}, 2
    else:
        data, means = _clustered(3, 2000, 16, 6, 0.05)
        k = 6
        kwargs = ({"seed": 2} if case == "clustered"
                  else {"seed": 5, "init_vectors": means})
    ours = ConvolutionalKMeans(data, k, device="cpu", **kwargs)
    theirs = JaxKMeans(data, k, **kwargs)
    np.testing.assert_allclose(ours.centers.numpy(),
                               np.asarray(theirs.centers), rtol=STAT_RTOL,
                               atol=1e-7)
    got = ours.execute(max_iterations=30, min_similarity=0.999999)
    want = theirs.execute(max_iterations=30, min_similarity=0.999999)
    assert got[0] == want[0]
    assert got[1] == pytest.approx(want[1], rel=STAT_RTOL)
    np.testing.assert_allclose(ours.centers.numpy(),
                               np.asarray(theirs.centers), rtol=STAT_RTOL,
                               atol=1e-6)
    np.testing.assert_array_equal(ours.assign(data), theirs.assign(data))


def test_ckmeans_checks_and_argmax_ties():
    with pytest.raises(TypeError):
        ConvolutionalKMeans(np.zeros((4, 2), np.int32), 2, device="cpu")
    with pytest.raises(ValueError):
        ConvolutionalKMeans(np.ones((4, 2), np.float32), 3, device="cpu",
                            init_vectors=np.ones((2, 2), np.float32))
    # equal similarities: the first center wins on both sides
    data = np.array([[1, 1], [1, -1], [2, 0]], np.float32)
    init = np.array([[1, 0], [1, 0], [0, 1]], np.float32)
    ours = ConvolutionalKMeans(data, 3, init_vectors=init, device="cpu")
    theirs = JaxKMeans(data, 3, init_vectors=init)
    np.testing.assert_array_equal(ours.assign(data), theirs.assign(data))


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        clahe(board_frame(0, 20, 20))
    with pytest.raises(RuntimeError, match="CUDA"):
        ConvolutionalKMeans(np.ones((4, 2), np.float32), 2)
