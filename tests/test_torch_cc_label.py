"""CC labeling of the port (lecturemath_tpu_torch/ops/cc_label.py and
ops/cc_label_pallas.py) against the JAX package's label_components /
label_components_batch (XLA on the CPU), its label_components_tiled run in
interpret mode, and scipy.ndimage.label, on the inputs of
tests/test_cc_label.py and tests/test_cc_label_pallas.py plus a dense and a
sparse 96x128 frame. Here the port's wrappers get CPU tensors and run their
plain versions; kernel K3 is held to the same plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py. Everything compared is integer:
equality is exact.

Raw labels (root linear index + 1) are compared, not only compacted ones.
The JAX propagation stops after max_iters=64 rounds. Each test asserts that
JAX reaches scipy's labels on its inputs, except on the ones listed in
STOPS_SHORT, where the port is compared with JAX round for round and with
scipy at its fixed point. A near-percolation frame on which JAX stops short
is tested on its own."""

import numpy as np
import pytest
import torch
from scipy import ndimage

from lecturemath_tpu.ops.cc_label import compact_labels as jax_compact
from lecturemath_tpu.ops.cc_label import label_components as jax_label
from lecturemath_tpu.ops.cc_label import \
    label_components_batch as jax_label_batch
from lecturemath_tpu.ops.cc_label_pallas import \
    label_components_tiled as jax_label_tiled
from lecturemath_tpu_torch.ops import (compact_labels, label_components,
                                       label_components_batch)
from lecturemath_tpu_torch.ops.cc_label_pallas import label_components_tiled

torch.set_num_threads(1)


def random_blobs(rng, h=64, w=64, density=0.25):
    """tests/test_cc_label.py's blobs: dilated salt noise."""
    img = (rng.random((h, w)) < density).astype(np.uint8)
    return ndimage.binary_dilation(img, iterations=1).astype(np.uint8)


def snake(size, pitch):
    """A single winding component whose rows alternate ends."""
    img = np.zeros((size, size), dtype=np.uint8)
    for row in range(0, size, pitch):
        img[row, :] = 1
        if (row // pitch) % 2 == 0:
            img[row:row + pitch + 1, -1] = 1
        else:
            img[row:row + pitch + 1, 0] = 1
    return img


def _frames():
    """(name, frame, tile of tests/test_cc_label_pallas.py or None)."""
    rng0 = np.random.default_rng(0)
    frames = [(f"blobs64_{k}", random_blobs(rng0), None) for k in range(3)]
    diagonal = np.zeros((8, 8), dtype=np.uint8)
    diagonal[1, 1] = diagonal[2, 2] = 1
    frames += [("empty32", np.zeros((32, 32), np.uint8), (16, 16)),
               ("full32", np.ones((32, 32), np.uint8), None),
               ("diagonal8", diagonal, None),
               ("snake48", snake(48, 4), None),
               ("snake64", snake(64, 8), (16, 16))]
    rng0 = np.random.default_rng(0)
    frames.append(("blobs96x128",
                   ndimage.binary_dilation(rng0.random((96, 128)) < 0.25
                                           ).astype(np.uint8), (32, 32)))
    rng1 = np.random.default_rng(1)
    frames.append(("uneven50x70",
                   (rng1.random((50, 70)) < 0.3).astype(np.uint8), (32, 32)))
    single = np.zeros((20, 20), dtype=np.uint8)
    single[2:8, 2:8] = 1
    single[12:18, 12:18] = 1
    frames.append(("single_tile20", single, (64, 64)))
    rng2 = np.random.default_rng(2)
    frames += [("dense96x128",
                (rng2.random((96, 128)) < 0.45).astype(np.uint8), (32, 32)),
               ("sparse96x128",
                (rng2.random((96, 128)) < 0.05).astype(np.uint8), (32, 32))]
    return frames


FRAMES = _frames()
IDS = [name for name, _, _ in FRAMES]
# frames on which JAX's 64 rounds of label_components stop short of the
# fixed point: the snake of pitch 8 winds 8 rows x 64 columns
STOPS_SHORT = {"snake64"}


def scipy_raw(binary):
    """The contract from scipy: each component's minimum linear index + 1."""
    labels, n = ndimage.label(binary)
    flat = labels.ravel()
    roots = np.full(n + 1, flat.size, dtype=np.int64)
    np.minimum.at(roots, flat, np.arange(flat.size))
    return np.where(flat > 0, roots[flat] + 1, 0).reshape(binary.shape)


@pytest.mark.parametrize("name,binary,tile", FRAMES, ids=IDS)
def test_label_components_matches_jax_and_scipy(name, binary, tile):
    expected = scipy_raw(binary)
    theirs = np.asarray(jax_label(binary))
    assert np.array_equal(theirs, expected) == (name not in STOPS_SHORT)
    ours = label_components(binary, device="cpu")
    assert ours.dtype == torch.int32 and ours.device.type == "cpu"
    # the same rounds as JAX: equal where JAX stops short too
    np.testing.assert_array_equal(ours.numpy(), theirs)
    # a CPU tensor stays on the CPU without device=
    np.testing.assert_array_equal(
        label_components(torch.from_numpy(binary) != 0).numpy(), theirs)
    if name in STOPS_SHORT:
        # JAX is no reference here: the port at its fixed point is scipy's
        ours = label_components(binary, max_iters=4096, device="cpu")
        theirs = expected.astype(np.int32)
    np.testing.assert_array_equal(ours.numpy(), expected)
    compacted, n = compact_labels(ours.numpy())
    j_compacted, j_n = jax_compact(theirs)
    reference, n_ref = ndimage.label(binary)
    assert n == j_n == n_ref
    np.testing.assert_array_equal(compacted, j_compacted)
    np.testing.assert_array_equal(compacted, reference)


def test_label_components_batch_matches_jax():
    """tests/test_cc_label.py's batch, plus the 96x128 frames as one batch."""
    rng = np.random.default_rng(1)
    batches = [np.stack([random_blobs(rng, 32, 32) for _ in range(4)]),
               np.stack([binary for _, binary, _ in FRAMES
                         if binary.shape == (96, 128)])]
    before = label_components_batch.launches
    for batch in batches:
        theirs = np.asarray(jax_label_batch(batch))
        ours = label_components_batch(batch, device="cpu").numpy()
        np.testing.assert_array_equal(ours, theirs)
        for frame, labels in zip(batch, ours):
            np.testing.assert_array_equal(labels, scipy_raw(frame))
    assert label_components_batch.launches == before   # plain path only


@pytest.mark.parametrize("name,binary,tile",
                         [f for f in FRAMES if f[2] is not None],
                         ids=[f[0] for f in FRAMES if f[2] is not None])
def test_label_components_tiled_matches_jax(name, binary, tile):
    theirs = jax_label_tiled(binary, tile=tile, interpret=True)
    ours = label_components_tiled(binary, tile=tile, device="cpu").numpy()
    np.testing.assert_array_equal(ours, scipy_raw(binary))
    # the JAX tiled path numbers roots by the width padded to whole tiles;
    # the same roots in the frame's own width are the port's labels
    h, w = binary.shape
    padded_w = -(-w // min(tile[1], w)) * min(tile[1], w)
    root = theirs.astype(np.int64) - 1
    unpadded = np.where(theirs > 0,
                        (root // padded_w) * w + root % padded_w + 1, 0)
    np.testing.assert_array_equal(ours, unpadded)
    assert (padded_w != w) or np.array_equal(ours, theirs)
    np.testing.assert_array_equal(compact_labels(ours)[0],
                                  jax_compact(theirs)[0])
    # the tile never shows in the output
    for other in ((8, 8), (16, 48), (7, 13), (512, 512)):
        np.testing.assert_array_equal(
            label_components_tiled(binary, tile=other, device="cpu").numpy(),
            ours)


def test_max_iters_stops_short_like_jax():
    """Near percolation, 64 rounds do not reach the fixed point: the plain
    version stops where JAX stops (same labels, not scipy's), and with more
    rounds it reaches scipy's."""
    binary = (np.random.default_rng(1).random((96, 128)) < 0.6).astype(
        np.uint8)
    theirs = np.asarray(jax_label(binary))
    expected = scipy_raw(binary)
    assert not np.array_equal(theirs, expected)
    np.testing.assert_array_equal(
        label_components(binary, device="cpu").numpy(), theirs)
    np.testing.assert_array_equal(
        label_components(binary, max_iters=4096, device="cpu").numpy(),
        expected)
    np.testing.assert_array_equal(
        label_components_tiled(binary, tile=(32, 32), device="cpu").numpy(),
        expected)


def test_explicit_device_and_bad_input():
    binary = np.zeros((4, 5), np.uint8)
    if not torch.cuda.is_available():
        # a numpy frame without device= goes to the card, which is missing
        with pytest.raises(RuntimeError, match="CUDA"):
            label_components(binary)
        with pytest.raises(RuntimeError, match="CUDA"):
            label_components_batch(binary[None])
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        label_components_batch(binary, device="cpu")
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        label_components(binary[None], device="cpu")
    with pytest.raises(ValueError, match="tile"):
        label_components_tiled(binary, tile=(0, 4), device="cpu")
    with pytest.raises(ValueError, match="tile"):
        label_components_tiled(binary, tile=16, device="cpu")
