"""Kernels K1 (ops/postprocess.py threshold_pack) and K2 (ops/conv7.py
conv7_same) of the port against the JAX package's Pallas kernels run in
interpret mode, on the CPU. Here the port's wrappers run their plain
versions (they are given CPU tensors); the CUDA kernels themselves are held
to the same plain versions on the card by chip_smoke.py and by
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lecturemath_tpu.models.fcn_lecturenet import pack_bits as jax_pack_bits
from lecturemath_tpu.ops.pallas_conv7 import conv7_same as jax_conv7_same
from lecturemath_tpu.ops.pallas_postprocess import threshold_binarize
from lecturemath_tpu_torch.ops.conv7 import (conv7_same, conv_same_nhwc,
                                             conv_same_plain)
from lecturemath_tpu_torch.ops.postprocess import (threshold_pack,
                                                   threshold_pack_plain)

torch.set_num_threads(1)

THRESHOLD = 128
# logit at which sigmoid(x) * 255 == THRESHOLD
BOUNDARY_LOGIT = float(np.log(THRESHOLD / (255.0 - THRESHOLD)))
# sigmoid differs by a few f32 ulps between jax, torch and CUDA's expf, so a
# pixel whose sigmoid*255 lies within 2 ulp of the threshold may flip; every
# other pixel must agree exactly
BAND = 2 * float(np.spacing(np.float32(THRESHOLD)))
# the pallas_conv7 test's tolerance: f32 sums of up to 49*35 terms taken in
# another order
CONV_ATOL = 1e-3


def _boundary_logits(shape, seed):
    """Normal logits, with a quarter of the pixels placed within a few ulps
    of the logit where sigmoid*255 lands on the threshold."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, shape).astype(np.float32)
    near = rng.random(shape) < 0.25
    base = np.float32(BOUNDARY_LOGIT)
    steps = rng.integers(-4, 5, shape).astype(np.float32)
    logits[near] = (base + steps * np.spacing(base))[near]
    return logits


def _in_band(logits):
    scaled = torch.sigmoid(torch.from_numpy(logits)).numpy() * np.float32(255)
    return np.abs(scaled - np.float32(THRESHOLD)) <= BAND


@pytest.mark.parametrize("shape,crop", [
    ((2, 64, 128), (64, 128)),      # tests/test_pallas_ops.py shapes
    ((1, 300, 128), (300, 128)),    # 300 % 256 != 0
    ((2, 64, 128), (60, 125)),      # the model's crop of a padded map
    ((1, 37, 45), (37, 45)),        # odd width, one partial byte
    ((2, 300, 131), (299, 129)),    # odd rows and columns
])
def test_threshold_pack_matches_pallas(shape, crop):
    h, w = crop
    logits = _boundary_logits(shape, seed=sum(shape))
    ours = threshold_pack(torch.from_numpy(logits), h, w, THRESHOLD).numpy()
    ref_u8 = np.asarray(threshold_binarize(jnp.asarray(logits), THRESHOLD,
                                           interpret=True))
    ref = np.asarray(jax_pack_bits(jnp.asarray(ref_u8[:, :h, :w])))
    assert ours.shape == ref.shape == (shape[0], h, (w + 7) // 8)

    ours_bits = np.unpackbits(ours, axis=-1)
    ref_bits = np.unpackbits(ref, axis=-1)
    # padding bits past w are 0 on both sides
    assert not ours_bits[..., w:].any() and not ref_bits[..., w:].any()
    band = _in_band(logits[:, :h, :w])
    differ = ours_bits[..., :w] != ref_bits[..., :w]
    np.testing.assert_array_equal(differ & ~band, False)
    # a few boundary pixels may flip between sigmoid implementations, never
    # a large share of the ones that sit on the threshold
    assert band.sum() > 0.1 * band.size
    assert differ.sum() <= 0.05 * band.sum(), (differ.sum(), band.sum())


def test_threshold_pack_plain_is_the_reference_formula():
    logits = _boundary_logits((2, 40, 70), seed=1)
    t = torch.from_numpy(logits)
    manual = (((torch.sigmoid(t) * 255).to(torch.uint8) >= THRESHOLD)
              [:, :33, :61])
    ours = threshold_pack_plain(t, 33, 61, THRESHOLD).numpy()
    np.testing.assert_array_equal(np.unpackbits(ours, axis=-1)[..., :61],
                                  manual.numpy().astype(np.uint8))


@pytest.mark.parametrize("activation", [None, "gelu"])
@pytest.mark.parametrize("shape", [
    (2, 5, 64, 480, 4, 7),    # odd channels, k=7 (head-like)
    (1, 8, 32, 256, 3, 3),    # k=3, aligned channels
    (1, 19, 16, 384, 16, 7),  # pixels_2-like
])
def test_conv7_same_matches_pallas(shape, activation):
    batch, c_in, height, width, n_out, k = shape
    rng = np.random.default_rng(42)
    x = rng.normal(size=(batch, height, c_in, width)).astype(np.float32)
    kernel = (rng.normal(size=(k, k, c_in, n_out)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(n_out,)).astype(np.float32)

    ref = jax_conv7_same(jnp.asarray(x), jnp.asarray(kernel),
                         jnp.asarray(bias), rt=8, activation=activation,
                         out_dtype=jnp.float32, interpret=True)
    ours = conv7_same(torch.from_numpy(x), torch.from_numpy(kernel),
                      torch.from_numpy(bias), activation=activation,
                      out_dtype=torch.float32)
    assert tuple(ours.shape) == (batch, height, n_out, width)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=CONV_ATOL)


def test_wrappers_refuse_other_devices():
    """No silent plain path for anything but a CPU tensor."""
    with pytest.raises(ValueError, match="unsupported device"):
        threshold_pack(torch.empty(1, 8, 8, device="meta"), 8, 8)
    x = torch.empty(1, 4, 8, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv_same_nhwc(x, torch.empty(2, 4, 3, 3, device="meta"))

