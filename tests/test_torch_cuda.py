"""The port's CUDA kernels against their plain versions on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch with CUDA:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX). Without a card every
test here skips."""

import numpy as np
import pytest
import torch

from lecturemath_tpu_torch.ops.conv7 import (conv7_same, conv_same_nhwc,
                                             conv_same_plain)
from lecturemath_tpu_torch.ops.postprocess import (threshold_pack,
                                                   threshold_pack_plain)

pytestmark = pytest.mark.cuda

THRESHOLD = 128
# sigmoid differs by a few f32 ulps between torch and CUDA's expf: a pixel
# whose sigmoid*255 lies within 2 ulp of the threshold may flip
BAND = 2 * float(np.spacing(np.float32(THRESHOLD)))
# f32 output: f32 sums of up to 49*35 bf16 products in another order
CONV_ATOL, CONV_RTOL = 1e-3, 1e-5
# bf16 output: one rounding to 8 mantissa bits (2^-8 relative)
BF16_RTOL = 2.0 ** -8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _boundary_logits(shape, seed):
    """Normal logits, a quarter of them within 4 ulps of the logit at which
    sigmoid*255 lands on the threshold."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, shape).astype(np.float32)
    near = rng.random(shape) < 0.25
    base = np.float32(np.log(THRESHOLD / (255.0 - THRESHOLD)))
    steps = rng.integers(-4, 5, shape).astype(np.float32)
    logits[near] = (base + steps * np.spacing(base))[near]
    return logits


@pytest.mark.parametrize("shape,crop", [((2, 96, 160), (90, 150)),
                                        ((1, 37, 45), (37, 45)),
                                        ((3, 64, 131), (61, 129))])
def test_threshold_pack_matches_plain(cuda, shape, crop):
    h, w = crop
    logits = _boundary_logits(shape, seed=sum(shape))
    dev = torch.from_numpy(logits).to(cuda)
    before = threshold_pack.launches
    ours = threshold_pack(dev, h, w, THRESHOLD).cpu().numpy()
    assert threshold_pack.launches == before + 1
    plain = threshold_pack_plain(dev, h, w, THRESHOLD).cpu().numpy()
    assert ours.shape == plain.shape == (shape[0], h, (w + 7) // 8)
    ours_bits = np.unpackbits(ours, axis=-1)
    assert not ours_bits[..., w:].any()
    scaled = torch.sigmoid(torch.from_numpy(logits[:, :h, :w])).numpy() * 255
    band = np.abs(scaled - THRESHOLD) <= BAND
    differ = ours_bits[..., :w] != np.unpackbits(plain, axis=-1)[..., :w]
    np.testing.assert_array_equal(differ & ~band, False)
    assert differ.sum() <= 0.05 * band.sum()


@pytest.mark.parametrize("c_in,n_out,k,activation,out_dtype", [
    (32, 1, 7, None, torch.float32),        # text_conv
    (35, 32, 7, "gelu", torch.bfloat16),    # pixels_1
    (35, 16, 7, "gelu", torch.float32),     # pixels_2, f32 out
    (19, 1, 7, None, torch.float32),        # out_conv
    (5, 3, 3, None, torch.float32),         # TINY heads
    (8, 40, 5, "gelu", torch.float32),      # two channel groups, k=5
])
def test_conv_same_nhwc_matches_plain(cuda, c_in, n_out, k, activation,
                                      out_dtype):
    gen = torch.Generator(device=cuda).manual_seed(c_in * 100 + n_out)
    x = torch.randn(2, c_in, 37, 70, device=cuda, generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    weight = (torch.randn(n_out, c_in, k, k, device=cuda, generator=gen)
              * 0.05).to(torch.bfloat16)
    bias = torch.randn(n_out, device=cuda, generator=gen)
    before = conv_same_nhwc.launches
    got = conv_same_nhwc(x, weight, bias, activation, out_dtype)
    assert conv_same_nhwc.launches == before + 1
    assert got.dtype == out_dtype and tuple(got.shape) == (2, n_out, 37, 70)
    assert got.is_contiguous(memory_format=torch.channels_last)
    ref = conv_same_plain(x, weight, bias, activation, torch.float32)
    rtol = CONV_RTOL if out_dtype == torch.float32 else BF16_RTOL
    torch.testing.assert_close(got.float(), ref, atol=CONV_ATOL, rtol=rtol)


def test_conv7_same_layout(cuda):
    """The (B, H, C, W) / HWIO wrapper of the JAX package's layout."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(1, 24, 6, 40, device=cuda, generator=gen).to(
        torch.bfloat16)
    kernel = (torch.randn(7, 7, 6, 4, device=cuda, generator=gen) * 0.1).to(
        torch.bfloat16)
    got = conv7_same(x, kernel, None, "gelu", torch.float32)
    ref = conv_same_plain(x.permute(0, 2, 1, 3), kernel.permute(3, 2, 0, 1),
                          None, "gelu", torch.float32).permute(0, 2, 1, 3)
    torch.testing.assert_close(got, ref, atol=CONV_ATOL, rtol=CONV_RTOL)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    logits = torch.zeros(1, 8, 16, device=cuda)
    with pytest.raises(TypeError):
        threshold_pack(logits.double(), 8, 16)
    with pytest.raises(ValueError, match="contiguous"):
        threshold_pack(logits.transpose(1, 2), 16, 8)
    with pytest.raises(ValueError, match="crop"):
        threshold_pack(logits, 9, 16)
    x = torch.zeros(1, 4, 8, 8, device=cuda, dtype=torch.bfloat16)
    weight = torch.zeros(2, 4, 3, 3, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="channels_last"):
        conv_same_nhwc(x, weight)
    x = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(TypeError):
        conv_same_nhwc(x.float(), weight)
    with pytest.raises(ValueError, match="odd k"):
        conv_same_nhwc(x, torch.zeros(2, 4, 4, 4, device=cuda,
                                      dtype=torch.bfloat16))
