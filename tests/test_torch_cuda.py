"""The port's CUDA kernels against their plain versions on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch with CUDA:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX). Without a card every
test here skips."""

import numpy as np
import pytest
import torch

from lecturemath_tpu_torch.ops.cc_label import (compact_labels,
                                                label_components,
                                                label_components_batch,
                                                label_components_plain)
from lecturemath_tpu_torch.ops.cc_label_pallas import label_components_tiled
from lecturemath_tpu_torch.ops.conv7 import (conv7_same, conv_same_nhwc,
                                             conv_same_plain)
from lecturemath_tpu_torch.ops.postprocess import (threshold_pack,
                                                   threshold_pack_plain)

pytestmark = pytest.mark.cuda

THRESHOLD = 128
# sigmoid differs by a few f32 ulps between torch and CUDA's expf: a pixel
# whose sigmoid*255 lies within 2 ulp of the threshold may flip
BAND = 2 * float(np.spacing(np.float32(THRESHOLD)))
# f32 output: f32 sums of up to 49*35 bf16 products (exact in f32) taken in
# another order, on the tensor cores for the kernel
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


def _bf16_nhwc(shape, gen, device):
    return torch.randn(*shape, device=device, generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)


# (C of x, C of x2, N, k, activation, out dtype, (H, W)); H and W are not
# multiples of the kernel's 16 x 32 block tile
@pytest.mark.parametrize("c_in,c2,n_out,k,activation,out_dtype,hw", [
    (32, 0, 1, 7, None, torch.float32, (37, 70)),           # text_conv
    (3, 32, 32, 7, "gelu", torch.bfloat16, (37, 70)),       # pixels_1
    (3, 32, 16, 7, "gelu", torch.bfloat16, (61, 129)),      # pixels_2
    (3, 16, 1, 7, None, torch.float32, (61, 129)),          # out_conv
    (35, 0, 32, 7, "gelu", torch.bfloat16, (37, 70)),       # one tensor, C=35
    (35, 0, 16, 7, "gelu", torch.float32, (61, 129)),       # f32 out
    (19, 0, 1, 7, None, torch.float32, (37, 70)),           # C=19
    (5, 0, 3, 3, None, torch.float32, (37, 70)),            # TINY heads
    (8, 0, 40, 5, "gelu", torch.float32, (61, 129)),        # two groups, k=5
    (5, 3, 8, 1, None, torch.float32, (61, 129)),           # k=1, unaligned
    (16, 19, 24, 3, "gelu", torch.bfloat16, (37, 70)),      # k=3, N=24
])
def test_conv_same_nhwc_matches_plain(cuda, c_in, c2, n_out, k, activation,
                                      out_dtype, hw):
    gen = torch.Generator(device=cuda).manual_seed(c_in * 100 + c2 * 10
                                                   + n_out)
    height, width = hw
    x = _bf16_nhwc((2, c_in, height, width), gen, cuda)
    x2 = _bf16_nhwc((2, c2, height, width), gen, cuda) if c2 else None
    weight = (torch.randn(n_out, c_in + c2, k, k, device=cuda, generator=gen)
              * 0.05).to(torch.bfloat16)
    bias = torch.randn(n_out, device=cuda, generator=gen)
    before = conv_same_nhwc.launches
    got = conv_same_nhwc(x, weight, bias, activation, out_dtype, x2=x2)
    assert conv_same_nhwc.launches == before + 1
    assert got.dtype == out_dtype
    assert tuple(got.shape) == (2, n_out, height, width)
    assert got.is_contiguous(memory_format=torch.channels_last)
    ref = conv_same_plain(x, weight, bias, activation, torch.float32, x2=x2)
    rtol = CONV_RTOL if out_dtype == torch.float32 else BF16_RTOL
    torch.testing.assert_close(got.float(), ref, atol=CONV_ATOL, rtol=rtol)


def test_conv_same_nhwc_rounds_f32_weights_to_bf16(cuda):
    """f32 weights that bf16 cannot hold: the kernel computes with them
    rounded to bf16, which is what the plain version does for a bf16
    input."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = _bf16_nhwc((2, 3, 37, 70), gen, cuda)
    x2 = _bf16_nhwc((2, 32, 37, 70), gen, cuda)
    weight = torch.randn(16, 35, 7, 7, device=cuda, generator=gen) * 0.05
    assert not torch.equal(weight, weight.bfloat16().float())
    bias = torch.randn(16, device=cuda, generator=gen)
    got = conv_same_nhwc(x, weight, bias, "gelu", torch.float32, x2=x2)
    ref = conv_same_plain(x, weight.bfloat16(), bias, "gelu",
                          torch.float32, x2=x2)
    torch.testing.assert_close(got, ref, atol=CONV_ATOL, rtol=CONV_RTOL)
    torch.testing.assert_close(
        conv_same_plain(x, weight, bias, "gelu", torch.float32, x2=x2), ref,
        atol=0, rtol=0)


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
    x2 = torch.zeros(1, 3, 8, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="channels_last"):
        conv_same_nhwc(x, torch.zeros(2, 7, 3, 3, device=cuda,
                                      dtype=torch.bfloat16), x2=x2)
    x2 = x2.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="does not fit"):
        conv_same_nhwc(x, weight, x2=x2)
    with pytest.raises(ValueError, match="does not match"):
        conv_same_nhwc(x, weight, x2=x2[:, :, :4])


# --- kernel K3: CC labeling, exact against the plain version at its fixed
# point (labels are integers; the kernel's result does not depend on the
# order of its atomics)

FIXED_POINT = 1 << 20   # rounds: the plain version stops at its fixed point


def _snake(h, w, pitch):
    img = np.zeros((h, w), np.uint8)
    for k, row in enumerate(range(0, h, pitch)):
        img[row, :] = 1
        img[row:row + pitch + 1, -1 if k % 2 == 0 else 0] = 1
    return img


def _spiral(h, w):
    img = np.zeros((h, w), np.uint8)
    top, left, bottom, right = 0, 0, h - 1, w - 1
    while top <= bottom and left <= right:
        img[top, left:right + 1] = 1
        img[top:bottom + 1, right] = 1
        if top + 2 <= bottom:
            img[bottom, left:right + 1] = 1
            img[top + 2:bottom + 1, left] = 1
            img[top + 2, min(left + 1, right)] = 1
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
    return img


def _border_lines(h, w):
    """Single-pixel lines on both sides of the 32-pixel block borders, and
    short crossings of them."""
    img = np.zeros((h, w), np.uint8)
    img[31::32, 5:-5] = 1
    img[5:-5, 32::32] = 1
    img[::7, 63:65] = 1
    img[95:97, ::5] = 1
    return img


def _patterns(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    return {"snake": _snake(h, w, 3), "spiral": _spiral(h, w),
            "full": np.ones((h, w), np.uint8),
            "checkerboard": ((yy + xx) % 2).astype(np.uint8),
            "border_lines": _border_lines(h, w),
            "percolation_0.55": (rng.random((h, w)) < 0.55).astype(np.uint8),
            "percolation_0.6": (rng.random((h, w)) < 0.6).astype(np.uint8),
            "empty": np.zeros((h, w), np.uint8)}


@pytest.mark.parametrize("shape", [(2, 200, 330), (3, 301, 133), (1, 37, 45),
                                   (2, 64, 64)])
def test_cc_label_matches_plain_and_scipy(cuda, shape):
    from scipy import ndimage

    b, h, w = shape
    for name, img in _patterns(h, w, seed=h * w).items():
        batch = np.stack([img] * b)
        batch[-1] = np.random.default_rng(b).random((h, w)) < 0.3
        dev = torch.from_numpy(batch).to(cuda)
        before = label_components_batch.launches
        got = label_components_batch(dev)
        assert label_components_batch.launches == before + 1
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        ref = label_components_plain(dev, FIXED_POINT)
        assert torch.equal(got, ref), name
        for frame, labels in zip(batch, got.cpu().numpy()):
            compacted, n = compact_labels(labels)
            expected, n_ref = ndimage.label(frame)
            assert n == n_ref, name
            np.testing.assert_array_equal(compacted, expected)
    # the single-frame and tiled wrappers go through the same kernel
    frame = torch.from_numpy(_spiral(h, w)).to(cuda)
    single = label_components(frame)
    assert torch.equal(single, label_components_tiled(frame, tile=(8, 8)))
    assert torch.equal(single, label_components_plain(frame[None],
                                                      FIXED_POINT)[0])
    # a bool batch is the same uint8 batch
    assert torch.equal(label_components_batch(dev != 0),
                       label_components_batch(dev))


def test_cc_label_refuses_what_the_kernel_does_not_take(cuda):
    binary = torch.zeros(2, 8, 16, dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError, match="uint8 or bool"):
        label_components_batch(binary.int())
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        label_components_batch(binary[0])
    with pytest.raises(ValueError, match="contiguous"):
        label_components_batch(binary.transpose(1, 2))
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        label_components(binary)
