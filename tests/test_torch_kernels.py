"""Kernels K1 (ops/postprocess.py threshold_pack) and K2 (ops/conv7.py
conv7_same, conv_same_plain) of the port against the JAX package's Pallas
kernels run in interpret mode, on the CPU. Here the port's wrappers run
their plain versions (they are given CPU tensors); the CUDA kernels
themselves are held to the same plain versions on the card by chip_smoke.py
and by tests/test_torch_cuda.py. What the CPU can check of K2's own layout
is checked here: its packed weights, read back in the kernel's K order,
compute the plain version's conv; and its library is rebuilt when a header
changes."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lecturemath_tpu.models.fcn_lecturenet import pack_bits as jax_pack_bits
from lecturemath_tpu.ops.pallas_conv7 import conv7_same as jax_conv7_same
from lecturemath_tpu.ops.pallas_postprocess import threshold_binarize
from lecturemath_tpu_torch.ops import cuda_build
from lecturemath_tpu_torch.ops.conv7 import (conv7_same, conv_same_nhwc,
                                             conv_same_plain, n_tiles,
                                             pack_weights)
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


@pytest.mark.parametrize("c1,c2,n_out,k,activation", [
    (3, 8, 4, 7, "gelu"),     # diff image + a feature map, k=7
    (3, 5, 2, 3, None),       # both unaligned, k=3
    (2, 16, 1, 5, None),      # out_conv-like, k=5
])
def test_conv_same_plain_two_inputs_match_pallas(c1, c2, n_out, k,
                                                 activation):
    """The two-input plain version is the Pallas kernel on the concat."""
    batch, height, width = 1, 16, 40
    rng = np.random.default_rng(c1 * 100 + c2)
    x = rng.normal(size=(batch, height, c1, width)).astype(np.float32)
    x2 = rng.normal(size=(batch, height, c2, width)).astype(np.float32)
    kernel = (rng.normal(size=(k, k, c1 + c2, n_out)) * 0.2).astype(
        np.float32)
    bias = rng.normal(size=(n_out,)).astype(np.float32)

    ref = jax_conv7_same(jnp.asarray(np.concatenate([x, x2], axis=2)),
                         jnp.asarray(kernel), jnp.asarray(bias), rt=8,
                         activation=activation, out_dtype=jnp.float32,
                         interpret=True)
    ours = conv_same_plain(
        torch.from_numpy(x).permute(0, 2, 1, 3),
        torch.from_numpy(kernel).permute(3, 2, 0, 1), torch.from_numpy(bias),
        activation, torch.float32, x2=torch.from_numpy(x2).permute(0, 2, 1, 3))
    assert tuple(ours.shape) == (batch, n_out, height, width)
    np.testing.assert_allclose(ours.permute(0, 2, 1, 3).numpy(),
                               np.asarray(ref), atol=CONV_ATOL)


def test_conv_same_plain_rounds_weights_to_the_input_dtype():
    """bf16 input: the weights count as bf16, as in the Pallas kernel."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(1, 4, 9, 11)).astype(np.float32))
    weight = torch.from_numpy(rng.normal(size=(2, 4, 3, 3)).astype(
        np.float32))
    assert not torch.equal(weight, weight.bfloat16().float())
    got = conv_same_plain(x.bfloat16(), weight, None, None, torch.float32)
    ref = F.conv2d(x.bfloat16().float(), weight.bfloat16().float(),
                   padding=1)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    # f32 input: the weights as given
    torch.testing.assert_close(conv_same_plain(x, weight),
                               F.conv2d(x, weight, padding=1), atol=0, rtol=0)


def _kernel_gemm(x, x2, packed, bias, k, n_out):
    """The CUDA kernel's implicit GEMM written out: K chunks of 8 channels
    (x's, then x2's, zero-padded), per chunk k16 steps pairing taps 2s and
    2s+1, and each B fragment read back as lane 4n + i holding channels
    2i, 2i+1 of output channel n, slot 0 then slot 1."""
    batch, _, height, width = x.shape
    chunks = []
    for t in (x, x2):
        if t is None:
            continue
        g = -(-t.shape[1] // 8)
        t = F.pad(t, (0, 0, 0, 0, 0, 8 * g - t.shape[1]))
        chunks += list(t.reshape(batch, g, 8, height, width).unbind(1))
    groups, n_chunks, steps, nt = packed.shape[:4]
    assert packed.shape[4:] == (32, 2, 2) and n_chunks == len(chunks)
    r = k // 2
    out = torch.zeros(batch, groups * nt * 8, height, width)
    for g, chunk in enumerate(chunks):
        padded = F.pad(chunk, (r, r, r, r))
        for s in range(steps):
            for slot in range(2):
                # [group][tile][n][i][half] -> [channel 2i + half][n']
                frag = packed[:, g, s, :, :, slot, :].reshape(
                    groups, nt, 8, 4, 2).permute(3, 4, 0, 1, 2).reshape(
                        8, groups * nt * 8).float()
                tap = 2 * s + slot
                if tap >= k * k:   # the zero block: no weight may sit here
                    assert not frag.any()
                    continue
                dy, dx = divmod(tap, k)
                a = padded[:, :, dy:dy + height, dx:dx + width]
                out += torch.einsum("bjhw,jn->bnhw", a, frag)
    assert not out[:, n_out:].any()
    return out[:, :n_out] + bias.reshape(1, -1, 1, 1)


@pytest.mark.parametrize("c1,c2,n_out,k", [
    (3, 32, 32, 7),    # pixels_1
    (3, 32, 16, 7),    # pixels_2
    (3, 16, 1, 7),     # out_conv
    (32, 0, 1, 7),     # text_conv
    (19, 0, 40, 5),    # unaligned, two groups of output channels
    (5, 3, 24, 1),     # k=1, three n8 tiles padded to four
])
def test_pack_weights_is_the_kernels_b_operand(c1, c2, n_out, k):
    """pack_weights read back in the kernel's K order and fragment layout
    computes the plain version's conv (with bf16 weights)."""
    rng = np.random.default_rng(c1 + c2 + n_out + k)
    x = torch.from_numpy(rng.normal(size=(2, c1, 9, 13)).astype(np.float32))
    x2 = (torch.from_numpy(rng.normal(size=(2, c2, 9, 13)).astype(
        np.float32)) if c2 else None)
    weight = torch.from_numpy(
        (rng.normal(size=(n_out, c1 + c2, k, k)) * 0.2).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(n_out,)).astype(np.float32))
    nt = n_tiles(n_out)
    packed = pack_weights(weight, c1, c2, nt)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape[:4] == (-(-n_out // (8 * nt)),
                                -(-c1 // 8) - (-c2 // 8), (k * k + 1) // 2, nt)
    got = _kernel_gemm(x, x2, packed, bias, k, n_out)
    ref = conv_same_plain(x, weight.bfloat16().float(), bias, None,
                          torch.float32, x2)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)


def test_kernel_build_follows_included_headers(tmp_path, monkeypatch):
    """A library older than a header its source includes is rebuilt."""
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    (tmp_path / "build").mkdir()
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#pragma once\n")
    lib = tmp_path / "build" / "libk.so"
    lib.write_bytes(b"")
    assert cuda_build.sources_of("k") == [
        str(tmp_path / name) for name in ("k.cu", "a.cuh", "b.cuh")]
    for name, age in (("k.cu", 30), ("a.cuh", 20), ("b.cuh", 20),
                      ("build/libk.so", 10)):
        t = 1_700_000_000 - age
        os.utime(tmp_path / name, (t, t))
    assert not cuda_build._stale("k")
    t = 1_700_000_000
    os.utime(tmp_path / "b.cuh", (t, t))
    assert cuda_build._stale("k")
    # the repository's K2 source names its PTX header
    monkeypatch.undo()
    assert any(path.endswith("mma.cuh")
               for path in cuda_build.sources_of("conv7"))


def test_wrappers_refuse_other_devices():
    """No silent plain path for anything but a CPU tensor."""
    with pytest.raises(ValueError, match="unsupported device"):
        threshold_pack(torch.empty(1, 8, 8, device="meta"), 8, 8)
    x = torch.empty(1, 4, 8, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv_same_nhwc(x, torch.empty(2, 4, 3, 3, device="meta"))

