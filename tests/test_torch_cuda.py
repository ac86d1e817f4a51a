"""The port's CUDA kernels against their plain versions on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch with CUDA:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX). Without a card every
test here skips."""

import time

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
from lecturemath_tpu_torch.ops.augment import augment_batch
from lecturemath_tpu_torch.ops.median import (median_u8_batch,
                                              median_u8_plain,
                                              median_unit_batch)
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
    # the production heads' channel slices on the model axis: pixels_1 at
    # M = 2 and 4, pixels_2 at M = 8
    (3, 32, 16, 7, "gelu", torch.bfloat16, (70, 96)),
    (3, 32, 8, 7, "gelu", torch.bfloat16, (70, 96)),
    (3, 16, 2, 7, "gelu", torch.bfloat16, (70, 96)),
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


# the kernel's tile (rows x columns) and the pixels a thread loads at once
TILE_H, TILE_W, SEGMENT = 32, 128, 16


def _border_lines(h, w):
    """Single-pixel lines along both sides of the kernel's tile borders and
    of its 16-pixel segment edges, and short crossings of them."""
    img = np.zeros((h, w), np.uint8)
    img[TILE_H - 1::TILE_H, 5:-5] = 1                # last row of a tile
    img[2 * TILE_H::2 * TILE_H, 3:w // 2] = 1        # first row of a tile
    img[5:-5, TILE_W::TILE_W] = 1                    # first column
    img[5:h // 2, TILE_W - 1::2 * TILE_W] = 1        # last column
    img[h // 2:, SEGMENT::3 * SEGMENT] = 1           # first pixel of a segment
    img[h // 2:, 3 * SEGMENT - 1::3 * SEGMENT] = 1   # last pixel of a segment
    img[::7, TILE_W - 1:TILE_W + 1] = 1              # dashes across columns
    img[::5, SEGMENT - 1:SEGMENT + 1] = 1            # and a segment edge
    img[3 * TILE_H - 1:3 * TILE_H + 1, ::5] = 1      # dashes across rows
    return img


def _stairs(h, w):
    """Vertical runs in neighbouring columns that touch only diagonally:
    under 4-connectivity each run is a component of its own."""
    img = np.zeros((h, w), np.uint8)
    for x in range(0, w, 3):    # pairs of columns, one blank between
        y0 = 2 * x % h
        img[y0:y0 + 5, x] = 1
        if x + 1 < w:
            img[y0 + 5:y0 + 10, x + 1] = 1
    return img


def _across_tile_edges(h, w):
    """Rows that are foreground across the tile's column edge (segments
    whose every pixel is foreground), cut every third row, and a block
    across the corner of four tiles."""
    img = np.zeros((h, w), np.uint8)
    img[:, TILE_W - SEGMENT:TILE_W + SEGMENT] = 1
    img[::3] = 0
    img[TILE_H - 8:TILE_H + 8, TILE_W - 8:TILE_W + 8] = 1
    return img


def _patterns(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    return {"snake": _snake(h, w, 3), "spiral": _spiral(h, w),
            "full": np.ones((h, w), np.uint8),
            "checkerboard": ((yy + xx) % 2).astype(np.uint8),
            "border_lines": _border_lines(h, w),
            "stairs": _stairs(h, w),
            "across_tile_edges": _across_tile_edges(h, w),
            "percolation_0.55": (rng.random((h, w)) < 0.55).astype(np.uint8),
            "percolation_0.6": (rng.random((h, w)) < 0.6).astype(np.uint8),
            "empty": np.zeros((h, w), np.uint8)}


def _check_cc_label(binary, labels, name=""):
    """labels (from the kernel) equal the plain version at its fixed point
    and scipy's after compact_labels, frame by frame."""
    from scipy import ndimage

    assert labels.dtype == torch.int32
    assert tuple(labels.shape) == tuple(binary.shape)
    assert torch.equal(labels, label_components_plain(binary, FIXED_POINT)), \
        name
    for frame, frame_labels in zip(binary.cpu().numpy(),
                                   labels.cpu().numpy()):
        compacted, n = compact_labels(frame_labels)
        expected, n_ref = ndimage.label(frame)
        assert n == n_ref, name
        np.testing.assert_array_equal(compacted, expected)


@pytest.mark.parametrize("shape", [(2, 200, 330), (3, 301, 133), (1, 37, 45),
                                   (2, 64, 64)])
def test_cc_label_matches_plain_and_scipy(cuda, shape):
    b, h, w = shape
    for name, img in _patterns(h, w, seed=h * w).items():
        batch = np.stack([img] * b)
        batch[-1] = np.random.default_rng(b).random((h, w)) < 0.3
        dev = torch.from_numpy(batch).to(cuda)
        before = label_components_batch.launches
        got = label_components_batch(dev)
        assert label_components_batch.launches == before + 1
        _check_cc_label(dev, got, name)
    # the single-frame and tiled wrappers go through the same kernel
    frame = torch.from_numpy(_spiral(h, w)).to(cuda)
    single = label_components(frame)
    assert torch.equal(single, label_components_tiled(frame, tile=(8, 8)))
    assert torch.equal(single, label_components_plain(frame[None],
                                                      FIXED_POINT)[0])
    # a bool batch is the same uint8 batch
    assert torch.equal(label_components_batch(dev != 0),
                       label_components_batch(dev))


@pytest.mark.parametrize("h", [1, 33])
@pytest.mark.parametrize("w", [1, 15, 16, 17, 127, 129, 960])
def test_cc_label_tile_geometry(cuda, h, w):
    """Widths around the 16-pixel segment and the 128-column tile, heights
    around the 32-row tile: every pattern in one batch, whose frames start
    16-byte aligned only where h * w is a multiple of 16."""
    patterns = _patterns(h, w, seed=h * 1000 + w)
    batch = torch.from_numpy(np.stack(list(patterns.values()))).to(cuda)
    before = label_components_batch.launches
    got = label_components_batch(batch)
    assert label_components_batch.launches == before + 1
    _check_cc_label(batch, got, f"{h}x{w}")


def test_cc_label_unaligned_batch_view(cuda):
    """Batch views whose data_ptr is not 16-byte aligned: frames of an odd
    number of pixels after the first, and a whole batch one byte into its
    storage (every segment of a 960-wide row then starts unaligned)."""
    rng = np.random.default_rng(7)
    for b, h, w in ((4, 37, 45), (3, 33, 129), (2, 70, 960)):
        big = torch.from_numpy(
            (rng.random((b, h, w)) < 0.55).astype(np.uint8)).to(cuda)
        big[0] = torch.from_numpy(_border_lines(h, w))
        view = big[1:]
        assert view.is_contiguous()
        if h * w % 16:
            assert view.data_ptr() % 16
        _check_cc_label(view, label_components_batch(view), f"{h}x{w}[1:]")
        storage = torch.zeros(big.numel() + 1, dtype=torch.uint8,
                              device=cuda)
        shifted = storage[1:].view(b, h, w)
        shifted.copy_(big)
        assert shifted.data_ptr() % 16
        assert torch.equal(label_components_batch(shifted),
                           label_components_batch(big))
        _check_cc_label(big, label_components_batch(big), f"{h}x{w}")


def test_cc_label_runs_across_tile_edges(cuda):
    """Foreground segments across a tile's column edge join into one
    component per row; runs that touch only diagonally stay apart."""
    from scipy import ndimage

    h, w = 2 * TILE_H + 5, 3 * TILE_W
    across = _across_tile_edges(h, w)
    stairs = _stairs(h, w)
    batch = torch.from_numpy(np.stack([across, stairs])).to(cuda)
    got = label_components_batch(batch)
    _check_cc_label(batch, got)
    labels = got.cpu().numpy()
    # a row of the band is one label from one end to the other
    row = TILE_H + 11   # not a cut row (every third)
    assert across[row].sum() == 2 * SEGMENT
    assert len(np.unique(labels[0, row][across[row] == 1])) == 1
    # every run of the stairs is its own component
    _, n_runs = ndimage.label(stairs, structure=[[0, 1, 0], [0, 1, 0],
                                                 [0, 1, 0]])
    assert compact_labels(labels[1])[1] == n_runs
    assert len(np.unique(labels[1])) - 1 == n_runs


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


# --- K4: the batch median of the reconstruction phase's targets

@pytest.mark.parametrize("pattern", ["random", "constant", "stripes"])
@pytest.mark.parametrize("k", [3, 5, 35, 255])
@pytest.mark.parametrize("shape", [(8, 256, 256, 3), (2, 256, 256, 1),
                                   (1, 37, 53, 3)])
def test_median_kernel_equals_native(cuda, shape, k, pattern):
    """Byte for byte ``native.median_u8`` an image at a time; the last
    shape is smaller than most windows, so the replicated border decides."""
    from test_torch_median import crops

    batch = torch.from_numpy(crops(pattern, shape, seed=k))
    before = median_u8_batch.launches
    ours = median_u8_batch(batch.to(cuda), k)
    torch.cuda.synchronize()
    assert median_u8_batch.launches == before + 1
    np.testing.assert_array_equal(ours.cpu().numpy(),
                                  median_u8_plain(batch, k).numpy())


def test_median_kernel_refuses_what_it_does_not_take(cuda):
    crops = torch.zeros(2, 16, 16, 3, dtype=torch.uint8, device=cuda)
    for view in (crops.transpose(1, 2), crops[:, :, ::2]):
        with pytest.raises(ValueError, match="contiguous"):
            median_u8_batch(view, 3)
    with pytest.raises(ValueError, match="odd"):
        median_u8_batch(crops, 4)
    with pytest.raises(TypeError, match="uint8"):
        median_u8_batch(crops.float(), 3)
    with pytest.raises(ValueError, match=r"\[B, H, W, C\]"):
        median_u8_batch(crops[0], 3)


def _training_frames(tmp_path, seed, n_frames, truths=False):
    """PNG files of synthetic board frames at 300x400 (and their ground
    truth)."""
    from lecturemath_tpu_torch.utils.png import encode_png
    from lecturemath_tpu_torch.utils.synthetic import synthetic_rgb_lecture

    rgb, binary, _, _ = synthetic_rgb_lecture(seed=seed, n_frames=n_frames,
                                              height=300, width=400)
    images, gts = [], []
    for k, frame in enumerate(rgb):
        path = tmp_path / f"{k}.png"
        path.write_bytes(encode_png(np.ascontiguousarray(frame[:, :, ::-1])))
        images.append(str(path))
        path = tmp_path / f"{k}_gt.png"
        path.write_bytes(encode_png(np.ascontiguousarray(255 - binary[k])))
        gts.append(str(path))
    return (images, gts) if truths else images


def _card_and_host_epochs(monkeypatch, make):
    """Two epochs of ``batches(8)`` drawn on a prefetch thread, on K5's
    route and on the host's: (data_stats, batches as numpy) of each, and
    the K4 and K5 launches of each."""
    from lecturemath_tpu_torch.train import dataset as dataset_module
    from lecturemath_tpu_torch.train.prefetch import prefetch

    assert dataset_module.median_route() == "cuda"
    runs = {}
    for route in ("cuda", "native"):
        monkeypatch.setattr(dataset_module, "median_route", lambda: route)
        launches = (median_u8_batch.launches, augment_batch.launches)
        dataset = make()
        dataset.preload()
        drawn = [[{key: (value.cpu().numpy()
                         if isinstance(value, torch.Tensor) else value)
                   for key, value in batch.items()}
                  for batch in prefetch(dataset.batches(8), 2)]
                 for _ in range(2)]
        runs[route] = (dataset.data_stats, drawn,
                       (median_u8_batch.launches - launches[0],
                        augment_batch.launches - launches[1]))
    return runs


def _assert_equal_epochs(on_card, on_host):
    for card_epoch, host_epoch in zip(on_card, on_host):
        assert len(card_epoch) == len(host_epoch) == 2
        for a, b in zip(card_epoch, host_epoch):
            assert list(a) == list(b)
            for key in b:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_reconstruction_batches_on_the_card_equal_the_hosts(cuda, tmp_path,
                                                            monkeypatch):
    """A process that sees a card takes the card's route: K5 makes the
    batch's pixels and K4 their medians from K5's crops where they lie.
    Two epochs of ``batches(8)`` from one seed at the recipe's crop and
    k = 35, drawn on a prefetch thread on the card (one K5 and one K4
    launch a batch) and on the host: equal key for key, dtype and
    value."""
    from lecturemath_tpu_torch.train.dataset import LectureNetDataset

    images = _training_frames(tmp_path, 11, 16)
    runs = _card_and_host_epochs(monkeypatch, lambda: LectureNetDataset(
        images, None, reconstruction_mode=True, crop_size=(256, 256),
        flip_chance=0.5, color_invert_chance=0.5, color_change_chance=0.5,
        gaussian_noise_chance=0.5, reconstruct_median=True,
        reconstruct_median_k=35, seed=5))
    card_stats, on_card, card_launches = runs["cuda"]
    host_stats, on_host, host_launches = runs["native"]
    assert card_launches == (4, 4) and host_launches == (0, 0)
    assert (card_stats["median_card"], card_stats["median_host"]) == (32, 0)
    assert (host_stats["median_card"], host_stats["median_host"]) == (0, 32)
    assert (card_stats["pixels_card"], card_stats["pixels_host"]) == (32, 0)
    _assert_equal_epochs(on_card, on_host)


def test_binarizer_batches_on_the_card_equal_the_hosts(cuda, tmp_path,
                                                       monkeypatch):
    """The binarizer phase at the train-bin-b8 recipe (256x256 crops of at
    least a tenth ink, the text mask at e = 15, the weights at w = 1, the
    published augmentation menu with the hue drawn more often): two epochs
    on K5's route, one launch a batch and every sample's pixels on the
    card, equal the host's."""
    from lecturemath_tpu_torch.train.dataset import LectureNetDataset

    images, truths = _training_frames(tmp_path, 12, 16, truths=True)
    runs = _card_and_host_epochs(monkeypatch, lambda: LectureNetDataset(
        images, truths, crop_size=(256, 256), crop_min_fg_prc=0.1,
        flip_chance=0.5, color_invert_chance=0.5, color_change_chance=0.5,
        gaussian_noise_chance=0.2, text_mask_expansion=15,
        weight_expansion=1, seed=9))
    card_stats, on_card, card_launches = runs["cuda"]
    host_stats, on_host, host_launches = runs["native"]
    assert card_launches == (0, 4) and host_launches == (0, 0)
    assert (card_stats["pixels_card"], card_stats["pixels_host"]) == (32, 0)
    assert (host_stats["pixels_card"], host_stats["pixels_host"]) == (0, 32)
    _assert_equal_epochs(on_card, on_host)


# --- K5: the batch's colour chain and targets

_MIXES = [(invert, hue, noisy) for invert in (0, 1) for hue in (0, 1)
          for noisy in (0, 1)]


def _k5_inputs(shape, seed):
    """Board-like crops (bright with dark strokes, some random bytes), a
    ground truth with ink on the crop's edges, every mix of inversion, hue
    and noise over the samples, and the noise rows."""
    batch, height, width = shape
    rng = np.random.default_rng(seed)
    images = np.clip(rng.normal(200, 25, (batch, height, width, 3)), 0,
                     255).astype(np.uint8)
    images[:, height // 4:height // 2] = rng.integers(
        0, 256, (batch, height // 2 - height // 4, width, 3), dtype=np.uint8)
    truths = np.where(rng.random((batch, height, width)) < 0.02, 0,
                      255).astype(np.uint8)
    truths[:, height // 2, :] = 0
    truths[:, 0, ::5] = truths[:, -1, ::3] = 0
    truths[:, ::4, 0] = truths[:, ::7, -1] = 0
    params, row = [], 0
    for k in range(batch):
        invert, hue, noisy = _MIXES[k % len(_MIXES)]
        shift = int((rng.random() * 0.9 - 0.45) * 180.0)
        params.append((invert, hue, shift if hue else 0,
                       row if noisy else -1))
        row += noisy
    noise = rng.standard_normal((row, height, width, 3))
    return (torch.from_numpy(images), torch.from_numpy(np.array(params,
                                                                np.int32)),
            torch.from_numpy(noise), torch.from_numpy(truths))


def _assert_bytes_equal(ours, plain):
    assert sorted(ours) == sorted(plain)
    for key, value in plain.items():
        got = ours[key].cpu()
        assert got.dtype == value.dtype, key
        np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                      value.numpy().view(np.uint8),
                                      err_msg=key)


@pytest.mark.parametrize("shape,mask,weight", [
    ((8, 256, 256), 15, 1),    # the main path: 16-pixel groups
    ((16, 256, 256), 15, 1),   # every mix twice
    ((8, 37, 53), 15, 1),      # a pixel a thread; narrower than the ellipse
    ((3, 100, 70), 3, 2),
    ((2, 64, 96), 0, 64),
])
def test_augment_kernel_equals_plain(cuda, shape, mask, weight):
    """K5 on the card equals its plain version byte for byte, every output
    and every mix of inversion, hue and noise, with one launch a call."""
    images, params, noise, truths = _k5_inputs(shape, seed=sum(shape))
    options = dict(target=True, text_mask_expansion=mask,
                   weight_expansion=weight, weight_fg_extra=1.5,
                   keep_crops=True)
    plain = augment_batch(images, params, noise, 5.0, truths, **options)
    before = augment_batch.launches
    ours = augment_batch(images.to(cuda), params.to(cuda), noise.to(cuda),
                         5.0, truths.to(cuda), **options)
    torch.cuda.synchronize()
    assert augment_batch.launches == before + 1
    _assert_bytes_equal(ours, plain)


def test_augment_kernel_without_ground_truth_or_alignment(cuda):
    """No ground truth (the reconstruction phase): the image and crops
    only. Crops that start off a 16-byte boundary take the pixel-a-thread
    path and give the same bytes."""
    images, params, noise, _ = _k5_inputs((8, 64, 128), seed=3)
    plain = augment_batch(images, params, noise, 5.0, keep_crops=True)
    ours = augment_batch(images.to(cuda), params.to(cuda), noise.to(cuda),
                         5.0, keep_crops=True)
    _assert_bytes_equal(ours, plain)
    flat = torch.zeros(images.numel() + 3, dtype=torch.uint8, device=cuda)
    shifted = flat[3:].view(images.shape)
    shifted.copy_(images.to(cuda))
    ours = augment_batch(shifted, params.to(cuda), noise.to(cuda), 5.0,
                         keep_crops=True)
    _assert_bytes_equal(ours, plain)


def test_augment_kernel_refuses_an_erosion_past_its_halo(cuda):
    images, params, noise, truths = _k5_inputs((2, 32, 64), seed=5)
    with pytest.raises(ValueError, match="at most 64"):
        augment_batch(images.to(cuda), params.to(cuda), noise.to(cuda), 5.0,
                      truths.to(cuda), text_mask_expansion=65)


def test_median_from_augmented_crops_on_the_card(cuda):
    """K4 fed K5's crops where they lie (the reconstruction batch's route)
    equals ``native.median_u8`` on the host's augmented crops, as float32
    m / 127.5 - 1."""
    from lecturemath_tpu_torch import native

    images, params, noise, _ = _k5_inputs((8, 256, 256), seed=4)
    crops = augment_batch(images, params, noise, 5.0,
                          keep_crops=True)["crops"].numpy()
    on_card = augment_batch(images.to(cuda), params.to(cuda),
                            noise.to(cuda), 5.0, keep_crops=True)["crops"]
    median = median_unit_batch(on_card, 35).cpu().numpy()
    want = np.stack([native.median_u8(crop, 35) for crop in crops])
    np.testing.assert_array_equal(
        median.view(np.uint32),
        (want.astype(np.float32) / 127.5 - 1.0).view(np.uint32))


# --- K2 with the model's cached packed weights, and the serving path: one
# CUDA graph per batch bucket holding K2's four launches and K1's one

def test_conv_same_nhwc_takes_cached_packed_weights(cuda):
    from lecturemath_tpu_torch.ops.conv7 import n_tiles, pack_weights

    gen = torch.Generator(device=cuda).manual_seed(7)
    x = _bf16_nhwc((2, 3, 40, 56), gen, cuda)
    x2 = _bf16_nhwc((2, 16, 40, 56), gen, cuda)
    weight = (torch.randn(8, 19, 7, 7, device=cuda, generator=gen)
              * 0.05).to(torch.bfloat16)
    bias = torch.randn(8, device=cuda, generator=gen)
    packed = pack_weights(weight, 3, 16, n_tiles(8))
    got = conv_same_nhwc(x, weight, bias, "gelu", torch.float32, x2,
                         packed=packed)
    ref = conv_same_nhwc(x, weight, bias, "gelu", torch.float32, x2)
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="packed weights"):
        conv_same_nhwc(x, weight, bias, "gelu", torch.float32, x2,
                       packed=packed.float())


def _serving_binarizer(cuda, threshold_gray=130.0):
    from lecturemath_tpu_torch.models.fcn_lecturenet import (FCNConfig,
                                                             FCNLectureNet)
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer
    from lecturemath_tpu_torch.utils.synthetic import \
        threshold_binarizer_variables

    cfg = FCNConfig(down_filters=(8, 8, 16, 16, 32), mid_filters=32,
                    upsample_filters=(8, 8, 16, 16, 32),
                    up_filters=(8, 8, 16, 16, 32), pixel_features=(32, 16),
                    kernel_size=3, pixel_kernel_size=7)
    model = FCNLectureNet(cfg)
    model.load_state_dict(threshold_binarizer_variables(
        cfg, threshold_gray=threshold_gray))
    return Binarizer(model, device=cuda, dtype=torch.bfloat16,
                     upload_format="rgb")


def _serving_frames(n, height=64, width=96, seed=0):
    rng = np.random.default_rng(seed)
    frames = np.clip(rng.normal(215, 10, (n, height, width, 3)), 0,
                     255).astype(np.uint8)
    for k in range(n):
        y, x = rng.integers(0, height - 12), rng.integers(0, width - 30)
        frames[k, y:y + 10, x:x + 28] = 25
    return frames


def test_serving_graph_equals_eager_for_every_bucket(cuda):
    from lecturemath_tpu_torch.pipeline.server import BinarizeService

    service = BinarizeService(_serving_binarizer(cuda), model_size=(96, 64),
                              max_batch=4, batch_window_ms=1.0)
    try:
        active = service._active
        assert active.graphs_enabled
        assert sorted(active.graphs) == service.batch_buckets == [1, 2, 4]
        frames = _serving_frames(4)
        for bucket, graph in active.graphs.items():
            # K2's four head convs and K1 in every graph
            assert graph.launches == {"threshold_pack": 1,
                                      "conv_same_nhwc": 4}
            with active.stream_context():
                ours = graph.run(frames[:bucket]).clone()
            eager = active.binarizer.packed_fn(
                torch.from_numpy(frames[:bucket]).to(cuda))
            torch.cuda.synchronize()
            assert torch.equal(ours, eager), bucket
    finally:
        service.close()


def test_serving_round_trip_on_the_card(cuda):
    """binarize_rgb from several threads at several sizes: each answer
    equals a direct binarization of its frame (a lone request rides bucket
    1), and the replays are counted."""
    import threading

    from lecturemath_tpu_torch.models.fcn_lecturenet import unpack_bits_host
    from lecturemath_tpu_torch.pipeline.server import BinarizeService
    from lecturemath_tpu_torch.utils.image import resize_area, resize_nearest

    service = BinarizeService(_serving_binarizer(cuda), model_size=(96, 64),
                              max_batch=4, batch_window_ms=1.0)
    binarizer = service._active.binarizer

    def direct(frame):
        resized = resize_area(frame, (96, 64))
        bits = binarizer.packed_fn(torch.from_numpy(resized[None]).to(cuda))
        binary = unpack_bits_host(bits.cpu().numpy(), 96)[0]
        return resize_nearest(binary, (frame.shape[1], frame.shape[0]))

    try:
        for height, width in ((64, 96), (128, 192), (80, 120), (40, 60)):
            frame = _serving_frames(1, height, width, seed=height)[0]
            np.testing.assert_array_equal(service.binarize_rgb(frame),
                                          direct(frame))
        results = []
        threads = [threading.Thread(target=lambda k=k: results.append(
            service.binarize_rgb(_serving_frames(1, seed=k)[0])))
            for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert len(results) == 8
        stats = service.stats()
        assert stats["graph_replays"] > 0
        assert stats["kernel_launches"]["conv_same_nhwc"] == \
            4 * stats["graph_replays"]
        assert stats["kernel_launches"]["threshold_pack"] == \
            stats["graph_replays"]
    finally:
        service.close()


def test_serving_reload_with_graphs(cuda, tmp_path):
    from lecturemath_tpu_torch.pipeline.server import BinarizeService

    def factory(checkpoint=None):
        return _serving_binarizer(cuda, 130.0 if checkpoint is None else 5.0)

    service = BinarizeService(factory(), model_size=(96, 64), max_batch=2,
                              batch_window_ms=1.0,
                              binarizer_factory=factory)
    try:
        frame = _serving_frames(1)[0]
        before = service.binarize_rgb(frame)
        assert (before == 0).any()
        old_pool = service._active.pool
        service.reload_checkpoint("blind")
        assert service._active.pool != old_pool
        assert sorted(service._active.graphs) == [1, 2]
        after = service.binarize_rgb(frame)
        assert (after == 255).all()
    finally:
        service.close()


def test_backend_probe_and_bounded_fetch_on_the_card(cuda):
    from lecturemath_tpu_torch.core.backend_probe import ensure_backend

    ensure_backend(timeout_s=60)
    binarizer = _serving_binarizer(cuda)
    tensor = torch.arange(12, dtype=torch.uint8, device=cuda).reshape(3, 4)
    np.testing.assert_array_equal(binarizer.fetch(tensor),
                                  np.arange(12, dtype=np.uint8).reshape(3, 4))


# --- training on the card: K2 stays out of every forward that carries
# gradients, its packs follow in-place updates, and a run_phase writes a
# .msgpack that reads back equal

def _training_config():
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig

    return FCNConfig(down_filters=(8, 8, 16, 16, 32), mid_filters=32,
                     upsample_filters=(8, 8, 16, 16, 32),
                     up_filters=(8, 8, 16, 16, 32), pixel_features=(32, 16),
                     kernel_size=3, pixel_kernel_size=7)


def _training_model(compute_dtype=None):
    from lecturemath_tpu_torch.models.fcn_lecturenet import (FCNLectureNet,
                                                             init_weights)

    return init_weights(FCNLectureNet(_training_config(),
                                      compute_dtype=compute_dtype),
                        torch.Generator().manual_seed(0))


def _training_batch(seed=0, size=64):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(-1, 1, (2, 3, size, size)),
            "target": rng.random((2, 1, size, size)) < 0.5,
            "text_mask": rng.random((2, 1, size, size)) < 0.5,
            "median": rng.uniform(-1, 1, (2, 3, size, size))}


def test_conv_same_nhwc_raises_under_grad(cuda):
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = _bf16_nhwc((1, 3, 16, 24), gen, cuda)
    weight = (torch.randn(4, 3, 7, 7, device=cuda, generator=gen)
              * 0.1).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        conv_same_nhwc(x, weight)
    with pytest.raises(RuntimeError, match="no backward"):
        conv_same_nhwc(x.clone().requires_grad_(), weight.detach())
    with torch.no_grad():
        assert conv_same_nhwc(x, weight).shape == (1, 4, 16, 24)


def test_training_head_gradients_equal_a_conv2d_model(cuda):
    """A text-detector step's head gradients on the card equal those of the
    same model on the CPU, whose heads are F.conv2d, in fp32; K2 is not
    launched."""
    from lecturemath_tpu_torch.train.losses import phase_losses

    batch = {key: torch.from_numpy(np.asarray(value, np.float32))
             for key, value in _training_batch().items()}
    grads = {}
    for key, device in (("cpu", "cpu"), ("card", cuda)):
        model = _training_model().to(device,
                                     memory_format=torch.channels_last)
        launches = conv_same_nhwc.launches
        on_device = {key: value.to(device) for key, value in batch.items()}
        outputs = model(on_device["image"].contiguous(
            memory_format=torch.channels_last))
        sum(phase_losses("text_detector", outputs,
                         on_device).values()).backward()
        assert conv_same_nhwc.launches == launches
        grads[key] = {name: param.grad.cpu() for name, param
                      in model.named_parameters()}
    heads = [name for name in grads["cpu"] if name.startswith(
        ("conv_pixels_", "conv_out.", "conv_text_mask_out."))]
    assert len(heads) == 16
    scale = max(grads["cpu"][name].abs().max().item() for name in heads)
    for name in heads:
        if name.endswith(".0.weight"):
            assert grads["cpu"][name].abs().max() > 0, name
        torch.testing.assert_close(grads["card"][name], grads["cpu"][name],
                                   rtol=1e-4, atol=1e-5 * scale)


def test_head_packs_refresh_after_optimizer_step(cuda):
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNLectureNet
    from lecturemath_tpu_torch.ops.conv7 import n_tiles, pack_weights

    model = _training_model(torch.bfloat16).to(
        cuda, memory_format=torch.channels_last)
    x = torch.from_numpy(_training_batch()["image"].astype(np.float32)).to(
        cuda).contiguous(memory_format=torch.channels_last)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.5)

    def infer(net):
        net.eval()
        with torch.no_grad():
            return net(x)[0]

    infer(model)
    before = {name: pack[1][0].clone()
              for name, pack in model._head_packs.items()}
    model.train()
    model(x)[0].float().square().mean().backward()
    optimizer.step()
    launches = conv_same_nhwc.launches
    after = infer(model)
    assert conv_same_nhwc.launches == launches + 4
    for name, (c1, c2) in model.head_inputs().items():
        weight = getattr(model, name)[0].weight
        used = model._head_packs[name][1][0]
        assert torch.equal(used, pack_weights(weight, c1, c2,
                                              n_tiles(weight.shape[0])))
        assert not torch.equal(used, before[name]), name
    fresh = FCNLectureNet(_training_config(), compute_dtype=torch.bfloat16)
    fresh.load_state_dict(model.state_dict())
    expected = infer(fresh.to(cuda, memory_format=torch.channels_last))
    torch.testing.assert_close(after, expected, rtol=0,
                               atol=2.0 ** -8 * expected.abs().max().item())


def test_run_phase_on_the_card_writes_a_msgpack_the_cpu_reads(cuda,
                                                             tmp_path):
    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.models.convert import load_checkpoint
    from lecturemath_tpu_torch.train.dataset import LectureNetDataset
    from lecturemath_tpu_torch.train.trainer import run_phase
    from lecturemath_tpu_torch.utils.png import encode_png

    rng = np.random.default_rng(3)
    images = []
    for k in range(4):
        path = tmp_path / f"{k}.png"
        path.write_bytes(encode_png(rng.integers(0, 256, (48, 64, 3),
                                                 np.uint8)))
        images.append(str(path))
    cfg = _training_config()
    widths = {"DOWN_CONV_FILTERS": cfg.down_filters,
              "UPSAMPLE_FILTERS": cfg.upsample_filters,
              "UP_CONV_FILTERS": cfg.up_filters}
    lines = [f"FCN_BINARIZER_NET_{key}_{i} = {v}"
             for key, values in widths.items()
             for i, v in enumerate(values, 1)]
    out = tmp_path / "rec.msgpack"
    lines += ["FCN_BINARIZER_NET_MIDDLE_CONV_FILTERS_MIDDLE = 32",
              "FCN_BINARIZER_NET_PIXEL_FEATURES_1 = 32",
              "FCN_BINARIZER_NET_PIXEL_FEATURES_2 = 16",
              "FCN_BINARIZER_NET_PIXEL_KERNEL_SIZE = 7",
              "FCN_BINARIZER_PRETRAIN_REC_EPOCHS = 2",
              "FCN_BINARIZER_PRETRAIN_BATCH_SIZE = 2",
              f"FCN_BINARIZER_PRETRAIN_RECONSTRUCTION_OUTPUT = {out}"]
    conf = tmp_path / "train.conf"
    conf.write_text("\n".join(lines))
    config = Config.from_file(str(conf))
    dataset = LectureNetDataset(images, None, reconstruction_mode=True,
                                crop_size=(32, 32), reconstruct_median=True,
                                reconstruct_median_k=5)
    assert run_phase(config, "reconstruction", dataset, verbose=False,
                     device=cuda) == str(out)
    # the resume file holds the same epoch's model as a torch state dict
    trained = torch.load(f"{out}.resume", map_location="cpu",
                         weights_only=True)["model"]
    read = load_checkpoint(str(out))
    assert set(read) == set(trained)
    for key, value in read.items():
        if not key.endswith("num_batches_tracked"):  # not in the format
            assert torch.equal(value, trained[key]), key


# ------------------------------------------------------------ evaluation

# the serving tests' narrow widths with the production pixel kernel (k=7)
EVAL_WIDTHS = {
    **{f"FCN_BINARIZER_NET_{kind}_{i}": w
       for kind in ("DOWN_CONV_FILTERS", "UPSAMPLE_FILTERS",
                    "UP_CONV_FILTERS")
       for i, w in enumerate((8, 8, 16, 16, 32), 1)},
    "FCN_BINARIZER_NET_MIDDLE_CONV_FILTERS_MIDDLE": 32,
    "FCN_BINARIZER_NET_PIXEL_FEATURES_1": 32,
    "FCN_BINARIZER_NET_PIXEL_FEATURES_2": 16,
    "FCN_BINARIZER_NET_PIXEL_KERNEL_SIZE": 7,
    "FCN_BINARIZER_NET_KERNEL_SIZE": 3,
}
# keyframe pixels that may differ between the bf16 kernel path and plain f32
MAX_FLIP_RATE = 0.01


def _eval_workspace(tmp_path):
    """The keyframe-bin GT tree at EVAL_WIDTHS with a threshold checkpoint,
    and 4 PNG image/mask pairs for the text-detector evaluation."""
    from _torch_eval_tree import keyframe_bin_tree, write_png
    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.models.convert import save_checkpoint
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig
    from lecturemath_tpu_torch.utils.synthetic import (
        synthetic_rgb_lecture, threshold_binarizer_variables)

    root = str(tmp_path)
    conf = keyframe_bin_tree(root, EVAL_WIDTHS)
    with open(conf, "a") as f:
        f.write(f"FCN_BINARIZER_PRETRAIN_EVAL_IMAGES_DIR = {root}/td/images\n"
                f"FCN_BINARIZER_PRETRAIN_EVAL_MASKS_DIR = {root}/td/masks\n")
    config = Config.from_file(conf)
    net_config = FCNConfig.from_config(config)
    model = str(tmp_path / "threshold.dat")
    save_checkpoint(threshold_binarizer_variables(net_config), model)
    rgb, binary, _, _ = synthetic_rgb_lecture(seed=7, n_frames=4, height=48,
                                              width=64, glyphs_per_board=4,
                                              glyph_size=(10, 12))
    for k in range(4):
        write_png(f"{root}/td/images/p{k}.png", rgb[k][:, :, ::-1])
        write_png(f"{root}/td/masks/p{k}.png", binary[k])
    return conf, config, net_config, model


def test_keyframe_binarization_within_flip_bound_of_plain_f32(cuda,
                                                              tmp_path):
    """The GT keyframes binarized on the card in bf16 (K2 on the heads)
    against the plain f32 model on the card."""
    from lecturemath_tpu_torch.core.metadata import MetaDataDB
    from lecturemath_tpu_torch.eval.keyframe_bin import binarize_keyframes
    from lecturemath_tpu_torch.eval.summary_eval import \
        load_dataset_keyframes
    from lecturemath_tpu_torch.models.convert import load_checkpoint
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNLectureNet
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer

    conf, config, net_config, model = _eval_workspace(tmp_path)
    database = MetaDataDB.from_file(config.get_str("VIDEO_DATABASE_PATH"))
    _, kernel_kfs = load_dataset_keyframes(config.get_str("OUTPUT_PATH"),
                                           database)
    _, plain_kfs = load_dataset_keyframes(config.get_str("OUTPUT_PATH"),
                                          database)
    kernel = FCNLectureNet(net_config)
    kernel.load_state_dict(load_checkpoint(model))
    plain = FCNLectureNet(net_config, plain=True)
    plain.load_state_dict(load_checkpoint(model))
    before = conv_same_nhwc.launches
    binarize_keyframes(Binarizer(kernel, device=cuda, dtype=torch.bfloat16),
                       kernel_kfs)
    assert conv_same_nhwc.launches > before
    binarize_keyframes(Binarizer(plain, device=cuda, dtype=torch.float32),
                       plain_kfs)
    flips = sum(int((a.binary_image != b.binary_image).sum())
                for a, b in zip(kernel_kfs, plain_kfs))
    pixels = sum(kf.binary_image.size for kf in kernel_kfs)
    assert flips <= MAX_FLIP_RATE * pixels
    assert all((kf.binary_image == 0).any() for kf in kernel_kfs)


def test_evaluate_keyframe_binarization_launches_k2(cuda, tmp_path):
    from lecturemath_tpu_torch.eval.keyframe_bin import \
        evaluate_keyframe_binarization

    conf, config, _, model = _eval_workspace(tmp_path)
    before = conv_same_nhwc.launches
    scope_metrics, scopes, pixel = evaluate_keyframe_binarization(
        config, model, "training", save_binaries=False)
    # four head convs a batch, two resolution buckets
    assert conv_same_nhwc.launches - before >= 8
    assert "all" in scopes
    for key in ("recall", "precision", "fmeasure"):
        assert 0.0 <= pixel[key] <= 1.0, key
    # the board variants drop the ink on the objects from the denominator
    # only (as the JAX package computes them), so they may pass 1
    assert pixel["board_precision"] >= pixel["precision"]
    assert np.isfinite(pixel["board_fmeasure"])
    assert pixel["recall"] > 0.5


def test_eval_text_detector_cli_on_the_card(cuda, tmp_path, capsys):
    from lecturemath_tpu_torch.cli import eval_text_detector

    conf, _, _, model = _eval_workspace(tmp_path)
    before = conv_same_nhwc.launches
    eval_text_detector.main(["eval_text_detector", conf, model])
    out = capsys.readouterr().out
    assert conv_same_nhwc.launches - before == 4 * 4  # 4 images, 4 heads
    assert out.count("Processing:") == 4 and "Pixel" in out


# ------------------------------------------------------------- scale-out

def _one_card_mesh():
    from lecturemath_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    return make_mesh(MeshSpec(1, 1))


def test_one_card_mesh_binarizer_equals_meshless(cuda):
    """A 1x1 mesh on the card: the stream's frames and binarize_frames are
    the meshless Binarizer's bit for bit, through K2 and K1."""
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer
    from lecturemath_tpu_torch.pipeline.video import ArraySource

    plain = _serving_binarizer(cuda)
    mesh = Binarizer(plain.model, mesh=_one_card_mesh(), batch_size=4,
                     upload_format="rgb")
    assert mesh.device == torch.device("cuda", 0)
    assert mesh.mesh.local_devices == (torch.device("cuda", 0),)
    frames = _serving_frames(7)
    plain.batch_size = 4
    before = (threshold_pack.launches, conv_same_nhwc.launches)
    _, _, ours = mesh.process_source(ArraySource(frames))
    assert threshold_pack.launches - before[0] == 2       # 2 batches
    assert conv_same_nhwc.launches - before[1] == 8       # 4 heads each
    _, _, theirs = plain.process_source(ArraySource(frames))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mesh.binarize_frames(frames[:3]),
                                  plain.binarize_frames(frames[:3]))


def test_sharded_binarizer_on_the_card(cuda):
    from lecturemath_tpu_torch.models.fcn_lecturenet import (
        make_packed_binarizer, unpack_bits_host)
    from lecturemath_tpu_torch.parallel.inference import ShardedBinarizer

    model = _serving_binarizer(cuda).model
    sharded = ShardedBinarizer(model, _one_card_mesh())
    frames = _serving_frames(5)
    before = threshold_pack.launches
    got = sharded.binarize_frames(frames)
    assert threshold_pack.launches == before + 1
    expected = unpack_bits_host(make_packed_binarizer(model)(
        torch.from_numpy(frames).to(cuda)).cpu().numpy(), 96)
    np.testing.assert_array_equal(got, expected)


def test_one_rank_nccl_training_equals_meshless(cuda, monkeypatch):
    """3 fp32 steps (TF32 off) with weighted losses and a live BN in a
    one-rank NCCL world joined under the LM_* contract: the cross-replica
    BN and the gradient all-reduce give the meshless Trainer's losses and
    running statistics within rtol 1e-5."""
    from lecturemath_tpu_torch.parallel.launch import free_port
    from lecturemath_tpu_torch.parallel.mesh import (
        MeshSpec, initialize_distributed_from_env, make_mesh,
        shutdown_distributed, warmup_collectives)
    from lecturemath_tpu_torch.train.trainer import Trainer

    batch = _training_batch(size=64)
    batch = {key: np.ascontiguousarray(
        np.moveaxis(value, 1, -1).astype(np.float32))
        for key, value in batch.items()}
    batch["weights"] = np.random.default_rng(1).uniform(
        0, 2, batch["target"].shape).astype(np.float32)

    def three_steps(mesh):
        trainer = Trainer(_training_model(), 0.05, phase="binarizer",
                          use_weights=True, clip_norm=1.0, prefetch_depth=0,
                          device=None if mesh else cuda, mesh=mesh)
        losses = [trainer.step(batch)["total"].item() for _ in range(3)]
        return losses, trainer.model.state_dict()

    plain_losses, plain_state = three_steps(None)
    monkeypatch.setenv("LM_COORDINATOR", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("LM_NUM_PROCESSES", "1")
    monkeypatch.setenv("LM_PROCESS_ID", "0")
    try:
        assert initialize_distributed_from_env()
        mesh = make_mesh(MeshSpec(1, 1))
        warmup_collectives(mesh)
        mesh_losses, mesh_state = three_steps(mesh)
    finally:
        shutdown_distributed()
    np.testing.assert_allclose(mesh_losses, plain_losses, rtol=1e-5)
    for key, value in plain_state.items():
        if "running" in key:
            torch.testing.assert_close(mesh_state[key], value, rtol=1e-5,
                                       atol=1e-6)


def test_step_graphs_equal_the_eager_steps(cuda):
    """The text-detector step with the frozen BN folded, replayed as CUDA
    graphs (captured on the second step, captured again when the crop
    size changes), gives the eager steps' losses and parameters over 6
    steps with momentum, within rtol 1e-5: the same kernels, whose
    float32 sums cuDNN may take in another order between runs."""
    from lecturemath_tpu_torch.train.trainer import Trainer

    def batch(seed, size):
        raw = _training_batch(seed, size)
        return {key: np.ascontiguousarray(
            np.moveaxis(value, 1, -1).astype(np.float32))
            for key, value in raw.items()}

    batches = [batch(k, 64) for k in range(4)] + [batch(k, 32)
                                                  for k in (4, 5)]

    def steps(graphs):
        model = _training_model()
        gen = torch.Generator().manual_seed(1)
        for module in model.modules():
            if isinstance(module, torch.nn.BatchNorm2d):
                module.running_mean.uniform_(-0.2, 0.2, generator=gen)
                module.running_var.uniform_(0.5, 1.5, generator=gen)
        trainer = Trainer(model, 0.05, momentum=0.9, phase="text_detector",
                          freeze_bn=True, fold_frozen_bn=True,
                          prefetch_depth=0, device=cuda)
        if not graphs:
            trainer._graphs = False
        losses, captured = [], []
        for b in batches:
            metrics = trainer.step(b)
            losses.append({k: v.item() for k, v in metrics.items()})
            captured.append(bool(trainer._graphs))
        return losses, trainer.model.state_dict(), captured

    eager_losses, eager_state, eager_captured = steps(False)
    graph_losses, graph_state, graph_captured = steps(True)
    assert not any(eager_captured)
    assert graph_captured == [False, True, True, True, True, True]
    assert eager_losses[0].keys() == {"text_bce", "bin_bce", "rec_mse",
                                      "total"}
    for got, want in zip(graph_losses, eager_losses):
        np.testing.assert_allclose([got[k] for k in want],
                                   list(want.values()), rtol=1e-5)
    for key, value in eager_state.items():
        torch.testing.assert_close(graph_state[key], value, rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------- device worker and device ops

_WORKER_WIDTHS = {"DOWN_CONV_FILTERS": (8, 8, 16, 16, 32),
                  "UPSAMPLE_FILTERS": (8, 8, 16, 16, 32),
                  "UP_CONV_FILTERS": (8, 8, 16, 16, 32)}


def _worker_config(tmp_path):
    """The serving test's widths and threshold heads, as a config whose
    checkpoint (.dat) the worker's child loads."""
    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.models.convert import save_checkpoint
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig
    from lecturemath_tpu_torch.utils.synthetic import \
        threshold_binarizer_variables

    values = {f"FCN_BINARIZER_NET_{key}_{i}": v
              for key, widths in _WORKER_WIDTHS.items()
              for i, v in enumerate(widths, 1)}
    values.update({"FCN_BINARIZER_NET_MIDDLE_CONV_FILTERS_MIDDLE": 32,
                   "FCN_BINARIZER_NET_PIXEL_FEATURES_1": 32,
                   "FCN_BINARIZER_NET_PIXEL_FEATURES_2": 16,
                   "FCN_BINARIZER_NET_KERNEL_SIZE": 3,
                   "FCN_BINARIZER_NET_PIXEL_KERNEL_SIZE": 7,
                   "BINARIZATION_FCN_LECTURENET_DIR": str(tmp_path),
                   "BINARIZATION_FCN_LECTURENET_FILENAME": "worker.dat",
                   "UPLOAD_FORMAT": "rgb",
                   "DEVICE_WORKER_COMPILE_CACHE": str(tmp_path / "cache")})
    config = Config(values)
    save_checkpoint(threshold_binarizer_variables(
        FCNConfig.from_config(config)), str(tmp_path / "worker.dat"))
    return config


def _free_bytes(cuda):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info(cuda)[0]


def test_worker_on_the_card_equals_inprocess(cuda, tmp_path):
    """The child builds the Binarizer on the card and runs K2 and K1 there
    (the parent's counters see none of it; the done messages carry the
    child's); its frames are the in-process Binarizer's bit for bit."""
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer
    from lecturemath_tpu_torch.pipeline.device_worker import WorkerBinarizer
    from lecturemath_tpu_torch.pipeline.video import ArraySource

    config = _worker_config(tmp_path)
    frames = _serving_frames(10)
    plain = Binarizer.from_config(config, batch_size=4)
    _, _, theirs = plain.process_source(ArraySource(frames))
    before = (threshold_pack.launches, conv_same_nhwc.launches)
    worker = WorkerBinarizer.from_config(config, recycle_mb=1.0,
                                         chunk_frames=4,
                                         binarizer_kwargs={"batch_size": 4})
    try:
        _, _, ours = worker.process_source(ArraySource(frames))
    finally:
        worker.close()
    assert (threshold_pack.launches, conv_same_nhwc.launches) == before
    assert worker.recycles >= 1
    assert worker.launches["threshold_pack"] >= 3
    assert worker.launches["conv_same_nhwc"] == \
        4 * worker.launches["threshold_pack"]
    assert len(ours) == len(theirs) == 10
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_recycled_children_free_their_card_memory(cuda, tmp_path):
    """At most the active child and its spare hold card memory: the
    recycled ones give theirs back, and after close() all of it is free."""
    from lecturemath_tpu_torch.pipeline.device_worker import WorkerBinarizer
    from lecturemath_tpu_torch.pipeline.video import ArraySource

    config = _worker_config(tmp_path)
    frames = _serving_frames(8)
    free_before = _free_bytes(cuda)
    worker = WorkerBinarizer.from_config(config, chunk_frames=4,
                                         binarizer_kwargs={"batch_size": 4})
    try:
        worker.process_source(ArraySource(frames[:1]))   # one child, warm
        one_child = free_before - _free_bytes(cuda)
        assert one_child > 0
        # a 1 MB budget: every stream ends with a recycle of its child
        worker.recycle_mb = 1.0
        for _ in range(3):
            _, _, out = worker.process_source(ArraySource(frames))
            assert len(out) == 8
        assert worker.recycles >= 3
        held = free_before - _free_bytes(cuda)
        assert held <= 2.5 * one_child, (held, one_child)
    finally:
        worker.close()
    deadline = time.monotonic() + 30
    while (free_before - _free_bytes(cuda) > 64 << 20
           and time.monotonic() < deadline):
        time.sleep(0.5)
    assert free_before - _free_bytes(cuda) <= 64 << 20


def _mod256(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return np.minimum(d, 256 - d)


@pytest.mark.parametrize("grid", [(8, 8), (48, 27)])
def test_clahe_batch_on_the_card_equals_cpu(cuda, grid):
    from lecturemath_tpu_torch.ops.clahe import clahe_batch

    rng = np.random.default_rng(0)
    gray = np.clip(rng.normal(200, 8, (4, 270, 480)), 0, 255)
    gray[rng.random(gray.shape) < 0.05] = 40
    gray = gray.astype(np.uint8)
    ours = clahe_batch(torch.from_numpy(gray).to(cuda), 0.04, *grid)
    assert ours.device.type == "cuda" and ours.dtype == torch.uint8
    ours = ours.cpu().numpy()
    cpu = clahe_batch(gray, 0.04, *grid, device="cpu").numpy()
    d = _mod256(ours, cpu)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_motion_stats_on_the_card_equals_cpu(cuda):
    from lecturemath_tpu_torch.ops.frame_diff import motion_stats

    rng = np.random.default_rng(2)
    last = rng.integers(0, 256, (270, 480, 3), dtype=np.uint8)
    frame = last.copy()
    frame[40:120, 100:300] = rng.integers(0, 256, (80, 200, 3),
                                          dtype=np.uint8)
    for jump in (1, 3):
        ours = motion_stats(torch.from_numpy(frame).to(cuda),
                            torch.from_numpy(last).to(cuda), 15, jump)
        theirs = motion_stats(frame, last, 15, jump, device="cpu")
        assert ours.bbox.device.type == "cuda"
        assert int(ours.total_changes) == int(theirs.total_changes) > 0
        np.testing.assert_array_equal(ours.bbox.cpu().numpy(),
                                      theirs.bbox.numpy())
        for a, b in ((ours.centroid, theirs.centroid),
                     (ours.deviation, theirs.deviation)):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-5)


def test_ckmeans_on_the_card_equals_cpu(cuda):
    from lecturemath_tpu_torch.ops.ckmeans import ConvolutionalKMeans

    rng = np.random.default_rng(3)
    means = rng.normal(0, 1, (16, 32))
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    data = (means[rng.integers(0, 16, 8192)]
            + rng.normal(0, 0.05, (8192, 32))).astype(np.float32)
    ours = ConvolutionalKMeans(data, 16, init_vectors=means, device=cuda)
    theirs = ConvolutionalKMeans(data, 16, init_vectors=means, device="cpu")
    assert ours.centers.device.type == "cuda"
    for _ in range(10):
        assert ours.update() == pytest.approx(theirs.update(), rel=1e-5)
    np.testing.assert_allclose(ours.centers.cpu().numpy(),
                               theirs.centers.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ours.assign(data), theirs.assign(data))


def test_export_binary_video_from_a_card_artifact(cuda, tmp_path,
                                                  monkeypatch):
    """The stage-01 artifact of frames the card binarized (K2 and K1), as
    stage01_binarize relays it, rendered by export_binary_video: every
    sampled frame's PNG (kept by making removal a no-op) is the artifact's
    binary in every channel. The video itself needs ffmpeg or OpenCV; the
    frames need neither."""
    import importlib.util
    import os
    import shutil

    from lecturemath_tpu_torch.core.artifacts import ArtifactStore
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer
    from lecturemath_tpu_torch.pipeline.export_video import \
        export_binary_video
    from lecturemath_tpu_torch.pipeline.video import (ArraySource,
                                                      compress_png,
                                                      decompress_png)
    from lecturemath_tpu_torch.utils.png import read_image

    binarizer = Binarizer.from_config(_worker_config(tmp_path), batch_size=4)
    assert binarizer.device.type == "cuda"
    before = (threshold_pack.launches, conv_same_nhwc.launches)
    times, indices, binaries = binarizer.process_source(
        ArraySource(_serving_frames(10)))
    assert threshold_pack.launches > before[0]
    assert conv_same_nhwc.launches > before[1]
    store = ArtifactStore(str(tmp_path / "temporal"))
    store.save((times, indices, compress_png(binaries)), "tempo_binary_",
               "lec")
    lecture = type("Lecture", (), {"id": "lec"})()
    out = str(tmp_path / "lec.mp4")
    monkeypatch.setattr(os, "remove", lambda path: None)
    if shutil.which("ffmpeg") or importlib.util.find_spec("cv2"):
        assert export_binary_video(store, "tempo_binary_", lecture, [], out,
                                   fps=30.0) == out
    else:
        with pytest.raises(ImportError):
            export_binary_video(store, "tempo_binary_", lecture, [], out,
                                fps=30.0)
    _, saved_indices, compressed = store.load("tempo_binary_", "lec")
    assert list(saved_indices) == list(indices)
    for idx, binary in zip(saved_indices, decompress_png(compressed)):
        rendered = read_image(str(tmp_path / "lec.mp4_frames" / f"{idx}.png"))
        np.testing.assert_array_equal(
            rendered, np.repeat(binary[:, :, None], 3, axis=2))


# --------------------------------------------------------- the model axis

def _axis_models(cuda):
    """Seeded xavier-normal weights (heads included) at small widths with
    pixel kernel 7 and pixel features 16, 8; BN folded, bf16 on the card,
    twice (a ShardedBinarizer moves the model it is given)."""
    from lecturemath_tpu_torch.models.fcn_lecturenet import (
        FCNConfig, FCNLectureNet, fold_model, init_weights)

    cfg = FCNConfig(down_filters=(8, 16, 16, 32, 32), mid_filters=32,
                    upsample_filters=(16, 16, 16, 32, 32),
                    up_filters=(16, 16, 16, 32, 32), pixel_features=(16, 8),
                    kernel_size=3, pixel_kernel_size=7)
    model = init_weights(FCNLectureNet(cfg),
                         torch.Generator().manual_seed(0)).eval()
    return [fold_model(model).to(cuda, torch.bfloat16,
                                 memory_format=torch.channels_last).eval()
            for _ in range(2)]


@pytest.mark.parametrize("flag", ["shard_params_over_model",
                                  "shard_spatial"])
def test_model_axis_on_one_card_launches_k2_on_the_shards(cuda, flag):
    """Two shards of a 1x2 mesh on the one card: K2 runs 4 heads on each
    (at N 8 and 4 on the channel path's head slices), K1 once a frame row
    (channels) or once a slab (height), and the binaries stay within 1% of
    the meshless bf16 path's (the shards sum in another order)."""
    from lecturemath_tpu_torch.parallel.inference import ShardedBinarizer
    from lecturemath_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    sharded_model, meshless_model = _axis_models(cuda)
    frames = _serving_frames(3, height=96, width=128)
    sharded = ShardedBinarizer(sharded_model, make_mesh(
        MeshSpec(1, 2), [cuda] * 2), **{flag: True})
    meshless = ShardedBinarizer(meshless_model, _one_card_mesh())
    before = (threshold_pack.launches, conv_same_nhwc.launches)
    got = sharded.binarize_frames(frames)
    assert conv_same_nhwc.launches - before[1] == 8
    assert threshold_pack.launches - before[0] == (
        2 if flag == "shard_spatial" else 1)
    expected = meshless.binarize_frames(frames)
    assert got.shape == expected.shape == (3, 96, 128)
    assert np.mean(got != expected) <= 0.01
