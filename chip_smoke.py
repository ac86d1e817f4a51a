#!/usr/bin/env python3
"""Smoke test of lecturemath_tpu_torch on one NVIDIA card.

Run from the root of a checkout with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``lecturemath_tpu_torch/csrc`` with nvcc and
then, in phases:

  1. environment: the card's name and power limit, torch and CUDA versions,
     the kernels' build time and ptxas' registers and spills per kernel;
  2. kernel K1 (threshold_pack) against its plain PyTorch version at the
     main path's shape [B, 544, 960] and at odd shapes, with logits placed on
     the threshold; kernel and plain times beside the bytes bound;
  3. kernel K2 (conv_same_nhwc, an implicit GEMM on the tensor cores)
     against its plain version (torch.cat + F.conv2d in f32, TF32 off) at
     the four head-conv shapes of the main path, in the two-input form the
     model calls (diff image beside a feature map), bf16 inputs; kernel,
     plain, cuDNN bf16 on the concatenated tensor (library yardstick) and
     cat + cuDNN times, per-head TFLOP/s and share of the bound;
  4. the express pipeline (Binarizer.from_config + run_lecture) on a
     240-frame synthetic 960x540 lecture at the production widths 48..768 in
     bf16 with seeded threshold-head weights: at least 2 inked keyframes
     split within 3 samples of the era boundary, both kernels launched, and
     a stage-01 batch within a 1% pixel flip rate of the plain f32 path;
     then 8 frames through the bf16 model with seeded random head weights
     on the kernel path against the same weights on the plain path (logits
     within a stated tolerance; no head concat on the kernel path); then
     the express run once more under torch.profiler for the device time by
     kernel group and the device's busy share;
  5. kernel K3 (cc_label) against its plain PyTorch version at its fixed
     point, exactly, and against scipy.ndimage.label after compact_labels:
     16 frames of 960x540 binarized by stage 01, a snake, a spiral, an
     all-foreground frame, a checkerboard, single-pixel lines on the block
     borders, random frames near percolation, and odd shapes; kernel and
     plain times beside the bytes bound;
  6. the staged path at the same widths with CC_ANALYSIS_DEVICE_LABELING = 1:
     stage01_binarize through the driver (frames from memory), then the
     cc_analysis, cc_grouping, vid_segmentation and generate_summary CLIs on
     the config; the device-labeled stage-02 tracker must equal a
     host-labeled one on the same artifact, the summary must hold at least 2
     inked keyframes split where express split them, and K1, K2 and K3 must
     all have launched. Each stage's wall time is printed.

The launch counts are set to 0 just before each of the two paths (phases 4
and 6) and read just after. It prints one JSON line of kernel numbers, then
as its last line
``{"ok": true, "device": {...}}``, and exits 0 only when every phase passed.
Without CUDA, or without the package beside it, it exits non-zero and prints
no result.
"""

import json
import os
import shutil
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
WORKSPACE = os.path.join(REPO, "chip_smoke_ws")

# published H100 SXM peaks (dense, no sparsity) at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

THRESHOLD = 128
N_FRAMES = 240
HEIGHT, WIDTH = 540, 960
# stage-01 pixels that may differ between the bf16 kernel path and the f32
# plain path (bf16 rounds the input and the diff image to 8 mantissa bits)
MAX_FLIP_RATE = 0.01
# K2 output against its f32 plain version: bf16 output rounds to 2^-8
# relative; f32 sums over up to 49*35 terms in another order
K2_REL = {"bf16": 2.0 ** -8, "f32": 1e-4}
K2_ABS = 1e-3
# the bf16 model's logits, K2 against its plain version, relative to the
# largest logit: the two sum in another order, so a bf16 intermediate (diff,
# pixels_1, pixels_2) may round the other way; one such ulp (2^-8 of one
# element) moves a logit far less than 2^-8 of the logits' range
LOGIT_REL = 2.0 ** -8
# stage 02's labeling batch on the main path (configs/example.conf:126)
CC_BATCH = 16
# rounds enough for the plain labeling to reach its fixed point on any frame
FIXED_POINT = 1 << 20


def log(*args):
    print(*args, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def cuda_ms(fn, reps, warmup=1):
    """Mean device time of fn() over ``reps`` launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def boundary_logits(shape, gen):
    """N(0, 3) logits with a quarter placed within 4 ulps of the logit at
    which sigmoid*255 lands on the threshold."""
    import math

    import torch

    logits = torch.randn(shape, device="cuda", generator=gen) * 3
    base = torch.tensor(math.log(THRESHOLD / (255.0 - THRESHOLD)),
                        dtype=torch.float32, device="cuda")
    ulp = torch.nextafter(base, base + 1) - base
    steps = torch.randint(-4, 5, shape, device="cuda", generator=gen)
    near = torch.rand(shape, device="cuda", generator=gen) < 0.25
    return torch.where(near, base + steps * ulp, logits).contiguous()


def unpack(packed, width):
    import numpy as np

    return np.unpackbits(packed.cpu().numpy(), axis=-1)[..., :width]


def phase_k1(batch):
    """K1 against threshold_pack_plain; returns its kernel record."""
    import numpy as np
    import torch

    from lecturemath_tpu_torch.ops.postprocess import (threshold_pack,
                                                       threshold_pack_plain)

    gen = torch.Generator(device="cuda").manual_seed(1)
    band_width = 2 * float(np.spacing(np.float32(THRESHOLD)))
    max_err = 0
    hp, wp = 544, 960
    for shape, (h, w) in (((batch, hp, wp), (HEIGHT, WIDTH)),
                          ((16, hp, wp), (HEIGHT, WIDTH)),
                          ((3, 301, 133), (299, 131)), ((1, 37, 45), (37, 45))):
        logits = boundary_logits(shape, gen)
        got = unpack(threshold_pack(logits, h, w, THRESHOLD), w)
        ref = unpack(threshold_pack_plain(logits, h, w, THRESHOLD), w)
        scaled = (torch.sigmoid(logits[:, :h, :w]) * 255).cpu().numpy()
        band = np.abs(scaled - THRESHOLD) <= band_width
        differ = got != ref
        outside = int((differ & ~band).sum())
        log(f"K1 {shape} crop {h}x{w}: {outside} differing bits outside the "
            f"2-ulp band, {int(differ.sum())} inside of {int(band.sum())} "
            f"band pixels")
        if outside:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{shape}")
        if differ.sum() > 0.05 * band.sum():
            raise AssertionError(f"K1: too many band flips at {shape}")
        max_err = max(max_err, int(np.abs(got.astype(int)
                                          - ref.astype(int))[~band].max()))

    logits = boundary_logits((batch, hp, wp), gen)
    ms = cuda_ms(lambda: threshold_pack(logits, HEIGHT, WIDTH, THRESHOLD), 20)
    plain_ms = cuda_ms(
        lambda: threshold_pack_plain(logits, HEIGHT, WIDTH, THRESHOLD), 20)
    pixels = batch * HEIGHT * WIDTH
    n_bytes = pixels * 4 + batch * HEIGHT * ((WIDTH + 7) // 8)
    # exp, add, divide, multiply, truncate, compare: ~6 f32 operations/pixel
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = 6 * pixels / PEAK_F32_FLOPS * 1e3
    log(f"K1 [{batch},{hp},{wp}] -> [{batch},{HEIGHT},{WIDTH // 8}]: kernel "
        f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
        f"{max(bytes_ms, ops_ms) * 1e3:.1f} us (bytes {n_bytes})")
    return {"name": "threshold_pack", "route": "cuda",
            "source": "lecturemath_tpu_torch/csrc/threshold_pack.cu",
            "replaces": "lecturemath_tpu/ops/pallas_postprocess.py:25",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def head_shapes(cfg):
    """(name, C of x, C of x2, N, activation, out dtype) of the four head
    convs as the model calls K2: text_conv reads the decoder features alone,
    the others the diff image (x) beside a feature map (x2)."""
    import torch

    c, up1 = cfg.in_channels, cfg.up_filters[0]
    p1, p2 = cfg.pixel_features
    return [("text_conv", up1, 0, 1, None, torch.float32),
            ("pixels_1", c, up1, p1, "gelu", torch.bfloat16),
            ("pixels_2", c, p1, p2, "gelu", torch.bfloat16),
            ("out_conv", c, p2, 1, None, torch.float32)]


def phase_k2(batch, cfg):
    """K2 against conv_same_plain at the head shapes; returns its record."""
    import torch
    import torch.nn.functional as F

    from lecturemath_tpu_torch.ops.conv7 import conv_same_nhwc, conv_same_plain

    gen = torch.Generator(device="cuda").manual_seed(2)
    k = cfg.pixel_kernel_size
    hp, wp = 544, 960
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "library_with_cat_ms": 0.0}
    flops = n_bytes = 0
    max_err = 0.0

    def bf16_input(channels):
        return torch.randn(batch, channels, hp, wp, device="cuda",
                           generator=gen).to(torch.bfloat16).contiguous(
                               memory_format=torch.channels_last)

    for name, c1, c2, n_out, act, out_dtype in head_shapes(cfg):
        c_in = c1 + c2
        x = bf16_input(c1)
        x2 = bf16_input(c2) if c2 else None
        weight = (torch.randn(n_out, c_in, k, k, device="cuda", generator=gen)
                  / (c_in * k * k) ** 0.5).to(torch.bfloat16)
        bias = (torch.randn(n_out, device="cuda", generator=gen) * 0.1).to(
            torch.bfloat16)
        got = conv_same_nhwc(x, weight, bias, act, out_dtype, x2=x2).float()
        ref = conv_same_plain(x, weight, bias, act, torch.float32, x2=x2)
        err = (got - ref).abs()
        kind = "f32" if out_dtype == torch.float32 else "bf16"
        excess = (err - K2_REL[kind] * ref.abs() - K2_ABS).max().item()
        max_err = max(max_err, err.max().item())
        del got, ref, err
        reps = 3
        ms = cuda_ms(lambda: conv_same_nhwc(x, weight, bias, act, out_dtype,
                                            x2=x2), reps)
        plain_ms = cuda_ms(lambda: conv_same_plain(x, weight, bias, act,
                                                   torch.float32, x2=x2),
                           reps)
        inputs = [x] if x2 is None else [x, x2]
        xcat = torch.cat(inputs, dim=1)
        library_ms = cuda_ms(lambda: F.conv2d(xcat, weight, bias,
                                              padding=k // 2), reps)
        del xcat
        cat_ms = cuda_ms(lambda: F.conv2d(torch.cat(inputs, dim=1), weight,
                                          bias, padding=k // 2), reps)
        out_bytes = 4 if out_dtype == torch.float32 else 2
        f = 2 * k * k * c_in * n_out * batch * hp * wp
        b = batch * hp * wp * (2 * c_in + out_bytes * n_out) \
            + weight.numel() * 2 + n_out * 2
        bound = max(f / PEAK_BF16_FLOPS, b / PEAK_BYTES_PER_S) * 1e3
        flops += f
        n_bytes += b
        log(f"K2 {name} [{batch},{c1}+{c2},{hp},{wp}] -> {n_out} ch k={k} "
            f"{act or 'linear'} {kind}: max |err| {max_err:.3g} (excess over "
            f"tolerance {excess:.3g}), kernel {ms:.3f} ms, plain f32 "
            f"{plain_ms:.3f} ms, cuDNN bf16 on the concat {library_ms:.3f} "
            f"ms, cat + cuDNN {cat_ms:.3f} ms; {f / ms / 1e9:.1f} TFLOP/s, "
            f"bound {bound:.3f} ms = {bound / ms:.3f} of the kernel's time; "
            f"faster than cuDNN: {ms < library_ms}")
        if excess > 0:
            raise AssertionError(f"K2 {name} outside tolerance")
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["library_ms"] += library_ms
        totals["library_with_cat_ms"] += cat_ms
        del x, x2, inputs
        torch.cuda.empty_cache()
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    bound = max(ops_ms, bytes_ms)
    log(f"K2 four heads per batch of {batch}: kernel {totals['ms']:.3f} ms "
        f"({flops / totals['ms'] / 1e9:.1f} TFLOP/s), cuDNN bf16 "
        f"{totals['library_ms']:.3f} ms, cat + cuDNN "
        f"{totals['library_with_cat_ms']:.3f} ms, bound {bound:.3f} ms "
        f"({flops / 1e9:.1f} GFLOP, {n_bytes / 1e6:.1f} MB) = "
        f"{bound / totals['ms']:.3f} of the kernel's time")
    return {"name": "conv_same_nhwc", "route": "cuda",
            "source": "lecturemath_tpu_torch/csrc/conv7.cu",
            "replaces": "lecturemath_tpu/ops/pallas_conv7.py:42",
            "max_abs_err": max_err, **totals, "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


DB_XML = """<AccessMath>
  <DataBase>
    <Name>SmokeDB</Name>
    <OutputPaths>
      <Temporal>temporal</Temporal><Images>images</Images>
      <Videos>videos</Videos><Annotations>annotations</Annotations>
      <Summaries>summaries</Summaries>
    </OutputPaths>
    <Datasets><Testing><LectureTitle>smoke01</LectureTitle></Testing></Datasets>
    <Lectures>
      <Lecture>
        <Id>smoke01</Id><Title>smoke01</Title><Parameters></Parameters>
        <Videos><Main><Video><Path>smoke01.mp4</Path></Video></Main></Videos>
      </Lecture>
    </Lectures>
  </DataBase>
</AccessMath>
"""

# production widths of configs/example.conf; the deletion-event thresholds
# of bench.py's synthetic workload
CONFIG = """VIDEO_DATABASE_PATH = {ws}/db.xml
VIDEO_FILES_PATH = {ws}/videos
OUTPUT_PATH = {ws}/output
BINARIZATION_FCN_LECTURENET_DIR = {ws}/models
BINARIZATION_FCN_LECTURENET_FILENAME = smoke.dat
UPLOAD_FORMAT = auto
SAMPLING_FPS = 1.0
FCN_BINARIZER_NET_DOWN_CONV_FILTERS_1 = 48
FCN_BINARIZER_NET_DOWN_CONV_FILTERS_2 = 96
FCN_BINARIZER_NET_DOWN_CONV_FILTERS_3 = 192
FCN_BINARIZER_NET_DOWN_CONV_FILTERS_4 = 384
FCN_BINARIZER_NET_DOWN_CONV_FILTERS_5 = 768
FCN_BINARIZER_NET_MIDDLE_CONV_FILTERS_MIDDLE = 768
FCN_BINARIZER_NET_UPSAMPLE_FILTERS_1 = 32
FCN_BINARIZER_NET_UPSAMPLE_FILTERS_2 = 48
FCN_BINARIZER_NET_UPSAMPLE_FILTERS_3 = 96
FCN_BINARIZER_NET_UPSAMPLE_FILTERS_4 = 192
FCN_BINARIZER_NET_UPSAMPLE_FILTERS_5 = 384
FCN_BINARIZER_NET_UP_CONV_FILTERS_1 = 32
FCN_BINARIZER_NET_UP_CONV_FILTERS_2 = 48
FCN_BINARIZER_NET_UP_CONV_FILTERS_3 = 96
FCN_BINARIZER_NET_UP_CONV_FILTERS_4 = 192
FCN_BINARIZER_NET_UP_CONV_FILTERS_5 = 384
FCN_BINARIZER_NET_KERNEL_SIZE = 3
FCN_BINARIZER_NET_PIXEL_FEATURES_1 = 32
FCN_BINARIZER_NET_PIXEL_FEATURES_2 = 16
FCN_BINARIZER_NET_PIXEL_KERNEL_SIZE = 7
CC_STABILITY_MIN_RECALL = 0.925
CC_STABILITY_MIN_PRECISION = 0.925
CC_STABILITY_MAX_GAP = 85
CC_STABILITY_MIN_TIMES = 3
CC_GROUPING_MIN_RECALL = 0.5
CC_GROUPING_MIN_IMAGE_THRESHOLD = 0.5
CC_GROUPING_TEMPORAL_WINDOW = 5
VIDEO_SEGMENTATION_METHOD = 3
VIDEO_SEGMENTATION_DEL_EVENT_ADD_THRESHOLD = 0.00005
VIDEO_SEGMENTATION_DEL_EVENT_MIN_LENGTH = 3
VIDEO_SEGMENTATION_DEL_EVENT_THRESHOLD = 0.0008
"""


# the staged relay's artifact names, and stage 02 labeling on the card
STAGED_CONFIG = """BINARIZATION_OUTPUT = tempo_binary_
CC_STABILITY_OUTPUT = tempo_stability_
CC_RECONSTRUCTED_OUTPUT = tempo_bin_reconstructed_
CC_CONFLICTS_OUTPUT = tempo_cc_conflicts_
CC_ST3D_OUTPUT = tempo_cc_ST3D_
VIDEO_SEGMENTATION_OUTPUT = tempo_intervals_
SUMMARY_KEYFRAMES_OUTPUT = tempo_segments_
CC_ANALYSIS_DEVICE_LABELING = 1
CC_ANALYSIS_DEVICE_BATCH = {batch}
"""


def make_workspace():
    """Config, database and a seeded threshold-head checkpoint (.dat); the
    staged config adds STAGED_CONFIG."""
    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.models.convert import save_checkpoint
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig
    from lecturemath_tpu_torch.utils.synthetic import \
        threshold_binarizer_variables

    shutil.rmtree(WORKSPACE, ignore_errors=True)
    os.makedirs(os.path.join(WORKSPACE, "models"))
    with open(os.path.join(WORKSPACE, "db.xml"), "w") as f:
        f.write(DB_XML)
    conf = os.path.join(WORKSPACE, "smoke.conf")
    with open(conf, "w") as f:
        f.write(CONFIG.format(ws=WORKSPACE))
    with open(os.path.join(WORKSPACE, "staged.conf"), "w") as f:
        f.write(CONFIG.format(ws=WORKSPACE)
                + STAGED_CONFIG.format(batch=CC_BATCH))
    net_config = FCNConfig.from_config(Config.from_file(conf))
    save_checkpoint(threshold_binarizer_variables(net_config, seed=0),
                    os.path.join(WORKSPACE, "models", "smoke.dat"))
    return conf, net_config


# the kernels express launches; it labels on the host, so K3 is not one
EXPRESS_KERNELS = ("threshold_pack", "conv_same_nhwc")


def make_source():
    from lecturemath_tpu_torch.utils.synthetic import SyntheticRGBLectureSource

    return SyntheticRGBLectureSource(
        seed=0, n_frames=N_FRAMES, height=HEIGHT, width=WIDTH, n_boards=2,
        glyphs_per_board=40, glyph_size=(40, 60))


def phase_main_path(conf, counters):
    """Express on the card; returns (launch counts of every kernel in
    ``counters``, summary dict)."""
    import numpy as np
    import torch

    from lecturemath_tpu_torch.native import available as native_available
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer
    from lecturemath_tpu_torch.pipeline.driver import PipelineDriver
    from lecturemath_tpu_torch.pipeline.express import run_lecture

    log(f"native C++ tracking library available: {native_available()}")
    driver = PipelineDriver.from_config_path(conf, [], None, None)
    lecture = driver.database.lectures[0]
    binarizer = Binarizer.from_config(driver.config)
    assert binarizer.device.type == "cuda"
    assert binarizer.model.dtype == torch.bfloat16
    assert binarizer.upload_format == "rgb"
    source = make_source()

    # warm-up batch (cuDNN algorithm choice, allocator): not part of the run
    warm = np.stack([source.rgb_frame(t) for t in range(8)])
    binarizer._packed_fn(torch.from_numpy(warm).cuda())
    torch.cuda.synchronize()

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    indices, times, keyframes = run_lecture(driver, lecture, binarizer,
                                            source=source, export=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    boundary = source.erase_times[0]
    log(f"express: {N_FRAMES} frames {WIDTH}x{HEIGHT} in {wall:.3f} s = "
        f"{N_FRAMES / wall:.2f} fps end to end; batch size "
        f"{binarizer.batch_size}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"stage-01 stream_stats: {json.dumps(binarizer.stream_stats)}")
    log(f"keyframes {len(keyframes)} at sample indices {indices} (era "
        f"boundary at {boundary}); launches {launches}")
    if len(keyframes) < 2:
        raise AssertionError(f"expected >= 2 keyframes, got {len(keyframes)}")
    for keyframe in keyframes:
        if keyframe.shape != (HEIGHT, WIDTH, 3) or not (keyframe < 128).any():
            raise AssertionError("a keyframe has no ink or a wrong shape")
    if abs(indices[0] - boundary) > 3:
        raise AssertionError(f"first segment ends at {indices[0]}, era "
                             f"boundary {boundary}")
    for name in EXPRESS_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched")

    # a stage-01 batch of both eras against the plain f32 path on the card
    from lecturemath_tpu_torch.models.fcn_lecturenet import (
        FCNLectureNet, make_packed_binarizer, unpack_bits_host)
    from lecturemath_tpu_torch.models.convert import load_checkpoint

    plain = FCNLectureNet(binarizer.model.config, plain=True)
    plain.load_state_dict(load_checkpoint(os.path.join(
        WORKSPACE, "models", "smoke.dat")))
    plain_bin = Binarizer(plain, batch_size=8, dtype=torch.float32)
    pick = [0, 30, 60, 119, 120, 150, 200, 239]
    frames = torch.from_numpy(np.stack([source.rgb_frame(t) for t in pick]))
    kernel_bits = unpack_bits_host(
        binarizer._packed_fn(frames.cuda()).cpu().numpy(), WIDTH)
    plain_bits = unpack_bits_host(make_packed_binarizer(plain_bin.model)(
        frames.cuda()).cpu().numpy(), WIDTH)
    flip_rate = float(np.mean(kernel_bits != plain_bits))
    truth = np.stack([source.binary_frame(t) for t in pick]) > 0
    ink_error = float(np.mean((kernel_bits == 0) != truth))
    log(f"stage-01 bf16 kernels vs plain f32 on {len(pick)} frames: flip "
        f"rate {flip_rate:.6f} (bound {MAX_FLIP_RATE}); ink mask vs ground "
        f"truth {ink_error:.6f}")
    if flip_rate > MAX_FLIP_RATE:
        raise AssertionError(f"stage-01 flip rate {flip_rate} > "
                             f"{MAX_FLIP_RATE}")

    random_head_check(binarizer.model, frames)

    device_breakdown(lambda: run_lecture(driver, lecture, binarizer,
                                         source=make_source(), export=False),
                     "express")
    return launches, {"fps": N_FRAMES / wall, "wall_s": wall,
                      "batch": binarizer.batch_size, "flip_rate": flip_rate,
                      "indices": list(indices)}


def random_head_check(model, frames):
    """K2 inside the forward, where the threshold weights cannot see it: the
    bf16 model with seeded random head weights (xavier-normal, as the
    trunk) on 8 frames, kernel path against the same weights on the plain
    path. Also logs each torch.cat of both forwards: on the kernel path no
    head concat (diff first) may remain."""
    import numpy as np
    import torch
    from torch.overrides import TorchFunctionMode

    from lecturemath_tpu_torch.models.fcn_lecturenet import (
        FCNLectureNet, pad_to_multiple, prepare_images)

    class CatLog(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.channels = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.cat:
                self.channels.append([t.shape[1] for t in args[0]])
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(3)
    state = {key: value.clone() for key, value in model.state_dict().items()}
    for head in ("conv_reconstruct", "conv_text_mask_out", "conv_pixels_1",
                 "conv_pixels_2", "conv_out"):
        weight = state[f"{head}.0.weight"]
        n_out, c_in, kh, kw = weight.shape
        std = (2.0 / ((n_out + c_in) * kh * kw)) ** 0.5
        state[f"{head}.0.weight"] = torch.from_numpy(
            rng.normal(0.0, std, weight.shape).astype(np.float32)).to(weight)
        state[f"{head}.0.bias"] = torch.from_numpy(
            rng.normal(0.0, 0.1, (n_out,)).astype(np.float32)).to(weight)
    device = model.mid_block[0].weight.device
    x, _ = pad_to_multiple(prepare_images(frames.to(device)))
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    results = {}
    for plain in (False, True):
        net = FCNLectureNet(model.config, fold_bn=True, plain=plain)
        net.load_state_dict(state)
        net = net.to(device=device, dtype=torch.bfloat16,
                     memory_format=torch.channels_last).eval()
        with torch.no_grad(), CatLog() as cats:
            bin_logits, text_logits, _ = net(x)
        results[plain] = (bin_logits.float(), text_logits.float(),
                          cats.channels)
        del net
    errors = {}
    for i, name in enumerate(("bin_logits", "text_logits")):
        ours, ref = results[False][i], results[True][i]
        errors[name] = ((ours - ref).abs().max().item(),
                        ref.abs().max().item())
    log(f"random heads, bf16, {x.shape[0]} frames, K2 against its plain "
        f"version: max |err| and max |logit| "
        f"{json.dumps({k: [round(v, 6) for v in e] for k, e in errors.items()})} "
        f"(bound {LOGIT_REL} of max |logit|); torch.cat channels, kernel "
        f"path {results[False][2]}, plain path {results[True][2]}")
    for name, (err, scale) in errors.items():
        if not err <= LOGIT_REL * scale:
            raise AssertionError(f"random heads: {name} differ by {err}")
    head_cats = [c for c in results[False][2]
                 if c[0] == model.config.in_channels]
    if head_cats:
        raise AssertionError(f"head concats on the kernel path: {head_cats}")


def profiled_spans(run):
    """Run ``run()`` under torch.profiler; returns (wall ms, sorted device
    spans (start us, end us, category, name) of kernels and copies)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return wall_ms, sorted(
        (ev["ts"], ev["ts"] + ev["dur"], ev["cat"], ev["name"])
        for ev in events if ev.get("ph") == "X" and ev.get("cat")
        in ("kernel", "gpu_memcpy", "gpu_memset"))


def device_breakdown(run, what):
    """Run ``run()`` once more under torch.profiler and print where the
    card's time went: device ms by kernel group and the device's busy share
    of the run's wall clock (the union of kernel and copy spans)."""
    wall_ms, spans = profiled_spans(run)
    if not spans:
        log(f"profiled {what}: the profiler saw no device events; device "
            f"breakdown not measured")
        return
    groups, counts, names = {}, {}, {}
    busy_us, end_us = 0.0, float("-inf")
    for start, end, cat, name in spans:
        group = ("K2 conv_igemm_kernel" if "conv_igemm_kernel" in name else
                 "K1 threshold_pack_kernel" if "threshold_pack_kernel" in name
                 else "K3 cc_*_kernel" if any(
                     f"cc_{step}_kernel" in name
                     for step in ("local", "merge", "flatten"))
                 else "torch.cat copies" if "CatArrayBatchedCopy" in name
                 else "copies and memsets" if cat != "kernel"
                 else "trunk and glue (cuDNN, elementwise)")
        groups[group] = groups.get(group, 0.0) + (end - start) / 1e3
        counts[group] = counts.get(group, 0) + 1
        names[name[:60]] = names.get(name[:60], 0.0) + (end - start) / 1e3
        busy_us += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    log(f"profiled {what} ({wall_ms:.1f} ms wall under the profiler): "
        f"device busy {busy_us / 1e3:.1f} ms = "
        f"{busy_us / 1e3 / wall_ms:.3f} of the wall; device ms by group "
        f"{json.dumps({k: round(v, 3) for k, v in groups.items()})}; "
        f"launches by group {json.dumps(counts)}; top "
        f"kernels {json.dumps({k: round(v, 3) for k, v in top})}")

def snake(h, w, pitch):
    """One component winding across the frame: rows every ``pitch`` pixels
    joined at alternate ends."""
    import numpy as np

    img = np.zeros((h, w), np.uint8)
    for k, row in enumerate(range(0, h, pitch)):
        img[row, :] = 1
        img[row:row + pitch + 1, -1 if k % 2 == 0 else 0] = 1
    return img


def spiral(h, w):
    """One component: a square spiral of 1-pixel walls and 1-pixel gaps."""
    import numpy as np

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


def border_lines(h, w):
    """Single-pixel lines on both sides of the kernel's 32-pixel block
    borders, and short crossings of them."""
    import numpy as np

    img = np.zeros((h, w), np.uint8)
    img[31::32, 5:-5] = 1
    img[5:-5, 32::32] = 1
    img[::7, 63:65] = 1
    img[95:97, ::5] = 1
    return img


def k3_inputs(binaries):
    """(name, uint8 [B, H, W]) batches for phase 5."""
    import numpy as np

    rng = np.random.default_rng(5)
    h, w = HEIGHT, WIDTH
    yy, xx = np.mgrid[:h, :w]
    patterns = np.stack([
        snake(h, w, 3), spiral(h, w), np.ones((h, w), np.uint8),
        ((yy + xx) % 2).astype(np.uint8), border_lines(h, w),
        np.zeros((h, w), np.uint8)])
    random = (rng.random((CC_BATCH, h, w))
              < np.linspace(0.5, 0.6, CC_BATCH)[:, None, None]).astype(
                  np.uint8)
    odd = [(rng.random((3, 301, 133)) < 0.55).astype(np.uint8),
           (rng.random((1, 37, 45)) < 0.59).astype(np.uint8)]
    odd[0][1] = spiral(301, 133)
    return [(f"stage-01 frames {list(binaries.shape)}", binaries),
            ("snake, spiral, full, checkerboard, border lines, empty",
             patterns),
            (f"random at density 0.5-0.6 {list(random.shape)}", random),
            ("odd [3, 301, 133]", odd[0]), ("odd [1, 37, 45]", odd[1])]


def phase_k3(conf):
    """K3 against label_components_plain at its fixed point and against
    scipy.ndimage.label; returns its kernel record."""
    import numpy as np
    import torch
    from scipy import ndimage

    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.ops.cc_label import (compact_labels,
                                                    label_components_batch,
                                                    label_components_plain)
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer
    from lecturemath_tpu_torch.pipeline.video import ArraySource

    # 16 frames over both eras through stage 01 (ink = 255)
    source = make_source()
    picks = np.linspace(0, N_FRAMES - 1, CC_BATCH).astype(int)
    binarizer = Binarizer.from_config(Config.from_file(conf))
    _, _, frames = binarizer.process_source(
        ArraySource(np.stack([source.rgb_frame(int(t)) for t in picks])))
    binaries = np.stack(frames)
    del binarizer
    torch.cuda.empty_cache()

    max_err = 0
    for name, batch in k3_inputs(binaries):
        dev = torch.from_numpy(np.ascontiguousarray(batch)).cuda()
        got = label_components_batch(dev)
        t0 = time.perf_counter()
        ref = label_components_plain(dev, FIXED_POINT)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        differ = int((got != ref).sum())
        err = int((got.long() - ref.long()).abs().max())
        max_err = max(max_err, err)
        labels = got.cpu().numpy()
        scipy_differ = 0
        components = 0
        for frame, frame_labels in zip(batch, labels):
            compacted, n = compact_labels(frame_labels)
            expected, n_ref = ndimage.label(frame)
            components += n_ref
            scipy_differ += int((compacted != expected).sum()) + abs(n - n_ref)
        log(f"K3 {name}: {differ} labels differ from the plain version "
            f"({plain_s:.2f} s to its fixed point), {scipy_differ} from "
            f"scipy after compact_labels; {components} components")
        if differ or scipy_differ:
            raise AssertionError(f"K3 disagrees on {name}")

    main = torch.from_numpy(binaries).cuda()
    ms = cuda_ms(lambda: label_components_batch(main), 50)
    plain_ms = cuda_ms(lambda: label_components_plain(main, FIXED_POINT), 3)
    n_bytes = main.numel() * (1 + 4)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    log(f"K3 [{CC_BATCH},{HEIGHT},{WIDTH}] u8 -> int32: kernel "
        f"{ms * 1e3:.1f} us (three launches), plain {plain_ms:.3f} ms, bound "
        f"{bytes_ms * 1e3:.1f} us (bytes {n_bytes}); no PyTorch call labels "
        f"components")
    device_breakdown(lambda: [label_components_batch(main)
                              for _ in range(20)],
                     f"K3 x20 at [{CC_BATCH},{HEIGHT},{WIDTH}]")
    return {"name": "cc_label", "route": "cuda",
            "source": "lecturemath_tpu_torch/csrc/cc_label.cu",
            "replaces": "lecturemath_tpu/ops/cc_label_pallas.py:33",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bytes_ms, "bound_by": "bytes", "library_ms": None}


def same_tracker(ours, theirs):
    """Unique CCs, their frames, boxes, sizes and images."""
    import numpy as np

    if len(ours.unique_ccs) != len(theirs.unique_ccs):
        return False
    if ours.unique_cc_frames != theirs.unique_cc_frames:
        return False
    for a, b in zip(ours.unique_ccs, theirs.unique_ccs):
        if (a.min_x, a.max_x, a.min_y, a.max_y, a.size) != \
                (b.min_x, b.max_x, b.min_y, b.max_y, b.size):
            return False
        if not np.array_equal(a.img, b.img):
            return False
    return True


def phase_staged(counters, express_indices):
    """The staged path on the card; returns its launch counts."""
    import torch

    from lecturemath_tpu_torch.cli import (cc_analysis, cc_grouping,
                                           generate_summary, vid_segmentation)
    from lecturemath_tpu_torch.core.timing import StageTimer
    from lecturemath_tpu_torch.pipeline import stages
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer
    from lecturemath_tpu_torch.pipeline.driver import PipelineDriver

    class MemoryDriver(PipelineDriver):
        """The card's machine has no OpenCV to decode a video: stage 01
        reads the synthetic lecture from memory."""

        def frame_source(self, lecture):
            return make_source()

    conf = os.path.join(WORKSPACE, "staged.conf")
    timer = StageTimer()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    with timer.measure("01 binarize"):
        driver = MemoryDriver.from_config_path(conf, [], None,
                                               "BINARIZATION_OUTPUT")
        binarizer = Binarizer.from_config(driver.config)
        driver.run(lambda d, lecture, inputs:
                   stages.stage01_binarize(d, lecture, inputs, binarizer))
        del binarizer
    for name, cli in (("02 cc_analysis", cc_analysis),
                      ("03 cc_grouping", cc_grouping),
                      ("04 vid_segmentation", vid_segmentation),
                      ("05 generate_summary", generate_summary)):
        with timer.measure(name):
            cli.main([cli.__name__, conf])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"staged path: {json.dumps({k: round(v, 3) for k, v in timer.totals.items()})} "
        f"s by stage (StageTimer), {sum(timer.totals.values()):.3f} s in all; "
        f"launches {launches}")

    # check 1: the K3-labeled tracker against host labeling of the artifact
    store = PipelineDriver.from_config_path(conf, [], None, None).store
    lecture_id = driver.database.lectures[0].id
    _, _, device_tracker = store.load("tempo_stability_", lecture_id)
    host = PipelineDriver.from_config_path(conf, [], "BINARIZATION_OUTPUT",
                                           None)
    host.config.set("CC_ANALYSIS_DEVICE_LABELING", 0)
    t0 = time.perf_counter()
    _, _, host_tracker = stages.stage02_cc_analysis(
        host, host.database.lectures[0], host.load_inputs(
            host.database.lectures[0]))
    log(f"stage 02 host-labeled on the same artifact in "
        f"{time.perf_counter() - t0:.3f} s: {len(host_tracker.unique_ccs)} "
        f"unique CCs, device-labeled {len(device_tracker.unique_ccs)}")
    if not same_tracker(device_tracker, host_tracker):
        raise AssertionError("the K3-labeled stage-02 tracker differs from "
                             "the host-labeled one")

    # check 2: the summary
    (indices, _, keyframes), = store.load("tempo_segments_", lecture_id)
    intervals = store.load("tempo_intervals_", lecture_id)
    boundary = make_source().erase_times[0]
    log(f"staged summary: {len(keyframes)} keyframes at {list(indices)}, "
        f"intervals {intervals} (era boundary {boundary}; express "
        f"{express_indices})")
    if len(keyframes) < 2:
        raise AssertionError(f"expected >= 2 keyframes, got {len(keyframes)}")
    for keyframe in keyframes:
        if keyframe.shape != (HEIGHT, WIDTH, 3) or not (keyframe < 128).any():
            raise AssertionError("a keyframe has no ink or a wrong shape")
    if abs(intervals[0][1] - boundary) > 3:
        raise AssertionError(f"first split at {intervals[0][1]}, era "
                             f"boundary {boundary}")
    if list(indices) != list(express_indices):
        raise AssertionError(f"staged summary indices {list(indices)} differ "
                             f"from express {express_indices}")

    # check 3: every kernel of the path ran
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched")

    stage02_profile(conf)
    device_breakdown(lambda: cc_analysis.main([cc_analysis.__name__, conf]),
                     "stage 02 (the cc_analysis CLI, K3)")
    return launches


# stage 02's pieces: (file, function) as cProfile names them
STAGE02_PIECES = {
    ("pipeline/stages.py", "stage02_cc_analysis"): "the whole stage",
    ("pipeline/video.py", "decompress_png"): "png decode",
    ("ops/cc_label.py", "label_components_batch"): "K3 wrapper (launch)",
    ("~", "<method 'cpu' of"): "Tensor.cpu (labels to the host, waits on K3)",
    ("ops/cc_label.py", "compact_labels"): "compact_labels",
    ("data/cc.py", "extract_ccs"): "extract_ccs from labels",
    ("pipeline/cc_tracking.py", "add_frame_ccs"): "tracking",
}


def stage02_profile(conf):
    """Run the stage-02 CLI once more under cProfile and print the
    cumulative host seconds of its pieces (cProfile adds a cost to every
    Python call, so the whole stage is printed beside them)."""
    import cProfile
    import pstats

    from lecturemath_tpu_torch.cli import cc_analysis

    profiler = cProfile.Profile()
    profiler.runcall(cc_analysis.main, [cc_analysis.__name__, conf])
    seconds = {}
    for (path, _, func), (_, _, _, cumulative, _) in \
            pstats.Stats(profiler).stats.items():
        for (suffix, name), piece in STAGE02_PIECES.items():
            if func.startswith(name) and path.endswith(suffix):
                seconds[piece] = seconds.get(piece, 0.0) + cumulative
    log(f"stage 02 under cProfile (host clock, cumulative s): "
        f"{json.dumps({k: round(v, 4) for k, v in seconds.items()})}")


def main():
    if not os.path.isdir(os.path.join(REPO, "lecturemath_tpu_torch")):
        print("chip_smoke.py: lecturemath_tpu_torch not found beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "smoke test needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig
    from lecturemath_tpu_torch.ops import cuda_build
    from lecturemath_tpu_torch.ops.cc_label import label_components_batch
    from lecturemath_tpu_torch.ops.conv7 import conv_same_nhwc
    from lecturemath_tpu_torch.ops.postprocess import threshold_pack
    from lecturemath_tpu_torch.pipeline.binarize import default_batch_size

    # every f32 comparison on the card runs in full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = cuda_build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (parallel nvcc, "
        f"sm_90a): {sorted(logs)}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                log(f"  {name}: {mangled}")
            elif ("registers" in line or "spill" in line
                  or line.startswith("built")):
                log(f"  {name}: {line.strip()}")

    failures = []
    records = {}
    counters = {"threshold_pack": threshold_pack,
                "conv_same_nhwc": conv_same_nhwc,
                "cc_label": label_components_batch}
    batch = default_batch_size(WIDTH, HEIGHT, torch.device("cuda"))
    log(f"main-path batch size: {batch}")
    for name, phase in (("K1", lambda: phase_k1(batch)),
                        ("K2", lambda: phase_k2(batch, FCNConfig()))):
        try:
            records[name] = phase()
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc()
            failures.append(name)
        torch.cuda.empty_cache()

    launches = {}
    staged_launches = {}
    summary = {}
    try:
        conf, _ = make_workspace()
        try:
            launches, summary = phase_main_path(conf, counters)
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc()
            failures.append("main path")
        torch.cuda.empty_cache()
        try:
            records["K3"] = phase_k3(conf)
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc()
            failures.append("K3")
        torch.cuda.empty_cache()
        try:
            staged_launches = phase_staged(counters, summary.get("indices"))
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc()
            failures.append("staged path")
    except Exception:  # noqa: BLE001 — report every phase, then fail
        traceback.print_exc()
        failures.append("workspace")
    finally:
        shutil.rmtree(WORKSPACE, ignore_errors=True)

    # launches: the staged path's counts (it runs every kernel), with each
    # path's own counts beside them
    for key, name in (("K1", "threshold_pack"), ("K2", "conv_same_nhwc"),
                      ("K3", "cc_label")):
        if key in records:
            records[key]["launches"] = staged_launches.get(name, 0)
            records[key]["launches_by_path"] = {
                "express": launches.get(name, 0),
                "staged": staged_launches.get(name, 0)}
    log(f"express {summary.get('fps', 0):.2f} fps on {card}")
    log(card)
    log(json.dumps({"kernels": list(records.values())}))
    if failures:
        print(f"chip_smoke.py: failed phases: {failures}", file=sys.stderr)
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
