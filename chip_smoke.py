#!/usr/bin/env python3
"""Smoke test of lecturemath_tpu_torch on one NVIDIA card.

Run from the root of a checkout with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``lecturemath_tpu_torch/csrc`` with nvcc and
then, in phases:

  1. environment: the card's name and power limit, torch and CUDA versions,
     the kernels' build time and ptxas' registers and spills per kernel;
  2. kernel K1 (threshold_pack) against its plain PyTorch version at the
     main path's shape [B, 544, 960], at the full-lecture drive's 1080p
     stage-01 shape [B, 1088, 1920] (cropped to 1080x1920) and at odd
     shapes, with logits placed on the threshold; kernel and plain times
     beside the bytes bound;
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
     all-foreground frame, a checkerboard, single-pixel lines on the tile
     and segment edges, runs touching only diagonally, foreground across a
     tile edge, random frames near percolation, odd shapes, and widths 1-960
     at heights 1 and 33; each batch also one byte into its storage (no
     aligned segment); the kernel's time a call for each batch (its three
     launches replayed in a CUDA graph) beside its bytes bound, the plain
     time, and the device time a launch by pass under torch.profiler; then
     kernel K4 (median) at the reconstruction phase's batch [8, 256, 256, 3]
     and k = 35 against native.median_u8, byte for byte, on random bytes
     and on board crops: its device time beside its bytes bound, the plain
     version's time on the host, and its float32 output (the training
     data's median targets) against the plain version's; then kernel K5
     (augment) at the binarizer phase's batch [8, 256, 256, 3] with its
     ground truth (text mask at e = 15, weights at w = 1) and every mix of
     inversion, hue and noise against its plain version, byte for byte: its
     device time beside its bytes bound, the plain version's time on the
     host, and the host's wall of a batch on the card's route and on the
     host's (the pixel work after the draws) with the card's share of the
     samples;
  6. the staged path at the same widths with CC_ANALYSIS_DEVICE_LABELING = 1:
     stage01_binarize through the driver (frames from memory), then the
     cc_analysis, cc_grouping, vid_segmentation and generate_summary CLIs on
     the config; the device-labeled stage-02 tracker must equal a
     host-labeled one on the same artifact, the summary must hold at least 2
     inked keyframes split where express split them, and K1, K2 and K3 must
     all have launched. Each stage's wall time is printed;
  7. the serving path at the same widths: BinarizeService with a 960x540
     bucket, batch buckets 1-8 and a 5 ms window captures one CUDA graph per
     bucket (capture seconds and the graph pool's bytes printed); each
     bucket's graph output must be bit-identical to the eager kernel path
     and within the 1% flip rate of the plain f32 path, with its device ms
     per dispatch by graph replay and eager, and K1's and K2's device µs per
     replay; then serve() over HTTP on 127.0.0.1: /healthz, 1, 8 and 32
     clients in client processes of their own (req/s, mean batch, p50,
     p99; a lone client's answers equal a direct binarization), the host
     ms of a request's steps, 1920x1080, 1280x720 and 640x480 bodies
     checked against a direct binarization, a /reload mid-traffic to a
     threshold_gray=5
     checkpoint (every answer the old model's or the new one's, no error),
     a body that is not an image (400) and /stats; then ensure_backend and
     the doctor CLI;
  8. the training path at the same widths, 256x256 crops and batch 8: the
     train_reconstruction, train_text_detector (warm-started, heads reset)
     and train_binarizer CLIs chained on a dataset of synthetic-lecture
     PNGs, a few steps each, with .msgpack outputs and finite per-term
     losses; one fp32 live-BN step where every parameter gets a finite,
     nonzero gradient, then 20 steps where the loss falls; step ms (CUDA
     events), images/s, peak memory and TFLOP/s for fp32 (TF32 convs) and
     bf16, live BN and frozen BN folded, batch 8 and 64, beside the four
     heads' cuDNN forward + backward; the kernels of a bf16 step by group
     under torch.profiler; no K2 launch in any training forward; then the
     trained checkpoint through Binarizer.from_config, K2 and K1 on packs
     of its weights, within the 1% flip rate of plain f32, and an
     optimizer.step() on a live model after which K2 runs on fresh packs;
  9. the evaluation path at the same widths on a synthetic ground-truth
     tree (GT binaries by the threshold heads' luminance rule, polygon
     video objects): the phase-4 lecture at 960x540 and a second lecture
     of 16 keyframes at 1920x1080. Through their entry points:
     eval.keyframe_bin.main (the binarizer-quality protocol), the
     eval_summaries CLI over the staged phase's summary, the eval_segments
     CLI, a self-evaluation (the GT scored as its own summary: recall =
     precision = 1.0 at every min R/P) and the eval_text_detector CLI on 16
     PNG image/mask pairs at 640x480; each one's wall time, the protocol's
     host seconds by step and the binarizer's keyframes a second (CUDA
     events), timed after that run; the binaries keyframe_bin.main saved
     for every keyframe (bf16 kernels) within the 1% flip rate of plain f32
     on the card; every metric that main returned finite and in [0, 1]
     (the board variants of the pixel metrics may pass 1 by their
     definition); K2 launched on the path;
 10. scale-out over the data axis at the same widths: Binarizer on a 1x1
     mesh in-process over the phase-4 lecture, bit-identical to the
     meshless Binarizer, fps of both (median of 3); the binarize and
     run_pipeline CLIs with -mesh 1x1 in child processes that join a
     one-rank NCCL world under LM_COORDINATOR / LM_NUM_PROCESSES /
     LM_PROCESS_ID, their stage-01 artifact byte-identical to the meshless
     CLI's and their summary identical; in a child of such a world, 3 fp32
     data-parallel steps (TF32 off, batch 8 at 256x256, weighted, clipped)
     against the meshless Trainer's losses and BN running statistics, the
     bf16 step ms of both, the cross-replica BN's and NCCL's device share
     of a profiled mesh step, and train_reconstruction -mesh 1x1 (finite
     falling losses, one checkpoint set). With 2 or more cards, inference
     over 2 cards and a 2-process NCCL training; otherwise one line says
     they did not run.
 11. express through the recycled device worker (WorkerBinarizer, batches
     of 16, prespawn with an eager spare, a recycle budget just above the
     first child's RSS at ready) on the phase-4 lecture: at least 2
     recycles, stage-01 frames identical to the in-process Binarizer's and
     the summary identical to phase 4's, K1 and K2 launched in the
     children (their counts come back with each stream); fps against
     in-process, each recycle's stall, cold and warm child start to ready,
     the children's RSS at ready and peak, and the card's free memory
     after the run against before it. Then the device ops on the card
     against the port's CPU versions: clahe_batch on 16 gray frames at
     grids 8x8 and 48x27 (within one gray level, modulo 256, of the CPU and
     of clahe_host on at most 0.1% of the pixels; ms a batch),
     motion_stats over frame pairs (counts and boxes exact, centroid and
     deviation within rtol 1e-5) and ConvolutionalKMeans on [65536, 64]
     clustered seeded features, k=32, 20 updates (assignments equal,
     similarity within 1e-5; ms an update); then
     CCTracker.add_frame(input_binary=False) over 16 RGB frames in a child
     with cv2 and PIL blocked, equal to the same run with them allowed.
 12. the lecture's tooling on the card's host, over phase 4's express
     summary and phase 6's stage-01 artifact at 960x540, all 240 frames
     (no kernel launches: it reuses their outputs). Without OpenCV:
     export_gt_tree from the express keyframes, then the eval_summaries
     CLI on the express summary against that tree (a self-evaluation that
     must score 1.0); KeyFrameProjection (default, and one corner moved)
     and KeyFrameWords over the exported keyframes, projections, word
     annotations and unique words saved and loaded back equal;
     TextAnnotationExporter's PNG branch (per frame and unique boxes) on
     phase 9's LectureAnnotation with a speaker track and text regions;
     prepare_text_masks' and prepare_cocotext's mask writers; and
     interpolated_frames over the artifact, every sampled index equal to
     its stage-01 binary. That half runs first in a child with cv2, PIL and
     matplotlib blocked, then here: the files written must be byte-
     identical. With OpenCV installed (one line says whether it is): the
     240 frames as an MJPG AVI, the video_metrics CLI counting 240 frames,
     the export_video CLI over the artifact (through ffmpeg where it is on
     the PATH, else OpenCV's VideoWriter; one line says which) reading
     back 240 frames, validate_dataset on 16 JPEGs, and visual_alignment
     between two warped views of a keyframe. Each step's wall on the
     card's host is printed beside the card's name and power limit.
 13. the four browser editors on the card's host (no kernel launches),
     each through its HTTP server on a free local port: the GT editor over
     a GT tree of phase 4's express keyframes (their lecture frames as the
     raw keyframes): threshold grid, strokes at radius 1-4 (points and
     polylines, paint and erase), an Otsu and a threshold portion, move,
     copy and reject, the chalkboard method, save, then the eval_summaries
     CLI of the express summary against the edited tree; the word
     annotator over that tree (one corner of a quad moved, word trees,
     unique words, unique CCs matched through a projection by the nearest
     warp, formulas, save and reload equal); the annotation editor over
     the 240 frames written as a PNG image list (splits, keyframes, a
     speaker with two keyposes, undo/redo, frames without objects, save
     and reload equal); the ST3D visualizer loaded from phase 6's stage-
     02/03 artifacts as its CLI loads them (all 240 samples in binary
     mode, five in the stable and reconstructed modes, queries under ink
     pixels). That runs first in a child with cv2, PIL and matplotlib
     blocked, then here: the files written and every answer (JSON, and PNG
     bytes by sha256) must be equal. With OpenCV installed: the labelled
     frames, and the port's circle, line (thickness 2-8) and Otsu held
     against it on seeded cases (0 may differ), the nearest warp and gray
     counted only. Each step's wall is printed beside the card's name and
     power limit.
 14. the full-lecture drive (flagship_drive_torch.py), its own phases and
     step table, at the flagship's widths 48..768, pixel kernel 7 and
     1920x1080, cut in depth to 240 frames of 4 boards x 120 glyphs (4 GT
     keyframes), 150 training steps at batch 8 on 256^2 crops, in
     chip_smoke_ws/flagship: an MJPG AVI, the training step (with its
     held-out probe through K2), the five staged CLIs, express, GT
     authoring, scripts_torch/lecturenet_eval_keyframe_bin.py and
     eval_summaries, each a child process as a user starts it. Every step
     exits 0; K1 and K2 launch in stage 01 and express, K2 in the
     training probe and keyframe_bin (whose full-output binarizer has no
     K1); the staged summary (kept before express writes over it) and the
     express summary split at the same samples with the same keyframes, at
     least 2 of them inked; the training losses are finite; every metric
     keyframe_bin and eval_summaries print is finite and in [0, 1] (the
     board variants of the pixel metrics finite); the drive's report is
     written in the workspace. Then 8 of the 1080p binaries the stage-01
     child wrote with the trained checkpoint (bf16, K2 and K1) are held
     within a 1% pixel flip rate of the plain f32 model on the same decoded
     frames, on the card. Each step's wall, in-run time, child peak RSS,
     card peak memory and launches print beside the card's name and power
     limit, and the phase's wall after them. Without OpenCV (no video
     codec) one line says it did not run.
 15. the mesh's model axis for inference at the same widths, bf16, BN
     folded, on meshes over [cuda:0] * n (the shards share the one card:
     the sharded math and K1 and K2 on the shards, no communication
     between cards): (a) express over phase 4's lecture through a
     channel-sharded Binarizer on 1x2, batch 16, with a summary equal to
     phase 4's, and 8 frames within the 1% flip rate of plain f32; (b)
     ShardedBinarizer(shard_params_over_model=True) on 2x2 over 8 frames
     with seeded random weights (every layer reaches the logits); (c)
     ShardedBinarizer(shard_spatial=True) on 1x2 and 1x4 over two 4K board
     scans (3840x2160, padded to 2176 rows) and, on 1x4, a 96-row strip
     that leaves the last shard without rows, each against the meshless
     1x1 ShardedBinarizer in bf16 (flips printed) and plain f32 (1%). Each
     prints ms a batch against meshless (CUDA events; the price of the
     gathers and halos, not a speed-up), the card's peak memory and the K1
     and K2 launches, which must be K1 > 0 and K2 = 4 x the shards holding
     rows x the batches. (d), with 2 or more cards only: cli.binarize -mesh
     1x2 over 2 cards in-process and in a 2-process NCCL world, each
     writing the meshless artifact; otherwise one line says it did not
     run.
 16. training over the mesh's model axis on meshes over [cuda:0] * M (the
     shards of one data position share the card), at phase 8's widths,
     256x256 crops and PNG dataset: (a) 3 fp32 steps (TF32 off) at batch 8
     on 1x2 and 1x4 against the meshless Trainer from the same weights on
     the same batches, for live BN (reconstruction from scratch), frozen
     BN folded (the binarizer phase from warm-start weights) and
     use_weights with clip_norm: losses within rtol 1e-4 and every
     assembled tensor within 1e-4 of its largest |value| (1e-6 at least);
     (b) 10 bf16
     steps of the binarizer phase (live BN) on one batch on 1x2, within
     rtol 2e-2 of meshless bf16 and falling, then the
     bf16 batch-64 step ms and peak GiB of meshless, 1x2 and 1x4 (printed,
     not gated); no kernel may launch in (a) or (b); (c) the trained 1x2
     checkpoint (Trainer.save) through the meshless packed binarizer (K2,
     K1) and ShardedBinarizer's channel shards on 1x2, each within 1% of
     the plain f32 model, K1 and K2 launched, and the shards' logits
     within 2^-6 of the largest meshless bf16 logit; (d), with 2 or more
     cards only: train_binarizer -mesh 1x2 over 2 cards in a child;
     otherwise one line says it did not run.

Each phase's wall prints as it ends, and all of them on one line before the
kernels line. The launch counts are set to 0 just before each of the twelve
paths (phases 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15 and 16; in phase 10 around
each mesh run, and the child processes count their own; in phase 11 the
worker's children count theirs and report them with each stream; in phase
14 every step on the card counts its own in its child and reports them on
its last line, the drive launches nothing in this process, and the
comparison with the plain model after it does not count; in phase 15
around each of its gated runs, its comparisons and timings not counted;
in phase 16 once before its training and around each of (c)'s two runs)
and read just after.
Serving launches are graph replays times the launches each graph holds,
counted by the service: the wrappers count once when a graph is captured.
It prints one JSON line of kernel numbers, then as its last line
``{"ok": true, "device": {...}}``, and exits 0 only when every phase
passed. Without CUDA, or without the package beside it, it exits non-zero
and prints no result.
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
PEAK_TF32_FLOPS = 495e12
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


def k1_check(shape, h, w, gen):
    """K1 against threshold_pack_plain on boundary logits of ``shape``
    cropped to h x w: raises for a bit that differs outside the 2-ulp band
    (or for more than 5% of the band flipped); returns the largest bit
    difference outside the band."""
    import numpy as np
    import torch

    from lecturemath_tpu_torch.ops.postprocess import (threshold_pack,
                                                       threshold_pack_plain)

    band_width = 2 * float(np.spacing(np.float32(THRESHOLD)))
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
    return int(np.abs(got.astype(int) - ref.astype(int))[~band].max())


def phase_k1(batch, flagship_batch):
    """K1 against threshold_pack_plain, at the main path's shape, at the
    full-lecture drive's 1080p stage-01 shape (``flagship_batch`` frames of
    1088x1920 cropped to 1080x1920) and at odd shapes; returns its kernel
    record."""
    import torch

    from lecturemath_tpu_torch.ops.postprocess import (threshold_pack,
                                                       threshold_pack_plain)

    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = 0
    hp, wp = 544, 960
    for shape, (h, w) in (((batch, hp, wp), (HEIGHT, WIDTH)),
                          ((16, hp, wp), (HEIGHT, WIDTH)),
                          ((flagship_batch, 1088, 1920), (1080, 1920)),
                          ((3, 301, 133), (299, 131)), ((1, 37, 45), (37, 45))):
        max_err = max(max_err, k1_check(shape, h, w, gen))

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


def k2_inputs(gen, batch, c1, c2, n_out, k, h, w):
    """Random bf16 channels_last inputs (x2 None for c2 = 0), weight and
    bias of a K2 call."""
    import torch

    def bf16_input(channels):
        return torch.randn(batch, channels, h, w, device="cuda",
                           generator=gen).to(torch.bfloat16).contiguous(
                               memory_format=torch.channels_last)

    c_in = c1 + c2
    x = bf16_input(c1)
    x2 = bf16_input(c2) if c2 else None
    weight = (torch.randn(n_out, c_in, k, k, device="cuda", generator=gen)
              / (c_in * k * k) ** 0.5).to(torch.bfloat16)
    bias = (torch.randn(n_out, device="cuda", generator=gen) * 0.1).to(
        torch.bfloat16)
    return x, x2, weight, bias


def k2_check(x, x2, weight, bias, act, out_dtype):
    """K2 against conv_same_plain (f32) on the same inputs: (max |err|,
    its largest excess over K2_REL * |ref| + K2_ABS); raises where the
    excess is positive."""
    import torch

    from lecturemath_tpu_torch.ops.conv7 import conv_same_nhwc, conv_same_plain

    got = conv_same_nhwc(x, weight, bias, act, out_dtype, x2=x2).float()
    ref = conv_same_plain(x, weight, bias, act, torch.float32, x2=x2)
    err = (got - ref).abs()
    kind = "f32" if out_dtype == torch.float32 else "bf16"
    excess = (err - K2_REL[kind] * ref.abs() - K2_ABS).max().item()
    if excess > 0:
        raise AssertionError(f"K2 outside tolerance at x {tuple(x.shape)}, "
                             f"x2 {None if x2 is None else tuple(x2.shape)}, "
                             f"N {weight.shape[0]}: excess {excess:.3g}")
    return err.max().item(), excess


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

    for name, c1, c2, n_out, act, out_dtype in head_shapes(cfg):
        c_in = c1 + c2
        x, x2, weight, bias = k2_inputs(gen, batch, c1, c2, n_out, k, hp, wp)
        err, excess = k2_check(x, x2, weight, bias, act, out_dtype)
        kind = "f32" if out_dtype == torch.float32 else "bf16"
        max_err = max(max_err, err)
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
# the training data's kernels (K4, K5): on the training paths only
TRAINING_KERNELS = ("median", "augment")


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
    binarizer.packed_fn(torch.from_numpy(warm).cuda())
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
        binarizer.packed_fn(frames.cuda()).cpu().numpy(), WIDTH)
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
                      "indices": list(indices), "times": list(times),
                      "keyframes": keyframes}


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


def inference_group(name, cat):
    """Kernel group of an inference run's device span."""
    return ("K2 conv_igemm_kernel" if "conv_igemm_kernel" in name else
            "K1 threshold_pack_kernel" if "threshold_pack_kernel" in name
            else "K3 cc_*_kernel" if any(
                f"cc_{step}_kernel" in name
                for step in ("local", "merge", "final"))
            else "torch.cat copies" if "CatArrayBatchedCopy" in name
            else "copies and memsets" if cat != "kernel"
            else "trunk and glue (cuDNN, elementwise)")


def device_breakdown(run, what, group_of=inference_group):
    """Run ``run()`` once more under torch.profiler and print where the
    card's time went: device ms by kernel group (``group_of(name, cat)``)
    and the device's busy share of the run's wall clock (the union of
    kernel and copy spans)."""
    wall_ms, spans = profiled_spans(run)
    if not spans:
        log(f"profiled {what}: the profiler saw no device events; device "
            f"breakdown not measured")
        return
    groups, counts, names, name_counts = {}, {}, {}, {}
    busy_us, end_us = 0.0, float("-inf")
    for start, end, cat, name in spans:
        group = group_of(name, cat)
        groups[group] = groups.get(group, 0.0) + (end - start) / 1e3
        counts[group] = counts.get(group, 0) + 1
        names[name[:60]] = names.get(name[:60], 0.0) + (end - start) / 1e3
        name_counts[name[:60]] = name_counts.get(name[:60], 0) + 1
        busy_us += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
    top = {name: [round(ms, 3), name_counts[name],
                  round(ms * 1e3 / name_counts[name], 2)]
           for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:6]}
    log(f"profiled {what} ({wall_ms:.1f} ms wall under the profiler): "
        f"device busy {busy_us / 1e3:.1f} ms = "
        f"{busy_us / 1e3 / wall_ms:.3f} of the wall; device ms by group "
        f"{json.dumps({k: round(v, 3) for k, v in groups.items()})}; "
        f"launches by group {json.dumps(counts)}; top kernels [ms, "
        f"launches, us a launch] {json.dumps(top)}")

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


# K3's tile (rows x columns) and the pixels one of its threads loads at once
K3_TILE_H, K3_TILE_W, K3_SEGMENT = 32, 128, 16


def border_lines(h, w):
    """Single-pixel lines along both sides of K3's tile borders and of its
    16-pixel segment edges, and short crossings of them."""
    import numpy as np

    th, tw, seg = K3_TILE_H, K3_TILE_W, K3_SEGMENT
    img = np.zeros((h, w), np.uint8)
    img[th - 1::th, 5:-5] = 1                   # last row of a tile
    img[2 * th::2 * th, 3:w // 2] = 1           # first row of a tile
    img[5:-5, tw::tw] = 1                       # first column
    img[5:h // 2, tw - 1::2 * tw] = 1           # last column
    img[h // 2:, seg::3 * seg] = 1              # first pixel of a segment
    img[h // 2:, 3 * seg - 1::3 * seg] = 1      # last pixel of a segment
    img[::7, tw - 1:tw + 1] = 1                 # dashes across columns
    img[::5, seg - 1:seg + 1] = 1               # and a segment edge
    img[3 * th - 1:3 * th + 1, ::5] = 1         # dashes across rows
    return img


def stairs(h, w):
    """Vertical runs in neighbouring columns that touch only diagonally."""
    import numpy as np

    img = np.zeros((h, w), np.uint8)
    for x in range(0, w, 3):    # pairs of columns, one blank between
        y0 = 2 * x % h
        img[y0:y0 + 5, x] = 1
        if x + 1 < w:
            img[y0 + 5:y0 + 10, x + 1] = 1
    return img


def across_tile_edges(h, w):
    """All-foreground segments across a tile's column edge, cut every third
    row, and a block across the corner of four tiles."""
    import numpy as np

    th, tw, seg = K3_TILE_H, K3_TILE_W, K3_SEGMENT
    img = np.zeros((h, w), np.uint8)
    img[:, tw - seg:tw + seg] = 1
    img[::3] = 0
    img[th - 8:th + 8, tw - 8:tw + 8] = 1
    return img


def k3_patterns(h, w):
    import numpy as np

    yy, xx = np.mgrid[:h, :w]
    return np.stack([
        snake(h, w, 3), spiral(h, w), np.ones((h, w), np.uint8),
        ((yy + xx) % 2).astype(np.uint8), border_lines(h, w), stairs(h, w),
        across_tile_edges(h, w), np.zeros((h, w), np.uint8)])


def k3_inputs(binaries):
    """(name, uint8 [B, H, W]) batches for phase 5."""
    import numpy as np

    rng = np.random.default_rng(5)
    h, w = HEIGHT, WIDTH
    random = (rng.random((CC_BATCH, h, w))
              < np.linspace(0.5, 0.6, CC_BATCH)[:, None, None]).astype(
                  np.uint8)
    odd = [(rng.random((3, 301, 133)) < 0.55).astype(np.uint8),
           (rng.random((1, 37, 45)) < 0.59).astype(np.uint8)]
    odd[0][1] = spiral(301, 133)
    inputs = [(f"stage-01 frames {list(binaries.shape)}", binaries),
              ("snake, spiral, full, checkerboard, border lines, stairs, "
               "across tile edges, empty", k3_patterns(h, w)),
              (f"random at density 0.5-0.6 {list(random.shape)}", random),
              ("odd [3, 301, 133]", odd[0]), ("odd [1, 37, 45]", odd[1])]
    # widths around the segment and the tile, heights around the tile; the
    # patterns again with a random frame (frames of an odd size start
    # unaligned)
    for gh in (1, 33):
        for gw in (1, 15, 16, 17, 127, 129, 960):
            batch = np.concatenate([k3_patterns(gh, gw), (
                rng.random((1, gh, gw)) < 0.55).astype(np.uint8)])
            inputs.append((f"geometry [{len(batch)}, {gh}, {gw}]", batch))
    return inputs


def graph_ms(fn, replays):
    """Mean device time of fn() over ``replays`` replays of a CUDA graph that
    captured its launches once, by CUDA events: events around a run of
    Python calls would time the host wherever a call takes longer than its
    kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, replays)


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
    ms_by_input = {}
    for name, batch in k3_inputs(binaries):
        dev = torch.from_numpy(np.ascontiguousarray(batch)).cuda()
        got = label_components_batch(dev)
        # the same batch one byte into its storage: no segment is aligned
        storage = torch.zeros(dev.numel() + 1, dtype=torch.uint8,
                              device="cuda")
        shifted = storage[1:].view(dev.shape)
        shifted.copy_(dev)
        unaligned_differ = int((label_components_batch(shifted) != got).sum())
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
        ms_by_input[name] = graph_ms(lambda: label_components_batch(dev), 20)
        bound_us = dev.numel() * 5 / PEAK_BYTES_PER_S * 1e6
        log(f"K3 {name}: {differ} labels differ from the plain version "
            f"({plain_s:.2f} s to its fixed point), {scipy_differ} from "
            f"scipy after compact_labels, {unaligned_differ} on the batch "
            f"one byte into its storage; {components} components; kernel "
            f"{ms_by_input[name] * 1e3:.1f} us a call (graph replay), bound "
            f"{bound_us:.2f} us")
        if differ or scipy_differ or unaligned_differ:
            raise AssertionError(f"K3 disagrees on {name}")

    main = torch.from_numpy(binaries).cuda()
    ms = graph_ms(lambda: label_components_batch(main), 100)
    wall_ms = cuda_ms(lambda: label_components_batch(main), 100)
    plain_ms = cuda_ms(lambda: label_components_plain(main, FIXED_POINT), 3)
    n_bytes = main.numel() * (1 + 4)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    log(f"K3 [{CC_BATCH},{HEIGHT},{WIDTH}] u8 -> int32: kernel "
        f"{ms * 1e3:.1f} us a call (three launches, replayed in a CUDA "
        f"graph; {wall_ms * 1e3:.1f} us a call launched from Python), "
        f"plain {plain_ms:.3f} ms, bound "
        f"{bytes_ms * 1e3:.1f} us (bytes {n_bytes}) = {bytes_ms / ms:.3f} of "
        f"the kernel's time; no PyTorch call labels components")
    device_breakdown(lambda: [label_components_batch(main)
                              for _ in range(20)],
                     f"K3 x20 at [{CC_BATCH},{HEIGHT},{WIDTH}]")
    return {"name": "cc_label", "route": "cuda",
            "source": "lecturemath_tpu_torch/csrc/cc_label.cu",
            "replaces": "lecturemath_tpu/ops/cc_label_pallas.py:33",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bytes_ms, "bound_by": "bytes", "library_ms": None,
            "ms_by_input": ms_by_input}


def phase_k4():
    """K4 against native.median_u8 at the reconstruction phase's batch and
    window; returns its kernel record."""
    import numpy as np
    import torch

    from lecturemath_tpu_torch.ops.median import (median_u8_batch,
                                                  median_u8_plain,
                                                  median_unit_batch)
    from lecturemath_tpu_torch.utils.synthetic import synthetic_rgb_lecture

    shape, k = (8, 256, 256, 3), 35
    boards, _, _, _ = synthetic_rgb_lecture(seed=22, n_frames=8, height=256,
                                            width=256)
    inputs = {"random": np.random.default_rng(22).integers(0, 256, shape,
                                                           np.uint8),
              "boards": np.ascontiguousarray(boards)}
    ms_by_input = {}
    for name, host in inputs.items():
        dev = torch.from_numpy(host).cuda()
        got = median_u8_batch(dev, k).cpu()
        t0 = time.perf_counter()
        plain = median_u8_plain(torch.from_numpy(host), k)
        plain_ms = (time.perf_counter() - t0) * 1e3
        differ = int((got != plain).sum())
        unit = median_unit_batch(dev, k).cpu().numpy()
        want = plain.numpy().astype(np.float32) / 127.5 - 1.0
        differ += int((unit.view(np.uint32) != want.view(np.uint32)).sum())
        ms_by_input[name] = cuda_ms(lambda: median_u8_batch(dev, k), 50, 3)
        unit_ms = cuda_ms(lambda: median_unit_batch(dev, k), 50, 3)
        log(f"K4 {name} {list(shape)} k={k}: {differ} values differ from "
            f"native.median_u8 (uint8 and float32 outputs); kernel "
            f"{ms_by_input[name] * 1e3:.1f} us a launch, "
            f"{unit_ms * 1e3:.1f} us with the float32 output, plain "
            f"(native.median_u8 on the host, a crop at a time) "
            f"{plain_ms:.1f} ms")
        if differ:
            raise AssertionError(f"K4 disagrees on {name}")
    ms = ms_by_input["boards"]
    n_bytes = 2 * int(np.prod(shape))
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    log(f"K4 bound {bytes_ms * 1e3:.2f} us (bytes {n_bytes}) = "
        f"{bytes_ms / ms:.5f} of the kernel's time on boards; no PyTorch "
        f"call computes a median filter")
    return {"name": "median", "route": "cuda",
            "source": "lecturemath_tpu_torch/csrc/median.cu",
            "replaces": None, "max_abs_err": 0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bytes_ms, "bound_by": "bytes",
            "library_ms": None, "ms_by_input": ms_by_input}


# K5's batch: the binarizer phase's recipe (train-bin-b8)
K5_RECIPE = dict(crop_size=(256, 256), crop_min_fg_prc=0.1, flip_chance=0.5,
                 color_invert_chance=0.5, color_change_chance=0.1,
                 gaussian_noise_chance=0.2, gaussian_noise_level=5.0,
                 text_mask_expansion=15, weight_expansion=1)


def phase_k5():
    """K5 against its plain version at the binarizer phase's batch with
    every mix of inversion, hue and noise, its time beside its bytes bound,
    and the host's wall of a batch's pixels on each route; returns its
    kernel record."""
    import tempfile

    import numpy as np
    import torch

    from lecturemath_tpu_torch.ops.augment import augment_batch
    from lecturemath_tpu_torch.train import dataset as dataset_module
    from lecturemath_tpu_torch.utils.png import encode_png
    from lecturemath_tpu_torch.utils.synthetic import synthetic_rgb_lecture

    batch, height, width = 8, 256, 256
    rng = np.random.default_rng(25)
    boards, ink, _, _ = synthetic_rgb_lecture(seed=25, n_frames=batch,
                                              height=height, width=width)
    images = torch.from_numpy(np.ascontiguousarray(boards))
    truths = torch.from_numpy(np.ascontiguousarray(255 - ink))
    params = [(k >> 2 & 1, k >> 1 & 1, int(rng.integers(-81, 81)), 0)
              for k in range(batch)]
    rows = 0
    for k, (invert, hue, shift, _) in enumerate(params):
        params[k] = (invert, hue, shift, rows if k & 1 else -1)
        rows += k & 1
    params = torch.tensor(params, dtype=torch.int32)
    noise = torch.from_numpy(rng.standard_normal((rows, height, width, 3)))
    options = dict(target=True, text_mask_expansion=15, weight_expansion=1,
                   weight_fg_extra=1.0)
    t0 = time.perf_counter()
    plain = augment_batch(images, params, noise, 5.0, truths, **options)
    plain_ms = (time.perf_counter() - t0) * 1e3
    dev = [t.cuda() for t in (images, params, noise)]
    dev_truths = truths.cuda()
    before = augment_batch.launches
    ours = augment_batch(*dev, 5.0, dev_truths, **options)
    torch.cuda.synchronize()
    launched = augment_batch.launches - before
    differ = sum(int((ours[key].cpu().numpy().view(np.uint32)
                      != value.numpy().view(np.uint32)).sum())
                 for key, value in plain.items())
    if differ or launched != 1:
        raise AssertionError("K5 disagrees with its plain version")
    # CUDA events around back-to-back calls time the wrapper's host work
    # (checks, output allocations, the ctypes call) where that is longer
    # than the kernel; the profiler's spans time the kernel itself
    call_ms = cuda_ms(
        lambda: augment_batch(*dev, 5.0, dev_truths, **options), 100, 5)
    kernel_ms = {}
    for name, truth, cases in (("binarizer", dev_truths, options),
                               ("reconstruction", None,
                                dict(keep_crops=True))):
        _, spans = profiled_spans(lambda: [augment_batch(
            *dev, 5.0, truth, **cases) for _ in range(50)])
        launches = [end - start for start, end, cat, kernel in spans
                    if cat == "kernel" and "augment_kernel" in kernel]
        kernel_ms[name] = (sum(launches) / len(launches) / 1e3 if launches
                           else None)
    ms = kernel_ms["binarizer"]
    n_bytes = (images.numel() + truths.numel() + params.numel() * 4
               + noise.numel() * 8
               + 4 * sum(value.numel() for value in plain.values()))
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    timed = ("not measured (the profiler saw no kernel)" if ms is None else
             f"{ms * 1e3:.1f} us a launch, bound {bytes_ms * 1e3:.2f} us "
             f"(bytes {n_bytes}) = {bytes_ms / ms:.4f} of it")
    log(f"K5 {[batch, height, width, 3]} with ground truth, every mix of "
        f"inversion, hue and noise ({rows} noisy): {differ} values differ "
        f"from the plain version, {launched} launch; kernel {timed}; "
        f"without ground truth, crops kept (the reconstruction phase) "
        f"{kernel_ms['reconstruction']} ms; a call back to back "
        f"{call_ms * 1e3:.1f} us (the wrapper's host work); plain "
        f"(train/augment.py on the host, a sample at a time) "
        f"{plain_ms:.1f} ms")

    # the host's wall of a batch's pixels after its draws, on each route
    directory = tempfile.mkdtemp(prefix="k5_frames_")
    try:
        frames, frame_ink, _, _ = synthetic_rgb_lecture(
            seed=26, n_frames=16, height=540, width=960)
        pairs = ([], [])
        for k in range(len(frames)):
            for paths, array, name in ((pairs[0], frames[k][:, :, ::-1], ""),
                                       (pairs[1], 255 - frame_ink[k],
                                        "_gt")):
                paths.append(os.path.join(directory, f"{k}{name}.png"))
                with open(paths[-1], "wb") as f:
                    f.write(encode_png(np.ascontiguousarray(array)))
        dataset = dataset_module.LectureNetDataset(*pairs, seed=3,
                                                   **K5_RECIPE)
        dataset.preload()
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    walls, counts = {}, {}
    original = dataset_module.median_route
    try:
        for route in ("cuda", "native"):
            dataset_module.median_route = (lambda route=route: route)
            plans = [dataset._plan(k) for k in range(batch)]
            dataset._make(plans)
            torch.cuda.synchronize()
            dataset.data_stats.update(pixels_card=0, pixels_host=0)
            t0 = time.perf_counter()
            for _ in range(20):
                dataset._make(plans)
            walls[route] = (time.perf_counter() - t0) * 1e3 / 20
            torch.cuda.synchronize()
            counts[route] = (dataset.data_stats["pixels_card"],
                             dataset.data_stats["pixels_host"])
    finally:
        dataset_module.median_route = original
    card, host = counts["cuda"]
    log(f"K5 route: a batch's pixels after its draws take {walls['cuda']:.3f}"
        f" ms of host wall on the card's route (staging, one upload, K5) and "
        f"{walls['native']:.3f} ms on the host's (the plain version); on the "
        f"card's route {card} of {card + host} samples' pixels on the card "
        f"({card / (card + host):.2f})")
    if card != 20 * batch:
        raise AssertionError(f"K5's route made {host} samples on the host")
    return {"name": "augment", "route": "cuda",
            "source": "lecturemath_tpu_torch/csrc/augment.cu",
            "replaces": None, "max_abs_err": 0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bytes_ms, "bound_by": "bytes",
            "library_ms": None, "call_ms": call_ms,
            "kernel_ms_by_phase": kernel_ms, "route_host_ms": walls}


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

    # check 3: every kernel of the path ran (the training data's are not on
    # it)
    for name, count in launches.items():
        if count <= 0 and name not in TRAINING_KERNELS:
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


# the serving phase: the bucket a request is resized to, the largest batch
# bucket, the micro-batching window, and the HTTP client's timeout
SERVE_MAX_BATCH = 8
SERVE_WINDOW_MS = 5.0
# the kernels a serving graph holds: profiler group -> launch counter
SERVING_KERNELS = {"K2": "conv_same_nhwc", "K1": "threshold_pack"}
HTTP_TIMEOUT_S = 120
# seconds between starting the client processes and their first requests
CLIENT_START_S = 8.0


def percentile(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q))


def encode_png_filtered(rgb, kinds=None):
    """PNG bytes of uint8 RGB [H, W, 3] with row y filtered by kinds[y %
    len(kinds)], or by libpng's adaptive heuristic (the default of Pillow
    and of browsers' encoders): the filter of None, Sub, Up, Avg and Paeth
    whose bytes, read as signed, sum to the least magnitude. zlib level
    6. Returns (bytes, rows of each filter type)."""
    import struct
    import zlib

    import numpy as np

    height, width, channels = rgb.shape
    x = rgb.reshape(height, width * channels).astype(np.int16)
    left = np.zeros_like(x)
    left[:, channels:] = x[:, :-channels]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    up_left = np.zeros_like(x)
    up_left[1:, channels:] = x[:-1, :-channels]
    p = left + up - up_left
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, up_left))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    filtered = ((x[None] - preds) & 0xFF).astype(np.uint8)
    if kinds is None:
        signed = filtered.astype(np.int32)
        cost = np.minimum(signed, 256 - signed).sum(axis=2)
        choice = cost.argmin(axis=0)
    else:
        choice = np.asarray(kinds)[np.arange(height) % len(kinds)]
    raw = np.concatenate([choice.astype(np.uint8)[:, None],
                          filtered[choice, np.arange(height)]], axis=1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    body = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))
    return body, np.bincount(choice, minlength=5).tolist()


def http_post(url, body):
    """(status, body bytes, seconds) of one POST; an HTTP error status is
    returned, not raised."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    request = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(request, timeout=HTTP_TIMEOUT_S) as r:
            status, data = r.status, r.read()
    except urllib.error.HTTPError as err:
        status, data = err.code, err.read()
    return status, data, time.perf_counter() - t0


def http_get_json(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def client_process(base, bodies, jobs, start_at):
    """A client process: one thread per job (a list of body indices sent
    one after another), all starting at ``start_at`` on the wall clock the
    parent shares; returns [(index, start, status, seconds, answer)]."""
    import threading

    out = []
    lock = threading.Lock()
    late = time.time() - start_at
    if late > 0:
        raise RuntimeError(f"client process started {late:.3f} s late")
    time.sleep(start_at - time.time())

    def run(job):
        for k in job:
            start = time.time()
            status, data, seconds = http_post(f"{base}/binarize", bodies[k])
            with lock:
                out.append((k, start, status, seconds, data))

    threads = [threading.Thread(target=run, args=(job,)) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def load_clients(base, bodies, clients, per_client):
    """``clients`` clients, each sending ``per_client`` requests one after
    another, spread over up to 8 client processes that all start at one
    moment (``CLIENT_START_S`` after the call, time enough for the
    processes to come up). Returns (answers, that moment)."""
    import concurrent.futures
    import multiprocessing

    processes = min(clients, 8)
    jobs = [[(c + i) % len(bodies) for i in range(per_client)]
            for c in range(clients)]
    start_at = time.time() + CLIENT_START_S
    with concurrent.futures.ProcessPoolExecutor(
            processes, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(client_process, base, bodies,
                               jobs[p::processes], start_at)
                   for p in range(processes)]
        return ([answer for future in futures for answer in future.result()],
                start_at)


def host_breakdown(bodies, service):
    """Host ms of the server's per-request steps, by the host clock: the
    PNG decode of each body in ``bodies`` (name -> body; the first is a
    960x540 body as encode_png writes it), the answer's PNG encode, and a
    bucket-1 dispatch (upload, replay, fetch, unpack); then decodes a
    second in 1 and 8 threads, and the dispatch's ms while 8 threads
    decode."""
    import numpy as np

    from lecturemath_tpu_torch.pipeline.server import decode_image
    from lecturemath_tpu_torch.utils.png import encode_png

    steps = {}
    for name, data in bodies.items():
        decode_image(data)
        t0 = time.perf_counter()
        for _ in range(10):
            decode_image(data)
        steps[f"decode_png {name}"] = (time.perf_counter() - t0) * 100
    body = next(iter(bodies.values()))
    rgb = decode_image(body)
    binary = service._dispatch(rgb[None])[0]
    t0 = time.perf_counter()
    for _ in range(10):
        service._dispatch(rgb[None])
    steps["dispatch bucket 1"] = (time.perf_counter() - t0) * 100
    t0 = time.perf_counter()
    for _ in range(10):
        encode_png(np.ascontiguousarray(binary))
    steps["encode_png"] = (time.perf_counter() - t0) * 100
    steps["batch window"] = service.batch_window_s * 1e3
    log(f"serving host ms per request step (host clock, mean of 10): "
        f"{json.dumps({k: round(v, 3) for k, v in steps.items()})}")

    # do the handler threads' decodes overlap, and what do they cost the
    # worker's dispatch? 8 threads decode 8 bodies each while this thread
    # dispatches bucket 1 ten times
    import threading

    decodes = {}
    for threads in (1, 8):
        busy = [threading.Thread(target=lambda: [decode_image(body)
                                                 for _ in range(8)])
                for _ in range(threads)]
        t0 = time.perf_counter()
        for t in busy:
            t.start()
        dispatch_s = []
        if threads > 1:
            for _ in range(10):
                t1 = time.perf_counter()
                service._dispatch(rgb[None])
                dispatch_s.append(time.perf_counter() - t1)
        for t in busy:
            t.join()
        decodes[threads] = (8 * threads / (time.perf_counter() - t0),
                            dispatch_s)
    log(f"serving PNG decodes a second in 1 / 8 threads: "
        f"{decodes[1][0]:.1f} / {decodes[8][0]:.1f}; bucket-1 dispatch ms "
        f"while 8 threads decode: mean "
        f"{np.mean(decodes[8][1]) * 1e3:.3f}, max "
        f"{np.max(decodes[8][1]) * 1e3:.3f} (alone "
        f"{steps['dispatch bucket 1']:.3f})")
    return steps


def pool_bytes(pool):
    """Device bytes of the caching allocator's segments in a graph pool."""
    import torch

    return sum(segment["total_size"]
               for segment in torch.cuda.memory_snapshot()
               if tuple(segment.get("segment_pool_id", ())) == tuple(pool))


def kernel_us_by_group(run, reps):
    """Device µs a call of ``run()`` in K2, K1 and other kernels, and the
    launches of each a call, from torch.profiler over ``reps`` calls (None
    when it saw no kernels)."""
    _, spans = profiled_spans(lambda: [run() for _ in range(reps)])
    if not spans:
        return None
    out = {"K2": 0.0, "K1": 0.0, "other": 0.0,
           "launches": {"K2": 0, "K1": 0, "other": 0}}
    for start, end, cat, name in spans:
        if cat != "kernel":
            continue
        group = ("K2" if "conv_igemm_kernel" in name else
                 "K1" if "threshold_pack_kernel" in name else "other")
        out[group] += (end - start) / reps
        out["launches"][group] += 1
    out["launches"] = {k: v / reps for k, v in out["launches"].items()}
    return out


def forward_and_pack_launches(binarizer, frames):
    """(device kernels and copies one eager packed forward launches, those
    that packing the four heads' K2 weights launches) under
    torch.profiler."""
    import torch

    from lecturemath_tpu_torch.ops.conv7 import n_tiles, pack_weights

    model = binarizer.model

    def pack():
        for name, (c1, c2) in model.head_inputs().items():
            conv = getattr(model, name)[0]
            pack_weights(conv.weight, c1, c2, n_tiles(conv.weight.shape[0]))
            conv.bias.detach().float().contiguous()

    counts = []
    for run in (lambda: binarizer.packed_fn(frames), pack):
        run()
        torch.cuda.synchronize()
        _, spans = profiled_spans(run)
        counts.append(len(spans))
    return counts


def stage01_host_paths(config):
    """Stage 01 on the card where it once imported OpenCV and Pillow: four
    3840x2160 frames (above the 2.5 MP cap) halved on the host to 1920x1080
    by each filter, binarized, and resized back by nearest; and eight
    960x540 frames uploaded as I420. Each output is held against the same
    frames binarized directly (4K) or uploaded as RGB (I420), within the
    flip bound, and the numpy resampling against Pillow and OpenCV where
    they import. Returns the host ms per frame of each host step (host
    clock), Pillow's and OpenCV's beside them where they import."""
    import importlib.util

    import numpy as np
    import torch

    from lecturemath_tpu_torch.models.fcn_lecturenet import (
        rgb_to_yuv420_host, unpack_bits_host)
    from lecturemath_tpu_torch.pipeline.binarize import (Binarizer,
                                                         _downscale_batch)
    from lecturemath_tpu_torch.pipeline.video import ArraySource
    from lecturemath_tpu_torch.utils.image import resize_nearest
    from lecturemath_tpu_torch.utils.synthetic import \
        SyntheticRGBLectureSource

    def per_frame_ms(fn, n):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3 / n

    uhd = SyntheticRGBLectureSource(
        seed=3, n_frames=4, height=2160, width=3840, n_boards=2,
        glyphs_per_board=40, glyph_size=(160, 240))
    frames = np.stack([uhd.rgb_frame(t).copy() for t in range(4)])
    half = (1920, 1080)
    host_ms = {}
    for filt in ("lanczos", "area"):
        binarizer = Binarizer.from_config(config, batch_size=4,
                                          downscale_filter=filt)
        assert binarizer.packed_fn is not None
        binarizer.process_source(ArraySource(frames))   # first use
        (_, _, binaries), ms = per_frame_ms(
            lambda: binarizer.process_source(ArraySource(frames)), 4)
        host_ms[f"3840x2160 stage 01 {filt} (whole)"] = ms
        host_ms[f"3840x2160 halve {filt} (in the stage)"] = \
            binarizer.stream_stats["downscale_s"] * 1e3 / 4
        small, ms = per_frame_ms(
            lambda: _downscale_batch(frames, half, filt), 4)
        host_ms[f"3840x2160 halve {filt}"] = ms
        bits = binarizer.packed_fn(torch.from_numpy(small).cuda())
        direct = unpack_bits_host(bits.cpu().numpy(), half[0])
        back, ms = per_frame_ms(lambda: [resize_nearest(b, (3840, 2160))
                                         for b in direct], 4)
        host_ms["1920x1080 -> 3840x2160 resize_nearest"] = ms
        flips = max(float(np.mean(ours != 255 - theirs))
                    for ours, theirs in zip(binaries, back))
        log(f"stage 01 at 3840x2160, {filt}: {len(binaries)} frames of "
            f"{binaries[0].shape}, flip rate against the halved frames "
            f"binarized directly {flips:.6f}")
        if len(binaries) != 4 or binaries[0].shape != (2160, 3840) or \
                flips > MAX_FLIP_RATE:
            raise AssertionError(f"stage 01 at 3840x2160 ({filt}) is wrong")
        if filt == "lanczos" and importlib.util.find_spec("PIL"):
            from PIL import Image

            theirs, ms = per_frame_ms(lambda: np.stack([np.asarray(
                Image.fromarray(f).resize(half, Image.LANCZOS))
                for f in frames]), 4)
            host_ms["3840x2160 halve lanczos, Pillow"] = ms
            if not np.array_equal(small, theirs):
                raise AssertionError("halve_lanczos differs from Pillow")
        if filt == "area" and importlib.util.find_spec("cv2"):
            import cv2

            theirs, ms = per_frame_ms(lambda: np.stack([cv2.resize(
                f, half, interpolation=cv2.INTER_AREA) for f in frames]), 4)
            host_ms["3840x2160 halve area, OpenCV"] = ms
            if not np.array_equal(small, theirs):
                raise AssertionError("resize_area differs from OpenCV")

    source = make_source()
    frames = np.stack([source.rgb_frame(t).copy()
                       for t in np.linspace(0, N_FRAMES - 1, 8).astype(int)])
    outputs = {}
    for upload in ("rgb", "yuv420"):
        binarizer = Binarizer.from_config(config, batch_size=8,
                                          upload_format=upload)
        assert binarizer.upload_format == upload
        _, _, outputs[upload] = binarizer.process_source(ArraySource(frames))
    flips = float(np.mean(np.stack(outputs["rgb"])
                          != np.stack(outputs["yuv420"])))
    planes, ms = per_frame_ms(lambda: rgb_to_yuv420_host(frames), 8)
    host_ms["960x540 rgb_to_yuv420"] = ms
    if importlib.util.find_spec("cv2"):
        import cv2

        theirs, ms = per_frame_ms(lambda: np.stack([cv2.cvtColor(
            f, cv2.COLOR_RGB2YUV_I420) for f in frames]), 8)
        host_ms["960x540 rgb_to_yuv420, OpenCV"] = ms
        if not np.array_equal(planes, theirs):
            raise AssertionError("rgb_to_yuv420 differs from OpenCV")
    log(f"stage 01 with I420 uploads: flip rate against RGB uploads "
        f"{flips:.6f} (chroma of each 2x2 block; bound {MAX_FLIP_RATE})")
    if flips > MAX_FLIP_RATE:
        raise AssertionError("I420 uploads flip too many pixels")
    log(f"stage 01 host ms per frame (host clock): "
        f"{json.dumps({k: round(v, 3) for k, v in host_ms.items()})}")
    return host_ms


def phase_serving(conf, counters):
    """The serving path on the card; returns (serving launches by kernel,
    per-bucket numbers)."""
    import contextlib
    import io
    import threading

    import numpy as np
    import torch

    from lecturemath_tpu_torch.cli import doctor
    from lecturemath_tpu_torch.core.backend_probe import ensure_backend
    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.models.convert import (load_checkpoint,
                                                      save_checkpoint)
    from lecturemath_tpu_torch.models.fcn_lecturenet import (
        FCNLectureNet, make_packed_binarizer, unpack_bits_host)
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer
    from lecturemath_tpu_torch.pipeline.server import BinarizeService, serve
    from lecturemath_tpu_torch.utils.image import resize_area, resize_nearest
    from lecturemath_tpu_torch.utils.png import (decode_png, decode_png_gray,
                                                 encode_png)
    from lecturemath_tpu_torch.utils.synthetic import (
        SyntheticRGBLectureSource, threshold_binarizer_variables)

    config = Config.from_file(conf)
    blind_path = os.path.join(WORKSPACE, "models", "blind.dat")

    def factory(checkpoint=None):
        if checkpoint is None:
            return Binarizer.from_config(config)
        override = Config({key: config.get(key) for key in config})
        override.set("BINARIZATION_FCN_LECTURENET_FILENAME",
                     os.path.basename(checkpoint))
        return Binarizer.from_config(override)

    source = make_source()
    frames = np.stack([source.rgb_frame(t).copy()
                       for t in np.linspace(0, N_FRAMES - 1,
                                            SERVE_MAX_BATCH).astype(int)])

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    service = BinarizeService(factory(), model_size=(WIDTH, HEIGHT),
                              max_batch=SERVE_MAX_BATCH,
                              batch_window_ms=SERVE_WINDOW_MS,
                              binarizer_factory=factory)
    warm_s = time.perf_counter() - t0
    active = service._active
    binarizer = active.binarizer
    if not active.graphs_enabled or \
            sorted(active.graphs) != service.batch_buckets:
        raise AssertionError(f"graphs not captured: {sorted(active.graphs)}")
    log(f"serving: buckets {service.batch_buckets} captured in "
        f"{active.capture_s:.3f} s (warm-up with the eager first passes "
        f"{warm_s:.3f} s); graph pool {pool_bytes(active.pool)} B (estimate "
        f"{service.graph_pool_estimate()} B); reserved +"
        f"{torch.cuda.memory_reserved() - reserved0} B; launches per replay "
        f"{json.dumps({b: g.launches for b, g in active.graphs.items()})}; "
        f"wrapper counts after warm-up (eager first passes and captures) "
        f"{json.dumps({k: f.launches for k, f in counters.items()})}")

    # per bucket: graph against the eager kernels and the plain f32 path
    plain = FCNLectureNet(binarizer.model.config, plain=True)
    plain.load_state_dict(load_checkpoint(os.path.join(
        WORKSPACE, "models", "smoke.dat")))
    plain_fn = make_packed_binarizer(
        Binarizer(plain, batch_size=8, dtype=torch.float32).model)
    eager_service = BinarizeService(binarizer, model_size=(WIDTH, HEIGHT),
                                    max_batch=SERVE_MAX_BATCH,
                                    batch_window_ms=SERVE_WINDOW_MS,
                                    warmup=False, graphs=False)
    by_bucket = {}
    try:
        for bucket in service.batch_buckets:
            batch = frames[:bucket]
            graph = active.graphs[bucket]
            with active.stream_context():
                graph_bits = graph.run(batch).clone()
            eager_bits = binarizer.packed_fn(torch.from_numpy(batch).cuda())
            plain_bits = plain_fn(torch.from_numpy(batch).cuda())
            torch.cuda.synchronize()
            identical = bool(torch.equal(graph_bits, eager_bits))
            flips = float(np.mean(unpack(graph_bits, WIDTH)
                                  != unpack(plain_bits, WIDTH)))
            static_in = graph.static_in
            graph_ms = cuda_ms(graph.graph.replay, 20)
            eager_ms = cuda_ms(lambda: binarizer.packed_fn(static_in), 20)
            dispatch = {}
            for name, svc in (("graph", service), ("eager", eager_service),
                              ("graph again", service),
                              ("eager again", eager_service)):
                t0 = time.perf_counter()
                for _ in range(5):
                    svc._dispatch(batch)
                dispatch[name] = (time.perf_counter() - t0) / 5 * 1e3
            groups = kernel_us_by_group(graph.graph.replay, 10)
            by_bucket[bucket] = {
                "identical": identical, "flip_rate": flips,
                "graph_ms": graph_ms, "eager_ms": eager_ms,
                "dispatch_ms": dispatch, "device_us": groups}
            log(f"serving bucket {bucket}: graph output bit-identical to the "
                f"eager kernels {identical}; flip rate against plain f32 "
                f"{flips:.6f} (bound {MAX_FLIP_RATE}); device ms per dispatch "
                f"{graph_ms:.3f} by graph replay, {eager_ms:.3f} eager (events "
                f"around 20 calls); host ms per dispatch with upload, fetch "
                f"and unpack {json.dumps({k: round(v, 3) for k, v in dispatch.items()})}; "
                f"device us per replay by group (profiler) "
                f"{json.dumps(groups and {k: round(v, 1) for k, v in groups.items() if k != 'launches'})}; "
                f"kernel launches per replay (profiler) "
                f"{json.dumps(groups and groups['launches'])} against the "
                f"graph's count at capture {json.dumps(graph.launches)}")
            if not identical:
                raise AssertionError(f"bucket {bucket}: graph output differs "
                                     f"from the eager kernel path")
            if flips > MAX_FLIP_RATE:
                raise AssertionError(f"bucket {bucket}: flip rate {flips}")
            # the service counts replays x the launches counted at capture:
            # hold that against what a replay really launches
            if groups is None or any(
                    groups["launches"][key] != graph.launches[name]
                    for key, name in SERVING_KERNELS.items()):
                raise AssertionError(
                    f"bucket {bucket}: a replay launched "
                    f"{groups and groups['launches']}, the graph counted "
                    f"{graph.launches} at capture")
    finally:
        eager_service.close()
    forward_launches, pack_launches = forward_and_pack_launches(
        binarizer, active.graphs[1].static_in)
    log(f"device launches per forward at bucket 1 (eager, profiler): "
        f"{forward_launches} with the heads' packed weights cached; packing "
        f"them as every forward did before (pack_weights and the f32 bias "
        f"of the four heads) launches {pack_launches} more")

    # the bits of one frame dispatched alone, as the server should answer
    def direct(frame):
        resized = (frame if frame.shape[:2] == (HEIGHT, WIDTH)
                   else resize_area(frame, (WIDTH, HEIGHT)))
        bits = binarizer.packed_fn(torch.from_numpy(resized[None]).cuda())
        binary = unpack_bits_host(bits.cpu().numpy(), WIDTH)[0]
        if binary.shape != frame.shape[:2]:
            binary = resize_nearest(binary, (frame.shape[1], frame.shape[0]))
        return binary

    server = serve(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    results = {}
    try:
        status, health = http_get_json(f"{base}/healthz")
        log(f"serving /healthz {status}: {json.dumps(health)}")
        if status != 200 or health["device"] != "cuda" or not health["graphs"]:
            raise AssertionError("/healthz is not ok on the card")

        bodies = [encode_png(frame[:, :, ::-1]) for frame in frames]
        expected = [direct(frame) for frame in frames]
        # bodies as other writers send them: libpng's adaptive filtering
        # at 960x540, and 1920x1080 frames (the 2x area path) adaptive or
        # with every row filter in turn (Avg and Paeth rows included)
        adaptive, filters = [], {}
        for frame in frames:
            body, counts = encode_png_filtered(frame)
            adaptive.append(body)
            filters["adaptive 960x540"] = np.add(
                filters.get("adaptive 960x540", 0), counts).tolist()
        hd_source = SyntheticRGBLectureSource(
            seed=2, n_frames=4, height=1080, width=1920, n_boards=2,
            glyphs_per_board=40, glyph_size=(80, 120))
        hd_frames = [hd_source.rgb_frame(t).copy() for t in range(4)]
        hd_bodies = []
        for t, frame in enumerate(hd_frames):
            name = ("adaptive 1920x1080" if t % 2 == 0
                    else "every filter 1920x1080")
            body, counts = encode_png_filtered(
                frame, None if t % 2 == 0 else [0, 1, 2, 3, 4])
            hd_bodies.append(body)
            filters[name] = np.add(filters.get(name, 0), counts).tolist()
        hd_expected = [direct(frame) for frame in hd_frames]
        for body, frame in zip(adaptive + hd_bodies,
                               list(frames) + hd_frames):
            if not np.array_equal(decode_png(body), frame):
                raise AssertionError("decode_png of a filtered body differs "
                                     "from its frame")
        log(f"serving bodies' rows by PNG filter (None, Sub, Up, Avg, "
            f"Paeth): {json.dumps(filters)}")

        def check(status, data, k, what, expected):
            if status != 200:
                raise AssertionError(f"{what}: HTTP {status} {data[:200]!r}")
            answer = decode_png_gray(data)
            return float(np.mean(answer != expected[k]))

        # concurrent clients, in processes of their own (a client in this
        # process would hold the server's interpreter lock): answers may
        # ride buckets 2-8 (another cuDNN choice in the trunk could flip a
        # pixel on the threshold, hence the flip bound)
        loads = (("1 client", bodies, expected, 1, 32),
                 ("8 clients", bodies, expected, 8, 8),
                 ("32 clients", bodies, expected, 32, 4),
                 ("8 clients adaptive 960x540", adaptive, expected, 8, 8),
                 ("8 clients 1920x1080 adaptive and every filter", hd_bodies,
                  hd_expected, 8, 4))
        for name, load_bodies, load_expected, clients, per_client in loads:
            before = service.stats()
            answers, start_at = load_clients(base, load_bodies, clients,
                                             per_client)
            after = service.stats()
            ends = [a[1] + a[3] for a in answers]
            latencies = [a[3] for a in answers if a[2] == 200]
            errors = [a[2] for a in answers if a[2] != 200]
            shares = [check(status, data, k, name, load_expected)
                      for k, _, status, _, data in answers if status == 200]
            batches = after["batches"] - before["batches"]
            n = clients * per_client
            results[name] = {
                "req_s": n / (max(ends) - start_at),
                "p50_ms": percentile(latencies, 50) * 1e3,
                "p99_ms": percentile(latencies, 99) * 1e3,
                "mean_batch": (after["frames"] - before["frames"])
                / max(batches, 1),
                "max_flip_rate": max(shares) if shares else None}
            log(f"serving {name} x {per_client} requests (client "
                f"processes): {json.dumps({k: v and round(v, 4) for k, v in results[name].items()})}; "
                f"errors {errors[:3]}")
            if errors or len(shares) != n:
                raise AssertionError(f"{len(errors)} failed requests")
            if max(shares) > MAX_FLIP_RATE:
                raise AssertionError(f"a concurrent answer flips "
                                     f"{max(shares)} of its pixels")
            if clients == 1 and max(shares) > 0:
                # one client: every request is its own bucket-1 dispatch
                raise AssertionError("a lone request's answer differs from "
                                     "the direct binarization")
        results["host ms"] = host_breakdown(
            {"encode_png 960x540": bodies[0],
             "adaptive 960x540": adaptive[0],
             "adaptive 1920x1080": hd_bodies[0],
             "every filter 1920x1080": hd_bodies[1]}, service)

        # other sizes: 3840x2160 and 1920x1080 take the integer area path,
        # 1280x720 the fractional one, 640x480 the upscale
        for width, height in ((3840, 2160), (1920, 1080), (1280, 720),
                              (640, 480)):
            big = SyntheticRGBLectureSource(
                seed=1, n_frames=4, height=height, width=width, n_boards=1,
                glyphs_per_board=20, glyph_size=(40, 60))
            for t in (1, 3):
                frame = big.rgb_frame(t).copy()
                status, data, seconds = http_post(
                    f"{base}/binarize", encode_png(frame[:, :, ::-1]))
                if status != 200:
                    raise AssertionError(f"{width}x{height}: HTTP {status}")
                answer = decode_png_gray(data)
                differ = int((answer != direct(frame)).sum())
                log(f"serving {width}x{height} frame {t}: answer "
                    f"{answer.shape}, {differ} pixels differ from a direct "
                    f"binarization, {seconds * 1e3:.1f} ms")
                if answer.shape != (height, width) or differ:
                    raise AssertionError(f"{width}x{height} answer is wrong")

        # /reload mid-traffic: every answer is the old model's or the new
        # one's for the batch bucket it rode in
        save_checkpoint(threshold_binarizer_variables(
            binarizer.model.config, seed=0, threshold_gray=5.0), blind_path)
        frame = frames[1]

        def references(model_binarizer):
            refs = set()
            for bucket in service.batch_buckets:
                bits = model_binarizer.packed_fn(torch.from_numpy(
                    np.stack([frame] * bucket)).cuda())
                for binary in unpack_bits_host(bits.cpu().numpy(), WIDTH):
                    refs.add(binary.tobytes())
            return refs

        old_refs = references(binarizer)
        answers, errors = [], []
        stop = threading.Event()
        body = bodies[1]

        def traffic():
            while not stop.is_set():
                status, data, _ = http_post(f"{base}/binarize", body)
                if status != 200:
                    errors.append(status)
                else:
                    answers.append(decode_png_gray(data).tobytes())

        threads = [threading.Thread(target=traffic) for _ in range(8)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        status, data, reload_s = http_post(
            f"{base}/reload", json.dumps({"checkpoint": blind_path}).encode())
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        new_refs = references(service._active.binarizer)
        n_old = sum(a in old_refs for a in answers)
        n_new = sum(a in new_refs for a in answers)
        log(f"serving /reload under 8 clients: HTTP {status} in "
            f"{reload_s:.3f} s; {len(answers)} answers, {n_old} of the old "
            f"model, {n_new} of the new, {len(errors)} errors; reference "
            f"sets old {len(old_refs)} new {len(new_refs)} overlap "
            f"{len(old_refs & new_refs)}; new graphs "
            f"{sorted(service._active.graphs)} pool "
            f"{pool_bytes(service._active.pool)} B")
        if status != 200 or errors or old_refs & new_refs or \
                n_old + n_new != len(answers) or not n_old or not n_new:
            raise AssertionError("reload under traffic: not old XOR new")

        status, data, _ = http_post(f"{base}/binarize", b"not an image")
        log(f"serving a body that is not an image: HTTP {status} "
            f"{data.decode()}")
        if status != 400:
            raise AssertionError("a body that is not an image must be 400")
        status, stats = http_get_json(f"{base}/stats")
        log(f"serving /stats: {json.dumps(stats)}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()

    torch.cuda.synchronize()
    launches = dict(stats["kernel_launches"])
    log(f"serving launches by graph replays (replays x launches per graph, "
        f"counted by the service; the wrappers count once per capture): "
        f"{json.dumps(launches)} in {stats['graph_replays']} replays; "
        f"wrapper counts over the phase (eager first passes, captures, the "
        f"comparisons) {json.dumps({k: f.launches for k, f in counters.items()})}")
    for name in EXPRESS_KERNELS:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by a "
                                 f"serving replay")

    results["stage 01 host ms"] = stage01_host_paths(config)
    ensure_backend()
    log("ensure_backend(): ok")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = doctor.main(["doctor"])
    for line in out.getvalue().splitlines():
        if line.strip():
            log(f"doctor: {line}")
    log(f"doctor exit code {code}")
    for name in ("device backend", "CUDA kernels", "native C++ kernels"):
        if f"[PASS] {name}" not in out.getvalue():
            raise AssertionError(f"doctor: {name} did not pass")
    return launches, {"buckets": by_bucket, "http": results}


# ---------------------------------------------------------------- phase 8

# the training curriculum at the production widths of CONFIG: 256x256 crops
# and batch 8 (configs/example.conf:176-194), each phase a few steps over
# 16 frames of both eras with their ground truth; the learning rates are
# the example config's
TRAIN_FRAMES = list(range(0, N_FRAMES, 15))
TRAIN_BATCH = 8
TRAINING_CONFIG = """BINARIZATION_FCN_LECTURENET_FILENAME = binarizer.msgpack
FCN_BINARIZER_PRETRAIN_REC_IMAGES_DIR = {ws}/training/images
FCN_BINARIZER_PRETRAIN_REC_LEARNING_RATE = 0.01
FCN_BINARIZER_PRETRAIN_REC_EPOCHS = 2
FCN_BINARIZER_PRETRAIN_REC_MEDIAN = True
FCN_BINARIZER_PRETRAIN_REC_MEDIAN_BLUR_K = 35
FCN_BINARIZER_PRETRAIN_RECONSTRUCTION_OUTPUT = {ws}/models/rec_pretrain.msgpack
FCN_BINARIZER_PRETRAIN_IMAGES_DIR = {ws}/training/images
FCN_BINARIZER_PRETRAIN_MASKS_DIR = {ws}/training/text_masks
FCN_BINARIZER_PRETRAIN_LEARNING_RATE = 0.01
FCN_BINARIZER_PRETRAIN_EPOCHS = 5
FCN_BINARIZER_PRETRAIN_BATCH_SIZE = {batch}
FCN_BINARIZER_PRETRAIN_PRELOAD_IMAGES = True
FCN_BINARIZER_PRETRAIN_USE_RECONSTRUCTION_OUTPUT = True
FCN_BINARIZER_PRETRAIN_TEXT_OUTPUT = {ws}/models/text_pretrain.msgpack
FCN_BINARIZER_TRAIN_LEARNING_RATE = 0.001
FCN_BINARIZER_TRAIN_EPOCHS = 5
FCN_BINARIZER_TRAIN_BATCH_SIZE = {batch}
FCN_BINARIZER_TRAIN_USE_PRETRAIN_OUTPUT = True
FCN_BINARIZER_TRAIN_PRETRAIN_OUTPUT = {ws}/models/text_pretrain.msgpack
FCN_BINARIZER_TRAIN_OUTPUT = {ws}/models/binarizer.msgpack
FCN_BINARIZER_TRAIN_CROP_SIZE = (256, 256)
FCN_BINARIZER_TRAIN_CROP_FLIP_CHANCE = 0.5
FCN_BINARIZER_TRAIN_CROP_MIN_FOREGROUND = 0.1
FCN_BINARIZER_TRAIN_COLOR_CHANGE_CHANCE = 0.10
FCN_BINARIZER_TRAIN_COLOR_INVERT_CHANGE = 0.50
FCN_BINARIZER_TRAIN_GAUSSIAN_NOISE_CHANCE = 0.20
FCN_BINARIZER_TRAIN_TEXT_MASK_EXPANSION = 15
FCN_BINARIZER_TRAIN_WEIGHT_EXPANSION = 1
TRAIN_PRECISION = fp32
"""
# steps timed a combination, after warm-up steps
TIMED_STEPS = 10
WARMUP_STEPS = 3


def make_training_set():
    """The training data the curriculum reads, as PNGs from ``encode_png``:
    frames under training/images (reconstruction and text detector), their
    ink masks under training/text_masks, and the keyframe/binary pairs of
    the annotations tree that the binarizer CLI walks. Returns the
    training config's path."""
    import numpy as np

    from lecturemath_tpu_torch.utils.png import encode_png

    annotations = os.path.join(WORKSPACE, "output", "annotations",
                               "SmokeDB_smoke01")
    dirs = {"images": os.path.join(WORKSPACE, "training", "images"),
            "text_masks": os.path.join(WORKSPACE, "training", "text_masks"),
            "keyframes": os.path.join(annotations, "keyframes"),
            "binary": os.path.join(annotations, "binary")}
    for path in dirs.values():
        os.makedirs(path, exist_ok=True)
    source = make_source()
    for t in TRAIN_FRAMES:
        frame = encode_png(source.rgb_frame(t)[:, :, ::-1])
        gt = np.where(source.binary_frame(t) > 0, 0, 255).astype(np.uint8)
        for key, data in (("images", frame), ("keyframes", frame),
                          ("binary", encode_png(gt)),
                          ("text_masks", encode_png(255 - gt))):
            with open(os.path.join(dirs[key], f"{t:04d}.png"), "wb") as f:
                f.write(data)
    conf = os.path.join(WORKSPACE, "training.conf")
    with open(conf, "w") as f:
        f.write(CONFIG.format(ws=WORKSPACE)
                + TRAINING_CONFIG.format(ws=WORKSPACE, batch=TRAIN_BATCH))
    return conf


def run_training_cli(module, argv):
    """``module.main(argv)`` with what it prints logged; returns the
    per-term losses of each epoch it printed."""
    import contextlib
    import io
    import math
    import re

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main(argv)
    epochs = []
    for line in out.getvalue().splitlines():
        if not line.strip() or line.startswith("preloaded"):
            continue
        log(f"  {line}")
        if "] epoch " in line:
            epochs.append({key: float(value) for key, value in re.findall(
                r"(\w+)=([^,\s]+)", line)})
    if not epochs or not all(math.isfinite(value) for terms in epochs
                             for value in terms.values()):
        raise AssertionError(f"{argv[0]}: no finite per-term losses")
    return epochs


def training_curriculum(conf):
    """Step 1: the three training CLIs chained as the curriculum runs them,
    on the card, with .msgpack outputs; returns the binarizer's path."""
    import torch

    from lecturemath_tpu_torch.cli import (train_binarizer,
                                           train_reconstruction,
                                           train_text_detector)
    from lecturemath_tpu_torch.models.convert import load_checkpoint

    steps = len(TRAIN_FRAMES) // TRAIN_BATCH
    for module, argv in ((train_reconstruction, [conf]),
                         (train_text_detector, [conf]),
                         (train_binarizer, [conf, "testing"])):
        name = module.__name__.rsplit(".", 1)[1]
        t0 = time.perf_counter()
        epochs = run_training_cli(module, [name] + argv)
        wall = time.perf_counter() - t0
        log(f"{name}: {len(epochs)} epochs of {steps} steps at batch "
            f"{TRAIN_BATCH} in {wall:.2f} s wall, model build, data and "
            f"checkpoints included ({len(epochs) * steps * TRAIN_BATCH / wall:.1f} "
            f"img/s); losses of the first epoch {json.dumps(epochs[0])}, of "
            f"the last {json.dumps(epochs[-1])}")
    models = os.path.join(WORKSPACE, "models")
    rec = load_checkpoint(os.path.join(models, "rec_pretrain.msgpack"))
    if any(key.startswith("conv_out.") for key in rec):
        raise AssertionError("the reconstruction checkpoint has a binary head")
    path = os.path.join(models, "binarizer.msgpack")
    state = load_checkpoint(path)
    if not all(torch.isfinite(value).all() for value in state.values()):
        raise AssertionError("the binarizer checkpoint is not finite")
    log(f"checkpoints {sorted(os.listdir(models))}")
    return path


def host_copy(batch):
    """A dataset batch as numpy arrays: the card's route yields tensors on
    the card (K5)."""
    import torch

    return {key: value.cpu().numpy() if isinstance(value, torch.Tensor)
            else value for key, value in batch.items()}


def training_data(conf):
    """The ms a batch of each phase's data path (PNG decode, the draws on
    the host, then the batch's pixels in K5 and its median targets in K4,
    as the prefetch thread runs them, from preloaded PNGs); returns one
    host copy of a batch of the text-detector phase (every head has a
    target: text mask, eroded text region and median reconstruction)."""
    import torch

    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.train.dataset import (LectureNetDataset,
                                                     find_image_mask_pairs)

    config = Config.from_file(conf)
    images, masks = find_image_mask_pairs(
        config.get_str("FCN_BINARIZER_PRETRAIN_IMAGES_DIR"),
        config.get_str("FCN_BINARIZER_PRETRAIN_MASKS_DIR"))
    annotations = os.path.join(WORKSPACE, "output", "annotations",
                               "SmokeDB_smoke01")
    keyframes, binaries = find_image_mask_pairs(
        os.path.join(annotations, "keyframes"),
        os.path.join(annotations, "binary"))
    rates = {}
    for name, pairs, options in (
            ("reconstruction", (images, None),
             dict(reconstruction_mode=True, reconstruct_median=True)),
            ("text_detector", (images, masks),
             dict(reconstruction_mode=False, reconstruct_median=True,
                  text_mask_expansion=15)),
            ("binarizer", (keyframes, binaries),
             dict(reconstruction_mode=False, text_mask_expansion=15))):
        dataset = LectureNetDataset.from_config(config, *pairs, **options)
        dataset.preload()
        t0 = time.perf_counter()
        batches = [batch for _ in range(2)
                   for batch in dataset.batches(TRAIN_BATCH)]
        torch.cuda.synchronize()
        rates[name] = (time.perf_counter() - t0) * 1e3 / len(batches)
        if name == "text_detector":
            host_batch = host_copy(batches[0])
    log(f"data path, ms a batch of {TRAIN_BATCH} on one thread "
        f"(img/s): " + json.dumps({name: [round(ms, 1), round(
            TRAIN_BATCH / ms * 1e3, 1)] for name, ms in rates.items()}))
    return host_batch


def fresh_trainer(net_config, dtype, frozen, phase="text_detector",
                  lr=0.01):
    """A Trainer on the card over a model drawn from seed 0; ``frozen``:
    BN frozen and folded into the convs inside the step."""
    import torch

    from lecturemath_tpu_torch.models.fcn_lecturenet import (FCNLectureNet,
                                                             init_weights)
    from lecturemath_tpu_torch.train.trainer import Trainer

    model = init_weights(FCNLectureNet(net_config, compute_dtype=dtype),
                         torch.Generator().manual_seed(0))
    return Trainer(model, lr, phase=phase, freeze_bn=frozen,
                   fold_frozen_bn=frozen, device="cuda")


def training_gradients(net_config, host_batch):
    """Step 2: one fp32 live-BN step where every parameter gets a finite,
    nonzero gradient, then 20 steps on the same batch where the loss
    falls."""
    import torch

    trainer = fresh_trainer(net_config, torch.float32, False)
    batch = trainer.to_device(host_batch)
    first = trainer.step(batch)
    bad, norms = [], []
    for name, param in trainer.model.named_parameters():
        grad = param.grad
        if (grad is None or not torch.isfinite(grad).all()
                or not (grad != 0).any()):
            bad.append(name)
        else:
            norms.append((grad.norm().item(), name))
    norms.sort()
    log(f"one fp32 live-BN step at batch {TRAIN_BATCH}: {len(norms)} of "
        f"{len(norms) + len(bad)} parameters with a finite, nonzero gradient; "
        f"losses {json.dumps({k: float(v) for k, v in first.items()})}; "
        f"smallest gradient norms {[(f'{n:.3g}', name) for n, name in norms[:4]]} "
        f"(conv biases before a live BN: zero but for rounding, as the "
        f"batch mean removes them)")
    if bad:
        raise AssertionError(f"parameters without a finite, nonzero "
                             f"gradient: {bad}")
    curve = [float(first["total"])] + [float(trainer.step(batch)["total"])
                                       for _ in range(20)]
    log(f"20 more steps on the same batch: total loss "
        f"{[round(v, 5) for v in curve]}")
    if not curve[-1] < curve[0]:
        raise AssertionError(f"the loss did not fall: {curve[0]} -> "
                             f"{curve[-1]}")


def step_flops(trainer, batch):
    """The operations of one training step, counted by PyTorch's
    FlopCounterMode (convolutions and matrix products, forward and
    backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        trainer.step(batch)
    return counter.get_total_flops()


def head_conv_ms(net_config, batch, dtype):
    """cuDNN's forward and backward (input and weight gradients) of the
    four k=7 head convs at the training crop: the work a K2 backward would
    take over."""
    import torch
    import torch.nn.functional as F

    k = net_config.pixel_kernel_size
    gen = torch.Generator(device="cuda").manual_seed(5)
    total = 0.0
    for _, c1, c2, n_out, _, _ in head_shapes(net_config):
        x = torch.randn(batch, c1 + c2, 256, 256, device="cuda",
                        generator=gen).to(dtype).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        w = (torch.randn(n_out, c1 + c2, k, k, device="cuda", generator=gen)
             * 0.05).to(dtype).requires_grad_()
        g = torch.randn(batch, n_out, 256, 256, device="cuda",
                        generator=gen).to(dtype).contiguous(
            memory_format=torch.channels_last)

        def run():
            y = F.conv2d(x, w, None, padding=k // 2)
            torch.autograd.grad(y, (x, w), g)

        total += cuda_ms(run, 5, warmup=2)
        del x, w, g
    return total


def training_group(name, cat):
    """Kernel group of a training step's device span."""
    low = name.lower()
    if cat != "kernel":
        return "copies and memsets"
    for key, group in (("dgrad", "cuDNN dgrad"), ("wgrad", "cuDNN wgrad"),
                       ("nchwtonhwc", "layout conversions"),
                       ("nhwctonchw", "layout conversions"),
                       ("batch_norm", "batch norm"), ("bn_", "batch norm"),
                       ("max_pool", "max-pool"), ("catarray", "torch.cat"),
                       ("multi_tensor", "optimizer"), ("foreach", "optimizer"),
                       ("reduce", "reductions"), ("fprop", "cuDNN fprop"),
                       ("xmma", "cuDNN other"), ("cutlass", "cuDNN other"),
                       ("gemm", "cuDNN other"), ("conv", "cuDNN other"),
                       ("elementwise", "elementwise")):
        if key in low:
            return group
    return "other"


def training_step_timings(net_config, host_batch):
    """Steps 3 and 4: step ms (CUDA events, median of TIMED_STEPS after
    WARMUP_STEPS), images/s and peak memory for fp32 and bf16, live BN and
    frozen BN folded, batch 8 and 64; the step's kernels by group under
    torch.profiler; the heads' cuDNN forward + backward beside the step."""
    import statistics

    import numpy as np
    import torch

    big = {key: np.concatenate([value] * 8) for key, value in
           host_batch.items()}
    results = {}
    # fp32 runs as the CLIs run it, with PyTorch's default TF32 convolutions
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for precision, dtype in (("fp32", torch.float32),
                                 ("bf16", torch.bfloat16)):
            for bn in ("live", "frozen+fold"):
                for batch_size, batch in ((TRAIN_BATCH, host_batch),
                                          (8 * TRAIN_BATCH, big)):
                    trainer = fresh_trainer(net_config, dtype,
                                            bn == "frozen+fold")
                    batch = trainer.to_device(batch)
                    for _ in range(WARMUP_STEPS):
                        trainer.step(batch)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    events = []
                    t0 = time.perf_counter()
                    for _ in range(TIMED_STEPS):
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        trainer.step(batch)
                        end.record()
                        events.append((start, end))
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
                    step_ms = statistics.median(
                        start.elapsed_time(end) for start, end in events)
                    peak = torch.cuda.max_memory_allocated() / 2**30
                    flops = step_flops(trainer, batch)
                    peak_flops = (PEAK_BF16_FLOPS if dtype == torch.bfloat16
                                  else PEAK_TF32_FLOPS)
                    heads_ms = head_conv_ms(net_config, batch_size, dtype)
                    key = f"{precision} {bn} batch {batch_size}"
                    results[key] = {
                        "step_ms": step_ms, "host_ms_per_step": wall_ms,
                        "img_per_s": batch_size / step_ms * 1e3,
                        "peak_gib": peak, "tflop_per_step": flops / 1e12,
                        "tflop_per_s": flops / step_ms / 1e9,
                        "heads_cudnn_fwd_bwd_ms": heads_ms}
                    log(f"training step, {key}: {step_ms:.3f} ms (median of "
                        f"{TIMED_STEPS}, CUDA events; host clock "
                        f"{wall_ms:.3f} ms a step) = "
                        f"{batch_size / step_ms * 1e3:.1f} img/s; peak "
                        f"memory {peak:.2f} GiB; {flops / 1e12:.3f} TFLOP a "
                        f"step = {flops / step_ms / 1e9:.1f} TFLOP/s, "
                        f"{flops / step_ms / 1e9 / (peak_flops / 1e12):.3f} "
                        f"of the {'bf16' if peak_flops == PEAK_BF16_FLOPS else 'TF32'} "
                        f"peak; the four heads' cuDNN forward + backward "
                        f"alone {heads_ms:.3f} ms = {heads_ms / step_ms:.3f} "
                        f"of the step")
                    if precision == "bf16" and (
                            bn == "live" or batch_size > TRAIN_BATCH):
                        device_breakdown(lambda: trainer.step(batch),
                                         f"one training step, {key}",
                                         training_group)
                    del trainer, batch
                    torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return results


def training_inference(conf, binarizer_path, net_config, host_batch):
    """Step 5: the trained binarizer through Binarizer.from_config, K2 and
    K1 on freshly packed heads, within the flip rate of plain f32; then an
    optimizer step on a live model and a forward that must repack."""
    import numpy as np
    import torch

    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.models.convert import load_checkpoint
    from lecturemath_tpu_torch.models.fcn_lecturenet import (
        FCNLectureNet, make_packed_binarizer, unpack_bits_host)
    from lecturemath_tpu_torch.ops.conv7 import (conv_same_nhwc, n_tiles,
                                                 pack_weights)
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer

    def stale_packs(model):
        """The heads whose cached pack (the one K2 last ran on) is not the
        pack of their current weights."""
        stale = []
        for name, (c1, c2) in model.head_inputs().items():
            weight = getattr(model, name)[0].weight
            if not torch.equal(model._head_packs[name][1][0], pack_weights(
                    weight, c1, c2, n_tiles(weight.shape[0]))):
                stale.append(name)
        return stale

    binarizer = Binarizer.from_config(Config.from_file(conf))
    plain = FCNLectureNet(net_config, plain=True)
    plain.load_state_dict(load_checkpoint(binarizer_path))
    plain_bin = Binarizer(plain, batch_size=8, dtype=torch.float32,
                          device="cuda")
    source = make_source()
    pick = [0, 30, 60, 119, 120, 150, 200, 239]
    frames = torch.from_numpy(np.stack([source.rgb_frame(t)
                                        for t in pick])).cuda()
    before = conv_same_nhwc.launches
    kernel_bits = unpack_bits_host(binarizer.packed_fn(frames).cpu().numpy(),
                                   WIDTH)
    if conv_same_nhwc.launches != before + 4:
        raise AssertionError("the trained binarizer did not run K2's four "
                             "heads")
    if stale_packs(binarizer.model):
        raise AssertionError("K2 did not run on packs of the trained weights")
    plain_fn = make_packed_binarizer(plain_bin.model)
    plain_bits = unpack_bits_host(plain_fn(frames).cpu().numpy(), WIDTH)
    flip_rate = float(np.mean(kernel_bits != plain_bits))
    truth = np.stack([source.binary_frame(t) for t in pick]) > 0
    log(f"trained binarizer (bf16, K2 + K1) against plain f32 on "
        f"{len(pick)} frames: flip rate {flip_rate:.6f} (bound "
        f"{MAX_FLIP_RATE}); ink share {float(np.mean(kernel_bits == 0)):.4f}, "
        f"ink mask vs ground truth "
        f"{float(np.mean((kernel_bits == 0) != truth)):.4f}")
    if flip_rate > MAX_FLIP_RATE:
        raise AssertionError(f"trained binarizer flip rate {flip_rate} > "
                             f"{MAX_FLIP_RATE}")

    # fault 1 on the card: an in-place optimizer step, then a forward that
    # runs K2 on packs of the new weights
    trainer = fresh_trainer(net_config, torch.bfloat16, False,
                            phase="binarizer", lr=0.001)
    trainer.model.load_state_dict(load_checkpoint(binarizer_path))
    batch = trainer.to_device(host_batch)
    x = batch["image"].contiguous(memory_format=torch.channels_last)

    def forward(net):
        net.eval()
        with torch.no_grad():
            return net(x)[0]

    forward(trainer.model)
    packs = {name: pack[1][0].clone()
             for name, pack in trainer.model._head_packs.items()}
    trainer.step(batch)
    before = conv_same_nhwc.launches
    after = forward(trainer.model)
    if conv_same_nhwc.launches != before + 4:
        raise AssertionError("the live model's forward did not run K2")
    stale = stale_packs(trainer.model)
    changed = [name for name, pack in packs.items() if not torch.equal(
        pack, trainer.model._head_packs[name][1][0])]
    reference = FCNLectureNet(net_config, compute_dtype=torch.bfloat16)
    reference.load_state_dict(trainer.model.state_dict())
    expected = forward(reference.to("cuda",
                                    memory_format=torch.channels_last))
    err = (after - expected).abs().max().item()
    log(f"after optimizer.step() on a live bf16 model: K2 ran on packs of "
        f"the new weights for {4 - len(stale)} of 4 heads (packs that "
        f"changed: {changed}); its logits against a model built from the "
        f"new weights: max |err| {err:.3g}")
    if stale or not changed:
        raise AssertionError(f"K2 ran on stale packs after optimizer.step(): "
                             f"{stale}")
    if not err <= LOGIT_REL * expected.abs().max().item():
        raise AssertionError(f"the repacked forward differs by {err}")
    return flip_rate


def phase_training(counters):
    """Phase 8: the three training phases on the card; returns (launch
    counts of every kernel in ``counters``, summary dict)."""
    import torch

    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig
    from lecturemath_tpu_torch.ops.conv7 import conv_same_nhwc

    conf = make_training_set()
    net_config = FCNConfig.from_config(Config.from_file(conf))
    for fn in counters.values():
        fn.launches = 0
    binarizer_path = training_curriculum(conf)
    host_batch = training_data(conf)
    training_gradients(net_config, host_batch)
    timings = training_step_timings(net_config, host_batch)
    if conv_same_nhwc.launches:
        raise AssertionError(f"training forwards launched K2 "
                             f"{conv_same_nhwc.launches} times")
    log("training (curriculum, gradients, timed steps): K2 launched 0 "
        "times; the heads ran F.conv2d")
    flip_rate = training_inference(conf, binarizer_path, net_config,
                                   host_batch)
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"training path launches {launches}")
    for name in EXPRESS_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched")
    torch.cuda.empty_cache()
    return launches, {"steps": timings, "flip_rate": flip_rate}


# ---------------------------------------------------------------- phase 9

# the evaluation path's GT tree (the AccessMath layout under its own
# annotations folder): the phase-4 lecture at 960x540 with a GT keyframe at
# the end of each era, scored against the staged phase's summary, and a
# second lecture of 16 keyframes at 1920x1080, AccessMath's keyframe size,
# for the binarizer-quality protocol; 16 image/mask pairs at 640x480 for
# the text-detector evaluation
EVAL_DB_XML = """<AccessMath>
  <DataBase>
    <Name>SmokeDB</Name>
    <OutputPaths>
      <Temporal>temporal</Temporal><Images>images</Images>
      <Videos>videos</Videos><Annotations>eval_annotations</Annotations>
      <Summaries>summaries</Summaries>
    </OutputPaths>
    <Datasets>
      <Training><LectureTitle>smoke01</LectureTitle>
        <LectureTitle>smoke02</LectureTitle></Training>
      <Testing><LectureTitle>smoke01</LectureTitle></Testing>
    </Datasets>
    <Lectures>
      <Lecture>
        <Id>smoke01</Id><Title>smoke01</Title><Parameters></Parameters>
        <Videos><Main><Video><Path>smoke01.mp4</Path></Video></Main></Videos>
      </Lecture>
      <Lecture>
        <Id>smoke02</Id><Title>smoke02</Title><Parameters></Parameters>
        <Videos><Main><Video><Path>smoke02.mp4</Path></Video></Main></Videos>
      </Lecture>
    </Lectures>
  </DataBase>
</AccessMath>
"""
EVAL_CONFIG = """VIDEO_SEGMENTATION_OUTPUT = tempo_intervals_
BINARIZATION_OUTPUT = tempo_binary_
FCN_BINARIZER_SAVE_BINARY = 1
FCN_BINARIZER_SAVE_BINARY_PATH = {ws}/eval/saved
FCN_BINARIZER_PRETRAIN_EVAL_IMAGES_DIR = {ws}/eval/td/images
FCN_BINARIZER_PRETRAIN_EVAL_MASKS_DIR = {ws}/eval/td/masks
"""
HD_KEYFRAMES = 16
HD_HEIGHT, HD_WIDTH = 1080, 1920
TD_PAIRS = 16
TD_HEIGHT, TD_WIDTH = 480, 640
# the video objects of every GT keyframe, in 960x540 coordinates (doubled
# at 1920x1080): a non-convex speaker polygon past the frame's left edge,
# with fractional vertices, and a board box in the X/Y/W/H form
SPEAKER = [[-40.5, 120.2], [180.7, 60.0], [130.0, 260.0], [260.3, 500.9],
           [20.0, 420.5]]
BOARD = (500.0, 40.0, 400.5, 300.25)
# the threshold heads' luminance rule (threshold_binarizer_variables)
GT_GRAY, GT_SHARPNESS = 130.0, 4.0


def threshold_ink(rgb):
    """The ink the threshold heads find, in exact arithmetic: sigmoid(z) *
    255 < 128 with z = sharpness * (sum of x - 3 t), x = v / 127.5 - 1."""
    import numpy as np

    x = rgb.astype(np.float64) / 127.5 - 1.0
    z = GT_SHARPNESS * (x.sum(axis=-1) - 3 * (GT_GRAY / 127.5 - 1.0))
    return z < np.log(128.0 / 127.0)


def write_gt_lecture(lecture, keyframes, segments, scale):
    """One lecture's GT tree: keyframes (index, RGB), segments, the video
    objects scaled by ``scale``, a full-frame portion a keyframe, and
    unique-CC groups chained by the annotation tooling; returns the GT
    binaries (ink = 0)."""
    import numpy as np

    from lecturemath_tpu_torch.eval.aligner import build_unique_cc_groups
    from lecturemath_tpu_torch.eval.annotation import (KeyframeAnnotation,
                                                       UniqueCCGroup)
    from lecturemath_tpu_torch.utils.png import encode_png

    prefix = os.path.join(WORKSPACE, "output", "eval_annotations",
                          f"SmokeDB_{lecture}")
    for sub in ("keyframes", "binary"):
        os.makedirs(os.path.join(prefix, sub), exist_ok=True)
    speaker = "".join(f"<Point><X>{x * scale}</X><Y>{y * scale}</Y></Point>"
                      for x, y in SPEAKER)
    x, y, w, h = (v * scale for v in BOARD)
    objects = ("<VideoObjects><VideoObject><Name>speaker</Name><Shape>2"
               f"</Shape><Polygon>{speaker}</Polygon></VideoObject>"
               f"<VideoObject><Name>board</Name><X>{x}</X><Y>{y}</Y>"
               f"<W>{w}</W><H>{h}</H></VideoObject></VideoObjects>")
    xml = [f"<Annotations><Database>SmokeDB</Database><Lecture>{lecture}"
           f"</Lecture><Filename>x</Filename><VideoFiles><VideoFile>"
           f"{lecture}.mp4</VideoFile></VideoFiles><VideoSegments>"]
    xml += [f"<VideoSegment><Start>{s}</Start><End>{e}</End></VideoSegment>"
            for s, e in segments]
    xml.append("</VideoSegments><VideoKeyFrames>")
    portions = ["<Annotations><KeyFrames>"]
    binaries = []
    for idx, rgb in keyframes:
        binary = np.where(threshold_ink(rgb), 0, 255).astype(np.uint8)
        binaries.append(binary)
        three = np.repeat(binary[:, :, None], 3, axis=2)
        for path, image in (
                (os.path.join(prefix, "keyframes", f"{idx}.png"),
                 rgb[:, :, ::-1]),
                (os.path.join(prefix, "binary", f"{idx}.png"), three),
                (os.path.join(prefix, "portions", f"frame_{idx}", "0.png"),
                 three)):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(encode_png(image))
        xml.append(f"<VideoKeyFrame><Index>{idx}</Index><AbsTime>"
                   f"{idx * 1000.0}</AbsTime>{objects}</VideoKeyFrame>")
        portions.append(
            f"<KeyFrame><Index>{idx}</Index><Portions><KeyFramePortion>"
            f"<X>0</X><Y>0</Y><W>{rgb.shape[1]}</W><H>{rgb.shape[0]}</H>"
            f"<Dark>0</Dark></KeyFramePortion></Portions></KeyFrame>")
    xml.append("</VideoKeyFrames></Annotations>")
    portions.append("</KeyFrames></Annotations>")
    with open(os.path.join(prefix, "segments.xml"), "w") as f:
        f.write("\n".join(xml) + "\n")
    with open(os.path.join(prefix, "portions.xml"), "w") as f:
        f.write("\n".join(portions) + "\n")

    gt, gt_segments = KeyframeAnnotation.load_exported_keyframes(
        os.path.join(prefix, "segments.xml"),
        os.path.join(prefix, "keyframes") + "/", True)
    for kf, binary in zip(gt, binaries):
        kf.binary_image = np.repeat(binary[:, :, None], 3, axis=2)
        kf.update_binary_cc(False)
    combined = KeyframeAnnotation.combine_per_segment(gt, gt_segments, False)
    groups, _ = build_unique_cc_groups(combined, local_window=3,
                                       min_recall=0.8, min_precision=0.8)
    with open(os.path.join(prefix, "unique_ccs.xml"), "w") as f:
        f.write(UniqueCCGroup.groups_to_xml(combined, groups))
    return binaries


def smoke_annotation():
    """The lecture's LectureAnnotation (segments split at the era boundary,
    a GT keyframe at the end of each era), which eval_segments reads."""
    from lecturemath_tpu_torch.eval.lecture_annotation import \
        LectureAnnotation

    boundary = make_source().erase_times[0]
    annotation = LectureAnnotation("SmokeDB", "smoke01", "smoke01.xml",
                                   ["smoke01.mp4"], total_frames=N_FRAMES)
    annotation.video_segments = [boundary]
    annotation.video_segment_keyframes = [boundary - 1, N_FRAMES - 1]
    return annotation


def make_eval_tree():
    """The GT tree of both lectures, the GT of smoke01 exported as a
    summary of itself (baseline prefix ``self_``), the LectureAnnotation
    XML eval_segments reads, the text-detector pairs and the config;
    returns (config path, {lecture: keyframe count})."""
    import numpy as np

    from lecturemath_tpu_torch.pipeline.keyframes import export_summary
    from lecturemath_tpu_torch.utils.png import encode_png
    from lecturemath_tpu_torch.utils.synthetic import \
        SyntheticRGBLectureSource

    source = make_source()
    boundary = source.erase_times[0]
    picks = [boundary - 1, N_FRAMES - 1]
    segments = [(0, boundary - 1), (boundary, N_FRAMES - 1)]
    binaries = write_gt_lecture(
        "smoke01", [(t, source.rgb_frame(t).copy()) for t in picks],
        segments, 1.0)
    export_summary(os.path.join(WORKSPACE, "output", "summaries",
                                "self_SmokeDB_smoke01"),
                   "SmokeDB", "smoke01", ["smoke01.mp4"], segments,
                   [(s * 1000.0, e * 1000.0) for s, e in segments], picks,
                   [t * 1000.0 for t in picks],
                   [np.repeat(b[:, :, None], 3, axis=2) for b in binaries])
    smoke_annotation().save(os.path.join(WORKSPACE, "output", "eval_annotations",
                                 "SmokeDB_smoke01.xml"))

    hd = SyntheticRGBLectureSource(
        seed=1, n_frames=HD_KEYFRAMES * 15, height=HD_HEIGHT, width=HD_WIDTH,
        n_boards=2, glyphs_per_board=60, glyph_size=(80, 120))
    hd_picks = [15 * k + 14 for k in range(HD_KEYFRAMES)]
    write_gt_lecture("smoke02", [(t, hd.rgb_frame(t).copy())
                                 for t in hd_picks],
                     [(15 * k, 15 * k + 14) for k in range(HD_KEYFRAMES)],
                     HD_HEIGHT / HEIGHT)

    td = SyntheticRGBLectureSource(seed=2, n_frames=TD_PAIRS * 10,
                                   height=TD_HEIGHT, width=TD_WIDTH,
                                   n_boards=2, glyphs_per_board=30,
                                   glyph_size=(30, 45))
    for k in range(TD_PAIRS):
        t = 10 * k + 9
        for sub, image in (("images", td.rgb_frame(t)[:, :, ::-1]),
                           ("masks", td.binary_frame(t))):
            path = os.path.join(WORKSPACE, "eval", "td", sub, f"{k:02d}.png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(encode_png(image))

    with open(os.path.join(WORKSPACE, "eval", "db.xml"), "w") as f:
        f.write(EVAL_DB_XML)
    conf = os.path.join(WORKSPACE, "eval", "eval.conf")
    with open(conf, "w") as f:
        f.write(CONFIG.format(ws=WORKSPACE).replace(
            f"{WORKSPACE}/db.xml", f"{WORKSPACE}/eval/db.xml")
            + EVAL_CONFIG.format(ws=WORKSPACE))
    return conf, {"smoke01": len(picks), "smoke02": HD_KEYFRAMES}


def run_eval_cli(name, main, argv):
    """``main(argv)`` with its stdout logged; returns (what main returned,
    stdout, wall s)."""
    import contextlib
    import io

    import torch

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        if line.strip() and not line.startswith("Processing:"):
            log(f"  {line}")
    log(f"{name}: {wall:.3f} s wall")
    return result, text, wall


def check_metrics(name, values):
    """Every metric finite and in [0, 1], except the board variants of the
    pixel metrics: the JAX package divides the matched ink (the objects'
    included) by the summary ink off the objects, so they pass 1 where an
    object covers matched ink."""
    import math

    for key, value in values.items():
        if not math.isfinite(value) or value < 0:
            raise AssertionError(f"{name}: {key} = {value}")
        if value > 1 and not key.startswith("board_"):
            raise AssertionError(f"{name}: {key} = {value} > 1")


def summary_numbers(metrics):
    """{min R/P: (recall, precision)} of the 'all' size range."""
    return {f"{e['min_cc_recall']:.2f}/{e['min_cc_precision']:.2f}":
            (e["recall_metrics"]["recall"],
             e["precision_metrics"]["precision"]) for e in metrics["all"]}


def eval_breakdown(conf, model):
    """Timing only, after the entry point's run: the keyframe-bin protocol
    step by step (each step the module's own function, as
    evaluate_keyframe_binarization runs them), host seconds a step, and the
    binarizer's keyframes a second (CUDA events around the forward of one
    batch a resolution). Then the entry point's own saved binaries of every
    keyframe against the plain f32 model's on the card, gated. Returns
    (flip rate, keyframes/s by size, host s by step)."""
    import numpy as np
    import torch

    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.core.metadata import MetaDataDB
    from lecturemath_tpu_torch.eval.annotation import KeyframeAnnotation
    from lecturemath_tpu_torch.eval.evaluator import Evaluator
    from lecturemath_tpu_torch.eval.keyframe_bin import (
        KEYFRAME_BIN_PARAMS, binarize_keyframes)
    from lecturemath_tpu_torch.eval.summary_eval import \
        load_dataset_keyframes
    from lecturemath_tpu_torch.models.convert import load_checkpoint
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNLectureNet
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer
    from lecturemath_tpu_torch.utils.png import read_image

    config = Config.from_file(conf)
    config.set("BINARIZATION_FCN_LECTURENET_FILENAME",
               os.path.basename(model))
    database = MetaDataDB.from_file(config.get_str("VIDEO_DATABASE_PATH"))
    seconds = {}
    t0 = time.perf_counter()
    gt, to_binarize = load_dataset_keyframes(config.get_str("OUTPUT_PATH"),
                                             database, "training")
    seconds["load GT (PNG decode, object masks, CCs)"] = \
        time.perf_counter() - t0
    fake = KeyframeAnnotation.generate_fake_keyframe_info(gt)
    binarizer = Binarizer.from_config(config)
    t0 = time.perf_counter()
    binarize_keyframes(binarizer, to_binarize)
    torch.cuda.synchronize()
    seconds["binarize + CCs (binarize_keyframes)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    Evaluator(KEYFRAME_BIN_PARAMS).compute_summary_metrics(
        fake[2], gt, fake[0], fake[1], fake[2], to_binarize)
    seconds["CC metrics (compute_summary_metrics)"] = \
        time.perf_counter() - t0
    t0 = time.perf_counter()
    Evaluator.compute_pixel_binary_metrics(gt, to_binarize)
    seconds["pixel metrics"] = time.perf_counter() - t0
    log("keyframe-bin protocol, host s by step: " + json.dumps(
        {k: round(v, 3) for k, v in seconds.items()}))

    by_shape = {}
    for kf in to_binarize:
        by_shape.setdefault(kf.raw_image.shape, []).append(kf)
    kfps = {}
    for shape, kfs in by_shape.items():
        batch = max(1, 8_000_000 // (shape[0] * shape[1]))
        tensor = torch.from_numpy(
            np.stack([kf.raw_image for kf in kfs[:batch]])).cuda()
        ms = cuda_ms(lambda: binarizer.full_outputs(tensor), reps=5)
        kfps[f"{shape[1]}x{shape[0]}"] = len(tensor) / ms * 1000.0
        log(f"binarizer at {shape[1]}x{shape[0]}, batch {len(tensor)}: "
            f"{ms:.3f} ms a batch (CUDA events) = "
            f"{len(tensor) / ms * 1000.0:.2f} keyframes/s")
    del tensor

    # what keyframe_bin.main saved, every keyframe, against plain f32
    plain_model = FCNLectureNet(binarizer.model.config, plain=True)
    plain_model.load_state_dict(load_checkpoint(model))
    plain = Binarizer(plain_model, dtype=torch.float32)
    save_dir = config.get_str("FCN_BINARIZER_SAVE_BINARY_PATH")
    flips = pixels = 0
    for shape, kfs in by_shape.items():
        batch = max(1, 8_000_000 // (shape[0] * shape[1]))
        for start in range(0, len(kfs), batch):
            chunk = kfs[start:start + batch]
            theirs = plain.binarize_frames(
                np.stack([kf.raw_image for kf in chunk]))
            for kf, reference in zip(chunk, theirs):
                saved = read_image(os.path.join(
                    save_dir, "FCN", kf.lecture, "binary", f"{kf.idx}.png"))
                if saved.shape[:2] != reference.shape:
                    raise AssertionError(f"saved binary {kf.lecture}/"
                                         f"{kf.idx}: {saved.shape}")
                flips += int((saved[:, :, 0] != reference).sum())
                pixels += reference.size
    flip_rate = flips / pixels
    log(f"keyframe binaries saved by keyframe_bin.main (bf16 kernels), all "
        f"{len(to_binarize)}, vs plain f32 on the card: flip rate "
        f"{flip_rate:.6f} (bound {MAX_FLIP_RATE})")
    if flip_rate > MAX_FLIP_RATE:
        raise AssertionError(f"keyframe flip rate {flip_rate} > "
                             f"{MAX_FLIP_RATE}")
    return flip_rate, kfps, seconds


def phase_evaluation(counters):
    """Phase 9: the evaluation path on the card through its entry points;
    returns (launch counts of every kernel in ``counters``, summary
    dict)."""
    import torch

    from lecturemath_tpu_torch.cli import (eval_segments, eval_summaries,
                                           eval_text_detector)
    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.core.metadata import MetaDataDB
    from lecturemath_tpu_torch.eval import keyframe_bin
    from lecturemath_tpu_torch.eval.summary_eval import SummaryEvaluator

    t0 = time.perf_counter()
    conf, counts = make_eval_tree()
    log(f"evaluation GT tree ({counts} keyframes, {TD_PAIRS} text-detector "
        f"pairs at {TD_WIDTH}x{TD_HEIGHT}) written in "
        f"{time.perf_counter() - t0:.1f} s")
    model = os.path.join(WORKSPACE, "models", "smoke.dat")
    walls = {}
    for fn in counters.values():
        fn.launches = 0
    keyframe_result, _, walls["keyframe_bin"] = run_eval_cli(
        "eval.keyframe_bin.main", keyframe_bin.main,
        ["keyframe_bin", conf, model, "0"])
    _, summaries, walls["eval_summaries"] = run_eval_cli(
        "cli.eval_summaries", eval_summaries.main,
        ["eval_summaries", conf, "-l", "smoke01"])
    _, segments, walls["eval_segments"] = run_eval_cli(
        "cli.eval_segments", eval_segments.main,
        ["eval_segments", conf, "0"])
    config = Config.from_file(conf)
    database = MetaDataDB.from_file(config.get_str("VIDEO_DATABASE_PATH"))
    t0 = time.perf_counter()
    self_metrics = SummaryEvaluator().evaluate_lecture(
        config, database, database.get_lecture("smoke01"), "self_")
    walls["self-evaluation"] = time.perf_counter() - t0
    _, _, walls["eval_text_detector"] = run_eval_cli(
        "cli.eval_text_detector", eval_text_detector.main,
        ["eval_text_detector", conf, model])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"evaluation path launches {launches}; wall s "
        f"{json.dumps({k: round(v, 3) for k, v in walls.items()})}")
    if launches["conv_same_nhwc"] <= 0:
        raise AssertionError("K2 was not launched on the evaluation path")

    self_numbers = summary_numbers(self_metrics)
    log(f"self-evaluation (GT scored as its own summary), recall/precision "
        f"by min R/P: {self_numbers}")
    if any(pair != (1.0, 1.0) for pair in self_numbers.values()):
        raise AssertionError(f"self-evaluation is not perfect: "
                             f"{self_numbers}")
    staged = SummaryEvaluator()
    staged_metrics = staged.evaluate_lecture(
        config, database, database.get_lecture("smoke01"))
    staged_numbers = summary_numbers(staged_metrics)
    log(f"staged summary against the GT, recall/precision by min R/P: "
        f"{staged_numbers}")
    for key, (recall, precision) in staged_numbers.items():
        check_metrics(f"staged summary {key}",
                      {"recall": recall, "precision": precision})
    if "Finished" not in summaries or "SIoU" not in segments:
        raise AssertionError("an evaluation CLI did not finish")

    # the gates hold what the entry point computed
    scope_metrics, _, pixel = keyframe_result
    check_metrics("pixel", pixel)
    for entry in scope_metrics["all"]:
        check_metrics(f"keyframe-bin {entry['min_cc_recall']}", {
            key: value for side in ("recall_metrics", "precision_metrics")
            for key, value in entry[side].items()
            if isinstance(value, float)})
    keyframe_numbers = summary_numbers(scope_metrics)
    log(f"keyframe-bin protocol (keyframe_bin.main) on "
        f"{sum(counts.values())} keyframes: pixel "
        f"{json.dumps({k: round(v, 6) for k, v in pixel.items()})}; CC "
        f"recall/precision by min R/P {keyframe_numbers}")
    flip_rate, kfps, seconds = eval_breakdown(conf, model)
    torch.cuda.empty_cache()
    return launches, {"walls": walls, "flip_rate": flip_rate,
                      "keyframes_per_s": kfps, "host_s": seconds,
                      "pixel": pixel}


# --------------------------------------------------------------- phase 10

# the scale-out phase's data-parallel steps: the phase-8 widths, batch and
# crop, the binarizer phase with per-pixel weights and the clip
SCALE_STEPS = 3
# fp32 (TF32 off) mesh steps against the meshless Trainer's: the cross-
# replica BN sums its statistics in another order than cuDNN's BN
SCALE_RTOL, SCALE_ATOL = 1e-5, 1e-5
# the train CLI's epochs under -mesh 1x1 (2 steps each)
SCALE_CLI_EPOCHS = 4
# seconds a child process of the phase may take
CHILD_TIMEOUT_S = 300


def start_child(call, world=1, rank=0, port=None, visible=None, block=()):
    """``chip_smoke.<call>`` in a child process, as process ``rank`` of a
    world joined under the LM_* contract (``child_results`` waits for
    it), with the modules ``block`` names unimportable."""
    from lecturemath_tpu_torch.parallel.launch import free_port

    env = dict(os.environ, LM_COORDINATOR=f"127.0.0.1:{port or free_port()}",
               LM_NUM_PROCESSES=str(world), LM_PROCESS_ID=str(rank))
    if visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = visible
    code = (f"import sys; sys.modules.update(dict.fromkeys({block!r})); "
            f"sys.path.insert(0, {REPO!r}); import chip_smoke; "
            f"sys.exit(chip_smoke.{call})")
    return subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def child_results(procs, what):
    """Wait for child processes (killed at CHILD_TIMEOUT_S); log their
    output and return each one's last-line JSON."""
    results = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
            lines = out.strip().splitlines()
            for line in lines[:-1]:
                if "hostname of the client socket" not in line:
                    log(f"  [{what}] {line}")
            if proc.returncode != 0 or not lines:
                raise AssertionError(f"{what}: child exited with "
                                     f"{proc.returncode}: {lines[-1:]}")
            results.append(json.loads(lines[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return results


def counted(counters):
    return {name: fn.launches for name, fn in counters.items()}


def memory_frames(driver_cls):
    """The card's machine has no OpenCV to decode a video: the CLIs read
    the synthetic lecture from memory."""
    driver_cls.frame_source = lambda self, lecture: make_source()


def scale_cli_child(module_name, conf):
    """Child: the CLI ``module_name`` on ``conf`` with ``-mesh 1x1`` in the
    world of the LM_* env; prints its wall and launches."""
    import importlib

    sys.path.insert(0, REPO)
    from lecturemath_tpu_torch.ops.conv7 import conv_same_nhwc
    from lecturemath_tpu_torch.ops.postprocess import threshold_pack
    from lecturemath_tpu_torch.pipeline.driver import PipelineDriver

    memory_frames(PipelineDriver)
    module = importlib.import_module(f"lecturemath_tpu_torch.cli."
                                     f"{module_name}")
    t0 = time.perf_counter()
    module.main([module_name, conf, "-mesh", "1x1"])
    wall = time.perf_counter() - t0
    print(json.dumps({"wall_s": wall, "launches": {
        "threshold_pack": threshold_pack.launches,
        "conv_same_nhwc": conv_same_nhwc.launches}}), flush=True)
    return 0


def scale_batch():
    """A seeded global training batch at the phase-8 shape, with weights."""
    import numpy as np

    rng = np.random.default_rng(0)
    shape = (TRAIN_BATCH, 256, 256)
    return {"image": rng.uniform(-1, 1, shape + (3,)).astype(np.float32),
            "target": (rng.random(shape + (1,)) < 0.1).astype(np.float32),
            "text_mask": (rng.random(shape + (1,)) < 0.3).astype(np.float32),
            "weights": rng.uniform(0.5, 2.0, shape + (1,)).astype(
                np.float32)}


def scale_trainer(net_config, dtype, mesh):
    import torch

    from lecturemath_tpu_torch.models.fcn_lecturenet import (FCNLectureNet,
                                                             init_weights)
    from lecturemath_tpu_torch.train.trainer import Trainer

    model = init_weights(FCNLectureNet(net_config, compute_dtype=dtype),
                         torch.Generator().manual_seed(0))
    return Trainer(model, 0.001, phase="binarizer", use_weights=True,
                   clip_norm=1.0, prefetch_depth=0,
                   device=None if mesh is not None else "cuda", mesh=mesh)


def scale_steps(trainer, batch):
    """SCALE_STEPS steps; (per-step totals, running statistics)."""
    losses = [float(trainer.step(batch)["total"]) for _ in range(SCALE_STEPS)]
    stats = {key: value.detach().float().cpu()
             for key, value in trainer.model.state_dict().items()
             if "running" in key}
    return losses, stats


def step_ms(trainer, batch):
    """Median step ms over TIMED_STEPS after WARMUP_STEPS, CUDA events."""
    import statistics

    import torch

    batch = trainer.to_device(batch)
    for _ in range(WARMUP_STEPS):
        trainer.step(batch)
    torch.cuda.synchronize()
    events = []
    for _ in range(TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.step(batch)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def compare_steps(plain, meshed):
    """The largest relative loss and running-statistic differences; raises
    past SCALE_RTOL / SCALE_ATOL."""
    import torch

    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(meshed[0], plain[0]))
    stat_rel = 0.0
    for key, value in plain[1].items():
        torch.testing.assert_close(meshed[1][key], value, rtol=SCALE_RTOL,
                                   atol=SCALE_ATOL, msg=key)
        stat_rel = max(stat_rel, float(((meshed[1][key] - value).abs()
                                        / value.abs().clamp(min=1e-6)).max()))
    if loss_rel > SCALE_RTOL:
        raise AssertionError(f"mesh losses {meshed[0]} vs meshless "
                             f"{plain[0]}: rel {loss_rel}")
    return loss_rel, stat_rel


def bn_share(trainer, batch):
    """The cross-replica BN's device share of one profiled mesh step (its
    forward range and its backward node), the NCCL kernels' (a one-rank
    world's all-reduce may launch none), the all-reduces the step made and
    its wall under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from lecturemath_tpu_torch.parallel import sync_norm

    inner = sync_norm.cross_replica_batch_norm

    def traced(*args, **kwargs):
        with record_function("cross_replica_batch_norm"):
            return inner(*args, **kwargs)

    batch = trainer.to_device(batch)
    trainer.step(batch)
    torch.cuda.synchronize()
    sync_norm.cross_replica_batch_norm = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.step(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        sync_norm.cross_replica_batch_norm = inner
    events = [e for e in prof.events() if str(e.device_type).endswith("CPU")]
    total = sum(e.self_device_time_total for e in events)
    bn = sum(e.device_time_total for e in events
             if e.name == "cross_replica_batch_norm" or e.name.startswith(
                 "autograd::engine::evaluate_function: _CrossReplicaBatch"))
    nccl = sum(k.duration for e in events for k in e.kernels
               if "nccl" in k.name.lower())
    collectives = sum(1 for e in events if e.name == "c10d::allreduce_")
    if total <= 0:
        return None
    return {"wall_ms_under_profiler": wall_ms, "device_ms": total / 1e3,
            "bn_ms": bn / 1e3, "bn_share": bn / total, "nccl_ms": nccl / 1e3,
            "nccl_share": nccl / total, "all_reduces": collectives}


def scale_train_child(conf, cli_conf):
    """Child: meshless and one-rank-NCCL-mesh training at the phase-8
    widths (fp32 parity, bf16 step ms, the BN's share), then the
    train_reconstruction CLI with -mesh 1x1 on ``cli_conf``."""
    import math

    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.models.convert import load_checkpoint
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig
    from lecturemath_tpu_torch.ops.conv7 import conv_same_nhwc
    from lecturemath_tpu_torch.parallel.mesh import (
        MeshSpec, initialize_distributed_from_env, make_mesh,
        warmup_collectives)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net_config = FCNConfig.from_config(Config.from_file(conf))
    batch = scale_batch()
    out = {}
    # batch 8 is launch-bound, batch 64 device-bound (phase 8's timings)
    big = {key: np.concatenate([value] * 8) for key, value in batch.items()}
    plain = scale_steps(scale_trainer(net_config, torch.float32, None),
                        batch)
    plain_ms = {size: step_ms(scale_trainer(net_config, torch.bfloat16,
                                            None), data)
                for size, data in ((TRAIN_BATCH, batch), (8 * TRAIN_BATCH,
                                                         big))}
    torch.cuda.empty_cache()
    if not initialize_distributed_from_env():
        raise AssertionError("no world joined under LM_COORDINATOR")
    mesh = make_mesh(MeshSpec(1, 1))
    warmup_collectives(mesh)
    meshed = scale_steps(scale_trainer(net_config, torch.float32, mesh),
                         batch)
    out["loss_rel"], out["stat_rel"] = compare_steps(plain, meshed)
    out["losses"] = {"meshless": plain[0], "mesh": meshed[0]}
    out["bf16_step_ms"] = {}
    for size, data in ((8 * TRAIN_BATCH, big), (TRAIN_BATCH, batch)):
        trainer = scale_trainer(net_config, torch.bfloat16, mesh)
        out["bf16_step_ms"][f"batch {size}"] = {
            "meshless": plain_ms[size], "mesh": step_ms(trainer, data)}
        if size == TRAIN_BATCH:
            out["profile"] = bn_share(trainer, data)
            # the same mesh step with each BN local: the collectives and
            # the work of the cross-replica BN out of it
            trainer.model.bn_group = None
            out["bf16_step_ms"][f"batch {size}"]["mesh, local BN"] = \
                step_ms(trainer, data)
        del trainer
        torch.cuda.empty_cache()

    # the CLI: it joins the same world (idempotent) and leaves it
    from lecturemath_tpu_torch.cli import train_reconstruction

    epochs = run_training_cli(train_reconstruction,
                              ["train_reconstruction", cli_conf, "-mesh",
                               "1x1"])
    losses = [terms["mse"] for terms in epochs]
    if not (len(losses) == SCALE_CLI_EPOCHS and losses[-1] < losses[0]
            and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"train CLI -mesh 1x1: losses {losses}")
    models = os.path.join(WORKSPACE, "scale_models")
    written = sorted(os.listdir(models))
    expected = ["rec_mesh.msgpack", "rec_mesh.msgpack.epoch_2.bak",
                "rec_mesh.msgpack.epoch_4.bak", "rec_mesh.msgpack.resume",
                "rec_mesh.msgpack.resume.json"]
    if written != expected:
        raise AssertionError(f"train CLI wrote {written}")
    state = load_checkpoint(os.path.join(models, "rec_mesh.msgpack"))
    if not all(torch.isfinite(v).all() for v in state.values()):
        raise AssertionError("the -mesh 1x1 checkpoint is not finite")
    out["cli_losses"] = losses
    out["k2_launches_in_training"] = conv_same_nhwc.launches
    print(json.dumps(out), flush=True)
    return 0


def scale_dp_child():
    """Child: one process of a 2-process NCCL world, one card each: 3 fp32
    data-parallel steps on the global batch against the meshless
    Trainer on this card."""
    import torch

    sys.path.insert(0, REPO)
    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig
    from lecturemath_tpu_torch.parallel.mesh import (
        MeshSpec, initialize_distributed_from_env, make_mesh,
        shutdown_distributed, warmup_collectives)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net_config = FCNConfig.from_config(Config.from_file(
        os.path.join(WORKSPACE, "smoke.conf")))
    batch = scale_batch()
    plain = scale_steps(scale_trainer(net_config, torch.float32, None),
                        batch)
    if not initialize_distributed_from_env():
        raise AssertionError("no world joined under LM_COORDINATOR")
    mesh = make_mesh(MeshSpec(2, 1))
    warmup_collectives(mesh)
    try:
        meshed = scale_steps(scale_trainer(net_config, torch.float32, mesh),
                             batch)
        loss_rel, stat_rel = compare_steps(plain, meshed)
    finally:
        shutdown_distributed()
    print(json.dumps({"rank": mesh.rank, "loss_rel": loss_rel,
                      "stat_rel": stat_rel, "losses": meshed[0]}),
          flush=True)
    return 0


def stream_fps(binarizer):
    """(fps, frames) of one stage-01 stream over the phase-4 lecture."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, frames = binarizer.process_source(make_source())
    torch.cuda.synchronize()
    return N_FRAMES / (time.perf_counter() - t0), frames


def summary_files(output):
    """segments.xml without its self-referential <Filename> line, and the
    keyframe PNGs' bytes, of the express summary under ``output``."""
    prefix = os.path.join(output, "summaries", "SmokeDB_smoke01")
    with open(os.path.join(prefix, "segments.xml")) as f:
        files = {"segments.xml": [line for line in f.read().splitlines()
                                  if "<Filename>" not in line]}
    for name in sorted(os.listdir(os.path.join(prefix, "keyframes"))):
        with open(os.path.join(prefix, "keyframes", name), "rb") as f:
            files[name] = f.read()
    return files


def phase_scale_out(conf, counters, card):
    """The data axis on the card; returns (launch counts of the path,
    numbers)."""
    import statistics

    import numpy as np
    import torch

    from lecturemath_tpu_torch.cli import binarize, run_pipeline
    from lecturemath_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer
    from lecturemath_tpu_torch.pipeline.driver import PipelineDriver

    config = PipelineDriver.from_config_path(conf, [], None, None).config
    plain = Binarizer.from_config(config)
    meshed = Binarizer.from_config(config, mesh=make_mesh(MeshSpec(1, 1)))
    for binarizer in (plain, meshed):  # cuDNN's choice, the allocator
        binarizer.packed_fn(torch.from_numpy(np.stack(
            [make_source().rgb_frame(t) for t in range(8)])).cuda())

    # the scale-out path: the mesh runs' launches count, the meshless
    # runs' (the comparison) do not
    inference_launches = {name: 0 for name in counters}
    fps = {"meshless": [], "mesh": []}
    frames = {}
    for which in ("meshless", "mesh", "mesh", "meshless", "meshless", "mesh"):
        for fn in counters.values():
            fn.launches = 0
        rate, got = stream_fps(plain if which == "meshless" else meshed)
        if which == "mesh":
            for name, count in counted(counters).items():
                inference_launches[name] += count
        fps[which].append(rate)
        frames.setdefault(which, got)
    if len(frames["mesh"]) != N_FRAMES or any(
            not np.array_equal(a, b) for a, b in zip(frames["mesh"],
                                                     frames["meshless"])):
        raise AssertionError("the 1x1 mesh's stage-01 frames differ from "
                             "the meshless Binarizer's")
    for name in EXPRESS_KERNELS:
        if inference_launches[name] <= 0:
            raise AssertionError(f"kernel {name} not launched on the mesh")
    medians = {k: statistics.median(v) for k, v in fps.items()}
    log(f"scale-out, one-card 1x1 mesh in-process: stage-01 frames "
        f"bit-identical to meshless over {N_FRAMES} frames; fps (median of "
        f"3, stream with host rendering) meshless {medians['meshless']:.2f}"
        f", mesh {medians['mesh']:.2f} ({json.dumps(fps)}); launches "
        f"{inference_launches}; on {card}")
    del plain, meshed
    torch.cuda.empty_cache()

    # the stage-01 CLI and express: meshless here, -mesh 1x1 in a child
    # that joins a one-rank NCCL world under the LM_* contract
    base = open(os.path.join(WORKSPACE, "staged.conf")).read()
    confs = {}
    for which in ("meshless", "mesh"):
        confs[which] = os.path.join(WORKSPACE, f"scale_{which}.conf")
        with open(confs[which], "w") as f:
            f.write(base.replace(f"{WORKSPACE}/output",
                                 f"{WORKSPACE}/scale_{which}"))
    saved = PipelineDriver.frame_source
    memory_frames(PipelineDriver)
    try:
        for module in (binarize, run_pipeline):
            module.main([module.__name__, confs["meshless"]])
    finally:
        PipelineDriver.frame_source = saved
    children = {}
    for name in ("binarize", "run_pipeline"):
        children[name], = child_results([start_child(
            f"scale_cli_child({name!r}, {confs['mesh']!r})")],
            f"{name} -mesh 1x1")
    artifact = os.path.join("temporal", "tempo_binary_smoke01.dat")
    with open(os.path.join(WORKSPACE, "scale_meshless", artifact), "rb") as f:
        single = f.read()
    with open(os.path.join(WORKSPACE, "scale_mesh", artifact), "rb") as f:
        if f.read() != single:
            raise AssertionError("the -mesh 1x1 stage-01 artifact differs "
                                 "from the meshless CLI's")
    ours = summary_files(os.path.join(WORKSPACE, "scale_mesh"))
    if ours != summary_files(os.path.join(WORKSPACE, "scale_meshless")):
        raise AssertionError("express -mesh 1x1's summary differs from the "
                             "meshless one's")
    log(f"scale-out CLIs under LM_* (one-rank NCCL world): binarize -mesh "
        f"1x1 artifact byte-identical ({len(single)} bytes), express "
        f"summary identical ({len(ours) - 1} keyframes); walls "
        f"{json.dumps({k: round(v['wall_s'], 3) for k, v in children.items()})}"
        f" s; launches {json.dumps({k: v['launches'] for k, v in children.items()})}"
        f"; on {card}")

    # data-parallel training in a one-rank NCCL world, and a train CLI
    make_training_set()
    models = os.path.join(WORKSPACE, "scale_models")
    os.makedirs(models, exist_ok=True)
    training = open(os.path.join(WORKSPACE, "training.conf")).read()
    cli_conf = os.path.join(WORKSPACE, "scale_training.conf")
    with open(cli_conf, "w") as f:
        f.write(training.replace(
            f"{WORKSPACE}/models/rec_pretrain.msgpack",
            f"{models}/rec_mesh.msgpack").replace(
            "FCN_BINARIZER_PRETRAIN_REC_EPOCHS = 2",
            f"FCN_BINARIZER_PRETRAIN_REC_EPOCHS = {SCALE_CLI_EPOCHS}"))
    train, = child_results([start_child(
        f"scale_train_child({conf!r}, {cli_conf!r})")], "training")
    profile = train["profile"]
    log(f"scale-out training, one-rank NCCL world, batch {TRAIN_BATCH} at "
        f"256x256, binarizer phase, weighted, clipped: fp32 (TF32 off) "
        f"losses mesh {train['losses']['mesh']} vs meshless "
        f"{train['losses']['meshless']} (largest rel {train['loss_rel']:.2e}"
        f"; running stats {train['stat_rel']:.2e}; bound rtol {SCALE_RTOL},"
        f" atol {SCALE_ATOL}); bf16 step ms (median of {TIMED_STEPS} after "
        f"{WARMUP_STEPS}, CUDA events) {json.dumps(train['bf16_step_ms'])}"
        f"; profiled mesh step at batch {TRAIN_BATCH} "
        f"{json.dumps(profile)}; train_reconstruction -mesh 1x1 epoch "
        f"losses {train['cli_losses']}; K2 launches in training "
        f"{train['k2_launches_in_training']}; on {card}")
    if train["k2_launches_in_training"]:
        raise AssertionError("K2 launched in a training forward")

    numbers = {"fps": medians, "bf16_step_ms": train["bf16_step_ms"],
               "bn_profile": profile, "loss_rel": train["loss_rel"],
               "stat_rel": train["stat_rel"],
               "cli_walls_s": {k: v["wall_s"] for k, v in children.items()}}
    if torch.cuda.device_count() >= 2:
        numbers["two_cards"] = two_card_checks(config, card)
    else:
        log(f"scale-out: the 2-card checks (inference over 2 cards, a "
            f"2-process NCCL training) were NOT run: this machine has "
            f"{torch.cuda.device_count()} card")
    launches = dict(inference_launches)
    for child in children.values():
        for name, count in child["launches"].items():
            launches[name] = launches.get(name, 0) + count
    return launches, numbers


def two_card_checks(config, card):
    """Inference over 2 cards in-process and a 2-process NCCL training."""
    import numpy as np

    from lecturemath_tpu_torch.parallel.launch import free_port
    from lecturemath_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer

    plain = Binarizer.from_config(config)
    two = Binarizer.from_config(config, mesh=make_mesh(MeshSpec(2, 1)))
    rates = {"meshless": [], "2 cards": []}
    frames = {}
    for which, binarizer in (("meshless", plain), ("2 cards", two),
                             ("2 cards", two), ("meshless", plain)):
        rate, frames[which] = stream_fps(binarizer)
        rates[which].append(rate)
    flips = float(np.mean([np.mean(a != b) for a, b in zip(
        frames["2 cards"], frames["meshless"])]))
    if flips > MAX_FLIP_RATE:
        raise AssertionError(f"2-card stage-01 flip rate {flips}")
    port = free_port()
    results = child_results([start_child("scale_dp_child()", world=2,
                                       rank=rank, port=port,
                                       visible=str(rank))
                             for rank in range(2)], "2-process training")
    log(f"scale-out on 2 cards: stage-01 fps {json.dumps(rates)}, flip rate "
        f"vs meshless {flips:.2e}; 2-process NCCL training "
        f"{json.dumps(results)}; on {card}")
    return {"fps": rates, "flip_rate": flips, "training": results}


# --------------------------------------------------------------- phase 11

# express through the recycled device worker: batches of 16 (the phase-4
# lecture is 15 of them, so every child reports batches before the stream
# ends) and a recycle budget this far above the first child's RSS at ready
WORKER_BATCH = 16
WORKER_MARGIN_MB = 32
# seconds to wait for a closed child's card memory to come back, and what
# may stay held
MEMORY_SETTLE_S = 30
MEMORY_SLACK = 64 << 20
# the device ops: CLAHE on 16 gray frames at two grids (the JAX package's
# default and the classical binarizer's 960 // 20 x 540 // 20), within one
# gray level (modulo 256) on at most this share of the pixels; motion
# statistics over frame pairs; k-means on clustered seeded features
CLAHE_FRAMES = 16
CLAHE_GRIDS = ((8, 8), (48, 27))
MAX_CLAHE_OFF = 1e-3
STAT_RTOL = 1e-5
KMEANS_ROWS, KMEANS_DIM, KMEANS_K, KMEANS_UPDATES = 65536, 64, 32, 20
# the classical tracker path: 16 RGB frames of the lecture
CLASSICAL_FRAMES = 16


class CapturedStream:
    """A binarizer's streaming surface that keeps every stage-01 frame the
    express run consumed."""

    def __init__(self, binarizer):
        self.binarizer = binarizer
        self.frames = []

    def stream_source(self, source, frames_limit=0, invert=True):
        for times, indices, frames in self.binarizer.stream_source(
                source, frames_limit, invert):
            self.frames.extend(frames)
            yield times, indices, frames


def free_card_bytes():
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0]


def worker_express(conf, summary, card):
    """Express through WorkerBinarizer against the in-process path."""
    import numpy as np
    import torch

    from lecturemath_tpu_torch.pipeline.binarize import Binarizer
    from lecturemath_tpu_torch.pipeline.device_worker import WorkerBinarizer
    from lecturemath_tpu_torch.pipeline.driver import PipelineDriver
    from lecturemath_tpu_torch.pipeline.express import run_lecture
    from lecturemath_tpu_torch.pipeline.video import ArraySource

    driver = PipelineDriver.from_config_path(conf, [], None, None)
    lecture = driver.database.lectures[0]
    plain = Binarizer.from_config(driver.config)
    plain.packed_fn(torch.from_numpy(np.stack(
        [make_source().rgb_frame(t) for t in range(8)])).cuda())
    plain_fps, plain_frames = stream_fps(plain)
    del plain
    free_before = free_card_bytes()

    worker = WorkerBinarizer.from_config(
        driver.config, binarizer_kwargs={"batch_size": WORKER_BATCH},
        compile_cache=os.path.join(WORKSPACE, "cuda_cache"))
    if not (worker.prespawn and worker.prespawn_eager):
        raise AssertionError("the worker runs without an eager spare")
    try:
        # the cold child, warmed by one frame (the stream before the
        # lecture, not counted); the budget sits just above its RSS at ready
        worker.process_source(ArraySource(
            np.stack([make_source().rgb_frame(0)])))
        cold = dict(worker.children[0])
        worker.recycle_mb = cold["ready_rss_mb"] + WORKER_MARGIN_MB
        worker.launches = {}
        captured = CapturedStream(worker)
        t0 = time.perf_counter()
        indices, times, keyframes = run_lecture(
            driver, lecture, captured, source=make_source(), export=False)
        wall = time.perf_counter() - t0
        launches = dict(worker.launches)
    finally:
        worker.close()
    deadline = time.monotonic() + MEMORY_SETTLE_S
    free_after = free_card_bytes()
    while free_before - free_after > MEMORY_SLACK and \
            time.monotonic() < deadline:
        time.sleep(0.5)
        free_after = free_card_bytes()

    ready = [c for c in worker.children if c["start_to_ready_s"] is not None]
    warm = [c["start_to_ready_s"] for c in ready[1:]]
    log(f"express through the device worker: {N_FRAMES} frames in "
        f"{wall:.3f} s = {N_FRAMES / wall:.2f} fps (in-process express "
        f"{summary['fps']:.2f} fps, phase 4; in-process stage-01 stream "
        f"{plain_fps:.2f} fps); batch {WORKER_BATCH}, budget "
        f"{worker.recycle_mb:.1f} MB; recycles {worker.recycles}, stalls ms "
        f"{[round(1000 * s, 3) for s in worker.recycle_stalls_s]}; child "
        f"start to ready s: cold {cold['start_to_ready_s']:.3f}, warm "
        f"{[round(s, 3) for s in warm]}; child RSS MB at ready / peak "
        f"{[(round(c['ready_rss_mb'], 1), round(c['peak_rss_mb'], 1)) for c in ready]}"
        f"; card free GiB before {free_before / 2**30:.3f}, after "
        f"{free_after / 2**30:.3f}; launches in the children {launches}; "
        f"on {card}")
    if worker.recycles < 2:
        raise AssertionError(f"{worker.recycles} recycles, expected >= 2")
    if len(captured.frames) != N_FRAMES or any(
            not np.array_equal(a, b)
            for a, b in zip(captured.frames, plain_frames)):
        raise AssertionError("the worker's stage-01 frames differ from the "
                             "in-process Binarizer's")
    if list(indices) != summary["indices"] or \
            list(times) != summary["times"] or \
            len(keyframes) != len(summary["keyframes"]) or any(
                not np.array_equal(a, b)
                for a, b in zip(keyframes, summary["keyframes"])):
        raise AssertionError("the worker's express summary differs from "
                             "phase 4's")
    for name in EXPRESS_KERNELS:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} not launched in a child")
    if free_before - free_after > MEMORY_SLACK:
        raise AssertionError(f"the closed children left "
                             f"{(free_before - free_after) / 2**20:.0f} MiB "
                             f"of card memory held")
    return launches, {"fps": N_FRAMES / wall, "plain_stream_fps": plain_fps,
                      "recycles": worker.recycles,
                      "stalls_ms": [1000 * s
                                    for s in worker.recycle_stalls_s],
                      "children": worker.children,
                      "free_gib": [free_before / 2**30, free_after / 2**30]}


def mod256(a, b):
    import numpy as np

    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return np.minimum(d, 256 - d)


def device_ops(card):
    """CLAHE, motion statistics and k-means on the card against the port's
    CPU versions (and CLAHE against the float64 host CLAHE)."""
    import numpy as np
    import torch

    from lecturemath_tpu_torch.ops import (clahe_batch, clahe_host,
                                           motion_stats)
    from lecturemath_tpu_torch.ops.ckmeans import ConvolutionalKMeans
    from lecturemath_tpu_torch.utils.image import rgb_to_gray

    source = make_source()
    picks = np.linspace(0, N_FRAMES - 1, CLAHE_FRAMES).astype(int)
    gray = np.stack([rgb_to_gray(source.rgb_frame(t)) for t in picks])
    numbers = {"clahe": {}}
    for grid in CLAHE_GRIDS:
        card_gray = torch.from_numpy(gray).cuda()
        ours = clahe_batch(card_gray, 0.04, *grid).cpu().numpy()
        ms = cuda_ms(lambda: clahe_batch(card_gray, 0.04, *grid), 5)
        cpu = clahe_batch(gray, 0.04, *grid, device="cpu").numpy()
        host = np.stack([clahe_host(g, 0.04, *grid) for g in gray])
        shares = {}
        for name, other in (("cpu", cpu), ("host", host)):
            d = mod256(ours, other)
            shares[name] = float((d > 0).mean())
            if d.max() > 1 or shares[name] > MAX_CLAHE_OFF:
                raise AssertionError(
                    f"clahe_batch grid {grid} on the card vs {name}: max "
                    f"{d.max()} levels, {shares[name]} of pixels off")
        numbers["clahe"][f"{grid[0]}x{grid[1]}"] = {"ms": ms, **shares}
        log(f"clahe_batch [{CLAHE_FRAMES},{HEIGHT},{WIDTH}] grid "
            f"{grid[0]}x{grid[1]}: {ms:.3f} ms a batch (CUDA events); pixels"
            f" one level off: {shares['cpu']:.2e} of the CPU's, "
            f"{shares['host']:.2e} of clahe_host's (bound {MAX_CLAHE_OFF})"
            f"; on {card}")

    pairs = [(t, t + step) for step in (1, 8, 60) for t in (0, 100, 119)]
    changed = 0
    for jump in (1, 3):
        for a, b in pairs:
            frame, last = source.rgb_frame(b), source.rgb_frame(a)
            ours = motion_stats(torch.from_numpy(frame).cuda(),
                                torch.from_numpy(last).cuda(), 15, jump)
            theirs = motion_stats(frame, last, 15, jump, device="cpu")
            if int(ours.total_changes) != int(theirs.total_changes) or \
                    not np.array_equal(ours.bbox.cpu().numpy(),
                                       theirs.bbox.numpy()):
                raise AssertionError(f"motion_stats {a}->{b} jump {jump}: "
                                     f"count or bbox differ")
            for got, want in ((ours.centroid, theirs.centroid),
                              (ours.deviation, theirs.deviation)):
                np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                           rtol=STAT_RTOL)
            changed += int(theirs.total_changes)
    if changed == 0:
        raise AssertionError("motion_stats saw no change in any pair")
    log(f"motion_stats on {2 * len(pairs)} frame pairs (jump 1 and 3): "
        f"counts and bboxes exact, centroid and deviation within rtol "
        f"{STAT_RTOL}; {changed} changed pixels in all")

    rng = np.random.default_rng(0)
    means = rng.normal(0, 1, (KMEANS_K, KMEANS_DIM))
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    data = (means[rng.integers(0, KMEANS_K, KMEANS_ROWS)]
            + rng.normal(0, 0.05, (KMEANS_ROWS, KMEANS_DIM))
            ).astype(np.float32)
    ours = ConvolutionalKMeans(data, KMEANS_K, init_vectors=means)
    theirs = ConvolutionalKMeans(data, KMEANS_K, init_vectors=means,
                                 device="cpu")
    ours.update()  # cuBLAS's first call, not timed
    theirs.update()
    gaps = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    elapsed = 0.0
    for _ in range(KMEANS_UPDATES - 1):
        start.record()
        similarity = ours.update()
        end.record()
        end.synchronize()
        elapsed += start.elapsed_time(end)
        gaps.append(abs(similarity - theirs.update()))
    if max(gaps) > STAT_RTOL:
        raise AssertionError(f"k-means similarity off by {max(gaps)}")
    if not np.array_equal(ours.assign(data), theirs.assign(data)):
        raise AssertionError("k-means assignments differ")
    np.testing.assert_allclose(ours.centers.cpu().numpy(),
                               theirs.centers.numpy(), rtol=STAT_RTOL,
                               atol=1e-6)
    update_ms = elapsed / (KMEANS_UPDATES - 1)
    log(f"ConvolutionalKMeans [{KMEANS_ROWS},{KMEANS_DIM}] k={KMEANS_K}: "
        f"{KMEANS_UPDATES} updates, assignments equal, similarity within "
        f"{max(gaps):.2e}; {update_ms:.3f} ms an update (CUDA events around "
        f"update(), its host sync included); on {card}")
    numbers["kmeans_update_ms"] = update_ms
    return numbers


def classical_run():
    """The tracker's classical path over CLASSICAL_FRAMES RGB frames of the
    lecture: (unique CCs, a digest of their boxes and sizes, ms a frame,
    whether cv2 was importable)."""
    import hashlib
    import importlib.util

    import numpy as np

    from lecturemath_tpu_torch.ops.classical import \
        background_subtraction_binarize
    from lecturemath_tpu_torch.pipeline.cc_tracking import CCTracker

    source = make_source()
    tracker = CCTracker(width=WIDTH, height=HEIGHT, min_recall=0.925,
                        min_precision=0.925, max_gap=85)
    picks = np.linspace(0, N_FRAMES - 1, CLASSICAL_FRAMES).astype(int)
    # untimed: the native median's first call builds its library
    background_subtraction_binarize(source.rgb_frame(0))
    t0 = time.perf_counter()
    for t in picks:
        tracker.add_frame(source.rgb_frame(int(t)), input_binary=False)
    wall = time.perf_counter() - t0
    boxes = [[cc.min_x, cc.max_x, cc.min_y, cc.max_y, cc.size]
             for cc in tracker.unique_ccs]
    return {"unique": len(boxes),
            "digest": hashlib.sha256(json.dumps(boxes).encode()).hexdigest(),
            "ms_per_frame": 1000 * wall / len(picks),
            # None for a module blocked through sys.modules
            "cv2_importable": importlib.util.find_spec("cv2") is not None}


def classical_child():
    """Child (cv2 and PIL blocked): classical_run's result as JSON."""
    print(json.dumps(classical_run()), flush=True)
    return 0


def phase_device_worker(conf, summary, card):
    """Express through the recycled device worker, the device ops on the
    card, and the classical tracker path; returns (the children's launch
    counts, numbers)."""
    launches, numbers = worker_express(conf, summary, card)
    numbers["ops"] = device_ops(card)
    blocked, = child_results([start_child("classical_child()",
                                          block=("cv2", "PIL"))],
                             "classical tracker")
    allowed = classical_run()
    log(f"classical tracker path, {CLASSICAL_FRAMES} RGB frames at "
        f"{WIDTH}x{HEIGHT}: {blocked['unique']} unique CCs with cv2 and PIL "
        f"blocked ({blocked['ms_per_frame']:.1f} ms a frame), "
        f"{allowed['unique']} with cv2 "
        f"{'importable' if allowed['cv2_importable'] else 'absent'} "
        f"({allowed['ms_per_frame']:.1f} ms a frame)")
    if blocked["cv2_importable"]:
        raise AssertionError("cv2 was importable in the blocked child")
    if blocked["unique"] <= 0 or (blocked["unique"], blocked["digest"]) != \
            (allowed["unique"], allowed["digest"]):
        raise AssertionError(f"classical tracker: blocked {blocked} vs "
                             f"allowed {allowed}")
    numbers["classical"] = {"blocked": blocked, "allowed": allowed}
    return launches, numbers


# --------------------------------------------------------------- phase 12

# the lecture's tooling on the card's host, over phase 4's express summary
# and phase 6's stage-01 artifact: the cv2-free half writes under
# TOOLING_OUT (once in a child with cv2, PIL and matplotlib blocked, once
# here), the cv2 half under TOOLING_DIR
TOOLING_DIR = os.path.join(WORKSPACE, "tooling")
TOOLING_OUT = os.path.join(TOOLING_DIR, "out")
TOOLING_BLOCK = ("cv2", "PIL", "matplotlib")
# the annotator's edit of the second keyframe's projection: one corner of
# the default quad (offset 10)
TOOLING_CORNER, TOOLING_DELTA = 2, (-24.5, 13.25)
# text regions on the 960x540 frame (annotation canvas = frame), each at the
# lecture's first and last frame; "board" is not a text region
TOOLING_TEXT = (
    ("text_title", [(300, 30), (700, 30), (700, 90), (300, 90)],
     [(310, 34), (720, 34), (720, 96), (310, 96)]),
    ("text_eq1", [(120, 200), (520, 190), (530, 260), (110, 270)],
     [(120, 200), (520, 190), (530, 260), (110, 270)]),
    ("text_eq2", [(560, 300), (900, 300), (900, 380), (560, 380)],
     [(500, 320), (860, 330), (850, 400), (505, 395)]),
    ("board", [(0, 0), (959, 0), (959, 539), (0, 539)],
     [(0, 0), (959, 0), (959, 539), (0, 539)]))
# the speaker's box (x, y, w, h) at sparse frames, walking past the text
TOOLING_SPEAKER = {0: (40.0, 120.0, 220.0, 400.0),
                   120: (420.0, 140.0, 220.0, 400.0),
                   239: (760.0, 120.0, 200.0, 420.0)}
TOOLING_TEXT_STEP = 20
# text polygons for the dataset-prep mask writers (LSVT-style points, and
# COCO-Text flat polygons), some past the frame
TOOLING_MASK_REGIONS = 24
TOOLING_JPEGS, TOOLING_SMALL_JPEGS = 16, 2
# the two views visual_alignment aligns: corners of the keyframe moved by
TOOLING_VIEWS = (((0, 0), (14, -9), (-11, 6), (5, 12)),
                 ((-8, 10), (3, 4), (12, -7), (-6, -13)))
TOOLING_MIN_ALIGNMENT, TOOLING_MAX_CORNER_PX = 0.5, 2.0


def tooling_gt(out, inputs):
    """The GT tree of the express keyframes, the express summary beside it,
    and cli.eval_summaries over both; returns the self-evaluation's
    recall/precision by min R/P."""
    import contextlib
    import io

    from lecturemath_tpu_torch.cli import eval_summaries
    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.core.metadata import MetaDataDB
    from lecturemath_tpu_torch.eval.gt_authoring import export_gt_tree
    from lecturemath_tpu_torch.eval.summary_eval import SummaryEvaluator
    from lecturemath_tpu_torch.pipeline.keyframes import export_summary

    indices = [int(i) for i in inputs["indices"]]
    times = [float(t) for t in inputs["times"]]
    keyframes = list(inputs["keyframes"])
    bounds = [0] + [i + 1 for i in indices]
    segments = [(bounds[k], indices[k]) for k in range(len(indices))]
    output = os.path.join(out, "output")
    export_gt_tree(os.path.join(output, "annotations"), "SmokeDB", "smoke01",
                   indices, times, [kf[:, :, 0] for kf in keyframes],
                   segments=segments, video_paths=["smoke01.mp4"],
                   write_portions=True)
    export_summary(os.path.join(output, "summaries", "SmokeDB_smoke01"),
                   "SmokeDB", "smoke01", ["smoke01.mp4"], segments,
                   [(s * 1000.0, e * 1000.0) for s, e in segments], indices,
                   times, keyframes)
    with open(os.path.join(out, "db.xml"), "w") as f:
        f.write(DB_XML)
    conf = os.path.join(out, "tooling.conf")
    with open(conf, "w") as f:
        f.write(CONFIG.format(ws=WORKSPACE).replace(
            f"{WORKSPACE}/db.xml", f"{out}/db.xml").replace(
            f"{WORKSPACE}/output", output))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        eval_summaries.main(["eval_summaries", conf, "-l", "smoke01"])
    if "Finished" not in printed.getvalue():
        raise AssertionError("cli.eval_summaries did not finish")
    config = Config.from_file(conf)
    database = MetaDataDB.from_file(config.get_str("VIDEO_DATABASE_PATH"))
    numbers = summary_numbers(SummaryEvaluator().evaluate_lecture(
        config, database, database.get_lecture("smoke01")))
    if not numbers or any(pair != (1.0, 1.0) for pair in numbers.values()):
        raise AssertionError(f"the express summary against its own GT tree "
                             f"does not score 1.0: {numbers}")
    return numbers


def tooling_words(out):
    """Default and edited projections and word trees over the exported
    keyframes; save and load projections, word annotations and unique
    words; returns the word boxes of each keyframe."""
    from lecturemath_tpu_torch.data.region_tree import RegionTree
    from lecturemath_tpu_torch.eval.annotation import KeyframeAnnotation
    from lecturemath_tpu_torch.eval.words import (
        KeyFrameWords, default_word_groups, load_projections,
        load_unique_words, load_word_annotations, save_projections,
        save_unique_words, save_word_annotations, warped_inverted_binary)
    from lecturemath_tpu_torch.utils.png import read_image

    prefix = os.path.join(out, "output", "annotations", "SmokeDB_smoke01")
    frames = KeyframeAnnotation.load_exported_keyframes(
        os.path.join(prefix, "segments.xml"),
        os.path.join(prefix, "keyframes") + "/", False)
    for kf in frames:
        kf.raw_image = read_image(os.path.join(prefix, "keyframes",
                                               f"{kf.idx}.png"))
        kf.binary_image = read_image(os.path.join(prefix, "binary",
                                                  f"{kf.idx}.png"))
    all_words = []
    for k, kf in enumerate(frames):
        words = KeyFrameWords.create_default(kf)
        if k == 1:
            projection = words.projection.copy()
            moved = projection.src_points.copy()
            moved[TOOLING_CORNER] += TOOLING_DELTA
            projection.update_from_points(projection.src_points, moved)
            words = KeyFrameWords(kf, projection, RegionTree.from_binary(
                warped_inverted_binary(kf, projection)))
        words.tree.segment_recursive()
        all_words.append(words)
    paths = {name: os.path.join(out, f"{name}.xml")
             for name in ("projections", "word_annotations", "unique_words")}
    save_projections(paths["projections"], [w.projection for w in all_words])
    save_word_annotations(paths["word_annotations"], all_words)
    _, groups = default_word_groups(all_words)
    save_unique_words(paths["unique_words"], all_words, groups)
    written = [w.get_words() for w in all_words]
    loaded = load_word_annotations(paths["word_annotations"], frames)
    _, loaded_groups = load_unique_words(paths["unique_words"], loaded)
    projections = load_projections(paths["projections"])
    if [w.get_words() for w in loaded] != written or \
            len(loaded_groups) != len(groups) or \
            len(projections) != len(frames):
        raise AssertionError("the loaded word annotations differ from the "
                             "written ones")
    if not all(written):
        raise AssertionError(f"a keyframe has no words: {written}")
    return [[list(map(int, box)) for box in boxes] for boxes in written]


def tooling_text(out):
    """TextAnnotationExporter's PNG branch, per frame and unique boxes, on
    phase 9's annotation with a speaker and text regions."""
    from lecturemath_tpu_torch.eval.gt_authoring import set_speaker_track
    from lecturemath_tpu_torch.eval.lecture_annotation import (DrawingInfo,
                                                               TimelineObject)
    from lecturemath_tpu_torch.eval.text_export import TextAnnotationExporter

    annotation = smoke_annotation()
    set_speaker_track(annotation, TOOLING_SPEAKER, fps=1.0)
    for name, first, last in TOOLING_TEXT:
        obj = TimelineObject(name, name, TimelineObject.SHAPE_POLYGON)
        obj.set_location_at(0, 0.0, True, first)
        obj.set_location_at(N_FRAMES - 1, (N_FRAMES - 1) * 1000.0, True,
                            last)
        annotation.video_objects[name] = obj
    annotation.drawing_info = DrawingInfo((0, 0, WIDTH, HEIGHT),
                                          (0, HEIGHT, WIDTH, 0),
                                          (0, 0, WIDTH, HEIGHT))
    annotation.save(os.path.join(out, "smoke01_text.xml"))
    source = make_source()
    counts = {}
    for mode, name in ((TextAnnotationExporter.ALL_PER_FRAME, "per_frame"),
                       (TextAnnotationExporter.UNIQUE_BOXES, "unique")):
        exporter = TextAnnotationExporter(
            annotation, ["text"], "speaker", 0.25, mode,
            os.path.join(out, "text", name), export_images=True)
        exporter.initialize(WIDTH, HEIGHT)
        visible = occluded = 0
        for t in range(0, N_FRAMES, TOOLING_TEXT_STEP):
            _, shown, hidden = exporter.frame_visible_bboxes_state(t)
            visible, occluded = visible + len(shown), occluded + len(hidden)
            exporter.handle_frame(source.rgb_frame(t)[:, :, ::-1].copy(), t)
        exporter.finalize()
        counts[name] = (visible, occluded)
    if counts["per_frame"][0] == 0 or counts["per_frame"][1] == 0:
        raise AssertionError(f"text export: no visible or no occluded text "
                             f"region (visible, occluded) {counts}")
    return counts


def tooling_masks(out):
    """prepare_text_masks' and prepare_cocotext's mask writers at the
    frame's size; returns the masks' ink pixels."""
    import numpy as np

    from lecturemath_tpu_torch.cli.prepare_cocotext import coco_polygon_mask
    from lecturemath_tpu_torch.cli.prepare_text_masks import \
        rasterize_text_regions
    from lecturemath_tpu_torch.utils.png import write_image

    rng = np.random.default_rng(12)
    entries = [{"points": np.stack([rng.integers(-40, WIDTH + 40, k),
                                    rng.integers(-40, HEIGHT + 40, k)],
                                   1).tolist()}
               for k in rng.integers(4, 9, TOOLING_MASK_REGIONS)]
    table = {}
    for k in range(TOOLING_MASK_REGIONS):
        x, y = rng.uniform(-20, WIDTH), rng.uniform(-20, HEIGHT)
        w, h = rng.uniform(20, 200), rng.uniform(10, 60)
        table[str(k)] = {"polygon": [x, y, x + w, y + 2, x + w, y + h, x,
                                     y + h - 3]}
    os.makedirs(os.path.join(out, "masks"), exist_ok=True)
    ink = {}
    for name, mask in (
            ("lsvt", rasterize_text_regions(entries, HEIGHT, WIDTH)),
            ("coco", coco_polygon_mask(range(TOOLING_MASK_REGIONS), table,
                                       HEIGHT, WIDTH))):
        write_image(os.path.join(out, "masks", f"{name}.png"), mask)
        ink[name] = int((mask > 0).sum())
    return ink


def tooling_frames():
    """interpolated_frames over phase 6's stage-01 artifact, every frame
    from 0 to the last sampled one; every sampled index must be the
    artifact's binary bit for bit. Returns (frames, sampled)."""
    import numpy as np

    from lecturemath_tpu_torch.core.artifacts import ArtifactStore
    from lecturemath_tpu_torch.pipeline.export_video import \
        interpolated_frames
    from lecturemath_tpu_torch.pipeline.video import decompress_png

    store = ArtifactStore(os.path.join(WORKSPACE, "output", "temporal"))
    _, indices, compressed = store.load("tempo_binary_", "smoke01")
    binaries = decompress_png(compressed)
    sampled = dict(zip((int(i) for i in indices), binaries))
    total = int(indices[-1]) + 1
    rendered = 0
    for idx, frame in interpolated_frames(binaries, indices, 0, total):
        rendered += 1
        if idx in sampled and not np.array_equal(frame, sampled[idx]):
            raise AssertionError(f"interpolated frame {idx} differs from "
                                 f"the stage-01 binary")
    if rendered != total or len(sampled) != N_FRAMES:
        raise AssertionError(f"{rendered} frames rendered, {total} expected;"
                             f" {len(sampled)} sampled")
    return rendered, len(sampled)


def tree_digest(root):
    """sha256 of every file under root, by relative path."""
    import hashlib

    digest = hashlib.sha256()
    count = 0
    for base, dirs, names in sorted(os.walk(root)):
        dirs.sort()
        for name in sorted(names):
            path = os.path.join(base, name)
            digest.update(os.path.relpath(path, root).encode() + b"\0")
            with open(path, "rb") as f:
                digest.update(f.read())
            count += 1
    return digest.hexdigest(), count


def tooling_run():
    """The cv2-free half over the inputs phase 12 saved; returns each
    step's result and wall, the digest of every file written and whether
    cv2 was importable."""
    import importlib.util

    import numpy as np

    shutil.rmtree(TOOLING_OUT, ignore_errors=True)
    os.makedirs(TOOLING_OUT)
    with np.load(os.path.join(TOOLING_DIR, "inputs.npz")) as data:
        inputs = dict(data)
    walls, results = {}, {}
    for name, step in (("gt tree + eval_summaries",
                        lambda: tooling_gt(TOOLING_OUT, inputs)),
                       ("words", lambda: tooling_words(TOOLING_OUT)),
                       ("text export", lambda: tooling_text(TOOLING_OUT)),
                       ("mask writers", lambda: tooling_masks(TOOLING_OUT)),
                       ("interpolated frames", tooling_frames)):
        t0 = time.perf_counter()
        results[name] = step()
        walls[name] = time.perf_counter() - t0
    digest, files = tree_digest(TOOLING_OUT)
    return {"results": results, "walls": walls, "digest": digest,
            "files": files,
            "cv2_importable": importlib.util.find_spec("cv2") is not None}


def tooling_child():
    """Child (cv2, PIL and matplotlib blocked): tooling_run's result."""
    print(json.dumps(tooling_run()), flush=True)
    return 0


def tooling_video_conf():
    """The staged config (phase 6's artifact) over a database whose
    lecture video is TOOLING_DIR/videos/smoke01.avi."""
    with open(os.path.join(TOOLING_DIR, "db.xml"), "w") as f:
        f.write(DB_XML.replace("smoke01.mp4", "smoke01.avi"))
    with open(os.path.join(WORKSPACE, "staged.conf")) as f:
        base = f.read()
    conf = os.path.join(TOOLING_DIR, "video.conf")
    with open(conf, "w") as f:
        f.write(base.replace(f"{WORKSPACE}/db.xml",
                             f"{TOOLING_DIR}/db.xml").replace(
            f"{WORKSPACE}/videos", f"{TOOLING_DIR}/videos"))
    return conf


def tooling_video(ffmpeg):
    """The lecture's 240 frames as an MJPG AVI at 30 fps (with a silent
    audio track muxed in by ffmpeg where it is on the PATH, since the
    export muxes the source's audio)."""
    import cv2

    videos = os.path.join(TOOLING_DIR, "videos")
    os.makedirs(videos, exist_ok=True)
    path = os.path.join(videos, "smoke01.avi")
    silent = os.path.join(videos, "frames_only.avi") if ffmpeg else path
    writer = cv2.VideoWriter(silent, cv2.VideoWriter_fourcc(*"MJPG"), 30.0,
                             (WIDTH, HEIGHT))
    if not writer.isOpened():
        raise AssertionError("OpenCV cannot write an MJPG AVI")
    source = make_source()
    for t in range(N_FRAMES):
        writer.write(source.rgb_frame(t)[:, :, ::-1])
    writer.release()
    if ffmpeg:
        subprocess.run([ffmpeg, "-y", "-loglevel", "error", "-i", silent,
                        "-f", "lavfi", "-i", "anullsrc=r=44100:cl=mono",
                        "-shortest", "-c:v", "copy", "-c:a", "pcm_s16le",
                        path], check=True, timeout=CHILD_TIMEOUT_S)
    return path


def tooling_cv2_half(keyframe, card):
    """The steps that need OpenCV: the AVI, the video_metrics and
    export_video CLIs, validate_dataset on JPEGs and visual_alignment;
    returns each step's wall."""
    import contextlib
    import io

    import cv2
    import numpy as np

    from lecturemath_tpu_torch.cli import (export_video, validate_dataset,
                                           video_metrics)
    from lecturemath_tpu_torch.eval.visual_alignment import \
        compute_visual_alignment
    from lecturemath_tpu_torch.pipeline.video_metrics import VideoMetrics

    walls = {}
    ffmpeg = shutil.which("ffmpeg")

    def timed(name, fn):
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            result = fn()
        walls[name] = time.perf_counter() - t0
        return result, printed.getvalue()

    video, _ = timed("MJPG AVI", lambda: tooling_video(ffmpeg))
    conf = tooling_video_conf()
    metrics_json = os.path.join(TOOLING_DIR, "metrics.json")
    _, text = timed("cli.video_metrics", lambda: video_metrics.main(
        ["video_metrics", conf, "-l", "smoke01", "-json", metrics_json]))
    with open(metrics_json) as f:
        counted = json.load(f)["smoke01"]["total_frames"]
    if counted != N_FRAMES:
        raise AssertionError(f"video_metrics counted {counted} frames of "
                             f"{N_FRAMES}: {text}")

    exported = os.path.join(TOOLING_DIR, "export", "smoke01_binary.mp4")
    _, text = timed("cli.export_video", lambda: export_video.main(
        ["export_video", conf, "-l", "smoke01", "-o", exported]))
    for line in text.splitlines():
        if not line.startswith("ffmpeg -y"):
            log(f"  {line}")
    read_back = VideoMetrics.from_video_files([exported]).total_frames
    writer = "ffmpeg" if ffmpeg else "OpenCV VideoWriter"
    if read_back != N_FRAMES:
        raise AssertionError(f"the exported video ({writer}) reads back "
                             f"{read_back} frames of {N_FRAMES}")

    jpegs = os.path.join(TOOLING_DIR, "jpegs")
    os.makedirs(jpegs, exist_ok=True)
    source = make_source()
    for k in range(TOOLING_JPEGS):
        frame = source.rgb_frame(15 * k)[:, :, ::-1]
        if k < TOOLING_SMALL_JPEGS:
            frame = frame[:200, :300]
        cv2.imwrite(os.path.join(jpegs, f"{k:02d}.jpg"), frame)
    with open(os.path.join(jpegs, f"{TOOLING_JPEGS - 1:02d}.jpg"),
              "wb") as f:
        f.write(b"not a JPEG")
    _, text = timed("validate_dataset", lambda: validate_dataset.main(
        ["validate_dataset", jpegs]))
    want = f"1 unloadable, {TOOLING_SMALL_JPEGS} below 256px"
    if want not in text:
        raise AssertionError(f"validate_dataset: expected '{want}': {text}")

    gray = np.ascontiguousarray(keyframe[:, :, 0])
    corners = np.float32([[0, 0], [WIDTH, 0], [WIDTH, HEIGHT], [0, HEIGHT]])
    views, maps = [], []
    for moved in TOOLING_VIEWS:
        H = cv2.getPerspectiveTransform(corners, corners + np.float32(moved))
        maps.append(H)
        views.append(cv2.warpPerspective(255 - gray, H, (WIDTH, HEIGHT)))
    (H, score), _ = timed("visual_alignment", lambda: compute_visual_alignment(
        [views[0]], [views[1]]))
    want_H = maps[0] @ np.linalg.inv(maps[1])
    probe = corners.reshape(-1, 1, 2).astype(np.float64)
    off = float(np.abs(cv2.perspectiveTransform(probe, H)
                       - cv2.perspectiveTransform(probe, want_H)).max()) \
        if H is not None else float("inf")
    log(f"visual_alignment of two warped views of keyframe 2: score "
        f"{score:.4f}, corners within {off:.3f} px of the true map")
    if score < TOOLING_MIN_ALIGNMENT or off > TOOLING_MAX_CORNER_PX:
        raise AssertionError(f"visual_alignment: score {score}, corner "
                             f"error {off} px")
    log(f"tooling with OpenCV {cv2.__version__}: {N_FRAMES}-frame MJPG AVI"
        f", video_metrics {counted} frames, export_video through {writer} "
        f"read back {read_back} frames, validate_dataset '{want}' on "
        f"{TOOLING_JPEGS} JPEGs; walls s "
        f"{json.dumps({k: round(v, 3) for k, v in walls.items()})} on the "
        f"card's host; {card}")
    return walls, writer


def phase_tooling(counters, summary, card):
    """Phase 12: the tooling over phase 4's summary and phase 6's artifact,
    cv2-free (blocked child, then here, byte-identical), then with OpenCV
    where it is installed; returns (launch counts, numbers)."""
    import importlib.util

    import numpy as np

    os.makedirs(TOOLING_DIR, exist_ok=True)
    np.savez(os.path.join(TOOLING_DIR, "inputs.npz"),
             indices=np.asarray(summary["indices"]),
             times=np.asarray(summary["times"]),
             keyframes=np.stack(summary["keyframes"]))
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    blocked, = child_results([start_child("tooling_child()",
                                          block=TOOLING_BLOCK)],
                             "tooling, cv2 blocked")
    child_wall = time.perf_counter() - t0
    allowed = tooling_run()
    launches = counted(counters)
    log(f"tooling, cv2-free half over the express summary "
        f"({len(summary['indices'])} keyframes at {WIDTH}x{HEIGHT}) and the "
        f"stage-01 artifact ({N_FRAMES} frames): walls s "
        f"{json.dumps({k: round(v, 3) for k, v in allowed['walls'].items()})}"
        f" here, {json.dumps({k: round(v, 3) for k, v in blocked['walls'].items()})}"
        f" in the blocked child ({child_wall:.3f} s with its start); "
        f"{allowed['files']} files, sha256 {allowed['digest'][:16]} here, "
        f"{blocked['digest'][:16]} blocked; results "
        f"{json.dumps(allowed['results']['gt tree + eval_summaries'])} "
        f"(self-evaluation), words a keyframe "
        f"{[len(w) for w in allowed['results']['words']]}, text regions "
        f"(visible, occluded) {allowed['results']['text export']}, mask ink "
        f"{allowed['results']['mask writers']}, frames (rendered, sampled) "
        f"{allowed['results']['interpolated frames']}; launches {launches};"
        f" {card}")
    if blocked["cv2_importable"]:
        raise AssertionError("cv2 was importable in the blocked child")
    # the child's results came through JSON: compare them as JSON
    if (blocked["digest"], blocked["files"], blocked["results"]) != \
            (allowed["digest"], allowed["files"],
             json.loads(json.dumps(allowed["results"]))):
        raise AssertionError("the tooling's output with cv2 blocked differs "
                             "from its output with cv2 allowed")
    numbers = {"walls": allowed["walls"], "blocked_walls": blocked["walls"],
               "files": allowed["files"]}
    if importlib.util.find_spec("cv2") is None:
        log("tooling, OpenCV half: did not run (cv2 is not installed)")
    else:
        log("tooling, OpenCV half: runs (cv2 is installed)")
        numbers["cv2_walls"], numbers["video_writer"] = tooling_cv2_half(
            summary["keyframes"][-1], card)
    return launches, numbers


# --------------------------------------------------------------- phase 13

# the four browser editors on the card's host, over phase 4's express
# keyframes (with their lecture frames as the raw keyframes), the lecture as
# a PNG image list and phase 6's stage-02/03 artifacts: each session writes
# under EDITORS_OUT, once in a child with cv2, PIL and matplotlib blocked,
# once here
EDITORS_DIR = os.path.join(WORKSPACE, "editors")
EDITORS_OUT = os.path.join(EDITORS_DIR, "out")
EDITORS_FRAMES = os.path.join(EDITORS_DIR, "frames")
EDITORS_BLOCK = ("cv2", "PIL", "matplotlib")
# GT editor strokes (points, radius, erase) on the 960x540 keyframe: single
# points and polylines at radius 1-4, paint and erase, one past the edge
EDITORS_STROKES = (
    ([[120, 400]], 1, False), ([[300, 80]], 3, False),
    ([[50, 50], [300, 120], [440, 300]], 2, False),
    ([[500, 400], [700, 410], [710, 520]], 3, True),
    ([[900, 500], [975, 560], [940, 600]], 4, False),
    ([[20, 530], [22, 520], [30, 500]], 1, True),
    ([[600, 300]], 4, True))
# portions added on the first keyframe: x, y, w, h, source, dark
EDITORS_PORTIONS = ((40, 40, 240, 160, "otsu", False),
                    (320, 60, 200, 140, "threshold", False))
# the word annotator's edit of keyframe 1's quad: one corner moved
EDITORS_CORNER, EDITORS_DELTA = 2, (-30.5, 18.25)
# the unique-CC match of keyframe 1 against keyframe 0 goes through this
# projection (the nearest warp of a 960x540 int32 label image)
EDITORS_CC_MATRIX = [[1.0, 0.01, 3.5], [-0.005, 1.0, 2.25],
                     [2e-5, -1e-5, 1.0]]
# the annotation editor's speaker box at two keyposes, its segment splits
# and keyframes; the frames served in the blocked child have no object (a
# boundary flash and a keyframe marker, a marker, none), the labelled ones
# are served where cv2 is installed
EDITORS_SPEAKER = ((10, [[40, 120], [260, 520]]),
                   (200, [[700, 120], [940, 520]]))
EDITORS_SPLITS, EDITORS_MARKS = (5, 120), (5, 220)
EDITORS_PLAIN_FRAMES = (0, 5, 220, 239)
EDITORS_LABELLED_FRAMES = (10, 100, 200)
# ST3D samples served in the stable and reconstructed modes, and the ink
# pixels queried in each
EDITORS_ST3D_SAMPLES = (0, 60, 119, 120, 239)
EDITORS_QUERIES = 8
# seeded cases of each primitive held against the host's cv2
EDITORS_CASES = 300


class EditorClient:
    """The page's side of an editor's HTTP surface: every answer kept (JSON
    decoded, PNGs as their sha256, errors as their status)."""

    def __init__(self, server):
        self.base = f"http://127.0.0.1:{server.server_address[1]}"
        self.answers = []

    def _answer(self, request):
        import hashlib
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(request,
                                        timeout=HTTP_TIMEOUT_S) as r:
                body, kind = r.read(), r.headers.get("Content-Type")
        except urllib.error.HTTPError as err:
            self.answers.append(["error", err.code])
            return None
        if kind == "image/png":
            if body[:4] != b"\x89PNG":
                raise AssertionError("an image route sent no PNG")
            self.answers.append(["png", hashlib.sha256(body).hexdigest()])
            return body
        value = json.loads(body)
        if isinstance(value, dict) and value.get("ok") is False:
            raise AssertionError(f"an editor refused a request: {value}")
        self.answers.append(["json", value])
        return value

    def get(self, path):
        return self._answer(self.base + path)

    def post(self, path, body):
        import urllib.request

        return self._answer(urllib.request.Request(
            self.base + path, data=json.dumps(body).encode(),
            method="POST"))


def served(module, session, drive):
    """``drive(client)`` against ``module.serve(session)`` on a free local
    port; returns the client's answers."""
    import threading

    server = module.serve(session, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    client = EditorClient(server)
    try:
        drive(client)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return client.answers


def editors_tree(out, inputs):
    """The GT tree of the express keyframes (raw = their lecture frames),
    the express summary beside it and a config; returns (prefix, conf)."""
    from lecturemath_tpu_torch.eval.gt_authoring import export_gt_tree
    from lecturemath_tpu_torch.pipeline.keyframes import export_summary

    indices = [int(i) for i in inputs["indices"]]
    times = [float(t) for t in inputs["times"]]
    keyframes = list(inputs["keyframes"])
    bounds = [0] + [i + 1 for i in indices]
    segments = [(bounds[k], indices[k]) for k in range(len(indices))]
    output = os.path.join(out, "output")
    prefix = export_gt_tree(
        os.path.join(output, "annotations"), "SmokeDB", "smoke01", indices,
        times, [kf[:, :, 0] for kf in keyframes], list(inputs["raw"]),
        segments=segments, video_paths=["smoke01.mp4"], write_portions=True)
    export_summary(os.path.join(output, "summaries", "SmokeDB_smoke01"),
                   "SmokeDB", "smoke01", ["smoke01.mp4"], segments,
                   [(s * 1000.0, e * 1000.0) for s, e in segments], indices,
                   times, keyframes)
    with open(os.path.join(out, "db.xml"), "w") as f:
        f.write(DB_XML)
    conf = os.path.join(out, "editors.conf")
    with open(conf, "w") as f:
        f.write(CONFIG.format(ws=WORKSPACE).replace(
            f"{WORKSPACE}/db.xml", f"{out}/db.xml").replace(
            f"{WORKSPACE}/output", output))
    return prefix, conf


def editors_gt(prefix, conf):
    """The GT editor over HTTP: threshold grid, strokes, an Otsu and a
    threshold portion, move / copy / reject, the chalkboard method, save;
    then cli.eval_summaries of the express summary against the edited
    tree. Returns (answers, summary numbers)."""
    import contextlib
    import io

    from lecturemath_tpu_torch.cli import eval_summaries
    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.core.metadata import MetaDataDB
    from lecturemath_tpu_torch.eval.summary_eval import SummaryEvaluator
    from lecturemath_tpu_torch.ops.classical import METHOD_CHALKBOARD
    from lecturemath_tpu_torch.utils import gt_editor

    session = gt_editor.GTEditorSession(prefix)
    kfs = session.keyframe_ids()

    def drive(client):
        client.get("/api/state")
        client.post("/api/thr_grid", {"kf": kfs[0], "rows": 4, "cols": 4})
        client.get(f"/api/thr_state/{kfs[0]}")
        client.get(f"/img/thr_preview/{kfs[0]}.png")
        for points, radius, erase in EDITORS_STROKES:
            client.post("/api/stroke", {"kf": kfs[-1], "points": points,
                                        "radius": radius, "erase": erase})
        before = len(session.portions(kfs[0]))
        for x, y, w, h, source, dark in EDITORS_PORTIONS:
            client.post("/api/add_portion", {"kf": kfs[0], "x": x, "y": y,
                                             "w": w, "h": h,
                                             "source": source, "dark": dark})
        client.post("/api/move_portion", {"kf": kfs[0], "index": before,
                                          "dx": 12, "dy": -7})
        client.post("/api/copy_portion", {"kf": kfs[0], "index": before + 1,
                                          "direction": 1})
        client.post("/api/reject_portion", {"kf": kfs[0], "index": 0})
        client.get(f"/api/portions/{kfs[0]}")
        client.post("/api/classical_apply", {"kf": kfs[1],
                                             "method": METHOD_CHALKBOARD})
        for kf in kfs:
            client.get(f"/img/binary/{kf}.png")
        client.get(f"/img/raw/{kfs[0]}.png")
        client.post("/api/save", {})

    answers = served(gt_editor, session, drive)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        eval_summaries.main(["eval_summaries", conf, "-l", "smoke01"])
    if "Finished" not in printed.getvalue():
        raise AssertionError("cli.eval_summaries did not finish")
    config = Config.from_file(conf)
    database = MetaDataDB.from_file(config.get_str("VIDEO_DATABASE_PATH"))
    numbers = summary_numbers(SummaryEvaluator().evaluate_lecture(
        config, database, database.get_lecture("smoke01")))
    return answers, {key: list(pair) for key, pair in numbers.items()}


def editors_words(prefix):
    """The word annotator over the edited tree: keyframe 1's quad with one
    corner moved, word trees auto-split, unique words matched, unique CCs
    matched through a projection and directly, formulas, save; returns
    (answers, whether a fresh editor's state equals the saved one)."""
    import numpy as np

    from lecturemath_tpu_torch.utils import word_editor

    editor = word_editor.WordTierEditor(prefix)
    count = len(editor.keyframes)
    region = [0, 0, WIDTH, HEIGHT]
    saved = []

    def drive(client):
        state = client.get("/api/state?tool=words")
        quad = np.asarray(state["keyframes"][1]["src_points"])
        quad[EDITORS_CORNER] += EDITORS_DELTA
        client.post("/api/words/projection_quad",
                    {"kf": 1, "points": quad.tolist()})
        for kf in range(count):
            x, y, w, h = client.get("/api/state?tool=words")[
                "keyframes"][kf]["words"][0]
            client.post("/api/words/auto_split",
                        {"kf": kf, "x": x + w // 2, "y": y + h // 2,
                         "normal": False})
        client.post("/api/words/match", {"kf": 1, "region": region})
        client.post("/api/words/accept", {"min_iou": 0.3})
        client.get("/img/words/1?view=projected_bin")
        client.post("/api/ccs/match", {"kf": 1, "source": 0,
                                       "region": region,
                                       "matrix": EDITORS_CC_MATRIX})
        client.post("/api/ccs/accept", {"min_recall": 0.4,
                                        "min_precision": 0.4})
        if count > 2:
            client.post("/api/ccs/match", {"kf": 2, "source": 1,
                                           "region": region})
            client.post("/api/ccs/accept", {})
        client.post("/api/ccs/save", {})
        client.post("/api/formulas/add", {"kf": 0, "region": region,
                                          "latex": "x^2"})
        client.post("/api/formulas/tag", {"index": 0,
                                          "latex": r"\frac{a}{b}"})
        for tool in ("words", "formulas"):
            client.post(f"/api/{tool}/save", {})
        saved.extend(client.get(f"/api/state?tool={tool}")
                     for tool in ("words", "ccs", "formulas"))

    answers = served(word_editor, editor, drive)
    reopened = word_editor.WordTierEditor(prefix)
    reloaded = [reopened.session(tool).state()
                for tool in ("words", "ccs", "formulas")]
    return answers, json.loads(json.dumps(reloaded)) == saved


def editors_annotation(out, labelled):
    """The annotation editor over the lecture's PNG image list: splits,
    keyframes, a speaker with two keyposes, undo/redo, the frames without
    objects (and, with ``labelled``, those with the labelled speaker), save;
    returns (answers, whether a reopened session's state is the saved
    one)."""
    from lecturemath_tpu_torch.utils import annotation_editor

    xml = os.path.join(out, "annotations", "SmokeDB_smoke01.xml")
    session = annotation_editor.AnnotationEditorSession.open(
        xml, "SmokeDB", "smoke01", [EDITORS_FRAMES])
    state = []

    def drive(client):
        client.get("/api/state")
        for frame in EDITORS_SPLITS:
            client.post("/api/split", {"frame": frame})
        for frame in EDITORS_MARKS:
            client.post("/api/keyframe", {"frame": frame, "op": "add"})
        (first, box), (last, moved) = EDITORS_SPEAKER
        client.post("/api/object", {"op": "add", "name": "speaker",
                                    "id": "spk", "shape_type": 0,
                                    "frame": first, "points": box})
        client.post("/api/pose", {"op": "set", "name": "speaker",
                                  "frame": last, "points": moved})
        client.get(f"/api/pose/speaker/{(first + last) // 2}")
        client.post("/api/undo", {})
        client.post("/api/redo", {})
        for frame in EDITORS_PLAIN_FRAMES + (EDITORS_LABELLED_FRAMES
                                             if labelled else ()):
            client.get(f"/img/frame/{frame}.png")
        client.post("/api/save", {})
        state.append(client.get("/api/state"))

    answers = served(annotation_editor, session, drive)
    reopened = annotation_editor.AnnotationEditorSession.open(
        xml, "SmokeDB", "smoke01", [EDITORS_FRAMES])
    same = json.loads(json.dumps(reopened.state())) == state[0]
    if state[0]["total_frames"] != N_FRAMES:
        raise AssertionError(f"the image list holds "
                             f"{state[0]['total_frames']} frames")
    return answers, same


def editors_st3d():
    """The ST3D visualizer from phase 6's stage-02/03 artifacts, loaded as
    its CLI loads them: every sample in binary mode, a few in the stable
    and reconstructed modes, queries under ink pixels; returns (answers,
    CC hits)."""
    import numpy as np

    from lecturemath_tpu_torch.pipeline.driver import PipelineDriver
    from lecturemath_tpu_torch.utils import st3d_visualizer

    keys = ["CC_STABILITY_OUTPUT", "CC_ST3D_OUTPUT",
            "CC_RECONSTRUCTED_OUTPUT"]
    driver = PipelineDriver.from_config_path(
        os.path.join(WORKSPACE, "staged.conf"), ["-l", "smoke01"], keys,
        None)
    lecture = driver.database.get_lecture("smoke01")
    session = st3d_visualizer.ST3DVisualizerSession.from_artifacts(
        driver.store, lecture.id, *driver.input_prefixes,
        lecture=lecture.title)
    hits = []

    def drive(client):
        state = client.get("/api/state")
        if state["n_samples"] != N_FRAMES or not state["has_reconstructed"]:
            raise AssertionError(f"ST3D state: {state}")
        for pos in range(state["n_samples"]):
            client.get(f"/img/frame/{pos}.png?mode=binary")
        for pos in EDITORS_ST3D_SAMPLES:
            for mode in ("stable", "reconstructed"):
                client.get(f"/img/frame/{pos}.png?mode={mode}")
            ccs = session.tracker.cc_idx_per_frame[pos]
            for _, cc in ccs[:EDITORS_QUERIES]:
                ys, xs = np.nonzero(cc.img)
                x, y = int(xs[0] + cc.min_x), int(ys[0] + cc.min_y)
                result = client.get(f"/api/query?pos={pos}&x={x}&y={y}")
                hits.append(result["cc"] is not None)

    answers = served(st3d_visualizer, session, drive)
    if not hits or not all(hits):
        raise AssertionError(f"ST3D queries under ink found no CC: {hits}")
    return answers, len(hits)


def editors_run(labelled=False):
    """Every editor's session over the inputs phase 13 saved; returns each
    step's wall, result and answers' digest, the digest of every file
    written and whether cv2 was importable."""
    import hashlib
    import importlib.util

    import numpy as np

    shutil.rmtree(EDITORS_OUT, ignore_errors=True)
    os.makedirs(EDITORS_OUT)
    with np.load(os.path.join(EDITORS_DIR, "inputs.npz")) as data:
        inputs = dict(data)
    walls, results, answers = {}, {}, {}
    prefix, conf = editors_tree(EDITORS_OUT, inputs)
    for name, step in (("gt editor + eval_summaries",
                        lambda: editors_gt(prefix, conf)),
                       ("word annotator", lambda: editors_words(prefix)),
                       ("annotation editor",
                        lambda: editors_annotation(EDITORS_OUT, labelled)),
                       ("st3d visualizer", editors_st3d)):
        t0 = time.perf_counter()
        answers[name], results[name] = step()
        walls[name] = time.perf_counter() - t0
    digest, files = tree_digest(EDITORS_OUT)
    return {"walls": walls, "results": results,
            "answers": {name: hashlib.sha256(json.dumps(a).encode())
                        .hexdigest() for name, a in answers.items()},
            "requests": {name: len(a) for name, a in answers.items()},
            "digest": digest, "files": files,
            "cv2_importable": importlib.util.find_spec("cv2") is not None}


def editors_child():
    """Child (cv2, PIL and matplotlib blocked): editors_run's result."""
    print(json.dumps(editors_run()), flush=True)
    return 0


def editors_cv2_parity():
    """The port's drawing, Otsu, nearest warp and gray against the host's
    cv2 on seeded cases; returns {primitive: (cases that differ, cases)}."""
    import cv2
    import numpy as np

    from lecturemath_tpu_torch.utils import image

    rng = np.random.default_rng(13)
    counts = {}

    def count(name, ours, theirs):
        bad, seen = counts.get(name, (0, 0))
        counts[name] = (bad + int(not np.array_equal(ours, theirs)),
                        seen + 1)

    for k in range(EDITORS_CASES):
        height, width = (int(v) for v in rng.integers(8, 120, 2))
        blank = np.zeros((height, width) + ((3,) if k % 2 else ()),
                         np.uint8)
        color = tuple(int(v) for v in rng.integers(1, 255, 3))
        point = lambda m: (int(rng.integers(-m, width + m)),  # noqa: E731
                           int(rng.integers(-m, height + m)))
        center, radius = point(12), int(rng.integers(0, 11))
        count("circle", image.circle(blank.copy(), center, radius, color),
              cv2.circle(blank.copy(), center, radius, color, -1))
        p0, p1, thickness = point(20), point(20), int(rng.integers(2, 9))
        count("line t2-8", image.line(blank.copy(), p0, p1, color, thickness),
              cv2.line(blank.copy(), p0, p1, color, thickness))
        gray = rng.integers(0, 256, (height, width), dtype=np.uint8)
        if k % 3 == 1:
            gray = np.where(gray < 80, rng.integers(0, 120),
                            rng.integers(120, 256)).astype(np.uint8)
        count("threshold_otsu", image.threshold_otsu(gray), cv2.threshold(
            gray, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)[0])
        corners = np.float32([[0, 0], [width, 0], [width, height],
                              [0, height]])
        H = cv2.getPerspectiveTransform(corners, corners + np.float32(
            rng.normal(0, 0.3, (4, 2)) * [width, height])).astype(np.float64)
        size = (int(rng.integers(8, 140)), int(rng.integers(8, 140)))
        for dtype in (np.int32, np.uint8):
            labels = rng.integers(0, 200, (height, width)).astype(dtype)
            count(f"warp nearest {np.dtype(dtype).name}",
                  image.warp_perspective(labels, H, size,
                                         interpolation="nearest"),
                  cv2.warpPerspective(labels, H, size,
                                      flags=cv2.INTER_NEAREST))
        rgb = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        count("rgb_to_gray", image.rgb_to_gray(rgb),
              cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
    return counts


def phase_editors(counters, summary, card):
    """Phase 13: the four editors over phase 4's summary, the lecture as
    PNGs and phase 6's artifacts, cv2-free (blocked child, then here, the
    same files and answers), then the labelled overlays and the drawing
    held against OpenCV where it is installed; returns (launch counts,
    numbers)."""
    import importlib.util

    import numpy as np

    from lecturemath_tpu_torch.utils.png import write_image

    for fn in counters.values():
        fn.launches = 0
    t_phase = time.perf_counter()
    walls = {}
    t0 = time.perf_counter()
    shutil.rmtree(EDITORS_DIR, ignore_errors=True)
    os.makedirs(EDITORS_FRAMES)
    source = make_source()
    for t in range(N_FRAMES):
        write_image(os.path.join(EDITORS_FRAMES, f"{t:04d}.png"),
                    source.rgb_frame(t)[:, :, ::-1])
    np.savez(os.path.join(EDITORS_DIR, "inputs.npz"),
             indices=np.asarray(summary["indices"]),
             times=np.asarray(summary["times"]),
             keyframes=np.stack(summary["keyframes"]),
             raw=np.stack([source.rgb_frame(int(t))
                           for t in summary["indices"]]))
    walls["image list + inputs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    blocked, = child_results([start_child("editors_child()",
                                          block=EDITORS_BLOCK)],
                             "editors, cv2 blocked")
    walls["blocked child"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    allowed = editors_run()
    walls["here"] = time.perf_counter() - t0
    if blocked["cv2_importable"]:
        raise AssertionError("cv2 was importable in the blocked child")
    same = {key: blocked[key] == json.loads(json.dumps(allowed[key]))
            for key in ("digest", "files", "answers", "results")}
    log(f"editors, cv2-free over the express keyframes "
        f"({len(summary['indices'])} at {WIDTH}x{HEIGHT}), the {N_FRAMES}-"
        f"frame PNG image list and the stage-02/03 artifacts: requests "
        f"{json.dumps(allowed['requests'])}; walls s "
        f"{json.dumps({k: round(v, 3) for k, v in allowed['walls'].items()})}"
        f" here, "
        f"{json.dumps({k: round(v, 3) for k, v in blocked['walls'].items()})}"
        f" in the blocked child; {allowed['files']} files, sha256 "
        f"{allowed['digest'][:16]} here, {blocked['digest'][:16]} blocked; "
        f"equal (files, answers, results): {same}")
    gt_numbers = allowed["results"]["gt editor + eval_summaries"]
    log(f"  cli.eval_summaries, express summary against the edited tree "
        f"(recall, precision by min R/P): {json.dumps(gt_numbers)}")
    if not all(same.values()):
        raise AssertionError("the editors' output with cv2 blocked differs "
                             "from their output with cv2 allowed")
    for name in ("word annotator", "annotation editor"):
        if not allowed["results"][name]:
            raise AssertionError(f"{name}: the reloaded state differs from "
                                 f"the saved one")
    numbers = {"walls": walls, "steps": allowed["walls"],
               "blocked_steps": blocked["walls"], "files": allowed["files"],
               "requests": allowed["requests"]}
    if importlib.util.find_spec("cv2") is None:
        log("editors, labelled overlays and cv2 parity: did not run (cv2 "
            "is not installed)")
    else:
        import cv2

        t0 = time.perf_counter()
        labelled_out = os.path.join(EDITORS_DIR, "labelled")
        os.makedirs(labelled_out)
        editors_annotation(labelled_out, labelled=True)
        walls["labelled frames (cv2)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        parity = editors_cv2_parity()
        walls["cv2 parity"] = time.perf_counter() - t0
        log(f"editors with OpenCV {cv2.__version__}: "
            f"{len(EDITORS_LABELLED_FRAMES)} labelled frames served; cases "
            f"that differ from cv2 (differ, cases): {json.dumps(parity)}")
        numbers["cv2_parity"] = parity
        exact = [key for key in parity if not key.startswith(
            ("warp", "rgb_to_gray"))]
        if any(parity[key][0] for key in exact):
            raise AssertionError(f"the port's drawing or Otsu differs from "
                                 f"cv2 {cv2.__version__}: {parity}")
    launches = counted(counters)
    walls["phase"] = time.perf_counter() - t_phase
    log(f"editors phase walls s "
        f"{json.dumps({k: round(v, 3) for k, v in walls.items()})}; "
        f"launches {launches}; {card}")
    if any(launches.values()):
        raise AssertionError(f"the editors launched a kernel: {launches}")
    return launches, numbers


# --------------------------------------------------------------- phase 14

# the full-lecture drive (flagship_drive_torch.py) at the flagship's width
# and resolution, cut in depth: 240 frames of 1920x1080, 4 boards x 120
# glyphs (4 GT keyframes), 150 training steps at batch 8 on 256^2 crops.
# The recipe is the drive's environment, read when it is imported; its
# steps' children inherit it.
FLAGSHIP_ENV = {"LM_FLAGSHIP_FRAMES": "240", "LM_FLAGSHIP_HEIGHT": "1080",
                "LM_FLAGSHIP_WIDTH": "1920", "LM_FLAGSHIP_BOARDS": "4",
                "LM_FLAGSHIP_GLYPHS": "120", "LM_FLAGSHIP_TRAIN_STEPS": "150",
                "LM_FLAGSHIP_CROP": "256"}
FLAGSHIP_DIR = os.path.join(WORKSPACE, "flagship")
# the kernels each step on the card must launch. keyframe_bin's binarizer
# is the full-output one (Binarizer.binarize_frames: sigmoid, x255 and the
# threshold in PyTorch, no bit packing), so it launches K2 and no K1, as
# phase 9 counts it
FLAGSHIP_KERNELS = {
    "train checkpoint": ("conv_same_nhwc",),
    "stage01 binarize": ("threshold_pack", "conv_same_nhwc"),
    "express run_pipeline": ("threshold_pack", "conv_same_nhwc"),
    "eval keyframe_bin": ("conv_same_nhwc",)}


def summary_split(summary):
    """(segments as (start, end), keyframe indices, keyframe file names) of
    an exported summary's segments.xml and keyframes folder."""
    import re

    with open(os.path.join(summary, "segments.xml")) as f:
        text = f.read()
    starts = [int(v) for v in re.findall(r"<Start>(\d+)</Start>", text)]
    ends = [int(v) for v in re.findall(r"<End>(\d+)</End>", text)]
    indices = [int(v) for v in re.findall(r"<Index>(\d+)</Index>", text)]
    return (list(zip(starts, ends)), indices,
            sorted(os.listdir(os.path.join(summary, "keyframes"))))


def printed_metrics(kb_text, es_text, lecture):
    """Every metric keyframe_bin and eval_summaries printed, as fractions:
    the CC tables (min R/P, recall, precision and their parts), the pixel
    metrics (the board variants keep their ``board_`` names) and each
    summary row's recall and precision (its frame count left out)."""
    metrics = {}
    scope = None
    for line in kb_text.splitlines():
        fields = line.split("\t")
        if line.startswith("Metrics for scope:"):
            scope = line.split(":", 1)[1].strip()
        elif len(fields) == 10 and all(_number(f) for f in fields):
            for col, value in enumerate(fields):
                metrics[f"keyframe_bin {scope} {fields[0]}/{fields[1]} "
                        f"column {col}"] = float(value) / 100
        elif len(fields) == 2 and _number(fields[1]):
            metrics[fields[0]] = float(fields[1]) / 100
    threshold = None
    for line in es_text.splitlines():
        fields = line.split("\t")
        if line.startswith("Min CC recall - Min CC precision:"):
            threshold = line.split(":", 1)[1].split()
            for value in threshold:
                metrics[f"eval_summaries threshold {value}"] = \
                    float(value) / 100
        elif fields[0] in (lecture, "Averages") and len(fields) == 6:
            for col, value in enumerate(fields[2:]):
                metrics[f"eval_summaries {threshold} {fields[0]} "
                        f"column {col}"] = float(value) / 100
    return metrics


def _number(text):
    try:
        float(text)
    except ValueError:
        return False
    return True


def flagship_flip_rate(drive, root, conf, artifact):
    """8 binaries of the stage-01 artifact the drive's binarize child wrote
    (``artifact``: bf16, K2 and K1 at 1080p, the trained checkpoint), spread
    over the lecture, against the plain f32 model on the same frames decoded
    from the MJPG video, on the card. Returns the flip rate."""
    import pickle

    import cv2
    import numpy as np
    import torch

    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.models.convert import load_checkpoint
    from lecturemath_tpu_torch.models.fcn_lecturenet import (
        FCNConfig, FCNLectureNet, make_packed_binarizer, unpack_bits_host)
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer
    from lecturemath_tpu_torch.pipeline.video import decompress_png

    with open(artifact, "rb") as f:
        _, indices, compressed = pickle.load(f)
    picks = np.linspace(0, len(indices) - 1, 8).round().astype(int)
    binaries = decompress_png([compressed[i] for i in picks])
    capture = cv2.VideoCapture(os.path.join(root, "videos",
                                            f"{drive.LECTURE}.avi"))
    frames = []
    for i in picks:
        # SAMPLING_FPS 1 of a 1 fps video: sample index = frame index
        capture.set(cv2.CAP_PROP_POS_FRAMES, int(indices[i]))
        ok, frame = capture.read()
        if not ok:
            raise AssertionError(f"decode failed at frame {indices[i]}")
        frames.append(frame[:, :, ::-1])
    capture.release()

    plain = FCNLectureNet(FCNConfig.from_config(Config.from_file(conf)),
                          plain=True)
    plain.load_state_dict(load_checkpoint(os.path.join(
        root, "models", drive.MODEL_FILE)))
    packed = make_packed_binarizer(Binarizer(plain, batch_size=4,
                                             dtype=torch.float32).model)
    flips = pixels = 0
    for start in range(0, len(frames), 4):
        chunk = torch.from_numpy(np.stack(frames[start:start + 4])).cuda()
        ink_255 = 255 - unpack_bits_host(packed(chunk).cpu().numpy(),
                                         drive.WIDTH)
        for binary, reference in zip(binaries[start:start + 4], ink_255):
            if binary.shape != reference.shape:
                raise AssertionError(f"stage-01 binary {binary.shape}, plain "
                                     f"{reference.shape}")
            flips += int((binary != reference).sum())
            pixels += reference.size
    return flips / pixels


def phase_flagship(counters, card):
    """Phase 14: flagship_drive_torch.py's own phases and step table at the
    flagship's width and resolution and 240 frames; each step on the card
    counts its kernels in its child. Returns (launch counts summed over the
    children, numbers)."""
    import importlib
    import importlib.util
    import math

    from lecturemath_tpu_torch.utils.png import read_image

    for fn in counters.values():
        fn.launches = 0
    if importlib.util.find_spec("cv2") is None:
        log("flagship drive: did not run: the drive writes and decodes an "
            "MJPG video, and without cv2 there is no video codec")
        return counted(counters), {}
    t_phase = time.perf_counter()
    saved = {key: os.environ.get(key)
             for key in list(FLAGSHIP_ENV) + ["LM_FLAGSHIP_TINY"]}
    os.environ.update(FLAGSHIP_ENV)
    os.environ.pop("LM_FLAGSHIP_TINY", None)
    try:
        sys.modules.pop("flagship_drive_torch", None)
        drive = importlib.import_module("flagship_drive_torch")
        root = FLAGSHIP_DIR
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        summary = os.path.join(root, "output", "summaries",
                               f"{drive.DB_NAME}_{drive.LECTURE}")
        staged_copy = os.path.join(root, "staged_summary")
        binary = os.path.join(root, "output", "temporal",
                              f"tempo_binary_{drive.LECTURE}.dat")
        staged_binary = os.path.join(root, "staged_binary.dat")

        def after(label, record):
            # express writes over the staged outputs: keep the staged ones
            if label == "stage01 binarize":
                shutil.copyfile(binary, staged_binary)
            elif label == "stage05 generate_summary":
                shutil.copytree(summary, staged_copy)

        t0 = time.perf_counter()
        conf = drive.build_workspace(root)
        workspace_s = time.perf_counter() - t0
        records = drive.run_steps(root, conf, card=card, after=after)
        report = drive.report(
            root, records, round(time.perf_counter() - t_phase, 1), card,
            workspace_s, out=os.path.join(root, drive.REPORT))
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    here = counted(counters)
    if any(here.values()):
        raise AssertionError(f"phase 14 launched a kernel in this process "
                             f"(every step runs in a child): {here}")

    launches = {name: sum(rec["launches"][name] for rec in records.values())
                for name in counters if name not in TRAINING_KERNELS}
    for label, kernels in FLAGSHIP_KERNELS.items():
        counts = records[label]["launches"]
        missing = [name for name in kernels if counts.get(name, 0) <= 0]
        if missing:
            raise AssertionError(f"{label}: {missing} not launched "
                                 f"({counts})")
    staged, express = summary_split(staged_copy), summary_split(summary)
    same_bytes = all(
        open(os.path.join(staged_copy, "keyframes", name), "rb").read()
        == open(os.path.join(summary, "keyframes", name), "rb").read()
        for name in express[2]) if staged[2] == express[2] else False
    log(f"flagship summaries: staged segments {staged[0]}, keyframes "
        f"{staged[1]}; express segments {express[0]}, keyframes "
        f"{express[1]}; keyframe PNGs byte-identical: {same_bytes}")
    if staged[:2] != express[:2]:
        raise AssertionError("the staged and express summaries differ")
    inked = sum(
        bool((read_image(os.path.join(staged_copy, "keyframes", name))
              < 128).any()) for name in staged[2])
    if inked < 2:
        raise AssertionError(f"the summary holds {inked} inked keyframes")
    stats = json.load(open(os.path.join(root, "train_stats.json")))
    losses = [loss for _, loss in stats["losses"]]
    if not losses or not all(math.isfinite(loss) for loss in losses):
        raise AssertionError(f"training losses {losses}")
    metrics = printed_metrics(records["eval keyframe_bin"]["stdout"],
                              records["eval summaries"]["stdout"],
                              drive.LECTURE)
    if not any(key.startswith("keyframe_bin") for key in metrics) or \
            not any(key.startswith("eval_summaries") for key in metrics) or \
            "fmeasure" not in metrics:
        raise AssertionError("keyframe_bin or eval_summaries printed no "
                             "metrics")
    check_metrics("flagship", metrics)
    if not os.path.exists(report):
        raise AssertionError(f"no report at {report}")
    t0 = time.perf_counter()
    flip_rate = flagship_flip_rate(drive, root, conf, staged_binary)
    log(f"flagship stage-01 binaries at {drive.WIDTH}x{drive.HEIGHT} (bf16 "
        f"kernels, trained checkpoint) vs plain f32 on 8 decoded frames: "
        f"flip rate {flip_rate:.6f} (bound {MAX_FLIP_RATE}); "
        f"{time.perf_counter() - t0:.3f} s")
    if flip_rate > MAX_FLIP_RATE:
        raise AssertionError(f"flagship stage-01 flip rate {flip_rate} > "
                             f"{MAX_FLIP_RATE}")

    steps = {label: {"wall_s": round(rec["wall_s"], 3),
                     "in_run_s": rec.get("in_run_s"),
                     "rss_mb": (round(rec["rss_mb"], 1)
                                if rec.get("rss_mb") is not None else None),
                     "card_peak_mib": (round(rec["card_peak_bytes"] / 2**20,
                                             1)
                                       if "card_peak_bytes" in rec else None),
                     "launches": rec.get("launches")}
             for label, rec in records.items()}
    for label, numbers in steps.items():
        log(f"  flagship step {label}: {json.dumps(numbers)}; {card}")
    wall = time.perf_counter() - t_phase
    gt = json.load(open(os.path.join(root, "gt_stats.json")))
    log(f"flagship drive at {drive.WIDTH}x{drive.HEIGHT}, {drive.N_FRAMES} "
        f"frames, {drive.N_BOARDS} boards x {drive.GLYPHS_PER_BOARD} glyphs, "
        f"widths {drive.PRODUCTION_WIDTHS['DOWN_CONV_FILTERS']}: workspace "
        f"{workspace_s:.3f} s, training {stats['steps']} steps in "
        f"{stats['train_wall_s']} s (losses {stats['losses']}, held-out "
        f"pixel acc {stats['pixel_acc']}), GT {gt}, {inked} inked summary "
        f"keyframes, {len(metrics)} printed metrics finite and in range "
        f"(fmeasure {metrics['fmeasure']:.4f}); stage-01 flip rate "
        f"{flip_rate:.6f}; report {report}; phase {wall:.3f} s; launches "
        f"{launches}; {card}")
    return launches, {"steps": steps, "workspace_s": workspace_s,
                      "phase_s": wall, "train": stats, "gt": gt,
                      "flip_rate": flip_rate}


# --------------------------------------------------------------- phase 15

# the model axis on one card: a mesh over [cuda:0] * n puts n shards on the
# one card, which runs the sharded math and K1 and K2 on the shards (it
# proves no communication between cards); (a) phase 4's lecture at this
# batch through a channel-sharded Binarizer on 1x2, (b) ShardedBinarizer's
# channel shards on 2x2 over this many frames, (c) the height-sharded path
# on two 4K board scans (the JAX package's "one 4K board scan") on 1x2 and
# 1x4, padded to 2176 rows, and a strip whose 3 row units leave a 1x4
# mesh's last shard without rows
AXIS_BATCH = 16
AXIS_FRAMES = 8
SCAN_HEIGHT, SCAN_WIDTH = 2160, 3840
SCAN_PICK = (3, 7)          # of an 8-frame scan lecture: half, then all ink
STRIP_HEIGHT = 96
AXIS_REPS = 3               # timed calls a path (CUDA events), after one
HEADS = 4                   # K2 launches a shard a batch
# binaries of a model-axis path against the meshless bf16 ones on the same
# card: both round every intermediate to bf16, and differ only where a
# sharded layer sums in another order and a pixel sits at the threshold
# (2e-5 at most on the card); a wrong gather or halo flips whole rows
AXIS_MAX_FLIPS_VS_BF16 = 1e-4


def axis_kernels(net_config):
    """K2 and K1 against their plain versions at the shapes the model axis
    gives them: K2 on the heads' channel slices (M = 2 at (a)'s and (b)'s
    batches, and N down to 2 at M = 4 and 8) and on the halo slabs of (c)
    (every head, width 3840), K1 on (c)'s slab logits cropped to their
    valid rows. Returns (K2's max |err|, K1's largest bit error outside
    the band)."""
    import torch

    from lecturemath_tpu_torch.parallel.model_axis import slab_rows

    gen = torch.Generator(device="cuda").manual_seed(15)
    k = net_config.pixel_kernel_size
    heads = head_shapes(net_config)
    cases = []
    for model, batch in ((2, AXIS_BATCH), (2, AXIS_FRAMES // 2),
                         (4, AXIS_FRAMES // 2), (8, AXIS_FRAMES // 2)):
        cases += [(f"{name} channels /{model}", batch, c1, c2,
                   n_out // model, act, out_dtype, 544, 960)
                  for name, c1, c2, n_out, act, out_dtype in heads
                  if n_out % model == 0 and n_out >= model]
    k1_shapes = []
    scan_rows = -(-SCAN_HEIGHT // 32) * 32
    for model, frames, height, valid in (
            (2, len(SCAN_PICK), scan_rows, SCAN_HEIGHT),
            (4, len(SCAN_PICK), scan_rows, SCAN_HEIGHT),
            (4, len(SCAN_PICK) - 1, STRIP_HEIGHT, STRIP_HEIGHT)):
        rows = [r for r in slab_rows(height, model) if r]
        cases += [(f"{name} slab 1x{model}", frames, c1, c2, n_out, act,
                   out_dtype, rows[0] + 2 * (k // 2), SCAN_WIDTH)
                  for name, c1, c2, n_out, act, out_dtype in heads]
        k1_shapes.append(((frames, rows[-1], SCAN_WIDTH),
                          valid - sum(rows[:-1])))
    k2_err = 0.0
    for what, batch, c1, c2, n_out, act, out_dtype, h, w in cases:
        x, x2, weight, bias = k2_inputs(gen, batch, c1, c2, n_out, k, h, w)
        err, excess = k2_check(x, x2, weight, bias, act, out_dtype)
        k2_err = max(k2_err, err)
        log(f"K2 model axis {what} [{batch},{c1}+{c2},{h},{w}] -> {n_out} "
            f"ch: max |err| {err:.3g} (excess over tolerance {excess:.3g})")
        del x, x2
    torch.cuda.empty_cache()
    k1_err = max(k1_check(shape, valid, SCAN_WIDTH, gen)
                 for shape, valid in k1_shapes)
    log(f"model axis kernels: K2 at {len(cases)} shapes within K2_REL/K2_ABS "
        f"(max |err| {k2_err:.3g}), K1 at {len(k1_shapes)} slab shapes "
        f"(largest bit error outside the band {k1_err})")
    return k2_err, k1_err


def card_mesh(data, model):
    import torch

    from lecturemath_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    return make_mesh(MeshSpec(data, model),
                     [torch.device("cuda", 0)] * (data * model))


def axis_counted(counters, fn):
    """fn() with every count set to 0 just before and read just after:
    (its result, the counts, the card's peak GiB during it)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in counters.values():
        counter.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return (out, counted(counters),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def axis_gate(what, launches, shards, batches):
    """K1 launched, and K2 once a head a shard holding rows a batch."""
    expected = HEADS * shards * batches
    if launches["threshold_pack"] <= 0:
        raise AssertionError(f"{what}: K1 not launched")
    if launches["conv_same_nhwc"] != expected:
        raise AssertionError(f"{what}: K2 launched "
                             f"{launches['conv_same_nhwc']} times, expected "
                             f"{expected} = {HEADS} x {shards} shards x "
                             f"{batches} batches")


def plain_bits(state_dict, net_config, frames):
    """The plain f32 model's binaries of uint8 RGB ``frames`` (on the
    card), and its logits."""
    import torch

    from lecturemath_tpu_torch.models.fcn_lecturenet import (
        FCNLectureNet, make_packed_binarizer, unpack_bits_host)

    plain = FCNLectureNet(net_config, plain=True)
    plain.load_state_dict(state_dict)
    plain = plain.cuda().eval()
    bits = make_packed_binarizer(plain)(frames.cuda())
    out = unpack_bits_host(bits.cpu().numpy(), frames.shape[2])
    del plain
    torch.cuda.empty_cache()
    return out


def flips(a, b):
    import numpy as np

    return int(np.sum(a != b)), float(np.mean(a != b))


def axis_channel_lecture(conf, counters, summary, card):
    """(a): express over phase 4's lecture through a channel-sharded
    Binarizer on 1x2; returns (launches, numbers)."""
    import numpy as np
    import torch

    from lecturemath_tpu_torch.models.convert import load_checkpoint
    from lecturemath_tpu_torch.models.fcn_lecturenet import (FCNLectureNet,
                                                             unpack_bits_host)
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer
    from lecturemath_tpu_torch.pipeline.driver import PipelineDriver
    from lecturemath_tpu_torch.pipeline.express import run_lecture

    driver = PipelineDriver.from_config_path(conf, [], None, None)
    lecture = driver.database.lectures[0]
    meshed = Binarizer.from_config(driver.config, mesh=card_mesh(1, 2),
                                   batch_size=AXIS_BATCH)
    meshless = Binarizer.from_config(driver.config, batch_size=AXIS_BATCH)
    assert [r.model_index for r in meshed._replicas] == [0, 1]
    source = make_source()
    batch = torch.from_numpy(np.stack(
        [source.rgb_frame(t) for t in range(AXIS_BATCH)])).cuda()
    for binarizer in (meshed, meshless):   # cuDNN's choice, the allocator
        binarizer.packed_fn(batch)
    t0 = time.perf_counter()
    (indices, times, keyframes), launches, peak = axis_counted(
        counters, lambda: run_lecture(driver, lecture, meshed,
                                      source=make_source(), export=False))
    fps = N_FRAMES / (time.perf_counter() - t0)
    batches = -(-N_FRAMES // AXIS_BATCH)
    axis_gate("(a) express, channels 1x2", launches, 2, batches)
    if (list(indices), list(times)) != (summary["indices"],
                                        summary["times"]) or \
            len(keyframes) != len(summary["keyframes"]) or any(
                not np.array_equal(a, b)
                for a, b in zip(keyframes, summary["keyframes"])):
        raise AssertionError("express on the 1x2 channel mesh: the summary "
                             "differs from phase 4's")
    pick = [0, 30, 60, 119, 120, 150, 200, 239]
    frames = torch.from_numpy(np.stack([source.rgb_frame(t) for t in pick]))
    ours = unpack_bits_host(meshed.packed_fn(frames.cuda()).cpu().numpy(),
                            WIDTH)
    bf16 = unpack_bits_host(meshless.packed_fn(frames.cuda()).cpu()
                            .numpy(), WIDTH)
    state = load_checkpoint(os.path.join(WORKSPACE, "models", "smoke.dat"))
    f32 = plain_bits(state, meshed.model.config, frames)
    vs_bf16, vs_f32 = flips(ours, bf16), flips(ours, f32)
    if vs_bf16[1] > AXIS_MAX_FLIPS_VS_BF16 or vs_f32[1] > MAX_FLIP_RATE:
        raise AssertionError(f"(a) flip rates {vs_bf16}, {vs_f32}")
    # smoke.dat's threshold heads read no trunk channel: the same frames
    # through Binarizers over seeded weights that reach every layer
    random_state = random_weights(meshed.model.config)[0]
    model = FCNLectureNet(meshed.model.config)
    model.load_state_dict(random_state)
    trunk = {"1x2": Binarizer(model, batch_size=AXIS_BATCH,
                              mesh=card_mesh(1, 2), dtype=torch.bfloat16),
             "meshless": Binarizer(model, batch_size=AXIS_BATCH,
                                   dtype=torch.bfloat16)}
    trunk["1x2"].packed_fn(frames.cuda())
    trunk_bits, trunk_launches, _ = axis_counted(
        counters, lambda: trunk["1x2"].packed_fn(frames.cuda()))
    axis_gate("(a) seeded weights, channels 1x2", trunk_launches, 2, 1)
    trunk_bits = unpack_bits_host(trunk_bits.cpu().numpy(), WIDTH)
    trunk_bf16 = flips(trunk_bits, unpack_bits_host(
        trunk["meshless"].packed_fn(frames.cuda()).cpu().numpy(), WIDTH))
    trunk_f32 = flips(trunk_bits,
                      plain_bits(random_state, model.config, frames))
    if trunk_bf16[1] > AXIS_MAX_FLIPS_VS_BF16 or \
            trunk_f32[1] > MAX_FLIP_RATE:
        raise AssertionError(f"(a) seeded weights: flip rates {trunk_bf16}, "
                             f"{trunk_f32}")
    del trunk, model
    ms = {"1x2": cuda_ms(lambda: meshed.packed_fn(batch), AXIS_REPS),
          "meshless": cuda_ms(lambda: meshless.packed_fn(batch),
                              AXIS_REPS)}
    for which, binarizer in (("1x2", meshed), ("meshless", meshless)):
        device_breakdown(lambda: binarizer.packed_fn(batch),
                         f"model axis (a) {which}, a batch of {AXIS_BATCH}")
    log(f"model axis (a) channels 1x2, express over {N_FRAMES} frames "
        f"{WIDTH}x{HEIGHT} in batches of {AXIS_BATCH} at {fps:.2f} fps end "
        f"to end: summary = phase 4's "
        f"({len(keyframes)} keyframes at {list(indices)}); {len(pick)} "
        f"frames vs meshless bf16: {vs_bf16[0]} pixels flipped "
        f"({vs_bf16[1]:.2e}, bound {AXIS_MAX_FLIPS_VS_BF16}); vs plain f32: "
        f"{vs_f32[0]} ({vs_f32[1]:.2e}, bound {MAX_FLIP_RATE}); the same "
        f"frames over seeded weights reaching the trunk: vs meshless bf16 "
        f"{trunk_bf16[0]} ({trunk_bf16[1]:.2e}), vs plain f32 "
        f"{trunk_f32[0]} ({trunk_f32[1]:.2e}), launches {trunk_launches}; "
        f"ms a batch of {AXIS_BATCH} (CUDA events, mean of {AXIS_REPS}) "
        f"{json.dumps(ms)}; peak {peak:.2f} GiB; express launches "
        f"{launches} (K2 = {HEADS} x 2 shards x {batches} batches); on "
        f"{card}")
    del meshed, meshless
    torch.cuda.empty_cache()
    total = {name: launches[name] + trunk_launches[name]
             for name in launches}
    return total, {"fps": fps, "ms": ms, "peak_gib": peak,
                   "flips_vs_bf16": vs_bf16, "flips_vs_f32": vs_f32,
                   "seeded_flips_vs_bf16": trunk_bf16,
                   "seeded_flips_vs_f32": trunk_f32}


def random_weights(net_config, seed=0):
    """Seeded xavier-normal weights everywhere, heads included, so the
    logits depend on every layer: (state dict, the bf16 folded model on
    the card)."""
    import torch

    from lecturemath_tpu_torch.models.fcn_lecturenet import (
        FCNLectureNet, fold_model, init_weights)

    model = init_weights(FCNLectureNet(net_config),
                         torch.Generator().manual_seed(seed)).eval()
    folded = fold_model(model).to(device="cuda", dtype=torch.bfloat16,
                                  memory_format=torch.channels_last).eval()
    return model.state_dict(), folded


def axis_channel_four(net_config, counters, card):
    """(b): ShardedBinarizer's channel shards on 2x2, with random weights,
    against meshless bf16 and plain f32; returns (launches, numbers)."""
    import numpy as np
    import torch

    from lecturemath_tpu_torch.parallel.inference import (ShardedBinarizer,
                                                           sharded_forward)

    state, folded = random_weights(net_config)
    source = make_source()
    frames = np.stack([source.rgb_frame(t) for t in
                       np.linspace(0, N_FRAMES - 1, AXIS_FRAMES).astype(int)])
    mesh = card_mesh(2, 2)
    four = ShardedBinarizer(folded, mesh, shard_params_over_model=True)
    meshless = ShardedBinarizer(random_weights(net_config)[1],
                                card_mesh(1, 1))
    assert [s.model_index for s in four.shards] == [0, 1, 0, 1]
    four.binarize_frames(frames)
    ours, launches, peak = axis_counted(
        counters, lambda: four.binarize_frames(frames))
    axis_gate("(b) ShardedBinarizer channels 2x2", launches, 4, 1)
    bf16 = meshless.binarize_frames(frames)
    f32 = plain_bits(state, net_config, torch.from_numpy(frames))
    vs_bf16, vs_f32 = flips(ours, bf16), flips(ours, f32)
    if vs_bf16[1] > AXIS_MAX_FLIPS_VS_BF16 or vs_f32[1] > MAX_FLIP_RATE:
        raise AssertionError(f"(b) flip rates {vs_bf16}, {vs_f32}")
    ms = {"2x2": cuda_ms(lambda: sharded_forward(mesh, four._fns, frames),
                         AXIS_REPS),
          "meshless": cuda_ms(lambda: sharded_forward(
              meshless.mesh, meshless._fns, frames), AXIS_REPS)}
    log(f"model axis (b) ShardedBinarizer channels 2x2 (4 shards), "
        f"{AXIS_FRAMES} frames {WIDTH}x{HEIGHT}, seeded random weights: vs "
        f"meshless bf16 {vs_bf16[0]} pixels flipped ({vs_bf16[1]:.2e}, "
        f"bound {AXIS_MAX_FLIPS_VS_BF16}); vs "
        f"plain f32 {vs_f32[0]} ({vs_f32[1]:.2e}, bound {MAX_FLIP_RATE}); "
        f"ms a call of {AXIS_FRAMES} frames {json.dumps(ms)}; peak "
        f"{peak:.2f} GiB; launches {launches}; on {card}")
    del four, meshless, folded
    torch.cuda.empty_cache()
    return launches, {"ms": ms, "peak_gib": peak, "flips_vs_bf16": vs_bf16,
                      "flips_vs_f32": vs_f32}


def axis_height(net_config, counters, card):
    """(c): the height-sharded path on two 4K board scans at 1x2 and 1x4,
    and a strip that leaves a shard without rows; returns (launches,
    numbers)."""
    import numpy as np
    import torch

    from lecturemath_tpu_torch.parallel.inference import (ShardedBinarizer,
                                                           sharded_forward)
    from lecturemath_tpu_torch.parallel.model_axis import slab_rows
    from lecturemath_tpu_torch.utils.synthetic import \
        SyntheticRGBLectureSource

    scan = SyntheticRGBLectureSource(
        seed=1, n_frames=8, height=SCAN_HEIGHT, width=SCAN_WIDTH,
        n_boards=1, glyphs_per_board=60, glyph_size=(80, 120))
    frames = np.stack([scan.rgb_frame(t) for t in SCAN_PICK])
    strip = np.ascontiguousarray(frames[1:, 1000:1000 + STRIP_HEIGHT])
    state, folded = random_weights(net_config)
    meshless = ShardedBinarizer(folded, card_mesh(1, 1))
    expected = {"scan": meshless.binarize_frames(frames),
                "strip": meshless.binarize_frames(strip)}
    f32 = {"scan": plain_bits(state, net_config, torch.from_numpy(frames)),
           "strip": plain_bits(state, net_config, torch.from_numpy(strip))}
    padded = -(-SCAN_HEIGHT // 32) * 32
    pad = np.pad(frames, ((0, 0), (0, padded - SCAN_HEIGHT), (0, 0),
                          (0, 0)), mode="edge")
    ms = {"meshless": cuda_ms(lambda: sharded_forward(
        meshless.mesh, meshless._fns, pad), AXIS_REPS)}
    device_breakdown(lambda: sharded_forward(meshless.mesh, meshless._fns,
                                             pad),
                     f"model axis (c) meshless, {len(pad)} frames at 4K")
    del meshless
    torch.cuda.empty_cache()
    total = {name: 0 for name in counters}
    numbers = {"ms": ms, "peak_gib": {}, "flips_vs_bf16": {},
               "flips_vs_f32": {}, "launches": {}}
    for model in (2, 4):
        mesh = card_mesh(1, model)
        binarizer = ShardedBinarizer(random_weights(net_config)[1], mesh,
                                     shard_spatial=True)
        cases = [("scan", frames)] + ([("strip", strip)] if model == 4
                                      else [])
        for what, batch in cases:
            rows = slab_rows(-(-batch.shape[1] // 32) * 32, model)
            holding = sum(1 for r in rows if r)
            binarizer.binarize_frames(batch[:1])
            got, launches, peak = axis_counted(
                counters, lambda: binarizer.binarize_frames(batch))
            key = f"1x{model} {what}"
            axis_gate(f"(c) height {key}", launches, holding, 1)
            if what == "strip" and holding == model:
                raise AssertionError("the strip left every shard rows")
            vs_bf16 = flips(got, expected[what])
            vs_f32 = flips(got, f32[what])
            if vs_bf16[1] > AXIS_MAX_FLIPS_VS_BF16 or \
                    vs_f32[1] > MAX_FLIP_RATE:
                raise AssertionError(f"(c) {key} flip rates {vs_bf16}, "
                                     f"{vs_f32}")
            for name, count in launches.items():
                total[name] += count
            numbers["peak_gib"][key] = peak
            numbers["flips_vs_bf16"][key] = vs_bf16
            numbers["flips_vs_f32"][key] = vs_f32
            numbers["launches"][key] = launches
            log(f"model axis (c) height 1x{model}, {what} "
                f"{len(batch)}x{batch.shape[1]}x{batch.shape[2]} (slab rows "
                f"{rows}): vs meshless bf16 {vs_bf16[0]} pixels flipped "
                f"({vs_bf16[1]:.2e}, bound {AXIS_MAX_FLIPS_VS_BF16}); vs "
                f"plain f32 {vs_f32[0]} "
                f"({vs_f32[1]:.2e}, bound {MAX_FLIP_RATE}); peak {peak:.2f} "
                f"GiB; launches {launches}; on {card}")
        ms[f"1x{model}"] = cuda_ms(lambda: sharded_forward(
            mesh, binarizer._fns, pad), AXIS_REPS)
        device_breakdown(lambda: sharded_forward(mesh, binarizer._fns, pad),
                         f"model axis (c) height 1x{model}, {len(pad)} "
                         f"frames at 4K")
        del binarizer
        torch.cuda.empty_cache()
    log(f"model axis (c) ms a call of {len(frames)} frames "
        f"{SCAN_WIDTH}x{padded} (CUDA events, mean of {AXIS_REPS}) "
        f"{json.dumps(ms)}; on {card}")
    return total, numbers


def model_axis_cli_child(conf, mesh):
    """Child: cli.binarize on ``conf`` with ``-mesh mesh`` in the world of
    the LM_* env (one card a process); prints its launches."""
    sys.path.insert(0, REPO)
    from lecturemath_tpu_torch.cli import binarize
    from lecturemath_tpu_torch.ops.conv7 import conv_same_nhwc
    from lecturemath_tpu_torch.ops.postprocess import threshold_pack
    from lecturemath_tpu_torch.pipeline.driver import PipelineDriver

    memory_frames(PipelineDriver)
    binarize.main(["binarize", conf, "-mesh", mesh])
    print(json.dumps({"launches": {
        "threshold_pack": threshold_pack.launches,
        "conv_same_nhwc": conv_same_nhwc.launches}}), flush=True)
    return 0


def axis_two_cards(card):
    """(d): cli.binarize -mesh 1x2 over two cards in-process, and in a
    2-process NCCL world one card a process; both artifacts equal the
    meshless CLI's."""
    from lecturemath_tpu_torch.cli import binarize
    from lecturemath_tpu_torch.parallel.launch import free_port
    from lecturemath_tpu_torch.pipeline.driver import PipelineDriver

    base = open(os.path.join(WORKSPACE, "staged.conf")).read()
    confs = {}
    for which in ("meshless", "cards", "world"):
        confs[which] = os.path.join(WORKSPACE, f"axis_{which}.conf")
        with open(confs[which], "w") as f:
            f.write(base.replace(f"{WORKSPACE}/output",
                                 f"{WORKSPACE}/axis_{which}"))
    saved = PipelineDriver.frame_source
    memory_frames(PipelineDriver)
    try:
        binarize.main(["binarize", confs["meshless"]])
        binarize.main(["binarize", confs["cards"], "-mesh", "1x2"])
    finally:
        PipelineDriver.frame_source = saved
    port = free_port()
    results = child_results([start_child(
        f"model_axis_cli_child({confs['world']!r}, '1x2')", world=2,
        rank=rank, port=port, visible=str(rank)) for rank in range(2)],
        "binarize -mesh 1x2, 2 processes")
    artifact = os.path.join("temporal", "tempo_binary_smoke01.dat")
    with open(os.path.join(WORKSPACE, "axis_meshless", artifact), "rb") as f:
        single = f.read()
    for which in ("cards", "world"):
        with open(os.path.join(WORKSPACE, f"axis_{which}", artifact),
                  "rb") as f:
            if f.read() != single:
                raise AssertionError(f"binarize -mesh 1x2 ({which}): the "
                                     f"artifact differs from meshless")
    log(f"model axis (d) on 2 cards: binarize -mesh 1x2 in-process and in "
        f"a 2-process NCCL world write the meshless artifact; child "
        f"launches {json.dumps([r['launches'] for r in results])}; on "
        f"{card}")
    return {"children": results}


def phase_model_axis(conf, counters, summary, card):
    """The model axis for inference on the card; returns (launch counts of
    the path's gated runs, numbers)."""
    import torch

    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig

    from lecturemath_tpu_torch.core.config import Config

    t0 = time.perf_counter()
    net_config = FCNConfig.from_config(Config.from_file(conf))
    numbers = {}
    numbers["k2_max_abs_err"], numbers["k1_max_err"] = axis_kernels(
        net_config)
    launches = {name: 0 for name in counters}
    for name, step in (
            ("channels_1x2", lambda: axis_channel_lecture(
                conf, counters, summary, card)),
            ("channels_2x2", lambda: axis_channel_four(
                net_config, counters, card)),
            ("height", lambda: axis_height(net_config, counters, card))):
        counts, numbers[name] = step()
        for key, count in counts.items():
            launches[key] += count
    if torch.cuda.device_count() >= 2:
        numbers["two_cards"] = axis_two_cards(card)
    else:
        log(f"model axis (d): the 2-card checks (binarize -mesh 1x2 over 2 "
            f"cards in-process, and in a 2-process NCCL world) were NOT "
            f"run: this machine has {torch.cuda.device_count()} card")
    numbers["wall_s"] = time.perf_counter() - t0
    log(f"model axis: phase wall {numbers['wall_s']:.3f} s; launches "
        f"{launches}; on {card}")
    return launches, numbers


# --------------------------------------------------------------- phase 16

# training over the model axis on one card: meshes over [cuda:0] * M put
# the M shards of a data position on the one card (the sharded math and
# its gathers, no communication between cards), at the phase-8 widths,
# 256x256 crops and batch 8 from phase 8's PNG dataset. (a) 3 fp32 steps
# (TF32 off) of each case on 1x2 and 1x4 against the meshless Trainer,
# from the same weights on the same batches
AXIS_TRAIN_STEPS = 3
AXIS_TRAIN_MODELS = (2, 4)
# (a)'s gates: the losses, and every assembled tensor within
# AXIS_STATE_REL of its tensor's largest |value| or AXIS_STATE_ABS,
# whichever is larger: cuDNN may pick another algorithm for a sliced shape.
# The floor is the CPU tests' atol; it matters only for the conv biases in
# front of a live BN, whose true gradient is zero (the batch mean removes
# them), so that both runs hold rounding noise there (~1e-10)
AXIS_LOSS_RTOL = 1e-4
AXIS_STATE_REL = 1e-4
AXIS_STATE_ABS = 1e-6
# (b): bf16 steps on 1x2 against meshless bf16 on one batch: bf16 rounds
# every product of the sharded sums another way
AXIS_BF16_STEPS = 10
AXIS_BF16_RTOL = 2e-2
AXIS_TIMED_BATCH = 64
AXIS_TIMED_STEPS = 5
# (c): frames binarized from the trained 1x2 checkpoint
AXIS_CHECK_FRAMES = 8
# (c)'s bin logits of the 1x2 shards against meshless bf16, relative to
# the largest logit: both round every layer's output to bf16 (about 20
# deep), in another order where a layer is sharded. At these widths on
# the CPU (seeded weights, one 256x256 frame) the two differ by
# 2.5e-3-2.9e-3, while a gather in the wrong order moves the logits by
# 0.40 and dropping the transposed convs' partial sums by 0.026
AXIS_LOGIT_REL = 2.0 ** -6


def axis_train_batches(conf, phase, n):
    """``n`` host batches of TRAIN_BATCH from phase 8's PNG dataset for
    ``phase`` (reconstruction: the frames and their median targets;
    text_detector and binarizer: the keyframe / binary pairs with text
    masks, the text detector's median targets too)."""
    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.train.dataset import (LectureNetDataset,
                                                     find_image_mask_pairs,
                                                     find_images)

    config = Config.from_file(conf)
    annotations = os.path.join(WORKSPACE, "output", "annotations",
                               "SmokeDB_smoke01")
    if phase == "reconstruction":
        images = find_images(config.get_str(
            "FCN_BINARIZER_PRETRAIN_REC_IMAGES_DIR"))
        gts = None
        options = dict(reconstruction_mode=True, reconstruct_median=True)
    else:
        images, gts = find_image_mask_pairs(
            os.path.join(annotations, "keyframes"),
            os.path.join(annotations, "binary"))
        options = dict(reconstruction_mode=False, text_mask_expansion=15,
                       reconstruct_median=phase == "text_detector")
    dataset = LectureNetDataset.from_config(config, images, gts, **options)
    dataset.preload()
    out = []
    while len(out) < n:
        # host copies: the card's route yields tensors on the card (K5)
        out.extend(host_copy(batch)
                   for batch in dataset.batches(TRAIN_BATCH))
    return out[:n]


def axis_start_state(net_config, reconstruction_mode, seed=0):
    """Seeded xavier weights with the BatchNorms' affines and running
    statistics off identity, as a warm start holds them."""
    import torch

    from lecturemath_tpu_torch.models.fcn_lecturenet import (FCNLectureNet,
                                                             init_weights)

    model = init_weights(FCNLectureNet(net_config, reconstruction_mode),
                         torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.BatchNorm2d):
                module.weight.uniform_(0.5, 1.5, generator=gen)
                module.bias.normal_(0, 0.1, generator=gen)
                module.running_mean.normal_(0, 0.1, generator=gen)
                module.running_var.uniform_(0.5, 1.5, generator=gen)
    return model.state_dict()


# (a)'s cases: the phase, the Trainer's options, the learning rate (the
# example config's), and whether the weights are a warm start's
AXIS_TRAIN_CASES = {
    "live BN (reconstruction from scratch)": (
        "reconstruction", {}, 0.01, False),
    "frozen BN folded (binarizer warm-started)": (
        "binarizer", dict(freeze_bn=True, fold_frozen_bn=True), 0.001, True),
    "use_weights + clip_norm (binarizer)": (
        "binarizer", dict(use_weights=True, clip_norm=1.0), 0.001, False),
}


def axis_trainer(net_config, case, dtype, model):
    """A Trainer of (a)'s ``case`` in ``dtype`` on the card: meshless
    (``model`` 1) or on a 1 x ``model`` mesh over the one card."""
    import torch

    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNLectureNet
    from lecturemath_tpu_torch.train.trainer import Trainer

    phase, options, lr, warm = AXIS_TRAIN_CASES[case]
    rec = phase == "reconstruction"
    net = FCNLectureNet(net_config, reconstruction_mode=rec,
                        compute_dtype=dtype)
    if warm:
        net.load_state_dict(axis_start_state(net_config, rec))
    else:
        from lecturemath_tpu_torch.models.fcn_lecturenet import init_weights

        init_weights(net, torch.Generator().manual_seed(0))
    return Trainer(net, lr, phase=phase, prefetch_depth=0,
                   device="cuda" if model == 1 else None,
                   mesh=None if model == 1 else card_mesh(1, model),
                   **options)


def axis_train_run(trainer, batches):
    """One step a batch: (per-step totals, the assembled state)."""
    losses = [float(trainer.step(batch)["total"]) for batch in batches]
    return losses, {key: value.float().cpu() for key, value in
                    trainer.state_dict().items()
                    if not key.endswith("num_batches_tracked")}


def axis_train_parity(conf, net_config):
    """(a): every case on 1x2 and 1x4 against meshless in fp32."""
    import torch

    batches = {phase: axis_train_batches(conf, phase, AXIS_TRAIN_STEPS)
               for phase in ("reconstruction", "binarizer")}
    numbers = {}
    for case, (phase, _, _, _) in AXIS_TRAIN_CASES.items():
        plain = axis_train_run(axis_trainer(net_config, case, torch.float32,
                                            1), batches[phase])
        for model in AXIS_TRAIN_MODELS:
            losses, state = axis_train_run(axis_trainer(
                net_config, case, torch.float32, model), batches[phase])
            loss_rel = max(abs(a - b) / abs(b)
                           for a, b in zip(losses, plain[0]))
            state_rel = max(float((state[key] - value).abs().max())
                            / max(float(value.abs().max()),
                                  AXIS_STATE_ABS / AXIS_STATE_REL)
                            for key, value in plain[1].items())
            log(f"model-axis training (a) {case}, 1x{model} vs meshless, "
                f"fp32, {AXIS_TRAIN_STEPS} steps at batch {TRAIN_BATCH}: "
                f"losses {[round(v, 6) for v in losses]} vs "
                f"{[round(v, 6) for v in plain[0]]} (largest rel "
                f"{loss_rel:.3g}, bound {AXIS_LOSS_RTOL}); assembled state "
                f"largest |diff| / max(max |value|, "
                f"{AXIS_STATE_ABS / AXIS_STATE_REL:g}) {state_rel:.3g} "
                f"(bound {AXIS_STATE_REL})")
            if sorted(state) != sorted(plain[1]):
                raise AssertionError(f"(a) {case} 1x{model}: the assembled "
                                     f"state has other tensors")
            if not (loss_rel <= AXIS_LOSS_RTOL
                    and state_rel <= AXIS_STATE_REL):
                raise AssertionError(f"(a) {case} 1x{model}: losses rel "
                                     f"{loss_rel}, state rel {state_rel}")
            numbers[f"{case} 1x{model}"] = {"loss_rel": loss_rel,
                                            "state_rel": state_rel}
        torch.cuda.empty_cache()
    return numbers


def axis_step_ms(trainer, batch):
    """Median step ms over AXIS_TIMED_STEPS after 2 warm-up steps (CUDA
    events), and the card's peak GiB over them."""
    import statistics

    import torch

    batch = trainer.to_device(batch)
    for _ in range(2):
        trainer.step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = []
    for _ in range(AXIS_TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.step(batch)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return (statistics.median(s.elapsed_time(e) for s, e in events),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def axis_train_bf16(conf, net_config, card):
    """(b): AXIS_BF16_STEPS bf16 steps of the binarizer phase (live BN,
    from seeded weights) on one batch, 1x2 against meshless; then the
    bf16 batch-64 step ms and peak GiB of meshless, 1x2 and 1x4 (printed,
    not gated). Returns (the 1x2 trainer, numbers)."""
    import numpy as np
    import torch

    from lecturemath_tpu_torch.models.fcn_lecturenet import (FCNLectureNet,
                                                             init_weights)
    from lecturemath_tpu_torch.train.trainer import Trainer

    batch = axis_train_batches(conf, "binarizer", 1)[0]

    def trainer(model):
        net = init_weights(FCNLectureNet(net_config,
                                         compute_dtype=torch.bfloat16),
                           torch.Generator().manual_seed(0))
        return Trainer(net, 0.01, phase="binarizer", prefetch_depth=0,
                       device="cuda" if model == 1 else None,
                       mesh=None if model == 1 else card_mesh(1, model))

    curves = {}
    trained = None
    for model in (1, 2):
        run = trainer(model)
        on_card = run.to_device(batch)
        curves[model] = [float(run.step(on_card)["total"])
                         for _ in range(AXIS_BF16_STEPS)]
        if model == 2:
            trained = run
        del run
    rel = max(abs(a - b) / abs(b) for a, b in zip(curves[2], curves[1]))
    log(f"model-axis training (b) bf16, binarizer phase, live BN, "
        f"{AXIS_BF16_STEPS} steps on one batch of {TRAIN_BATCH}: 1x2 "
        f"{[round(v, 5) for v in curves[2]]}, meshless "
        f"{[round(v, 5) for v in curves[1]]} (largest rel {rel:.3g}, bound "
        f"{AXIS_BF16_RTOL})")
    if not (rel <= AXIS_BF16_RTOL and curves[2][-1] < curves[2][0]):
        raise AssertionError(f"(b) bf16 1x2 losses {curves[2]} vs "
                             f"meshless {curves[1]}")
    big = {key: np.concatenate([value] * (AXIS_TIMED_BATCH // TRAIN_BATCH))
           for key, value in batch.items()}
    timed = {}
    for model in (1, 2, 4):
        run = trainer(model)
        ms, peak = axis_step_ms(run, big)
        timed["meshless" if model == 1 else f"1x{model}"] = {
            "step_ms": ms, "peak_gib": peak}
        del run
        torch.cuda.empty_cache()
    log(f"model-axis training (b) bf16 live BN, batch {AXIS_TIMED_BATCH} at "
        f"256x256, step ms (median of {AXIS_TIMED_STEPS}, CUDA events) and "
        f"peak GiB, shards sharing one card (the price, not a speed-up): "
        f"{json.dumps(timed)}; on {card}")
    return trained, {"loss_rel": rel, "losses_1x2": curves[2],
                     "losses_meshless": curves[1], "batch_64": timed}


def axis_trained_check(trained, net_config, counters, card):
    """(c): the trained 1x2 checkpoint saved by Trainer.save, reloaded
    meshless, through the packed binarizer (K2, K1) and through
    ShardedBinarizer's channel shards on 1x2 (K2 on the shards' heads,
    K1), each within phase 8's flip rate of the plain f32 model, and the
    shards' logits within AXIS_LOGIT_REL of meshless bf16."""
    import numpy as np
    import torch

    from lecturemath_tpu_torch.models.convert import load_checkpoint
    from lecturemath_tpu_torch.models.fcn_lecturenet import (
        FCNLectureNet, fold_model, make_packed_binarizer, model_input,
        unpack_bits_host)
    from lecturemath_tpu_torch.parallel.inference import ShardedBinarizer
    from lecturemath_tpu_torch.parallel.model_axis import \
        forward_channel_sharded

    path = os.path.join(WORKSPACE, "models", "axis_1x2.msgpack")
    trained.save(path)
    state = load_checkpoint(path)
    source = make_source()
    pick = np.linspace(0, N_FRAMES - 1, AXIS_CHECK_FRAMES).astype(int)
    frames = np.stack([source.rgb_frame(t) for t in pick])

    def bf16_model():
        net = FCNLectureNet(net_config)
        net.load_state_dict(state)
        return fold_model(net.eval()).to(
            device="cuda", dtype=torch.bfloat16,
            memory_format=torch.channels_last).eval()

    model = bf16_model()
    meshless = make_packed_binarizer(model)
    meshless(torch.from_numpy(frames).cuda())
    packed, launches_meshless, _ = axis_counted(
        counters, lambda: meshless(torch.from_numpy(frames).cuda()))
    axis_gate("(c) meshless packed binarizer", launches_meshless, 1, 1)
    sharded = ShardedBinarizer(bf16_model(), card_mesh(1, 2),
                               shard_params_over_model=True)
    ours, launches_sharded, _ = axis_counted(
        counters, lambda: sharded.binarize_frames(frames))
    axis_gate("(c) ShardedBinarizer channels 1x2", launches_sharded, 2, 1)
    f32 = plain_bits(state, net_config, torch.from_numpy(frames))
    bits = unpack_bits_host(packed.cpu().numpy(), WIDTH)
    vs_f32 = {"meshless": flips(bits, f32), "1x2": flips(ours, f32)}
    truth = np.stack([source.binary_frame(t) for t in pick]) > 0
    log(f"model-axis training (c) the trained 1x2 checkpoint "
        f"({len(state)} tensors, Trainer.save) on {AXIS_CHECK_FRAMES} "
        f"frames {WIDTH}x{HEIGHT}: flips vs plain f32 {json.dumps(vs_f32)} "
        f"(bound {MAX_FLIP_RATE}); 1x2 vs meshless {flips(ours, bits)}; "
        f"ink share {float(np.mean(bits == 0)):.4f} (ground truth "
        f"{float(np.mean(truth)):.4f}, pixels off it "
        f"{float(np.mean((bits == 0) != truth)):.4f}); launches meshless "
        f"{launches_meshless}, 1x2 {launches_sharded}; on {card}")
    # the binaries of a few trained steps may sit far from the threshold
    # (all background), where no flip can show a fault: the logits are
    # held too, the shards' against meshless bf16 (AXIS_LOGIT_REL)
    x, _ = model_input(torch.from_numpy(frames).cuda())
    with torch.no_grad():
        logits = model(x)[0].float()
        sharded_logits = forward_channel_sharded(sharded.shards, x)[0]
        plain = FCNLectureNet(net_config, plain=True)
        plain.load_state_dict(state)
        plain_logits = plain.cuda().eval()(x)[0]
    largest = float(logits.abs().max())
    logit_rel = float((sharded_logits.float() - logits).abs().max()) / largest
    plain_rel = float((plain_logits - logits).abs().max()) / largest
    log(f"model-axis training (c) bin logits of the trained checkpoint: "
        f"1x2 shards vs meshless bf16 max |diff| / max |logit| "
        f"{logit_rel:.3g} (bound {AXIS_LOGIT_REL:.3g}; max |logit| "
        f"{largest:.4g}); meshless bf16 vs plain f32 {plain_rel:.3g}")
    if max(rate for _, rate in vs_f32.values()) > MAX_FLIP_RATE:
        raise AssertionError(f"(c) flip rates vs plain f32 {vs_f32}")
    if not logit_rel <= AXIS_LOGIT_REL:
        raise AssertionError(f"(c) the 1x2 shards' logits differ from "
                             f"meshless bf16 by {logit_rel} of the largest")
    launches = {key: launches_meshless[key] + launches_sharded[key]
                for key in launches_meshless}
    return launches, {"flips_vs_f32": vs_f32, "logit_rel_1x2": logit_rel,
                      "logit_rel_plain_f32": plain_rel}


def axis_train_cli_child(conf):
    """Child: cli.train_binarizer on ``conf`` with ``-mesh 1x2`` over the
    two cards it sees; prints its launches."""
    sys.path.insert(0, REPO)
    from lecturemath_tpu_torch.cli import train_binarizer
    from lecturemath_tpu_torch.ops.conv7 import conv_same_nhwc

    t0 = time.perf_counter()
    train_binarizer.main(["train_binarizer", conf, "testing", "-mesh",
                          "1x2"])
    print(json.dumps({"wall_s": time.perf_counter() - t0,
                      "conv_same_nhwc": conv_same_nhwc.launches}),
          flush=True)
    return 0


def axis_train_two_cards(conf, card):
    """(d): train_binarizer -mesh 1x2 over two cards in a child (one data
    position, its two shards a card each); its checkpoint is finite and
    holds every tensor of phase 8's."""
    import torch

    from lecturemath_tpu_torch.models.convert import load_checkpoint

    with open(conf) as f:
        text = f.read()
    cli_conf = os.path.join(WORKSPACE, "axis_train.conf")
    out = os.path.join(WORKSPACE, "models", "axis_cli.msgpack")
    with open(cli_conf, "w") as f:
        f.write(text.replace(f"{WORKSPACE}/models/binarizer.msgpack", out)
                .replace("FCN_BINARIZER_TRAIN_EPOCHS = 5",
                         "FCN_BINARIZER_TRAIN_EPOCHS = 1"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0,1")
    env.pop("LM_COORDINATOR", None)
    code = (f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
            f"sys.exit(chip_smoke.axis_train_cli_child({cli_conf!r}))")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    result = child_results([proc], "train_binarizer -mesh 1x2, 2 cards")[0]
    state = load_checkpoint(out)
    expected = load_checkpoint(os.path.join(WORKSPACE, "models",
                                            "text_pretrain.msgpack"))
    if sorted(state) != sorted(expected) or not all(
            torch.isfinite(v).all() for v in state.values()):
        raise AssertionError("(d) the 2-card checkpoint is incomplete or "
                             "not finite")
    if result["conv_same_nhwc"]:
        raise AssertionError("(d) a training forward launched K2")
    log(f"model-axis training (d) train_binarizer -mesh 1x2 over 2 cards: "
        f"{result['wall_s']:.3f} s, checkpoint of {len(state)} finite "
        f"tensors, K2 0; on {card}")
    return result


def phase_model_axis_training(counters, card):
    """Phase 16: training over the model axis on the card; returns
    (launch counts of the path, numbers)."""
    import torch

    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig

    t0 = time.perf_counter()
    conf = make_training_set()
    net_config = FCNConfig.from_config(Config.from_file(conf))
    for counter in counters.values():
        counter.launches = 0
    numbers = {"parity_fp32": axis_train_parity(conf, net_config)}
    trained, numbers["bf16"] = axis_train_bf16(conf, net_config, card)
    # the data path's pixels go through K5 and its median targets through
    # K4; no model kernel may
    training_launches = counted(counters)
    if any(count for name, count in training_launches.items()
           if name not in TRAINING_KERNELS):
        raise AssertionError(f"model-axis training launched kernels "
                             f"{training_launches}: K2 under grad")
    log(f"model-axis training (a), (b): no model kernel launched (the heads "
        f"run F.conv2d under grad); K4 {training_launches['median']} for "
        f"the median targets, K5 {training_launches['augment']} for the "
        f"batches' pixels")
    launches, numbers["trained_check"] = axis_trained_check(
        trained, net_config, counters, card)
    del trained
    torch.cuda.empty_cache()
    for name in EXPRESS_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched")
    if torch.cuda.device_count() >= 2:
        numbers["two_cards"] = axis_train_two_cards(conf, card)
    else:
        log(f"model-axis training (d): train_binarizer -mesh 1x2 over 2 "
            f"cards was NOT run: this machine has "
            f"{torch.cuda.device_count()} card")
    numbers["wall_s"] = time.perf_counter() - t0
    log(f"model-axis training: phase wall {numbers['wall_s']:.3f} s; "
        f"launches {launches}; on {card}")
    return launches, numbers


def main():
    t_start = time.perf_counter()
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
    from lecturemath_tpu_torch.ops.augment import augment_batch
    from lecturemath_tpu_torch.ops.median import median_u8_batch
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
    import importlib.util

    log(f"OpenCV importable: {importlib.util.find_spec('cv2') is not None}, "
        f"Pillow: {importlib.util.find_spec('PIL') is not None} (the port "
        f"needs neither)")
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
                "cc_label": label_components_batch,
                "median": median_u8_batch,
                "augment": augment_batch}
    walls = {"1 environment and build": time.perf_counter() - t_start}
    log(f"phase 1 environment and build: "
        f"{walls['1 environment and build']:.3f} s")

    def run(name, fn, default=None):
        """fn() as the phase ``name``: its wall printed and kept; a failure
        printed and named, and ``default`` returned in its place."""
        t0 = time.perf_counter()
        try:
            return fn()
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc()
            failures.append(name.split(" ", 1)[1])
            return default
        finally:
            walls[name] = time.perf_counter() - t0
            log(f"phase {name}: {walls[name]:.3f} s")
            torch.cuda.empty_cache()

    batch = default_batch_size(WIDTH, HEIGHT, torch.device("cuda"))
    # what the drive's stage-01 and express children take at 1080p (each
    # starts on an empty card, as this process is here)
    flagship_batch = default_batch_size(1920, 1080, torch.device("cuda"))
    log(f"main-path batch size: {batch}; 1080p stage-01 batch size: "
        f"{flagship_batch}")
    for name, phase in (("2 K1", lambda: phase_k1(batch, flagship_batch)),
                        ("3 K2", lambda: phase_k2(batch, FCNConfig()))):
        record = run(name, phase)
        if record is not None:
            records[name.split()[1]] = record

    def empty():
        return {}, {}

    launches, summary = empty()
    staged_launches = {}
    serving_launches, serving = empty()
    training_launches, training = empty()
    evaluation_launches, evaluation = empty()
    scale_launches, scale = empty()
    worker_launches, worker = empty()
    tooling_launches, tooling = empty()
    editors_launches, editors = empty()
    flagship_launches, flagship = empty()
    axis_launches, axis = empty()
    axis_train_launches, axis_train = empty()
    try:
        conf, _ = make_workspace()
        launches, summary = run(
            "4 main path", lambda: phase_main_path(conf, counters), empty())
        record = run("5 K3", lambda: phase_k3(conf))
        if record is not None:
            records["K3"] = record
        record = run("5 K4", phase_k4)
        if record is not None:
            records["K4"] = record
        record = run("5 K5", phase_k5)
        if record is not None:
            records["K5"] = record
        staged_launches = run(
            "6 staged path",
            lambda: phase_staged(counters, summary.get("indices")), {})
        serving_launches, serving = run(
            "7 serving path", lambda: phase_serving(conf, counters), empty())
        training_launches, training = run(
            "8 training path", lambda: phase_training(counters), empty())
        evaluation_launches, evaluation = run(
            "9 evaluation path", lambda: phase_evaluation(counters), empty())
        scale_launches, scale = run(
            "10 scale-out path",
            lambda: phase_scale_out(conf, counters, card), empty())
        worker_launches, worker = run(
            "11 device-worker path and device ops",
            lambda: phase_device_worker(conf, summary, card), empty())
        tooling_launches, tooling = run(
            "12 tooling", lambda: phase_tooling(counters, summary, card),
            empty())
        editors_launches, editors = run(
            "13 editors", lambda: phase_editors(counters, summary, card),
            empty())
        flagship_launches, flagship = run(
            "14 flagship drive", lambda: phase_flagship(counters, card),
            empty())
        axis_launches, axis = run(
            "15 model axis",
            lambda: phase_model_axis(conf, counters, summary, card), empty())
        axis_train_launches, axis_train = run(
            "16 model axis for training",
            lambda: phase_model_axis_training(counters, card), empty())
    except Exception:  # noqa: BLE001 — report every phase, then fail
        traceback.print_exc()
        failures.append("workspace")
    finally:
        shutil.rmtree(WORKSPACE, ignore_errors=True)

    # launches: the staged path's counts (it runs every kernel), with each
    # path's own counts beside them; serving's are graph replays x the
    # launches each graph counted at capture, and beside them the launches
    # the profiler saw in one replay of each bucket's graph
    for key, name in (("K1", "threshold_pack"), ("K2", "conv_same_nhwc"),
                      ("K3", "cc_label"), ("K4", "median"),
                      ("K5", "augment")):
        if key in records:
            records[key]["launches"] = staged_launches.get(name, 0)
            records[key]["launches_by_path"] = {
                "express": launches.get(name, 0),
                "staged": staged_launches.get(name, 0),
                "serving": serving_launches.get(name, 0),
                "training": training_launches.get(name, 0),
                "evaluation": evaluation_launches.get(name, 0),
                "scale_out": scale_launches.get(name, 0),
                "device_worker": worker_launches.get(name, 0),
                "tooling": tooling_launches.get(name, 0),
                "editors": editors_launches.get(name, 0),
                "flagship": flagship_launches.get(name, 0),
                "model_axis": axis_launches.get(name, 0),
                "model_axis_training": axis_train_launches.get(name, 0)}
    for key in SERVING_KERNELS:
        if key in records and serving:
            device_us = {bucket: numbers["device_us"]
                         for bucket, numbers in serving["buckets"].items()}
            records[key]["serving_us_by_bucket"] = {
                bucket: groups and groups[key]
                for bucket, groups in device_us.items()}
            records[key]["serving_launches_per_replay_by_bucket"] = {
                bucket: groups and groups["launches"][key]
                for bucket, groups in device_us.items()}
    if serving:
        log(f"serving: " + json.dumps({k: {m: round(v, 3) for m, v in r.items()
                                           if isinstance(v, float)}
                                       for k, r in serving["http"].items()}))
    if training:
        log("training steps: " + json.dumps(
            {key: {m: round(v, 3) for m, v in numbers.items()}
             for key, numbers in training["steps"].items()}))
    if evaluation:
        log("evaluation: " + json.dumps(
            {"keyframes_per_s": evaluation["keyframes_per_s"],
             "wall_s": evaluation["walls"], "host_s": evaluation["host_s"],
             "flip_rate": evaluation["flip_rate"]}))
    if scale:
        log(f"scale-out on {card}: " + json.dumps(scale))
    if worker:
        log(f"device worker and device ops on {card}: " + json.dumps(worker))
    if tooling:
        log(f"tooling on the card's host, {card}: " + json.dumps(tooling))
    if editors:
        log(f"editors on the card's host, {card}: " + json.dumps(editors))
    if flagship:
        log(f"flagship drive on {card}: " + json.dumps(
            {"steps": flagship["steps"], "phase_s": flagship["phase_s"]}))
    if axis:
        log(f"model axis on {card}: " + json.dumps(
            {key: value for key, value in axis.items()
             if key != "two_cards"}))
    if axis_train:
        log(f"model-axis training on {card}: " + json.dumps(
            {key: value for key, value in axis_train.items()
             if key != "two_cards"}))
    log(f"express {summary.get('fps', 0):.2f} fps on {card}")
    walls["all"] = time.perf_counter() - t_start
    log(f"phase walls s on {card}: "
        + json.dumps({k: round(v, 3) for k, v in walls.items()}))
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
