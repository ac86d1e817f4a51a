#!/usr/bin/env python3
"""Smoke test of lecturemath_tpu_torch on one NVIDIA card.

Run from the root of a checkout with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``lecturemath_tpu_torch/csrc`` with nvcc and
then, in phases:

  1. environment: the card's name and power limit, torch and CUDA versions,
     the kernels' build time;
  2. kernel K1 (threshold_pack) against its plain PyTorch version at the
     main path's shape [B, 544, 960] and at odd shapes, with logits placed on
     the threshold; kernel and plain times beside the bytes bound;
  3. kernel K2 (conv_same_nhwc) against its plain version (F.conv2d in f32,
     TF32 off) at the four head-conv shapes of the main path, bf16 inputs;
     kernel, plain and cuDNN bf16 (library yardstick) times beside the
     operations bound;
  4. the express pipeline (Binarizer.from_config + run_lecture) on a
     240-frame synthetic 960x540 lecture at the production widths 48..768 in
     bf16 with seeded threshold-head weights: at least 2 inked keyframes
     split within 3 samples of the era boundary, both kernels launched, and
     a stage-01 batch within a 1% pixel flip rate of the plain f32 path;
     then the same run once more under torch.profiler for the device time
     by kernel group and the device's busy share.

It prints one JSON line of kernel numbers, then as its last line
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
    """(name, C_in, N, activation, out dtype) of the four head convs."""
    import torch

    c, up1 = cfg.in_channels, cfg.up_filters[0]
    p1, p2 = cfg.pixel_features
    return [("text_conv", up1, 1, None, torch.float32),
            ("pixels_1", c + up1, p1, "gelu", torch.bfloat16),
            ("pixels_2", c + p1, p2, "gelu", torch.bfloat16),
            ("out_conv", c + p2, 1, None, torch.float32)]


def phase_k2(batch, cfg):
    """K2 against conv_same_plain at the head shapes; returns its record."""
    import torch
    import torch.nn.functional as F

    from lecturemath_tpu_torch.ops.conv7 import conv_same_nhwc, conv_same_plain

    gen = torch.Generator(device="cuda").manual_seed(2)
    k = cfg.pixel_kernel_size
    hp, wp = 544, 960
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    flops = n_bytes = 0
    max_err = 0.0
    for name, c_in, n_out, act, out_dtype in head_shapes(cfg):
        x = torch.randn(batch, c_in, hp, wp, device="cuda", generator=gen).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        weight = (torch.randn(n_out, c_in, k, k, device="cuda", generator=gen)
                  / (c_in * k * k) ** 0.5).to(torch.bfloat16)
        bias = (torch.randn(n_out, device="cuda", generator=gen) * 0.1).to(
            torch.bfloat16)
        got = conv_same_nhwc(x, weight, bias, act, out_dtype).float()
        ref = conv_same_plain(x, weight, bias, act, torch.float32)
        err = (got - ref).abs()
        kind = "f32" if out_dtype == torch.float32 else "bf16"
        excess = (err - K2_REL[kind] * ref.abs() - K2_ABS).max().item()
        max_err = max(max_err, err.max().item())
        del got, ref, err
        reps = 3
        ms = cuda_ms(lambda: conv_same_nhwc(x, weight, bias, act, out_dtype),
                     reps)
        plain_ms = cuda_ms(lambda: conv_same_plain(x, weight, bias, act,
                                                   torch.float32), reps)
        library_ms = cuda_ms(lambda: F.conv2d(x, weight, bias,
                                              padding=k // 2), reps)
        out_bytes = 4 if out_dtype == torch.float32 else 2
        f = 2 * k * k * c_in * n_out * batch * hp * wp
        b = batch * hp * wp * (2 * c_in + out_bytes * n_out) \
            + weight.numel() * 2 + n_out * 2
        flops += f
        n_bytes += b
        log(f"K2 {name} [{batch},{c_in},{hp},{wp}] -> {n_out} ch k={k} "
            f"{act or 'linear'} {kind}: max |err| {max_err:.3g} (excess over "
            f"tolerance {excess:.3g}), kernel {ms:.3f} ms, plain f32 "
            f"{plain_ms:.3f} ms, cuDNN bf16 {library_ms:.3f} ms, "
            f"{f / ms / 1e9:.1f} TFLOP/s")
        if excess > 0:
            raise AssertionError(f"K2 {name} outside tolerance")
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["library_ms"] += library_ms
        del x
        torch.cuda.empty_cache()
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    log(f"K2 four heads per batch of {batch}: kernel {totals['ms']:.3f} ms, "
        f"bound {max(ops_ms, bytes_ms):.3f} ms ({flops / 1e9:.1f} GFLOP, "
        f"{n_bytes / 1e6:.1f} MB)")
    return {"name": "conv_same_nhwc", "route": "cuda",
            "source": "lecturemath_tpu_torch/csrc/conv7.cu",
            "replaces": "lecturemath_tpu/ops/pallas_conv7.py:42",
            "max_abs_err": max_err, **totals,
            "bound_ms": max(ops_ms, bytes_ms),
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


def make_workspace():
    """Config, database and a seeded threshold-head checkpoint (.dat)."""
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
    net_config = FCNConfig.from_config(Config.from_file(conf))
    save_checkpoint(threshold_binarizer_variables(net_config, seed=0),
                    os.path.join(WORKSPACE, "models", "smoke.dat"))
    return conf, net_config


def make_source():
    from lecturemath_tpu_torch.utils.synthetic import SyntheticRGBLectureSource

    return SyntheticRGBLectureSource(
        seed=0, n_frames=N_FRAMES, height=HEIGHT, width=WIDTH, n_boards=2,
        glyphs_per_board=40, glyph_size=(40, 60))


def phase_main_path(conf, counters):
    """Express on the card; returns (launch counts, summary dict)."""
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
    for name, count in launches.items():
        if count <= 0:
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

    device_breakdown(lambda: run_lecture(driver, lecture, binarizer,
                                         source=make_source(), export=False))
    return launches, {"fps": N_FRAMES / wall, "wall_s": wall,
                      "batch": binarizer.batch_size, "flip_rate": flip_rate}


def device_breakdown(run):
    """Run ``run()`` once more under torch.profiler and print where the
    card's time went: device ms by kernel group and the device's busy share
    of the run's wall clock (the union of kernel and copy spans)."""
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
    spans = sorted((ev["ts"], ev["ts"] + ev["dur"], ev["cat"], ev["name"])
                   for ev in events if ev.get("ph") == "X" and ev.get("cat")
                   in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        log("profiled express: the profiler saw no device events; device "
            "breakdown not measured")
        return
    groups, names = {}, {}
    busy_us, end_us = 0.0, float("-inf")
    for start, end, cat, name in spans:
        group = ("K2 conv_same_kernel" if "conv_same_kernel" in name else
                 "K1 threshold_pack_kernel" if "threshold_pack_kernel" in name
                 else "copies and memsets" if cat != "kernel"
                 else "trunk and glue (cuDNN, elementwise)")
        groups[group] = groups.get(group, 0.0) + (end - start) / 1e3
        names[name[:60]] = names.get(name[:60], 0.0) + (end - start) / 1e3
        busy_us += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    log(f"profiled express ({wall_ms:.1f} ms wall under the profiler): "
        f"device busy {busy_us / 1e3:.1f} ms = "
        f"{busy_us / 1e3 / wall_ms:.3f} of the wall; device ms by group "
        f"{json.dumps({k: round(v, 3) for k, v in groups.items()})}; top "
        f"kernels {json.dumps({k: round(v, 3) for k, v in top})}")


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
            if "registers" in line or line.startswith("built"):
                log(f"  {name}: {line.strip()}")

    failures = []
    records = {}
    counters = {"threshold_pack": threshold_pack,
                "conv_same_nhwc": conv_same_nhwc}
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
    summary = {}
    try:
        conf, _ = make_workspace()
        launches, summary = phase_main_path(conf, counters)
    except Exception:  # noqa: BLE001 — report every phase, then fail
        traceback.print_exc()
        failures.append("main path")
    finally:
        shutil.rmtree(WORKSPACE, ignore_errors=True)

    if "K1" in records:
        records["K1"]["launches"] = launches.get("threshold_pack", 0)
    if "K2" in records:
        records["K2"]["launches"] = launches.get("conv_same_nhwc", 0)
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
