"""Binarizer-quality evaluation: binarize GT keyframes with the model and
score CC-level + pixel-level metrics against the GT binary annotations.

This is the parity gate named in BASELINE.json
(reference: lecturenet_eval_keyframe_bin.py:24-185): alignment window 1,
min R/P grid {50,55,...,95} zipped, global metrics only, plus pixel
recall/precision/f-measure and board-precision variants.

The model runs batched on the card (frames bucketed by resolution), the
four k=7 head convs in kernel K2, unless the caller asks for the CPU
(``device="cpu"``; CLI ``-device cpu``). The saved binaries are written by
``utils/png.py``, byte for byte as ``cv2.imwrite`` writes them.
"""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict
from typing import List, Optional, Union

import numpy as np
import torch

from ..core.config import Config
from ..core.device import cli_args, resolve_device
from ..core.metadata import MetaDataDB
from ..pipeline.binarize import Binarizer
from ..utils.png import write_image
from .annotation import KeyframeAnnotation
from .evaluator import EvalParams, Evaluator
from .summary_eval import load_dataset_keyframes

KEYFRAME_BIN_PARAMS = EvalParams(
    global_translation_window=1,
    min_cc_recall=(0.50, 0.55, 0.60, 0.65, 0.70, 0.75, 0.80, 0.90, 0.95),
    min_cc_precision=(0.50, 0.55, 0.60, 0.65, 0.70, 0.75, 0.80, 0.90, 0.95),
    show_counts=False, show_avg_per_frame=False, show_globals=True)


def binarize_keyframes(binarizer: Binarizer,
                       keyframes: List[KeyframeAnnotation],
                       save_dir: Optional[str] = None) -> None:
    """Batch-binarize keyframe raw images (bucketed by shape) and install
    the results as each keyframe's binary image (ink=0 polarity, matching
    the GT convention)."""
    buckets = defaultdict(list)
    for idx, kf in enumerate(keyframes):
        buckets[kf.raw_image.shape].append(idx)

    for shape, indices in buckets.items():
        batch_size = binarizer.batch_size or max(
            1, 8_000_000 // (shape[0] * shape[1]))
        for start in range(0, len(indices), batch_size):
            chunk = indices[start:start + batch_size]
            # no pad of the last chunk to the batch size: outputs are per
            # frame, and nothing here compiles a program per shape
            frames = np.stack([keyframes[i].raw_image for i in chunk])
            binary = binarizer.binarize_frames(frames)
            for offset, kf_index in enumerate(chunk):
                kf = keyframes[kf_index]
                mono = binary[offset]
                kf.binary_image = np.stack([mono] * 3, axis=-1)
                kf.update_binary_cc(False)
                if save_dir is not None:
                    out_dir = os.path.join(save_dir, "FCN", kf.lecture, "binary")
                    os.makedirs(out_dir, exist_ok=True)
                    write_image(os.path.join(out_dir, f"{kf.idx}.png"),
                                kf.binary_image)


def evaluate_keyframe_binarization(config: Config, model_path: str,
                                   dataset_name: str,
                                   params: Optional[EvalParams] = None,
                                   save_binaries: Optional[bool] = None,
                                   device: Union[None, str,
                                                 torch.device] = None):
    """Full protocol: load GT keyframes, binarize with the model, run
    CC-level metrics with fake per-keyframe segments + pixel metrics.
    Returns (scope_metrics, scopes, pixel_metrics). The model runs on
    ``device`` (default: the card)."""
    params = params or KEYFRAME_BIN_PARAMS
    database = MetaDataDB.from_file(config.get_str("VIDEO_DATABASE_PATH"))
    output_root = config.get_str("OUTPUT_PATH")

    all_keyframes, binarized_keyframes = load_dataset_keyframes(
        output_root, database, dataset_name)
    fake_groups, fake_cc_group, fake_segments = \
        KeyframeAnnotation.generate_fake_keyframe_info(all_keyframes)

    config_override = Config({key: config.get(key) for key in config})
    model_dir, model_file = os.path.split(model_path)
    config_override.set("BINARIZATION_FCN_LECTURENET_DIR", model_dir or ".")
    config_override.set("BINARIZATION_FCN_LECTURENET_FILENAME", model_file)
    binarizer = Binarizer.from_config(config_override, device=device)

    if save_binaries is None:
        save_binaries = config.get_bool("FCN_BINARIZER_SAVE_BINARY", True)
    save_dir = (config.get_str("FCN_BINARIZER_SAVE_BINARY_PATH", ".")
                if save_binaries else None)

    binarize_keyframes(binarizer, binarized_keyframes, save_dir)

    evaluator = Evaluator(params)
    scope_metrics, scopes = evaluator.compute_summary_metrics(
        fake_segments, all_keyframes, fake_groups, fake_cc_group,
        fake_segments, binarized_keyframes)

    pixel_metrics = Evaluator.compute_pixel_binary_metrics(
        all_keyframes, binarized_keyframes)

    return scope_metrics, scopes, pixel_metrics


def print_keyframe_bin_report(scope_metrics, scopes, pixel_metrics) -> None:
    for scope in scopes:
        print(f"\nMetrics for scope: {scope}")
        print("      \t      \tRecall\t      \t       \tPrecision")
        print("Min R.\tMin P.\tE + P\tE. Only\tP. Only\tE + P\tE. Only\t"
              "P. Only\tBG. %\tNo BG P.")
        for entry in scope_metrics[scope]:
            r = entry["recall_metrics"]
            p = entry["precision_metrics"]
            print(f"{entry['min_cc_recall'] * 100:.2f}\t"
                  f"{entry['min_cc_precision'] * 100:.2f}\t"
                  f"{r['recall'] * 100:.2f}\t"
                  f"{r['only_exact_recall'] * 100:.2f}\t"
                  f"{r['only_partial_recall'] * 100:.2f}\t"
                  f"{p['precision'] * 100:.2f}\t"
                  f"{p['only_exact_precision'] * 100:.2f}\t"
                  f"{p['only_partial_precision'] * 100:.2f}\t"
                  f"{p['global_bg_unmatched'] * 100:.2f}\t"
                  f"{p['no_bg_precision'] * 100:.2f}")

    print("Pixel level metrics")
    for key in sorted(pixel_metrics):
        print(f"{key}\t{pixel_metrics[key] * 100:.2f}")


def main(argv=None):
    argv = sys.argv if argv is None else argv
    positional, device = cli_args(argv[1:])
    if len(positional) < 3:
        print(f"Usage: python {argv[0]} config model dataset [-device cpu]")
        print("\tdataset: 0 - training, 1 - testing")
        return

    from ..core.backend_probe import ensure_backend

    device = resolve_device(device)
    ensure_backend(device=device)
    config = Config.from_file(positional[0])
    dataset_name = "training" if int(positional[2]) == 0 else "testing"

    start = time.time()
    scope_metrics, scopes, pixel_metrics = evaluate_keyframe_binarization(
        config, positional[1], dataset_name, device=device)
    print_keyframe_bin_report(scope_metrics, scopes, pixel_metrics)
    print(f"Total time: {time.time() - start:.2f}s")
    return scope_metrics, scopes, pixel_metrics


if __name__ == "__main__":
    main()
