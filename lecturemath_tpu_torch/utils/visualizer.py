"""Headless visualization renderers for debugging and evaluation output.

Covers the reference's match/debug image generators (reference:
AccessMath/util/visualizer.py, evaluator.py:678-697, ST3D_visualizer
rendering — the pygame GUI shells are out of scope, these produce the same
images to files)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..data.cc import CC
from ..data.space_time import SpaceTimeStruct


def combine_binary_images(first: np.ndarray, second: np.ndarray,
                          disp_x: int = 0, disp_y: int = 0,
                          content_lum: int = 0) -> np.ndarray:
    """Overlay two binary frames after displacement: first in red, second in
    green, agreement in yellow."""
    h, w = first.shape
    canvas = np.zeros((h, w, 3), dtype=np.uint8)
    ink1 = first == content_lum
    shifted = np.zeros_like(ink1)
    src = second == content_lum
    y0, y1 = max(0, disp_y), h + min(0, disp_y)
    x0, x1 = max(0, disp_x), w + min(0, disp_x)
    shifted[y0:y1, x0:x1] = src[max(0, -disp_y):h + min(0, -disp_y),
                                max(0, -disp_x):w + min(0, -disp_x)]
    canvas[ink1, 2] = 255
    canvas[shifted, 1] = 255
    return canvas


def paint_ccs(canvas: np.ndarray, ccs: Sequence[CC], channel: int,
              disp_x: int = 0, disp_y: int = 0) -> None:
    h, w = canvas.shape[:2]
    for cc in ccs:
        y0 = max(0, cc.min_y + disp_y)
        x0 = max(0, cc.min_x + disp_x)
        y1 = min(h, cc.max_y + disp_y + 1)
        x1 = min(w, cc.max_x + disp_x + 1)
        if y1 <= y0 or x1 <= x0:
            continue
        crop = cc.img[y0 - (cc.min_y + disp_y):y1 - (cc.min_y + disp_y),
                      x0 - (cc.min_x + disp_x):x1 - (cc.min_x + disp_x)]
        region = canvas[y0:y1, x0:x1, channel]
        np.maximum(region, crop, out=region)


def gt_match_image(height: int, width: int, exact: Sequence[CC],
                   partial: Sequence[CC], unmatched: Sequence[CC]) -> np.ndarray:
    """GT keyframe match visualization: exact green, partial yellow-ish,
    unmatched red (reference: Visualizer.show_gt_matches)."""
    canvas = np.zeros((height, width, 3), dtype=np.uint8)
    paint_ccs(canvas, exact, 1)
    paint_ccs(canvas, partial, 1)
    paint_ccs(canvas, partial, 2)
    paint_ccs(canvas, unmatched, 2)
    return canvas


def keyframe_match_image(height: int, width: int, exact, partial,
                         unmatched_gt: Sequence[CC],
                         unmatched_summ: Sequence[CC],
                         disp_x: int = 0, disp_y: int = 0) -> np.ndarray:
    """GT-vs-summary match visualization (reference:
    Visualizer.show_keyframes_matches): matched content green, missed GT
    red, spurious summary blue."""
    canvas = np.zeros((height, width, 3), dtype=np.uint8)
    for match in exact + partial:
        paint_ccs(canvas, match.frame1_ccs, 1)
        paint_ccs(canvas, match.frame2_ccs, 1, disp_x, disp_y)
    paint_ccs(canvas, unmatched_gt, 2)
    paint_ccs(canvas, unmatched_summ, 0, disp_x, disp_y)
    return canvas


def st3d_frame_image(st3d: SpaceTimeStruct, frame_pos: int,
                     groups: Optional[Sequence[int]] = None) -> np.ndarray:
    """Render the grouped content visible at one sampled frame
    (the ST3D_Visualizer view, headless)."""
    if groups is None:
        groups = [g for g, ages in st3d.group_ages.items()
                  if ages[0] <= frame_pos <= ages[-1]]
    canvas = np.zeros((st3d.height, st3d.width, 3), dtype=np.uint8)
    for gidx in groups:
        ages = st3d.group_ages[gidx]
        seg = 0
        while seg + 1 < len(ages) - 1 and ages[seg + 1] < frame_pos:
            seg += 1
        image = st3d.group_images[gidx][min(seg, len(st3d.group_images[gidx]) - 1)]
        min_x, max_x, min_y, max_y = st3d.group_boundaries[gidx]
        region = canvas[min_y:max_y + 1, min_x:max_x + 1]
        for channel in range(3):
            np.maximum(region[:, :, channel], image,
                       out=region[:, :, channel])
    return canvas


def signal_plot(signals: Dict[str, np.ndarray], out_path: str,
                intervals: Optional[Sequence] = None,
                title: str = "") -> str:
    """Matplotlib line plot of per-frame signals with optional interval
    boundary markers (stage-04 debug plots, pre_ST3D_v3.0_04:174-217)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6), dpi=120)
    for name, signal in signals.items():
        ax.plot(np.arange(len(signal)), signal, label=name)
    if intervals:
        top = max(float(np.max(s)) for s in signals.values())
        for start, end in intervals:
            ax.axvline(start, color="g", linewidth=1)
            ax.axvline(end, color="r", linewidth=1)
        del top
    ax.legend()
    if title:
        ax.set_title(title)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def put_label(img: np.ndarray, text: str, origin, scale: float,
              color) -> bool:
    """``cv2.putText(img, text, origin, cv2.FONT_HERSHEY_PLAIN, scale,
    color, 1)`` where OpenCV is installed. The Hershey font has no port, so
    without OpenCV the label is left out of the (preview) image. Returns
    whether it was drawn."""
    try:
        import cv2
    except ImportError:
        return False
    cv2.putText(img, text, origin, cv2.FONT_HERSHEY_PLAIN, scale, color, 1)
    return True
