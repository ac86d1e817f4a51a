"""Procedural synthetic lectures with known write/erase events.

Used by the test suite as golden-input data (the reference ships no videos)
and by bench.py to generate deterministic workloads. A synthetic lecture is a
sequence of binary frames on which "glyphs" (connected blobs standing in for
handwritten symbols) appear at known times and are erased at known times;
erase events are the ground-truth segment boundaries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class SyntheticGlyph:
    mask: np.ndarray       # uint8 0/255 crop
    x: int                 # top-left placement
    y: int
    t_write: int           # first frame the glyph is visible
    t_erase: Optional[int]  # first frame the glyph is gone (None = stays)


def _make_glyph(rng: np.random.Generator, max_h: int, max_w: int) -> np.ndarray:
    """A connected blob: filled rectangle with random notches carved from the
    border (stays 4-connected), at least ~40 px."""
    h = int(rng.integers(8, max_h))
    w = int(rng.integers(8, max_w))
    mask = np.full((h, w), 255, dtype=np.uint8)
    # carve notches from corners/edges without disconnecting the interior
    for _ in range(int(rng.integers(0, 4))):
        nh = int(rng.integers(1, max(2, h // 3)))
        nw = int(rng.integers(1, max(2, w // 3)))
        corner = rng.integers(0, 4)
        if corner == 0:
            mask[:nh, :nw] = 0
        elif corner == 1:
            mask[:nh, -nw:] = 0
        elif corner == 2:
            mask[-nh:, :nw] = 0
        else:
            mask[-nh:, -nw:] = 0
    return mask


def _plan_glyphs(rng: np.random.Generator, n_frames: int, height: int,
                 width: int, n_boards: int, glyphs_per_board: int,
                 glyph_size: Tuple[int, int]):
    """Build the glyph write/erase plan (shared by the materializing
    synthetic_lecture and the streaming SyntheticRGBLectureSource; the rng
    consumption order here is load-bearing for seeded test workloads)."""
    max_h, max_w = glyph_size
    era_len = n_frames // n_boards
    glyphs: List[SyntheticGlyph] = []
    erase_times: List[int] = []

    # place glyphs on a coarse grid so they never touch
    cell_h = max_h + 4
    cell_w = max_w + 4
    rows = max(1, (height - 4) // cell_h)
    cols = max(1, (width - 4) // cell_w)
    cells = [(r, c) for r in range(rows) for c in range(cols)]

    for board in range(n_boards):
        t0 = board * era_len
        t1 = (board + 1) * era_len if board + 1 < n_boards else None
        if t1 is not None:
            erase_times.append(t1)
        rng.shuffle(cells)
        for k in range(min(glyphs_per_board, len(cells))):
            r, c = cells[k]
            mask = _make_glyph(rng, max_h, max_w)
            x = 2 + c * cell_w + int(rng.integers(0, max(1, cell_w - mask.shape[1] - 1)))
            y = 2 + r * cell_h + int(rng.integers(0, max(1, cell_h - mask.shape[0] - 1)))
            t_write = t0 + int(rng.integers(0, max(1, era_len // 2)))
            glyphs.append(SyntheticGlyph(mask, x, y, t_write, t1))
    return glyphs, erase_times


def render_binary_frame(glyphs: List[SyntheticGlyph], t: int, height: int,
                        width: int) -> np.ndarray:
    """Render the uint8 0/255 ink mask of frame ``t`` from a glyph plan."""
    frame = np.zeros((height, width), dtype=np.uint8)
    for glyph in glyphs:
        if glyph.t_write <= t and (glyph.t_erase is None or t < glyph.t_erase):
            h, w = glyph.mask.shape
            region = frame[glyph.y:glyph.y + h, glyph.x:glyph.x + w]
            np.maximum(region, glyph.mask, out=region)
    return frame


def synthetic_lecture(seed: int = 0, n_frames: int = 40, height: int = 96,
                      width: int = 128, n_boards: int = 2,
                      glyphs_per_board: int = 5, jitter: float = 0.0,
                      glyph_size: Tuple[int, int] = (16, 20)):
    """Generate a synthetic lecture.

    The timeline is split into ``n_boards`` eras; each era writes
    ``glyphs_per_board`` glyphs at staggered times, then everything is erased
    at the era boundary (the ground-truth segmentation split).

    Args:
      jitter: probability of dropping each foreground pixel per frame
        (exercises the partial-overlap matching thresholds).

    Returns:
      (frames, glyphs, erase_times): frames is uint8 [T, H, W] (0/255),
      glyphs is the placed glyph list, erase_times the era boundaries.
    """
    rng = np.random.default_rng(seed)
    glyphs, erase_times = _plan_glyphs(rng, n_frames, height, width,
                                       n_boards, glyphs_per_board, glyph_size)

    frames = np.zeros((n_frames, height, width), dtype=np.uint8)
    for t in range(n_frames):
        frames[t] = render_binary_frame(glyphs, t, height, width)
        if jitter > 0.0:
            drop = rng.random(frames[t].shape) < jitter
            frames[t][drop] = 0

    return frames, glyphs, erase_times


def threshold_binarizer_variables(net_config, seed: int = 0,
                                  threshold_gray: float = 130.0,
                                  sharpness: float = 4.0):
    """A state dict that makes FCN-LectureNet compute a deterministic
    per-pixel luminance threshold at FULL production compute cost.

    The trunk (encoder/decoder) gets a random xavier-normal init drawn from
    ``numpy.random.default_rng(seed)`` and runs in its entirety; only the
    head parameters are set so the binarization logit reduces to
    sharpness * (r + g + b - 3 * threshold) of the normalized input: the
    reconstruction head emits 0, the text head saturates its sigmoid at ~1
    (so diff_img == x0), the two pixel blocks emit constants, and the output
    conv reads just the diff channels through its center tap. The heads are
    those of lecturemath_tpu's threshold_binarizer_variables, so both
    packages binarize a frame alike whatever their trunks draw.

    Returns {name: torch.Tensor} for the port's FCNLectureNet
    (``strict=True``)."""
    import torch

    from ..models.fcn_lecturenet import FCNLectureNet

    rng = np.random.default_rng(seed)
    template = FCNLectureNet(net_config).state_dict()
    sd = {}
    for key, value in template.items():
        shape = tuple(value.shape)
        if key.endswith("num_batches_tracked"):
            sd[key] = np.zeros((), np.int64)
        elif key.endswith(".weight") and len(shape) == 4:
            # Conv2d (O, I, k, k) and ConvTranspose2d (I, O, k, k) alike:
            # fan_in + fan_out = (O + I) * k * k
            std = np.sqrt(2.0 / ((shape[0] + shape[1]) * shape[2] * shape[3]))
            sd[key] = rng.normal(0.0, std, shape).astype(np.float32)
        elif key.endswith(("running_var", ".weight")):
            sd[key] = np.ones(shape, np.float32)
        else:  # conv biases, BN biases, running means
            sd[key] = np.zeros(shape, np.float32)

    def neutral_bn(name, scale, bias):
        sd[f"{name}.weight"][:] = scale
        sd[f"{name}.bias"][:] = bias
        sd[f"{name}.running_mean"][:] = 0.0
        sd[f"{name}.running_var"][:] = 1.0

    def zero_conv(name):
        sd[f"{name}.weight"][:] = 0.0
        sd[f"{name}.bias"][:] = 0.0

    # reconstruction -> 0  (tanh(0)); text mask -> sigmoid(10) ~ 1
    zero_conv("conv_reconstruct.0")
    neutral_bn("conv_reconstruct.1", 1.0, 0.0)
    zero_conv("conv_text_mask_out.0")
    neutral_bn("conv_text_mask_out.1", 1.0, 10.0)

    # pixel blocks -> constants (GELU(1)); their outputs are ignored below
    for head in ("conv_pixels_1", "conv_pixels_2"):
        zero_conv(f"{head}.0")
        neutral_bn(f"{head}.1", 1.0, 1.0)

    # out_conv: center tap over the 3 diff channels only
    zero_conv("conv_out.0")
    center = net_config.pixel_kernel_size // 2
    sd["conv_out.0.weight"][0, :net_config.in_channels, center, center] = \
        sharpness
    t_norm = threshold_gray / 127.5 - 1.0
    neutral_bn("conv_out.1", 1.0,
               -sharpness * net_config.in_channels * t_norm)

    return {key: torch.from_numpy(value) for key, value in sd.items()}


class SyntheticRGBLectureSource:
    """Streaming full-lecture-scale RGB source: frames render on demand.

    A real AccessMath lecture is ~1 h sampled at 1 FPS — 3,000-5,500 frames
    at 1080p (reference: ACCESS2021_release/README.md:16, 34 lectures in
    lecture_data/db_LectureMath.xml). Materializing that as RGB would be
    >20 GB, so this source renders each frame when the pipeline asks for it
    (memory stays O(one frame)). Without jitter the frame content is
    piecewise-constant between glyph write/erase events, so renders are
    cached per content segment and the per-frame cost is a uint8 copy.

    A frame source: ``frames`` is all that stage 01 reads of it.
    """

    forced_resolution = None

    def __init__(self, seed: int = 0, n_frames: int = 3600,
                 height: int = 1080, width: int = 1920, n_boards: int = 10,
                 glyphs_per_board: int = 120,
                 glyph_size: Tuple[int, int] = (40, 60), fps: float = 1.0):
        rng = np.random.default_rng(seed)
        self.glyphs, self.erase_times = _plan_glyphs(
            rng, n_frames, height, width, n_boards, glyphs_per_board,
            glyph_size)
        self.n_frames = n_frames
        self.height = height
        self.width = width
        self.fps = fps
        self._seed = seed

        bg_rng = np.random.default_rng(seed + 1)
        background = np.full((height, width, 3), 230, dtype=np.float32)
        background += bg_rng.normal(0, 4, (height, width, 3))
        self._background = np.clip(background, 0, 255).astype(np.uint8)

        events = {0}
        for glyph in self.glyphs:
            events.add(glyph.t_write)
            if glyph.t_erase is not None:
                events.add(glyph.t_erase)
        self._changes = sorted(t for t in events if 0 <= t < n_frames)
        self._cache_segment = None
        self._cache = None

    # ------------------------------------------------------------ rendering

    def _segment_start(self, t: int) -> int:
        import bisect

        return self._changes[bisect.bisect_right(self._changes, t) - 1]

    def binary_frame(self, t: int) -> np.ndarray:
        """Ground-truth ink mask (0/255) of frame ``t`` at source size."""
        return render_binary_frame(self.glyphs, t, self.height, self.width)

    def rgb_frame(self, t: int) -> np.ndarray:
        segment = self._segment_start(t)
        if self._cache_segment != segment:
            binary = self.binary_frame(segment)
            frame = self._background.copy()
            ink = binary > 0
            ink_rng = np.random.default_rng((self._seed, segment))
            frame[ink] = np.clip(
                ink_rng.normal(35, 10, (int(ink.sum()), 3)), 0, 255
            ).astype(np.uint8)
            self._cache = frame
            self._cache_segment = segment
        return self._cache

    # ---------------------------------------------- VideoFrameSource surface

    def frames(self, frames_limit: int = 0):
        n = self.n_frames
        if frames_limit:
            n = min(n, frames_limit)
        for t in range(n):
            yield (t / self.fps) * 1000.0, t, self.rgb_frame(t)


def synthetic_rgb_lecture(seed: int = 0, n_frames: int = 8, height: int = 96,
                          width: int = 128, **kwargs):
    """Whiteboard-style RGB frames: light background, dark ink, mild noise.
    For exercising the binarization model end-to-end."""
    frames, glyphs, erase_times = synthetic_lecture(
        seed, n_frames, height, width, **kwargs)
    rng = np.random.default_rng(seed + 1)
    background = np.full((height, width, 3), 230, dtype=np.float32)
    background += rng.normal(0, 4, (height, width, 3))

    rgb = np.zeros((n_frames, height, width, 3), dtype=np.uint8)
    for t in range(n_frames):
        frame = background.copy()
        ink = frames[t] > 0
        frame[ink] = rng.normal(35, 10, (int(ink.sum()), 3))
        rgb[t] = np.clip(frame, 0, 255).astype(np.uint8)
    return rgb, frames, glyphs, erase_times
