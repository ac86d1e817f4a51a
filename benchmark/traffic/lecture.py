"""Seeded synthetic board lectures and training keyframes.

A frozen rewrite of ``lecturemath_tpu_torch/utils/synthetic.py`` (its glyph
plan, ``_make_glyph`` and ``_plan_glyphs``, as of commit 2c9f9f7), kept here
so that no change to the program moves the benchmark's inputs. Changes from
it: every glyph keeps one ink texture for its life (the program's source
redraws the ink of the whole board at every content change), and every
distinct frame is rendered once, in set-up, and shared by the frames of its
content segment, so feeding a lecture costs no rendering.

A lecture is ``n_boards`` eras; each writes ``glyphs_per_board`` glyphs at
staggered times and is erased at the era's end (the segment boundaries a
summary should find). Frames are uint8 RGB: dark ink (35 +- 10) on a light
board (230 +- 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Glyph:
    mask: np.ndarray        # bool [h, w]
    ink: np.ndarray         # uint8 [h, w, 3]
    x: int
    y: int
    t_write: int
    t_erase: Optional[int]


def _make_glyph(rng: np.random.Generator, max_h: int,
                max_w: int) -> np.ndarray:
    """A connected blob: a filled rectangle with up to three corner notches."""
    h = int(rng.integers(8, max_h))
    w = int(rng.integers(8, max_w))
    mask = np.ones((h, w), dtype=bool)
    for _ in range(int(rng.integers(0, 4))):
        nh = int(rng.integers(1, max(2, h // 3)))
        nw = int(rng.integers(1, max(2, w // 3)))
        corner = rng.integers(0, 4)
        rows = slice(None, nh) if corner in (0, 1) else slice(-nh, None)
        cols = slice(None, nw) if corner in (0, 2) else slice(-nw, None)
        mask[rows, cols] = False
    return mask


def plan_glyphs(rng: np.random.Generator, n_frames: int, height: int,
                width: int, n_boards: int, glyphs_per_board: int,
                glyph_size: Tuple[int, int]):
    """Glyphs on a coarse grid (they never touch), each written in the first
    half of its era and erased at the era's end. Returns (glyphs, erase
    times)."""
    max_h, max_w = glyph_size
    era_len = n_frames // n_boards
    cell_h, cell_w = max_h + 4, max_w + 4
    rows = max(1, (height - 4) // cell_h)
    cols = max(1, (width - 4) // cell_w)
    cells = [(r, c) for r in range(rows) for c in range(cols)]
    glyphs: List[Glyph] = []
    erase_times: List[int] = []
    for board in range(n_boards):
        t0 = board * era_len
        t1 = (board + 1) * era_len if board + 1 < n_boards else None
        if t1 is not None:
            erase_times.append(t1)
        rng.shuffle(cells)
        for k in range(min(glyphs_per_board, len(cells))):
            r, c = cells[k]
            mask = _make_glyph(rng, max_h, max_w)
            h, w = mask.shape
            x = 2 + c * cell_w + int(rng.integers(0, max(1, cell_w - w - 1)))
            y = 2 + r * cell_h + int(rng.integers(0, max(1, cell_h - h - 1)))
            t_write = t0 + int(rng.integers(0, max(1, era_len // 2)))
            ink = np.clip(rng.normal(35.0, 10.0, mask.shape + (3,)), 0, 255)
            glyphs.append(Glyph(mask, ink.astype(np.uint8), x, y, t_write, t1))
    return glyphs, erase_times


class Lecture:
    """Every frame of a seeded lecture, rendered once: ``frames[t]`` is the
    uint8 RGB frame at sample ``t`` (frames of one content segment are one
    array), ``ink(t)`` its ground-truth ink mask."""

    def __init__(self, seed: int, n_frames: int = 300, height: int = 1080,
                 width: int = 1920, n_boards: int = 3,
                 glyphs_per_board: int = 120,
                 glyph_size: Tuple[int, int] = (40, 60)):
        rng = np.random.default_rng(seed)
        self.glyphs, self.erase_times = plan_glyphs(
            rng, n_frames, height, width, n_boards, glyphs_per_board,
            glyph_size)
        self.n_frames, self.height, self.width = n_frames, height, width
        self.n_boards = n_boards
        noise = rng.standard_normal((height, width, 3), dtype=np.float32)
        self.background = np.clip(230.0 + 4.0 * noise, 0, 255).astype(np.uint8)
        events = {0}
        for glyph in self.glyphs:
            events.add(glyph.t_write)
            if glyph.t_erase is not None:
                events.add(glyph.t_erase)
        changes = sorted(t for t in events if 0 <= t < n_frames)
        self.frames: List[np.ndarray] = []
        current = None
        for t in range(n_frames):
            if t in changes:
                current = self.background.copy()
                for glyph in self._visible(t):
                    h, w = glyph.mask.shape
                    region = current[glyph.y:glyph.y + h, glyph.x:glyph.x + w]
                    region[glyph.mask] = glyph.ink[glyph.mask]
            self.frames.append(current)

    def _visible(self, t: int):
        return [g for g in self.glyphs if g.t_write <= t
                and (g.t_erase is None or t < g.t_erase)]

    def ink(self, t: int) -> np.ndarray:
        """Ground truth of frame ``t``: bool [H, W], True on ink."""
        mask = np.zeros((self.height, self.width), dtype=bool)
        for glyph in self._visible(t):
            h, w = glyph.mask.shape
            mask[glyph.y:glyph.y + h, glyph.x:glyph.x + w] |= glyph.mask
        return mask


def keyframes(seed: int, count: int, height: int = 1080, width: int = 1920,
              glyphs: int = 120, glyph_size: Tuple[int, int] = (40, 60)):
    """``count`` board keyframes, each a full board of ``glyphs`` glyphs, with
    their ground truth in the training polarity (ink 0 on 255). Returns
    (list of uint8 RGB [H, W, 3], list of uint8 [H, W])."""
    lecture = Lecture(seed, n_frames=count, height=height, width=width,
                      n_boards=count, glyphs_per_board=glyphs,
                      glyph_size=glyph_size)
    images = [lecture.frames[t] for t in range(count)]
    truths = [np.where(lecture.ink(t), 0, 255).astype(np.uint8)
              for t in range(count)]
    return images, truths
