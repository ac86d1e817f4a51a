"""Seeded synthetic scene-text images in the shape of COCO-Text's training
pairs: the text-detector phase's data.

COCO-Text (ICDAR 2017) marks the words of MS-COCO photos with polygons,
and the program's ``cli/prepare_cocotext.py`` rasterises them into masks,
text 255 on 0. Its 2017 release holds about 43,700 training images, mostly
640x480 or 480x640, and 239,506 words over 63,686 images (3.8 an image). A
scene stands in for one such pair:

  * its size drawn from ``sizes_hw`` (640x480, 480x640, 640x427, 427x640);
  * the background a smooth colour field (a 3x4 grid of colours
    interpolated over the image), with texture (a patch of a smoothed noise
    tile that the run's scenes share) and ``shapes`` filled rectangles and
    ellipses of other colours;
  * ``words`` (a Poisson count of mean ``words_mean``, at most
    ``words_max``), each a row of glyphs (``lecture.py``'s blobs) of one
    height in ``glyph_height`` and one colour that stands off the
    background beneath it;
  * the mask: each word's box filled 255 on 0.

Each scene draws from a generator of its own, seeded from the run's seed
and its index, so any one can be rendered alone and in any order:
``write`` renders and writes them all, and ``Scenes`` renders the few a
reader asks for.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Tuple

import numpy as np

from benchmark.traffic import pngio
from benchmark.traffic.lecture import _make_glyph

# the shared texture tile's side, at least every size's larger side
TILE = 768


@functools.lru_cache(maxsize=4)
def texture(seed: int) -> np.ndarray:
    """The run's texture tile: float32 [TILE, TILE, 3], normal noise summed
    over a 5x5 box and divided by 5 (so of unit variance), the same in the
    three channels, read-only."""
    rng = np.random.default_rng([int(seed), 1 << 40])
    noise = rng.standard_normal((TILE + 4, TILE + 4), dtype=np.float32)
    rows = np.cumsum(np.pad(noise, ((1, 0), (0, 0))), axis=0)
    rows = rows[5:] - rows[:-5]
    cols = np.cumsum(np.pad(rows, ((0, 0), (1, 0))), axis=1)
    tile = np.repeat(((cols[:, 5:] - cols[:, :-5]) / 5.0)[:, :, None], 3,
                     axis=2)
    tile.setflags(write=False)
    return tile


def _lerp(n: int, k: int) -> np.ndarray:
    """float32 [n, k]: each of n points spread evenly over k knots, as the
    weights of its two nearest knots."""
    t = np.linspace(0.0, k - 1.0, n)
    low = np.minimum(t.astype(np.int64), k - 2)
    frac = (t - low).astype(np.float32)
    out = np.zeros((n, k), np.float32)
    out[np.arange(n), low] = 1.0 - frac
    out[np.arange(n), low + 1] = frac
    return out


def _background(rng: np.random.Generator, seed: int, h: int, w: int,
                shapes: Tuple[int, int]) -> np.ndarray:
    # the colours of the grid's knots, [row, column, channel], spread over
    # the columns and then the rows by two matrix products
    grid = rng.uniform(30.0, 225.0, (3, 4, 3)).astype(np.float32)
    across = (_lerp(w, 4) @ grid.transpose(1, 0, 2).reshape(4, 9)).reshape(
        w, 3, 3)
    img = (_lerp(h, 3) @ across.transpose(1, 0, 2).reshape(3, w * 3)
           ).reshape(h, w, 3)
    y0 = int(rng.integers(0, TILE - h + 1))
    x0 = int(rng.integers(0, TILE - w + 1))
    img += np.float32(rng.uniform(5.0, 25.0)) * texture(seed)[
        y0:y0 + h, x0:x0 + w]
    for _ in range(int(rng.integers(shapes[0], shapes[1] + 1))):
        colour = rng.uniform(0.0, 255.0, 3).astype(np.float32)
        sh = int(rng.integers(h // 10, h // 2))
        sw = int(rng.integers(w // 10, w // 2))
        top = int(rng.integers(0, h - sh))
        left = int(rng.integers(0, w - sw))
        region = img[top:top + sh, left:left + sw]
        if rng.random() < 0.5:
            region[:] = colour
        else:
            yy = (np.arange(sh, dtype=np.float32)[:, None] + 0.5) / sh - 0.5
            xx = (np.arange(sw, dtype=np.float32)[None, :] + 0.5) / sw - 0.5
            region[yy * yy + xx * xx <= 0.25] = colour
    return img


def _word(rng: np.random.Generator, img: np.ndarray, mask: np.ndarray,
          glyph_height: Tuple[int, int]) -> None:
    """One word painted into ``img`` and its box into ``mask``."""
    h, w = mask.shape
    height = int(rng.integers(glyph_height[0], glyph_height[1] + 1))
    gap = max(1, height // 6)
    glyphs = [_make_glyph(rng, height + 1, max(9, 3 * height // 4 + 1))
              for _ in range(int(rng.integers(2, 9)))]
    while len(glyphs) > 1 and (sum(g.shape[1] for g in glyphs)
                               + gap * (len(glyphs) - 1)) > w - 2:
        glyphs.pop()
    width = sum(g.shape[1] for g in glyphs) + gap * (len(glyphs) - 1)
    top = int(rng.integers(0, h - height + 1))
    left = int(rng.integers(0, w - width + 1))
    box = img[top:top + height, left:left + width]
    dark = float(box.mean()) > 128.0
    colour = rng.uniform(0.0, 70.0, 3) if dark else rng.uniform(185.0,
                                                                 255.0, 3)
    x = 0
    for glyph in glyphs:
        gh, gw = glyph.shape
        box[height - gh:, x:x + gw][glyph] = colour
        x += gw + gap
    mask[top:top + height, left:left + width] = 255


def scene(seed: int, index: int, traffic: Dict
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Scene ``index`` of the run seeded ``seed``: (uint8 RGB [H, W, 3],
    uint8 mask [H, W], words 255 on 0)."""
    rng = np.random.default_rng([int(seed), int(index)])
    sizes = traffic["sizes_hw"]
    h, w = (int(v) for v in sizes[int(rng.integers(len(sizes)))])
    img = _background(rng, seed, h, w, tuple(traffic["shapes"]))
    mask = np.zeros((h, w), np.uint8)
    words = min(int(rng.poisson(traffic["words_mean"])),
                int(traffic["words_max"]))
    for _ in range(words):
        _word(rng, img, mask, tuple(traffic["glyph_height"]))
    np.clip(img, 0.0, 255.0, out=img)
    return img.astype(np.uint8), mask


def write(seed: int, count: int, traffic: Dict, directory: str
          ) -> Tuple[List[str], List[str]]:
    """Scenes 0 to ``count - 1`` and their masks as PNG files in
    ``directory``, stored without compression (zlib level 0, so that 2,048
    pairs are written and read again in seconds). Returns (image paths,
    mask paths). One thread renders and writes them all: on a host whose
    share of its cores is small, threads and processes only contend."""
    images, masks = [], []
    for index in range(count):
        for paths, name, array in zip(
                (images, masks), (f"{index:04d}.png", f"{index:04d}_gt.png"),
                scene(seed, index, traffic)):
            paths.append(os.path.join(directory, name))
            with open(paths[-1], "wb") as f:
                f.write(pngio.encode(array, level=0))
    return images, masks


class Scenes:
    """The scenes of one seed, each rendered when first read: ``images``
    and ``masks`` are sequences of ``count``."""

    def __init__(self, seed: int, count: int, traffic: Dict):
        self.seed, self.count, self.traffic = seed, count, traffic
        self._made: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.images, self.masks = _Part(self, 0), _Part(self, 1)

    def pair(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        if index not in self._made:
            self._made[index] = scene(self.seed, index, self.traffic)
        return self._made[index]


class _Part:
    def __init__(self, scenes: Scenes, part: int):
        self.scenes, self.part = scenes, part

    def __len__(self) -> int:
        return self.scenes.count

    def __getitem__(self, index) -> np.ndarray:
        return self.scenes.pair(int(index))[self.part]
