"""The text-detector phase's training samples, worked out again in plain
NumPy and PyTorch from the scenes and the data seed: the reference's side
of the text-detector cell's data path.

A sample is ``augment.sample``'s (the published augmentation menu drawn in
the port's order: flips, the crop retried on the mask's zeros, inversion,
hue, noise; the raw mask over 255 as ``target``, and the text mask of the
mask's zeros under the ellipse) with one more target: the exact k x k
median of its augmented crop (``rec_data.median``, OpenCV's ``medianBlur``
with the border replicated), as lecturenet_train_01 makes it with
FCN_BINARIZER_PRETRAIN_REC_MEDIAN. It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from benchmark.reference.augment import sample
from benchmark.reference.rec_data import median


def first_batches(images: Sequence[np.ndarray], masks: Sequence[np.ndarray],
                  cfg: Dict, seed: int, count: int, device="cpu"
                  ) -> List[Dict]:
    """The first ``count`` batches of the first epoch: the order shuffled
    by the data seed's generator, then each sample drawn from it in turn.
    Each batch holds ``image``, ``target``, ``text_mask`` and ``median``,
    NHWC float32."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(images))
    rng.shuffle(order)
    size = cfg["batch_size"]
    batches = []
    for k in range(count):
        samples = [sample(rng, images[i], masks[i], cfg)
                   for i in order[k * size:(k + 1) * size]]
        batch = {key: np.stack([s[key] for s in samples])
                 for key in samples[0]}
        # the uint8 crop back from image = crop / 127.5 - 1 (the float32
        # round trip lies within 1e-4 of each whole value)
        crops = np.rint((batch["image"] + 1.0) * 127.5).astype(np.uint8)
        batch["median"] = np.stack([
            median(crop, cfg["median_k"], device) for crop in crops
        ]).astype(np.float32) / 127.5 - 1.0
        batches.append(batch)
    return batches
