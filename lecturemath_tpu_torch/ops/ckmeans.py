"""Convolutional (spherical) K-means for image-patch features, in PyTorch
on the caller's device (the card unless the caller asks for the CPU).

Semantics match the reference ConvolutionalKMeans (reference:
AccessMath/util/ckmean.py:18-150): cosine-similarity assignment, centers
updated as similarity-weighted means and re-normalized; convergence measured
by the mean dot product between old and new centers. Assignment and update
are two matmuls, as in the JAX package: the similarities, then the
similarity-weighted one-hot rows times the data. ``argmax`` ties go to the
first center.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device


def _normalize_rows(mat: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(mat, dim=1, keepdim=True)
    return torch.where(norms > 0.0, mat / norms, mat)


def _update(centers: torch.Tensor, data: torch.Tensor,
            data_norms: torch.Tensor, k: int):
    cos_sim = (data @ centers.T) / (
        data_norms[:, None]
        * torch.linalg.vector_norm(centers, dim=1)[None, :])
    best = torch.argmax(cos_sim, dim=1)
    best_sim = torch.gather(cos_sim, 1, best[:, None])[:, 0]

    one_hot = torch.nn.functional.one_hot(best, k).to(data.dtype)  # [N, K]
    weights = one_hot * best_sim[:, None]                 # similarity-weighted
    weighted_sums = weights.T @ data                      # [K, D]
    total_weights = weights.sum(dim=0)                    # [K]

    updated = torch.where(
        total_weights[:, None] > 0.0,
        weighted_sums / torch.clamp_min(total_weights, 1e-12)[:, None],
        centers)
    updated = _normalize_rows(updated)
    similarity = torch.sum(centers * updated, dim=1).mean()
    return updated, similarity


class ConvolutionalKMeans:
    """``data`` and ``centers`` live on ``device`` (None: the card)."""

    def __init__(self, data: np.ndarray, k: int, seed: int = 0,
                 init_vectors: np.ndarray = None, verbose: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        data = np.asarray(data)
        if data.dtype not in (np.float32, np.float64):
            raise TypeError("K-means data must be floating point")
        self.device = resolve_device(device)
        self.data = torch.as_tensor(data, dtype=torch.float32,
                                    device=self.device)
        self.k = k
        self.verbose = verbose
        self._data_norms = torch.linalg.vector_norm(self.data, dim=1)

        if init_vectors is None:
            rng = np.random.default_rng(seed)
            rows = rng.choice(len(data), size=k, replace=False)
            init_vectors = data[rows]
        elif len(init_vectors) < k:
            raise ValueError("not enough init vectors for selected K")
        else:
            rng = np.random.default_rng(seed)
            rows = rng.choice(len(init_vectors), size=k, replace=False)
            init_vectors = np.asarray(init_vectors)[rows]

        self.centers = _normalize_rows(torch.as_tensor(
            np.asarray(init_vectors), dtype=torch.float32,
            device=self.device))

    def update(self) -> float:
        self.centers, similarity = _update(self.centers, self.data,
                                           self._data_norms, self.k)
        return float(similarity)

    def execute(self, max_iterations: int = 1000,
                min_similarity: float = 1.0) -> Tuple[int, float]:
        similarity = 0.0
        iterations = 0
        while iterations < max_iterations and similarity < min_similarity:
            similarity = self.update()
            iterations += 1
            if self.verbose:
                print(f"it {iterations}, mean similarity: {similarity:.10f}")
        return iterations, similarity

    def assign(self, data: np.ndarray) -> np.ndarray:
        data = torch.as_tensor(np.asarray(data), dtype=torch.float32,
                               device=self.device)
        cos_sim = (data @ self.centers.T) / (
            torch.linalg.vector_norm(data, dim=1, keepdim=True) *
            torch.linalg.vector_norm(self.centers, dim=1)[None, :])
        return torch.argmax(cos_sim, dim=1).cpu().numpy()
