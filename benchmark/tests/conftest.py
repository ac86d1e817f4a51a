"""Shared fixtures of the benchmark's tests: tiny sizes for CPU runs of a
cell, and the card check of the tests marked ``cuda``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# widths small enough for the CPU; the cells' own are in configs/
TINY = {"down_filters": [8, 16, 16, 32, 32], "mid_filters": 32,
        "upsample_filters": [8, 8, 16, 16, 32],
        "up_filters": [8, 8, 16, 16, 32], "pixel_features": [8, 8]}


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
