"""Device selection for the port's entry points: ``cuda`` unless the caller
asks for the CPU. There is no silent fallback: asking for ``cuda`` without a
card raises."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for and missing,
    and for device types other than cuda and cpu."""
    if device is not None and not isinstance(device, (str, torch.device)):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda."
                           "is_available() is False; pass device='cpu' "
                           "(CLI: -device cpu) to run on the CPU")
    return dev
