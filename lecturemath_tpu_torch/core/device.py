"""Device selection for the port's entry points: ``cuda`` unless the caller
asks for the CPU. There is no silent fallback: asking for ``cuda`` without a
card raises."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
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


def as_tensor(data: Union[np.ndarray, torch.Tensor],
              device: Optional[Union[str, torch.device]] = None
              ) -> torch.Tensor:
    """A tensor stays where it is; an array goes to ``device`` (None: the
    card, as ``resolve_device``)."""
    if isinstance(data, torch.Tensor):
        return data
    return torch.from_numpy(np.ascontiguousarray(data)).to(
        resolve_device(device))


def cli_args(args: Sequence[str]) -> Tuple[List[str], Optional[str]]:
    """Split a CLI's arguments (without the program name) into the
    positional ones before the first ``-key`` and the device that
    ``-device`` names (None: the card, once resolved)."""
    from .config import parse_cli_overrides

    args = list(args)
    cut = next((i for i, a in enumerate(args) if a.startswith("-")),
               len(args))
    device = parse_cli_overrides(args[cut:]).get("device")
    if device is not None and not isinstance(device, str):
        raise ValueError("-device requires a value (e.g. -device cpu)")
    return args[:cut], device
