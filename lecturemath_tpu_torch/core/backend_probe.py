"""Fail fast when the card is unreachable.

A device entry point that hangs at its first CUDA call (a driver that does
not answer, a card lost mid-run) is indistinguishable from a slow start, so
the device-touching entry points first probe the card on a daemon thread
with a deadline and turn both failure modes, raising and hanging, into one
actionable error. The JAX package's probe does the same for its backend
(lecturemath_tpu/core/backend_probe.py).

The probe is near-free on a healthy card (CUDA initialises now instead of
moments later) and skippable with LM_DEVICE_PROBE_TIMEOUT_S=0.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Union

_HINT = ("retry when the card recovers, or run on the CPU with -device cpu "
         "(device='cpu')")


class BackendUnavailable(RuntimeError):
    """Device backend failed to initialize within the probe deadline."""


def call_with_deadline(fn, timeout_s: float, description: str):
    """Run ``fn()`` on a daemon thread with a deadline.

    Returns fn's value; re-raises fn's exception; raises
    BackendUnavailable("<description> still hanging after N s") when the
    deadline passes. The single home of the probe idiom — a hung backend
    call cannot be interrupted, only abandoned (the daemon thread dies
    with the process)."""
    result = {}

    def _run():
        try:
            result["value"] = fn()
        except Exception as err:    # noqa: BLE001 — re-raised below
            result["error"] = err

    thread = threading.Thread(target=_run, daemon=True,
                              name="lm-deadline-call")
    thread.start()
    thread.join(timeout=timeout_s)
    if "value" in result:
        return result["value"]
    if "error" in result:
        raise result["error"]
    raise BackendUnavailable(
        f"{description} still hanging after {timeout_s:.0f} s")


def _probe_cuda(device) -> str:
    """Initialise CUDA, read the card's properties and round-trip one
    element through its memory; returns the card's name."""
    import torch

    torch.cuda.init()
    properties = torch.cuda.get_device_properties(device)
    value = torch.ones(1, device=device).add_(1).item()
    if value != 2.0:
        raise RuntimeError(f"a one-element round trip through {device} "
                           f"returned {value}, not 2.0")
    return properties.name


def ensure_backend(timeout_s: Optional[float] = None,
                   device: Union[None, str, "torch.device"] = None) -> None:
    """Initialize CUDA on ``device`` (default: the current card), bounded by
    a deadline.

    Raises BackendUnavailable when init raises or is still hanging after
    ``timeout_s`` (default: LM_DEVICE_PROBE_TIMEOUT_S env, else 120 s;
    <= 0 skips the probe entirely). A no-op when the caller asked for the
    CPU. On success CUDA is initialised and every later call proceeds as
    usual.
    """
    import torch

    if device is not None and torch.device(device).type == "cpu":
        return
    if timeout_s is None:
        timeout_s = float(os.environ.get("LM_DEVICE_PROBE_TIMEOUT_S", "120"))
    if timeout_s <= 0:
        return
    target = torch.device("cuda" if device is None else device)

    try:
        call_with_deadline(lambda: _probe_cuda(target), timeout_s,
                           "CUDA device init")
    except BackendUnavailable as err:
        raise BackendUnavailable(f"{err} (card or driver hung?) — {_HINT}") \
            from None
    except Exception as err:    # noqa: BLE001 — reported, not dropped
        raise BackendUnavailable(
            f"CUDA device failed to initialize: {err} — {_HINT}") from err
