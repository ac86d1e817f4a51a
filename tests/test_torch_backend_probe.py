"""The port's fail-fast device probe (lecturemath_tpu_torch.core.
backend_probe) and the bounded device fetch of its Binarizer: the scenarios
of tests/test_backend_probe.py, with the CUDA probe in place of
jax.devices(). The port has no multi-host contract yet (ROADMAP queue 1,
item 10); its place is taken by the CPU request, which never touches
CUDA."""

import time

import numpy as np
import pytest
import torch

from lecturemath_tpu_torch.core import backend_probe
from lecturemath_tpu_torch.core.backend_probe import (BackendUnavailable,
                                                      call_with_deadline,
                                                      ensure_backend)


def test_healthy_backend_passes(monkeypatch):
    calls = []
    monkeypatch.setattr(backend_probe, "_probe_cuda",
                        lambda device: calls.append(device) or "a card")
    ensure_backend(timeout_s=60)
    assert calls == [torch.device("cuda")]
    ensure_backend(timeout_s=60, device="cuda:1")
    assert calls[-1] == torch.device("cuda:1")


def test_raising_backend_is_reported(monkeypatch):
    def boom(device):
        raise RuntimeError("CUDA driver initialization failed")

    monkeypatch.setattr(backend_probe, "_probe_cuda", boom)
    with pytest.raises(BackendUnavailable, match="failed to initialize"):
        ensure_backend(timeout_s=5)
    with pytest.raises(BackendUnavailable, match="-device cpu"):
        ensure_backend(timeout_s=5)     # the hint names the workaround


def test_hanging_backend_times_out(monkeypatch):
    monkeypatch.setattr(backend_probe, "_probe_cuda",
                        lambda device: time.sleep(30))
    start = time.time()
    with pytest.raises(BackendUnavailable, match="hanging"):
        ensure_backend(timeout_s=0.3)
    assert time.time() - start < 5      # bounded, not the full sleep


def test_cpu_request_never_touches_cuda(monkeypatch):
    def boom(*args):
        raise AssertionError("the probe must not touch CUDA")

    monkeypatch.setattr(backend_probe, "_probe_cuda", boom)
    monkeypatch.setattr(torch.cuda, "init", boom)
    ensure_backend(timeout_s=5, device="cpu")
    ensure_backend(timeout_s=5, device=torch.device("cpu"))


def test_probe_opt_out(monkeypatch):
    def boom(device):
        raise RuntimeError("should never be called")

    monkeypatch.setattr(backend_probe, "_probe_cuda", boom)
    ensure_backend(timeout_s=0)         # explicit skip
    monkeypatch.setenv("LM_DEVICE_PROBE_TIMEOUT_S", "0")
    ensure_backend()                    # env skip


def test_real_probe_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(BackendUnavailable, match="failed to initialize"):
        ensure_backend(timeout_s=30)


def test_call_with_deadline_relays_value_and_error():
    assert call_with_deadline(lambda: 7, 5, "x") == 7
    with pytest.raises(KeyError):
        call_with_deadline(lambda: {}["missing"], 5, "x")


def test_binarizer_fetch_is_bounded(monkeypatch):
    """A card dying mid-run leaves the copy's event wait hung: the
    Binarizer's fetch must raise an actionable error, not stall."""
    from lecturemath_tpu_torch.models.fcn_lecturenet import (FCNConfig,
                                                             FCNLectureNet)
    from lecturemath_tpu_torch.pipeline import binarize as port_binarize
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer

    config = FCNConfig(down_filters=(2, 3, 4, 5, 6), mid_filters=6,
                       upsample_filters=(2, 3, 4, 5, 6),
                       up_filters=(2, 3, 4, 5, 6), pixel_features=(3, 2),
                       kernel_size=3, pixel_kernel_size=3)
    binarizer = Binarizer(FCNLectureNet(config), device="cpu",
                          upload_format="rgb")
    tensor = torch.arange(4, dtype=torch.uint8).reshape(2, 2)
    # healthy path first
    np.testing.assert_array_equal(binarizer.fetch(tensor), tensor.numpy())

    monkeypatch.setattr(port_binarize, "_wait_host_copy",
                        lambda host, done: time.sleep(30))
    monkeypatch.setenv("LM_FETCH_TIMEOUT_S", "0.3")
    start = time.time()
    with pytest.raises(BackendUnavailable, match="fetch hung"):
        binarizer.fetch(tensor)
    assert time.time() - start < 5

    def boom(host, done):
        raise RuntimeError("transport dead")

    monkeypatch.setenv("LM_FETCH_TIMEOUT_S", "5")
    monkeypatch.setattr(port_binarize, "_wait_host_copy", boom)
    with pytest.raises(RuntimeError, match="transport dead"):
        binarizer.fetch(tensor)
    # <= 0 disables the deadline: the wait runs on the caller's thread
    monkeypatch.setenv("LM_FETCH_TIMEOUT_S", "0")
    with pytest.raises(RuntimeError, match="transport dead"):
        binarizer.fetch(tensor)
