"""The batch median of ``ops/median.py`` on the CPU: its plain version
against ``native.median_u8`` and the numpy median, what the wrapper refuses,
and the route the training data's medians take without a card. Kernel K4
itself is held to the plain version in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from lecturemath_tpu_torch import native
from lecturemath_tpu_torch.ops.median import median_u8_batch
from lecturemath_tpu_torch.utils import image as timage


def crops(pattern, shape, seed=0):
    """uint8 [B, H, W, C]: random bytes, one value, or 0/255 stripes
    (across the rows in the even images, down the columns in the odd)."""
    if pattern == "random":
        return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    if pattern == "constant":
        return np.full(shape, 173, np.uint8)
    out = np.zeros(shape, np.uint8)
    out[0::2, 0::3] = 255
    out[1::2, :, 0::2] = 255
    return out


@pytest.mark.parametrize("pattern", ["random", "constant", "stripes"])
@pytest.mark.parametrize("k", [3, 5, 35, 255])
@pytest.mark.parametrize("shape", [(2, 40, 30, 3), (2, 33, 20, 1),
                                   (1, 37, 53, 3)])
def test_plain_median_equals_native_and_numpy(shape, k, pattern,
                                              monkeypatch):
    batch = crops(pattern, shape, seed=k)
    ours = median_u8_batch(torch.from_numpy(batch), k)
    assert ours.dtype == torch.uint8 and tuple(ours.shape) == shape
    for index, img in enumerate(batch):
        np.testing.assert_array_equal(ours[index].numpy(),
                                      native.median_u8(img, k))
    monkeypatch.setattr(native, "available", lambda: False)
    for index, img in enumerate(batch[:1]):
        np.testing.assert_array_equal(ours[index].numpy(),
                                      timage.median_blur(img, k))


@pytest.mark.parametrize("bad,error", [
    (dict(k=4), ValueError), (dict(k=1), ValueError),
    (dict(k=257), ValueError), (dict(k=3.0), ValueError),
    (dict(dtype=torch.float32), TypeError), (dict(dtype=torch.int16), TypeError),
    (dict(shape=(8, 8, 3)), ValueError), (dict(shape=(1, 1, 8, 8, 3)), ValueError),
    (dict(transposed=True), ValueError), (dict(array=True), TypeError)],
    ids=["even-k", "k-1", "k-257", "float-k", "float32", "int16", "3-d", "5-d",
         "non-contiguous", "numpy"])
def test_median_u8_batch_refuses_what_it_does_not_take(bad, error):
    shape = bad.get("shape", (2, 8, 8, 3))
    tensor = torch.zeros(shape, dtype=bad.get("dtype", torch.uint8))
    if bad.get("transposed"):
        tensor = tensor.transpose(1, 2)
    if bad.get("array"):
        tensor = tensor.numpy()
    with pytest.raises(error):
        median_u8_batch(tensor, bad.get("k", 3))


def test_empty_batch_gives_an_empty_batch():
    out = median_u8_batch(torch.zeros((0, 4, 4, 3), dtype=torch.uint8), 3)
    assert tuple(out.shape) == (0, 4, 4, 3)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_median_route_without_a_card_is_the_hosts(route, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if route == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    assert timage.median_route() == route
