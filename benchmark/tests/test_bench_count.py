"""count.py against a hand count of FCN-LectureNet's convolutions at the
BIN_V34 widths."""

import json
import os

import pytest

from benchmark import count
from benchmark.harness import HERE
from benchmark.traffic.weights import net_widths


@pytest.fixture
def net():
    with open(os.path.join(HERE, "configs", "lecturenet-bin.json")) as f:
        return net_widths(json.load(f))


def test_heads_per_pixel(net):
    # 2 * 49 * (32*1 + 35*32 + 35*16 + 19*1)
    assert sum(count.head_flops_per_pixel(net).values()) == 169_638


def test_trunk_per_pixel(net):
    down = 2 * 9 * (3 * 48 + 48 * 96 / 4 + 96 * 192 / 16 + 192 * 384 / 64
                    + 384 * 768 / 256 + 768 * 768 / 1024)
    deconvs = 2 * (768 * 384 / 256 + 384 * 192 / 64 + 192 * 96 / 16
                   + 96 * 48 / 4 + 48 * 32)
    ups = 2 * 9 * (1152 * 384 / 256 + 576 * 192 / 64 + 288 * 96 / 16
                   + 144 * 48 / 4 + 80 * 32)
    rec = 2 * 9 * 32 * 3
    assert count.trunk_flops_per_pixel(net) == down + deconvs + ups + rec
    assert count.trunk_flops_per_pixel(net) == 280_416


def test_k2_heads_at_960x544_batch_96(net):
    # the K2 figure of the port's kernel table: 8.5 TFLOP
    assert count.heads_flops(net, 540, 960) * 96 == pytest.approx(8.5e12,
                                                                  rel=2e-3)


def test_frame_and_step(net):
    assert count.forward_flops(net, 1080, 1920) == pytest.approx(
        (280_416 + 169_638) * 1088 * 1920)
    assert count.train_step_flops(net, 1, 256, 256) == pytest.approx(
        3 * 450_054 * 65536)


def test_k1_bytes():
    # f32 logits of the crop read once, the packed rows written once
    assert count.k1_bytes(96, 540, 960) == 96 * 540 * (4 * 960 + 120)
