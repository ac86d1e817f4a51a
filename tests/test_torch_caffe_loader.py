"""The port's caffe checkpoint reader (models/caffe_loader.py) against the
JAX package's: the same synthesized ``.caffemodel`` files (the encoder of
tests/test_caffe_loader.py) over its ``dims`` cases parse to the same
layers and blobs, and ``caffe_conv_to_flax`` gives the same flax layout,
which ``models/convert.py`` takes into the port's conv weight."""

import numpy as np
import pytest
import torch

from lecturemath_tpu.models.caffe_loader import (
    caffe_conv_to_flax as jax_caffe_conv_to_flax,
    load_caffemodel as jax_load_caffemodel)
from lecturemath_tpu_torch.models.caffe_loader import (CaffeModelLoader,
                                                       caffe_conv_to_flax,
                                                       iter_fields,
                                                       load_caffemodel)
from test_caffe_loader import _make_caffemodel


def _same_net(ours, theirs):
    assert ours["name"] == theirs["name"]
    assert len(ours["layers"]) == len(theirs["layers"])
    for mine, other in zip(ours["layers"], theirs["layers"]):
        assert {k: v for k, v in mine.items() if k != "blobs"} == \
            {k: v for k, v in other.items() if k != "blobs"}
        assert len(mine["blobs"]) == len(other["blobs"])
        for a, b in zip(mine["blobs"], other["blobs"]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dims", ["packed", "unpacked", "legacy"])
def test_caffemodel_round_trip_equals_jax(tmp_path, dims):
    rng = np.random.default_rng(3)
    conv_w = rng.normal(0, 1, (4, 3, 3, 3)).astype(np.float32)  # OIHW
    conv_b = rng.normal(0, 1, (4,)).astype(np.float32)
    path = str(tmp_path / "tiny.caffemodel")
    _make_caffemodel(path, conv_w, conv_b, dims)

    net = load_caffemodel(path)
    _same_net(net, jax_load_caffemodel(path))
    conv = net["layers"][0]
    np.testing.assert_array_equal(conv["blobs"][0], conv_w)
    np.testing.assert_array_equal(conv["blobs"][1], conv_b)

    ours = caffe_conv_to_flax(conv["blobs"][0], conv["blobs"][1])
    theirs = jax_caffe_conv_to_flax(conv["blobs"][0], conv["blobs"][1])
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype
        np.testing.assert_array_equal(ours[key], theirs[key])
    assert "bias" not in caffe_conv_to_flax(conv_w)

    # the flax kernel (kh, kw, I, O) is what models/convert.py takes back
    # to torch's (O, I, kh, kw): the conv it defines is the caffe one
    weight = torch.from_numpy(np.ascontiguousarray(
        np.transpose(ours["kernel"], (3, 2, 0, 1))))
    np.testing.assert_array_equal(weight.numpy(), conv_w)
    x = torch.from_numpy(rng.normal(0, 1, (1, 3, 8, 8)).astype(np.float32))
    torch.testing.assert_close(
        torch.nn.functional.conv2d(x, weight, torch.from_numpy(
            ours["bias"]), padding=1),
        torch.nn.functional.conv2d(x, torch.from_numpy(conv_w),
                                   torch.from_numpy(conv_b), padding=1),
        rtol=0, atol=0)


def test_loader_surface_and_wire_reader(tmp_path, capsys):
    conv_w = np.ones((2, 1, 1, 1), np.float32)
    path = str(tmp_path / "m.caffemodel")
    _make_caffemodel(path, conv_w, np.zeros((2,), np.float32))
    loader = CaffeModelLoader(path, model_def="deploy.prototxt")
    assert loader.getModel()["name"] == "TinyNet"
    _same_net(loader.get_model(), jax_load_caffemodel(path))
    out = capsys.readouterr().out
    assert "Loading" in out and "complete" in out
    # fixed64 / fixed32 records and an unknown wire type
    records = list(iter_fields(bytes([0x09]) + (7).to_bytes(8, "little")
                               + bytes([0x15]) + (9).to_bytes(4, "little")))
    assert records == [(1, 1, 7), (2, 5, 9)]
    with pytest.raises(ValueError, match="wire type"):
        list(iter_fields(bytes([0x0B])))
