"""Caffe checkpoint loader — no caffe (or protobuf) dependency.

The reference's CaffeModelLoader (reference:
AccessMath/util/caffe_model_loader.py:5) wraps ``caffe.Net`` to load a
legacy VGG text-detection ``.caffemodel``; the caffe framework is
unavailable in modern stacks (and the reference's own ``Parameters``
module it reads paths from does not ship). This module replaces the
capability natively: a ``.caffemodel`` file IS a binary-protobuf
``NetParameter`` message, so a ~100-line wire-format reader extracts every
layer's name/type and weight blobs as numpy arrays — enough to inspect a
legacy checkpoint or map its tensors into the model. ``caffe_conv_to_flax``
keeps the JAX package's flax layout, which ``models/convert.py
state_dict_from_flax`` takes into the port's state dict.

Wire format (protobuf encoding): a message is a sequence of
(key varint = field_number << 3 | wire_type, payload) records; wire types
0 = varint, 1 = fixed64, 2 = length-delimited (nested message / string /
packed repeated), 5 = fixed32. Fields used here:

  NetParameter:   1 name, 100 layer (LayerParameter), 2 layers (V1, legacy)
  LayerParameter: 1 name, 2 type, 7 blobs (BlobProto)
  V1LayerParameter: 1 name? -> (4 name, 5 type enum, 6 blobs)
  BlobProto:      7 shape (BlobShape: 1 repeated dim), 5 data (float,
                  packed or repeated), plus legacy dims
                  1 num / 2 channels / 3 height / 4 width
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


# ------------------------------------------------------------ wire reader

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's records.
    value is int for varint/fixed types, bytes for length-delimited."""
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            value = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _parse_blob(buf: bytes) -> np.ndarray:
    """BlobProto -> numpy array (new-style shape or legacy NCHW dims)."""
    shape: List[int] = []
    legacy = {}
    data: List[np.ndarray] = []
    for field, wire, value in iter_fields(buf):
        if field == 7 and wire == 2:  # BlobShape
            # caffe.proto: repeated int64 dim = 1 [packed = true] — real
            # caffe writes ONE length-delimited record of varints; accept
            # the unpacked per-element encoding too
            shape = []
            for f, w, v in iter_fields(value):
                if f != 1:
                    continue
                if w == 2:  # packed
                    pos = 0
                    while pos < len(v):
                        dim, pos = _read_varint(v, pos)
                        shape.append(dim)
                else:
                    shape.append(v)
        elif field in (1, 2, 3, 4) and wire == 0:  # num/channels/h/w
            legacy[field] = value
        elif field == 5:
            if wire == 2:  # packed floats
                data.append(np.frombuffer(value, dtype="<f4"))
            elif wire == 5:  # unpacked repeated float
                data.append(np.asarray(
                    [struct.unpack("<f", struct.pack("<I", value))[0]],
                    np.float32))
        elif field == 8 and wire == 2:  # double_data
            data.append(np.frombuffer(value, dtype="<f8").astype(np.float32))
    values = (np.concatenate(data) if data
              else np.zeros((0,), np.float32)).astype(np.float32)
    if not shape and legacy:
        shape = [legacy.get(k, 1) for k in (1, 2, 3, 4)]
    if shape and int(np.prod(shape)) == values.size:
        return values.reshape(shape)
    return values


def _parse_layer(buf: bytes, v1: bool = False) -> Dict[str, Any]:
    name_field, type_field, blobs_field = (4, 5, 6) if v1 else (1, 2, 7)
    layer: Dict[str, Any] = {"name": "", "type": "", "blobs": [],
                             "bottom": [], "top": []}
    for field, wire, value in iter_fields(buf):
        if field == name_field and wire == 2:
            layer["name"] = value.decode("utf-8", "replace")
        elif field == type_field:
            layer["type"] = (str(value) if v1
                             else value.decode("utf-8", "replace"))
        elif field == blobs_field and wire == 2:
            layer["blobs"].append(_parse_blob(value))
        elif not v1 and field == 3 and wire == 2:
            layer["bottom"].append(value.decode("utf-8", "replace"))
        elif not v1 and field == 4 and wire == 2:
            layer["top"].append(value.decode("utf-8", "replace"))
    return layer


def load_caffemodel(path: str) -> Dict[str, Any]:
    """Parse a .caffemodel (binary NetParameter) into
    {'name': str, 'layers': [{'name', 'type', 'blobs': [np.ndarray], ...}]}.
    Layers without weights are included (empty blobs) so the architecture
    order is preserved."""
    with open(path, "rb") as f:
        buf = f.read()
    net: Dict[str, Any] = {"name": "", "layers": []}
    for field, wire, value in iter_fields(buf):
        if field == 1 and wire == 2:
            net["name"] = value.decode("utf-8", "replace")
        elif field == 100 and wire == 2:        # new-style LayerParameter
            net["layers"].append(_parse_layer(value))
        elif field == 2 and wire == 2:          # V1LayerParameter (legacy)
            net["layers"].append(_parse_layer(value, v1=True))
    return net


# ----------------------------------------------------------- conversions

def caffe_conv_to_flax(weights: np.ndarray,
                       bias: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Caffe conv blob (O, I, kh, kw) -> flax nn.Conv {'kernel': (kh, kw,
    I, O), 'bias'} (caffe and torch share the OIHW layout)."""
    out = {"kernel": np.transpose(np.asarray(weights, np.float32),
                                  (2, 3, 1, 0))}
    if bias is not None:
        out["bias"] = np.asarray(bias, np.float32)
    return out


class CaffeModelLoader:
    """Reference-shaped surface (caffe_model_loader.py:5): construct with
    the weights path, ``get_model()`` returns the parsed net. ``model_def``
    (deploy.prototxt) is accepted for signature compatibility but unused —
    the binary checkpoint itself carries the layer names/types/shapes."""

    def __init__(self, model_weights: str, model_def: Optional[str] = None):
        print(f"Loading {model_def or '<weights only>'} {model_weights}")
        self.net = load_caffemodel(model_weights)
        print("Loading complete")

    def get_model(self) -> Dict[str, Any]:
        return self.net

    getModel = get_model  # reference method name
