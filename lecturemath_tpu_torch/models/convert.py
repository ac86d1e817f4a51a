"""Checkpoints for the port's FCNLectureNet.

The port's module names are the reference torch names, so a reference
``.dat``/``.pth`` state dict (``torch.save(model.state_dict())``, reference:
lecturenet_train_02_train_binarizer.py:254-264) loads as it is. Weights of
the JAX package come across as its flax variables: ``state_dict_from_flax``
maps them by name (``flax_variables_from_state_dict`` back), and
``load_checkpoint`` / ``save_checkpoint`` read and write its ``.msgpack``
files with a msgpack codec of this module's own (the card's machine has no
msgpack package).

Layout notes (flax -> torch):
  * Conv kernel (kh, kw, I, O)                        -> weight (O, I, kh, kw)
  * ConvTranspose(transpose_kernel) kernel (kh, kw, O, I) -> weight (I, O, kh, kw)
  * BatchNorm scale/bias, batch_stats mean/var        -> weight/bias,
    running_mean/running_var
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch


# (flax name, port name) of the conv + BN blocks under params/<name>/{conv,bn}
_BLOCKS = ([(f"down_{i}", f"conv_down_block_{i}") for i in range(1, 6)]
           + [("mid", "mid_block"), ("pixels_1", "conv_pixels_1"),
              ("pixels_2", "conv_pixels_2")])
# (flax conv, flax BN, port name) of the heads kept at the top level
_HEADS = (("out_conv", "out_bn", "conv_out"),
          ("text_conv", "text_bn", "conv_text_mask_out"),
          ("rec_conv", "rec_bn", "conv_reconstruct"))
# flax Conv kernel (kh, kw, I, O) <-> torch (O, I, kh, kw), and flax
# ConvTranspose(transpose_kernel) (kh, kw, O, I) <-> torch (I, O, kh, kw):
# the same permutation, which is its own inverse's transpose
_TO_TORCH = (3, 2, 0, 1)
_TO_FLAX = (2, 3, 1, 0)


def _flax_to_numpy_state_dict(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    params = variables["params"]
    stats = variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}

    def put_conv(torch_name, tree):
        sd[f"{torch_name}.weight"] = np.transpose(
            np.asarray(tree["kernel"], np.float32), _TO_TORCH)
        sd[f"{torch_name}.bias"] = np.asarray(tree["bias"], np.float32)

    def put_bn(torch_name, p_bn, s_bn):
        sd[f"{torch_name}.weight"] = np.asarray(p_bn["scale"], np.float32)
        sd[f"{torch_name}.bias"] = np.asarray(p_bn["bias"], np.float32)
        sd[f"{torch_name}.running_mean"] = np.asarray(s_bn["mean"], np.float32)
        sd[f"{torch_name}.running_var"] = np.asarray(s_bn["var"], np.float32)
        sd[f"{torch_name}.num_batches_tracked"] = np.asarray(0, np.int64)

    # a reconstruction-mode checkpoint has no text, pixel or out heads
    for flax_name, torch_name in _BLOCKS:
        if flax_name in params:
            put_conv(f"{torch_name}.0", params[flax_name]["conv"])
            put_bn(f"{torch_name}.1", params[flax_name]["bn"],
                   stats[flax_name]["bn"])
    for i in range(1, 6):
        up, s_up = params[f"up_{i}"], stats[f"up_{i}"]
        put_conv(f"transposed_conv_{i}", up["deconv"])
        put_bn(f"upsample_block_{i}.0", up["bn"], s_up["bn"])
        put_conv(f"conv_up_block_{i}.0", up["conv_block"]["conv"])
        put_bn(f"conv_up_block_{i}.1", up["conv_block"]["bn"],
               s_up["conv_block"]["bn"])
    for conv_name, bn_name, torch_name in _HEADS:
        if conv_name in params:
            put_conv(f"{torch_name}.0", params[conv_name])
            put_bn(f"{torch_name}.1", params[bn_name], stats[bn_name])
    return sd


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's {'params', 'batch_stats'} (numpy leaves) -> the
    port's FCNLectureNet state dict (loads with ``strict=True``)."""
    return {key: torch.from_numpy(np.array(value, copy=True))
            for key, value in _flax_to_numpy_state_dict(variables).items()}


def flax_variables_from_state_dict(state_dict: Dict[str, torch.Tensor]
                                   ) -> Dict[str, Any]:
    """The inverse of ``state_dict_from_flax``: the port's state dict ->
    the JAX package's {'params', 'batch_stats'} tree of f32 numpy arrays
    (``num_batches_tracked``, which flax has no slot for, is dropped)."""
    sd = {key: value.detach().float().cpu().numpy()
          for key, value in state_dict.items()
          if not key.endswith("num_batches_tracked")}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def conv(torch_name):
        return {"kernel": np.ascontiguousarray(np.transpose(
                    sd[f"{torch_name}.weight"], _TO_FLAX)),
                "bias": sd[f"{torch_name}.bias"]}

    def bn(torch_name):
        return ({"scale": sd[f"{torch_name}.weight"],
                 "bias": sd[f"{torch_name}.bias"]},
                {"mean": sd[f"{torch_name}.running_mean"],
                 "var": sd[f"{torch_name}.running_var"]})

    for flax_name, torch_name in _BLOCKS:
        if f"{torch_name}.0.weight" in sd:
            p_bn, s_bn = bn(f"{torch_name}.1")
            params[flax_name] = {"conv": conv(f"{torch_name}.0"), "bn": p_bn}
            stats[flax_name] = {"bn": s_bn}
    for i in range(1, 6):
        p_up, s_up = bn(f"upsample_block_{i}.0")
        p_cb, s_cb = bn(f"conv_up_block_{i}.1")
        params[f"up_{i}"] = {"deconv": conv(f"transposed_conv_{i}"),
                             "bn": p_up,
                             "conv_block": {"conv": conv(
                                 f"conv_up_block_{i}.0"), "bn": p_cb}}
        stats[f"up_{i}"] = {"bn": s_up, "conv_block": {"bn": s_cb}}
    for conv_name, bn_name, torch_name in _HEADS:
        if f"{torch_name}.0.weight" in sd:
            params[conv_name] = conv(f"{torch_name}.0")
            params[bn_name], stats[bn_name] = bn(f"{torch_name}.1")
    return {"params": params, "batch_stats": stats}


def state_dict_specs_from_flax(param_specs: Dict[str, Any]
                               ) -> Dict[str, tuple]:
    """A tree shaped like the JAX package's ``params``, of partition specs
    (tuples of axis names or None, as ``jax.sharding.PartitionSpec`` is) ->
    the spec of each port ``state_dict`` key it names, in torch axis order
    (a kernel's spec permuted as the kernel is), ``()`` for a replicated
    tensor: the JAX package's ``params_pspec_tree`` in the port's terms.
    BatchNorm running statistics and ``num_batches_tracked`` have no flax
    parameter and no entry."""
    out: Dict[str, tuple] = {}

    def norm(spec) -> tuple:
        spec = tuple(spec)
        return spec if any(axis is not None for axis in spec) else ()

    def conv(torch_name, tree):
        kernel = tuple(tree["kernel"])
        if kernel:
            kernel = tuple(kernel[axis] for axis in _TO_TORCH)
        out[f"{torch_name}.weight"] = norm(kernel)
        out[f"{torch_name}.bias"] = norm(tree["bias"])

    def bn(torch_name, tree):
        out[f"{torch_name}.weight"] = norm(tree["scale"])
        out[f"{torch_name}.bias"] = norm(tree["bias"])

    for flax_name, torch_name in _BLOCKS:
        if flax_name in param_specs:
            conv(f"{torch_name}.0", param_specs[flax_name]["conv"])
            bn(f"{torch_name}.1", param_specs[flax_name]["bn"])
    for i in range(1, 6):
        up = param_specs[f"up_{i}"]
        conv(f"transposed_conv_{i}", up["deconv"])
        bn(f"upsample_block_{i}.0", up["bn"])
        conv(f"conv_up_block_{i}.0", up["conv_block"]["conv"])
        bn(f"conv_up_block_{i}.1", up["conv_block"]["bn"])
    for conv_name, bn_name, torch_name in _HEADS:
        if conv_name in param_specs:
            conv(f"{torch_name}.0", param_specs[conv_name])
            bn(f"{torch_name}.1", param_specs[bn_name])
    return out


# ---------------------------------------------------------------------------
# flax's msgpack format, without the msgpack package
# ---------------------------------------------------------------------------
#
# flax.serialization.msgpack_serialize writes the variables tree as msgpack
# maps with str keys; each array leaf is ext type 1 holding a packed
# (shape, dtype name, C-order bytes) triple, a numpy scalar ext type 3 of
# the same triple. The codec below reads and writes that subset of msgpack
# (nil, bool, int, float, str, bin, array, map, ext) and writes what
# msgpack.packb writes, byte for byte.

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}       # bin
        if b in sized:
            return self.take(self.unpack(sized[b]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strings = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strings:
            return self.take(self.unpack(strings[b])).decode("utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            return self.ext(self.unpack(ext[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        array = _ndarray_from_bytes(data)
        return array[()] if code == _EXT_NPSCALAR else array


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    """flax's array leaf: packed (shape, dtype name, bytes); bfloat16 comes
    back as f32 (numpy has no bfloat16)."""
    reader = _Reader(data)
    shape, dtype_name, buffer = reader.value()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).reshape(shape)
        return (bits.astype(np.uint32) << 16).view(np.float32)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def _pack_length(out: bytearray, n: int, fix: int, fix_max: int,
                 codes: tuple) -> None:
    """A str/bin/array/map header: fix form below ``fix_max``, else the
    8/16/32-bit length forms in ``codes`` (None where msgpack has none)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of {n} entries or bytes is too large")


def _pack(out: bytearray, value) -> None:
    if value is None:
        out.append(0xC0)
    elif value is True or value is False:
        out.append(0xC3 if value else 0xC2)
    elif isinstance(value, int):
        _pack_int(out, value)
    elif isinstance(value, float):
        out.append(0xCB)
        out += struct.pack(">d", value)
    elif isinstance(value, str):
        encoded = value.encode("utf-8")
        _pack_length(out, len(encoded), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += encoded
    elif isinstance(value, bytes):
        _pack_length(out, len(value), None, 0, (0xC4, 0xC5, 0xC6))
        out += value
    elif isinstance(value, (list, tuple)):
        _pack_length(out, len(value), 0x90, 16, (None, 0xDC, 0xDD))
        for item in value:
            _pack(out, item)
    elif isinstance(value, dict):
        _pack_length(out, len(value), 0x80, 16, (None, 0xDE, 0xDF))
        for key, item in value.items():
            _pack(out, key)
            _pack(out, item)
    elif isinstance(value, (np.ndarray, np.generic)):
        array = np.asarray(value)
        if array.dtype.hasobject or array.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be saved")
        inner = bytearray()
        _pack(inner, (list(array.shape), array.dtype.name,
                      array.tobytes("C")))
        code = _EXT_NDARRAY if isinstance(value, np.ndarray) else \
            _EXT_NPSCALAR
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(inner) in fixext:
            out.append(fixext[len(inner)])
        else:
            _pack_length(out, len(inner), None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", code)
        out += inner
    else:
        raise TypeError(f"cannot save {type(value).__name__} in msgpack")


def _pack_int(out: bytearray, value: int) -> None:
    if 0 <= value < 0x80:
        out.append(value)
    elif -32 <= value < 0:
        out.append(value & 0xFF)
    elif value >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if value < limit:
                out.append(code)
                out += struct.pack(fmt, value)
                return
        raise ValueError(f"integer {value} is too large for msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31),
                                 (0xD3, ">q", 1 << 63)):
            if value >= -limit:
                out.append(code)
                out += struct.pack(fmt, value)
                return
        raise ValueError(f"integer {value} is too large for msgpack")


def _sorted_tree(tree):
    """Maps in sorted key order, as the JAX package writes them (its tree
    passes through ``jax.tree.map``, which sorts dict keys)."""
    if isinstance(tree, dict):
        return {key: _sorted_tree(tree[key]) for key in sorted(tree)}
    return tree


def load_msgpack_variables(path: str) -> Dict[str, Any]:
    """Read a flax ``msgpack_serialize`` checkpoint written by the JAX
    package (or by ``save_msgpack_variables``) into a tree of numpy arrays,
    with neither flax nor the msgpack package."""
    with open(path, "rb") as f:
        data = f.read()
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{path}: {len(data) - reader.pos} bytes after the "
                         f"msgpack object")

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError(f"{path}: chunked msgpack arrays are not "
                                 f"supported")
            for value in node.values():
                check(value)

    check(tree)
    return tree


def save_msgpack_variables(state_dict: Dict[str, torch.Tensor],
                           path: str) -> None:
    """Write the port's state dict as the JAX package's ``.msgpack``
    checkpoint (``flax_variables_from_state_dict``, then the bytes flax's
    ``msgpack_serialize`` writes for that tree)."""
    out = bytearray()
    _pack(out, _sorted_tree(flax_variables_from_state_dict(state_dict)))
    with open(path, "wb") as f:
        f.write(bytes(out))


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a state dict from a torch ``.dat``/``.pth`` file or from a flax
    ``.msgpack``/``.flax`` file of the JAX package."""
    if path.endswith((".msgpack", ".flax")):
        return state_dict_from_flax(load_msgpack_variables(path))
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(state_dict: Dict[str, torch.Tensor], path: str) -> None:
    """Save a state dict as a flax ``.msgpack``/``.flax`` file for a path of
    that suffix (``save_msgpack_variables``), else ``torch.save`` it as a
    reference-compatible ``.dat``/``.pth``."""
    if path.endswith((".msgpack", ".flax")):
        save_msgpack_variables(state_dict, path)
        return
    torch.save({key: value.detach().cpu() for key, value in state_dict.items()},
               path)
