"""Checkpoints for the port's FCNLectureNet.

The port's module names are the reference torch names, so a reference
``.dat``/``.pth`` state dict (``torch.save(model.state_dict())``, reference:
lecturenet_train_02_train_binarizer.py:254-264) loads as it is. Weights of
the JAX package come across as its flax variables: ``state_dict_from_flax``
maps them by name, and ``load_checkpoint`` reads its ``.msgpack`` files.

Layout notes (flax -> torch):
  * Conv kernel (kh, kw, I, O)                        -> weight (O, I, kh, kw)
  * ConvTranspose(transpose_kernel) kernel (kh, kw, O, I) -> weight (I, O, kh, kw)
  * BatchNorm scale/bias, batch_stats mean/var        -> weight/bias,
    running_mean/running_var
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _flax_to_numpy_state_dict(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    params = variables["params"]
    stats = variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}

    def put_conv(torch_name, tree):
        sd[f"{torch_name}.weight"] = np.transpose(
            np.asarray(tree["kernel"], np.float32), (3, 2, 0, 1))
        sd[f"{torch_name}.bias"] = np.asarray(tree["bias"], np.float32)

    def put_deconv(torch_name, tree):
        # flax transpose_kernel kernels are (kh, kw, O, I) -> torch (I, O, kh, kw)
        sd[f"{torch_name}.weight"] = np.transpose(
            np.asarray(tree["kernel"], np.float32), (3, 2, 0, 1))
        sd[f"{torch_name}.bias"] = np.asarray(tree["bias"], np.float32)

    def put_bn(torch_name, p_bn, s_bn):
        sd[f"{torch_name}.weight"] = np.asarray(p_bn["scale"], np.float32)
        sd[f"{torch_name}.bias"] = np.asarray(p_bn["bias"], np.float32)
        sd[f"{torch_name}.running_mean"] = np.asarray(s_bn["mean"], np.float32)
        sd[f"{torch_name}.running_var"] = np.asarray(s_bn["var"], np.float32)
        sd[f"{torch_name}.num_batches_tracked"] = np.asarray(0, np.int64)

    for i in range(1, 6):
        put_conv(f"conv_down_block_{i}.0", params[f"down_{i}"]["conv"])
        put_bn(f"conv_down_block_{i}.1", params[f"down_{i}"]["bn"],
               stats[f"down_{i}"]["bn"])
    put_conv("mid_block.0", params["mid"]["conv"])
    put_bn("mid_block.1", params["mid"]["bn"], stats["mid"]["bn"])

    for i in range(1, 6):
        put_deconv(f"transposed_conv_{i}", params[f"up_{i}"]["deconv"])
        put_bn(f"upsample_block_{i}.0", params[f"up_{i}"]["bn"],
               stats[f"up_{i}"]["bn"])
        put_conv(f"conv_up_block_{i}.0", params[f"up_{i}"]["conv_block"]["conv"])
        put_bn(f"conv_up_block_{i}.1", params[f"up_{i}"]["conv_block"]["bn"],
               stats[f"up_{i}"]["conv_block"]["bn"])

    for flax_name, torch_name in (("pixels_1", "conv_pixels_1"),
                                  ("pixels_2", "conv_pixels_2")):
        put_conv(f"{torch_name}.0", params[flax_name]["conv"])
        put_bn(f"{torch_name}.1", params[flax_name]["bn"],
               stats[flax_name]["bn"])

    for conv_name, bn_name, torch_name in (("out_conv", "out_bn", "conv_out"),
                                           ("text_conv", "text_bn",
                                            "conv_text_mask_out"),
                                           ("rec_conv", "rec_bn",
                                            "conv_reconstruct")):
        put_conv(f"{torch_name}.0", params[conv_name])
        put_bn(f"{torch_name}.1", params[bn_name], stats[bn_name])

    return sd


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's {'params', 'batch_stats'} (numpy leaves) -> the
    port's FCNLectureNet state dict (loads with ``strict=True``)."""
    return {key: torch.from_numpy(np.array(value, copy=True))
            for key, value in _flax_to_numpy_state_dict(variables).items()}


def _msgpack_ndarray(data: bytes) -> np.ndarray:
    """Decode flax's msgpack ndarray extension: packb((shape, dtype, bytes))."""
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).float().numpy()
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape)


def _msgpack_ext(code: int, data: bytes):
    import msgpack

    if code == 1:       # flax ndarray
        return _msgpack_ndarray(data)
    if code == 3:       # flax numpy scalar
        return _msgpack_ndarray(data)[()]
    return msgpack.ExtType(code, data)


def load_msgpack_variables(path: str) -> Dict[str, Any]:
    """Read a flax ``msgpack_serialize`` checkpoint written by the JAX
    package into a tree of numpy arrays, without flax."""
    try:
        import msgpack
    except ImportError:
        raise RuntimeError(f"loading {path} needs the 'msgpack' package, "
                           f"which is not installed; convert the checkpoint "
                           f"to a torch .dat state dict instead") from None

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_msgpack_ext, raw=False)

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError(f"{path}: chunked msgpack arrays are not "
                                 f"supported")
            for value in node.values():
                check(value)

    check(tree)
    return tree


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a state dict from a torch ``.dat``/``.pth`` file or from a flax
    ``.msgpack``/``.flax`` file of the JAX package."""
    if path.endswith((".msgpack", ".flax")):
        return state_dict_from_flax(load_msgpack_variables(path))
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(state_dict: Dict[str, torch.Tensor], path: str) -> None:
    """torch.save a reference-compatible state dict."""
    torch.save({key: value.detach().cpu() for key, value in state_dict.items()},
               path)
