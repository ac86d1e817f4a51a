"""FCN-LectureNet: 3-branch fully-convolutional U-Net for lecture-video
binarization, as a torch ``nn.Module`` (NCHW tensors, ``channels_last``
memory and bf16 on the card).

The same network as ``lecturemath_tpu.models.fcn_lecturenet`` (reference:
AccessMath/lecturenet_v1/FCN_lecturenet.py:16-427), with the reference torch
module names, so a reference ``state_dict`` loads with ``strict=True``:

  * 5 down blocks ``conv_down_block_{i}``: conv(k)+BatchNorm+GELU, then 2x2
    max-pool; the pre-pool map is the skip
  * ``mid_block``: conv(k)+BN+GELU
  * 5 up blocks: ``transposed_conv_{i}`` (2x2, stride 2), ``upsample_block_{i}``
    (BN+GELU), crop to the skip, concat, ``conv_up_block_{i}``
  * reconstruction head ``conv_reconstruct``: conv(k)+BN+Tanh
  * text-mask head ``conv_text_mask_out``: conv(pixel_k)+BN -> logits
  * binarization head: diff = (x0 - rec) * sigmoid(text), then
    ``conv_pixels_1``, ``conv_pixels_2`` (conv+BN+GELU) and ``conv_out``
    (conv+BN), each reading diff concatenated with the previous features

The four pixel_k head convs go through ``ops.conv7.conv_same_nhwc`` (kernel
K2 on the card), which reads diff and the feature map as two tensors, so
the heads' concats are never built; the trunk's convs, deconvs and pools
stay ``F.conv2d``, ``F.conv_transpose2d`` and ``F.max_pool2d``. GELU is the
exact erf form. K2 has no backward: a forward that must carry gradients to
the heads (training) runs them as ``F.conv2d`` over the concat, as the JAX
package's training forward does (``_head``).

Training runs in mixed precision with ``compute_dtype`` (bf16) over f32
master weights: each conv casts its weights to the compute dtype, each
BatchNorm runs in ``bn_dtype`` (f32 by default) against f32 running
buffers, and its output goes back to the compute dtype after the
activation, as the JAX package's modules cast.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.config import Config
from ..ops.conv7 import (conv_same_nhwc, conv_same_plain, n_tiles, needs_grad,
                         pack_weights)
from ..ops.postprocess import pack_bits, threshold_pack, threshold_pack_plain
from ..utils.image import rgb_to_yuv420

__all__ = ["FCNConfig", "FCNLectureNet", "fold_batch_norms", "fold_model",
           "init_weights", "prepare_images", "pad_to_multiple",
           "make_binarizer", "make_packed_binarizer", "model_input",
           "probability_u8", "pack_bits",
           "unpack_bits_host", "yuv420_to_rgb", "rgb_to_yuv420_host",
           "device_halve"]


@dataclass(frozen=True)
class FCNConfig:
    in_channels: int = 3
    down_filters: Tuple[int, ...] = (48, 96, 192, 384, 768)
    mid_filters: int = 768
    upsample_filters: Tuple[int, ...] = (32, 48, 96, 192, 384)  # up blocks 1..5
    up_filters: Tuple[int, ...] = (32, 48, 96, 192, 384)
    pixel_features: Tuple[int, int] = (32, 16)
    kernel_size: int = 3
    pixel_kernel_size: int = 7

    @classmethod
    def from_config(cls, config: Config, in_channels: int = 3) -> "FCNConfig":
        """Build from FCN_BINARIZER_NET_* keys (reference:
        FCN_lecturenet.py:620-659, configs/FCN_LectureNet.conf:109-132)."""
        g = config.get
        return cls(
            in_channels=in_channels,
            down_filters=tuple(g(f"FCN_BINARIZER_NET_DOWN_CONV_FILTERS_{i}", d)
                               for i, d in zip(range(1, 6), (16, 32, 64, 128, 256))),
            mid_filters=g("FCN_BINARIZER_NET_MIDDLE_CONV_FILTERS_MIDDLE", 512),
            upsample_filters=tuple(g(f"FCN_BINARIZER_NET_UPSAMPLE_FILTERS_{i}", d)
                                   for i, d in zip(range(1, 6), (16, 32, 64, 128, 256))),
            up_filters=tuple(g(f"FCN_BINARIZER_NET_UP_CONV_FILTERS_{i}", d)
                             for i, d in zip(range(1, 6), (16, 32, 64, 128, 256))),
            pixel_features=(g("FCN_BINARIZER_NET_PIXEL_FEATURES_1", 32),
                            g("FCN_BINARIZER_NET_PIXEL_FEATURES_2", 16)),
            kernel_size=g("FCN_BINARIZER_NET_KERNEL_SIZE", 3),
            pixel_kernel_size=g("FCN_BINARIZER_NET_PIXEL_KERNEL_SIZE", 3),
        )


def _conv_block(c_in: int, c_out: int, k: int, fold_bn: bool,
                activation: Optional[nn.Module]) -> nn.Sequential:
    """Conv2d(k, SAME) at index 0, BatchNorm2d at 1 (Identity once folded),
    activation at 2: the reference Sequential layout."""
    layers = [nn.Conv2d(c_in, c_out, k, padding=k // 2),
              nn.Identity() if fold_bn else nn.BatchNorm2d(c_out, eps=1e-5)]
    if activation is not None:
        layers.append(activation)
    return nn.Sequential(*layers)


class FCNLectureNet(nn.Module):
    """``fold_bn``: the BatchNorms are Identity and their affines live in the
    conv weights (see ``fold_model``; the trainer's frozen-BN fold runs this
    structure on weights folded inside the step). ``plain``: the heads and
    the packed tail run the plain PyTorch versions of the kernels even on
    the card (the reference the kernels are compared with).
    ``compute_dtype`` (default: the weights' dtype) and ``bn_dtype``
    (default: the compute dtype) set the mixed precision of training."""

    def __init__(self, config: FCNConfig, reconstruction_mode: bool = False,
                 fold_bn: bool = False, plain: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        self.reconstruction_mode = reconstruction_mode
        self.fold_bn = fold_bn
        self.plain = plain
        self._compute_dtype = compute_dtype
        self._bn_dtype = bn_dtype
        cfg = config
        k, pk = cfg.kernel_size, cfg.pixel_kernel_size
        if pk % 2 == 0 or pk > 7:
            raise ValueError(f"pixel kernel size must be odd and <= 7, "
                             f"got {pk}")

        c_in = cfg.in_channels
        for level, features in enumerate(cfg.down_filters, start=1):
            setattr(self, f"conv_down_block_{level}",
                    _conv_block(c_in, features, k, fold_bn, nn.GELU()))
            c_in = features
        self.mid_block = _conv_block(c_in, cfg.mid_filters, k, fold_bn,
                                     nn.GELU())
        below = cfg.mid_filters
        for level in range(5, 0, -1):
            up = cfg.upsample_filters[level - 1]
            setattr(self, f"transposed_conv_{level}",
                    nn.ConvTranspose2d(below, up, 2, stride=2))
            setattr(self, f"upsample_block_{level}", nn.Sequential(
                nn.Identity() if fold_bn else nn.BatchNorm2d(up, eps=1e-5),
                nn.GELU()))
            setattr(self, f"conv_up_block_{level}",
                    _conv_block(up + cfg.down_filters[level - 1],
                                cfg.up_filters[level - 1], k, fold_bn,
                                nn.GELU()))
            below = cfg.up_filters[level - 1]

        up1 = cfg.up_filters[0]
        self.conv_reconstruct = _conv_block(up1, cfg.in_channels, k, fold_bn,
                                            nn.Tanh())
        if not reconstruction_mode:
            p1, p2 = cfg.pixel_features
            self.conv_text_mask_out = _conv_block(up1, 1, pk, fold_bn, None)
            self.conv_pixels_1 = _conv_block(cfg.in_channels + up1, p1, pk,
                                             fold_bn, None)
            self.conv_pixels_2 = _conv_block(cfg.in_channels + p1, p2, pk,
                                             fold_bn, None)
            self.conv_out = _conv_block(cfg.in_channels + p2, 1, pk, fold_bn,
                                        None)
        # K2's packed head weights (``head_pack``), each beside the key of
        # the weights it was packed from
        self._head_packs: Dict[str, Tuple[tuple, Tuple[torch.Tensor,
                                                       torch.Tensor]]] = {}
        # a process group: every BatchNorm in training mode normalizes over
        # the group's global batch (parallel/sync_norm.py); None: local
        self.bn_group = None

    def _apply(self, fn, *args, **kwargs):
        # .to, .cuda, .half and the like make new weight tensors, which the
        # allocator may place where the old ones were
        self._head_packs = {}
        return super()._apply(fn, *args, **kwargs)

    @property
    def dtype(self) -> torch.dtype:
        """The weights' dtype."""
        return self.mid_block[0].weight.dtype

    @property
    def compute_dtype(self) -> torch.dtype:
        return self._compute_dtype or self.dtype

    def head_inputs(self) -> Dict[str, Tuple[int, int]]:
        """Channels of the two inputs of each pixel_k head conv, as the
        forward passes them to kernel K2 (0: a single input)."""
        cfg = self.config
        c, up1 = cfg.in_channels, cfg.up_filters[0]
        p1, p2 = cfg.pixel_features
        return {"conv_text_mask_out": (up1, 0), "conv_pixels_1": (c, up1),
                "conv_pixels_2": (c, p1), "conv_out": (c, p2)}

    def head_pack(self, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(``pack_weights`` of head ``name``'s weight, its bias in f32),
        computed once and kept while the weight and bias tensors stay the
        same: the cache key is each one's ``data_ptr()`` and ``_version``,
        so an in-place update (``optimizer.step()``, ``load_state_dict``)
        repacks, and a move (``.to``) drops every pack."""
        conv = getattr(self, name)[0]
        key = tuple((t.data_ptr(), t._version)
                    for t in (conv.weight, conv.bias))
        cached = self._head_packs.get(name)
        if cached is not None and cached[0] == key:
            return cached[1]
        c1, c2 = self.head_inputs()[name]
        with torch.no_grad():
            pack = (pack_weights(conv.weight, c1, c2,
                                 n_tiles(conv.weight.shape[0])),
                    conv.bias.detach().float().contiguous().clone())
        self._head_packs[name] = (key, pack)
        return pack

    def pack_heads(self) -> None:
        """Pack every head's weights for K2 now (the stage-01 binarizer
        calls this once the model is on the card), so no forward launches
        the packing kernels."""
        if not self.reconstruction_mode:
            for name in self.head_inputs():
                self.head_pack(name)

    def _bn_act(self, norm: nn.Module, y: torch.Tensor,
                activation: Optional[Callable] = None) -> torch.Tensor:
        """BatchNorm (Identity once folded) in ``bn_dtype``, then the
        activation, back in the compute dtype. A BatchNorm in training mode
        of a model with a ``bn_group`` is cross-replica."""
        dt = y.dtype
        y = y.to(self._bn_dtype or dt)
        if self.bn_group is not None and isinstance(norm, nn.BatchNorm2d) \
                and norm.training:
            from ..parallel.sync_norm import cross_replica_batch_norm

            y = cross_replica_batch_norm(norm, y, self.bn_group)
        else:
            y = norm(y)
        if activation is not None:
            y = activation(y)
        return y.to(dt)

    def _block(self, name: str, x: torch.Tensor,
               halo: bool = False) -> torch.Tensor:
        """Conv block ``name`` (conv, BN, optional activation) on ``x``,
        with the conv's weights cast to ``x``'s dtype. ``halo``: ``x``
        carries the conv's k // 2 rows of its neighbours above and below
        (a height slab of the model axis), so the conv pads only the width
        and returns the rows between them."""
        block = getattr(self, name)
        conv, dt = block[0], x.dtype
        if halo:
            y = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                         conv.stride, (0, conv.padding[1]), conv.dilation,
                         conv.groups)
        else:
            y = conv._conv_forward(x, conv.weight.to(dt), conv.bias.to(dt))
        return self._bn_act(block[1], y, block[2] if len(block) > 2 else None)

    def _up(self, level: int, x: torch.Tensor) -> torch.Tensor:
        """Transposed conv (2x2, stride 2) + BN + GELU of up block
        ``level``."""
        return self._up_act(level, self._deconv(level, x))

    def _deconv(self, level: int, x: torch.Tensor,
                bias: bool = True) -> torch.Tensor:
        """The transposed conv of up block ``level`` on ``x``, with its bias
        unless ``bias`` is False (the model axis adds it after summing the
        shards' partial products)."""
        deconv = getattr(self, f"transposed_conv_{level}")
        dt = x.dtype
        return F.conv_transpose2d(x, deconv.weight.to(dt),
                                  deconv.bias.to(dt) if bias else None,
                                  stride=2)

    def _up_act(self, level: int, y: torch.Tensor,
                bias: bool = False) -> torch.Tensor:
        """BN + GELU of up block ``level`` on its transposed conv's output
        ``y``, adding the conv's bias first when ``bias``."""
        if bias:
            deconv = getattr(self, f"transposed_conv_{level}")
            y = y + deconv.bias.to(y.dtype)[:, None, None]
        up = getattr(self, f"upsample_block_{level}")
        return self._bn_act(up[0], y, up[1])

    @staticmethod
    def _pool(x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, 2, 2)

    @staticmethod
    def _map(fn: Callable, *xs):
        """``fn`` on the layer inputs ``xs``: one tensor each here; the
        model axis's layers (parallel/model_axis.py) map over shards."""
        return fn(*xs)

    def _head(self, name: str, x: torch.Tensor, gelu: bool,
              out_dtype: torch.dtype,
              x2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Head conv ``name`` on ``x``, or on ``x`` and ``x2`` read as their
        channel concat. Two routes, chosen here and nowhere else:

          * a forward that carries gradients to the head (grad enabled and
            its weight, bias or an input requires grad: training) runs
            ``F.conv2d`` over the concat in the compute dtype. K2 has no
            backward, and this is what the JAX package's training forward
            computes (its heads are XLA convs; no Pallas call is reachable
            from its training step);
          * any other forward runs kernel K2 (``conv_same_nhwc``; its plain
            version with ``plain`` or for CPU tensors), which reads the two
            inputs without the concat. On the card K2 takes the head's
            cached packed weights (``head_pack``).

        Bias and GELU fuse into K2 once BN is folded."""
        block = getattr(self, name)
        conv, bn = block[0], block[1]
        folded = isinstance(bn, nn.Identity)
        activation = F.gelu if gelu else None
        if needs_grad(x, x2, conv.weight, conv.bias):
            dt = x.dtype
            xin = x if x2 is None else torch.cat([x, x2], dim=1)
            y = conv._conv_forward(xin, conv.weight.to(dt), conv.bias.to(dt))
            y = self._bn_act(bn, y, activation)
            return y.to(out_dtype)
        conv_fn = conv_same_plain if self.plain else conv_same_nhwc
        x = x.contiguous(memory_format=torch.channels_last)
        if x2 is not None:
            x2 = x2.contiguous(memory_format=torch.channels_last)
        bias, extra = conv.bias, {}
        if not self.plain and x.device.type == "cuda":
            packed, bias = self.head_pack(name)
            extra = {"packed": packed}
        if folded:
            return conv_fn(x, conv.weight, bias, "gelu" if gelu else None,
                           out_dtype, x2, **extra)
        y = conv_fn(x, conv.weight, bias, None, x.dtype, x2, **extra)
        return self._bn_act(bn, y, activation).to(out_dtype)

    def forward(self, x0: torch.Tensor, mode: str = "full"):
        """x0: (B, 3, H, W) float in [-1, 1], H and W multiples of 32.

        mode: 'full' -> (bin_logits, text_logits, rec) (f32 logits, rec in
        the model dtype), 'encode' -> mid-block features (reference
        get_batch_mid_block_features, FCN_lecturenet.py:213-258), 'diff' ->
        (diff_img, decoder features) (reference get_batch_diff_images,
        :325-352). With ``reconstruction_mode``, 'full' returns rec only."""
        return self.network(self, x0, mode)

    def network(self, layers, x0, mode: str = "full"):
        """The network, the one description of it, over ``layers``: this
        model, or the layers of a mesh's model axis
        (``parallel/model_axis.py``), whose values are lists of the shards'
        tensors. ``layers`` runs the conv blocks (``_block``), up blocks
        (``_up``), heads (``_head``) and pools (``_pool``), and ``_map``
        applies the element-wise steps."""
        if mode not in ("full", "encode", "diff"):
            raise ValueError(f"unknown mode {mode!r}")
        dt = self.compute_dtype
        each = layers._map
        x = each(lambda t: t.to(dt), x0)

        skips = []
        for level in range(1, 6):
            pre = layers._block(f"conv_down_block_{level}", x)
            skips.append(pre)
            x = layers._pool(pre)
        x = layers._block("mid_block", x)
        if mode == "encode":
            return each(lambda t: t.float(), x)

        for level in range(5, 0, -1):
            x = layers._up(level, x)
            x = layers._block(f"conv_up_block_{level}",
                              each(_crop_cat, x, skips[level - 1]))
        x_up1 = x

        rec = layers._block("conv_reconstruct", x_up1)
        if self.reconstruction_mode:
            if mode == "full":
                return rec
            raise ValueError("a reconstruction-mode model has no text head")

        text_logits = layers._head("conv_text_mask_out", x_up1, False,
                                   torch.float32)
        diff = each(lambda a, r, t: (a.to(dt) - r) * torch.sigmoid(t).to(dt),
                    x0, rec, text_logits)
        if mode == "diff":
            return each(lambda d, u: (d.float(), u.float()), diff, x_up1)

        # channels_last once: the three heads each read diff beside a
        # feature map
        diff = each(lambda d: d.contiguous(memory_format=torch.channels_last),
                    diff)
        h = layers._head("conv_pixels_1", diff, True, dt, x_up1)
        h = layers._head("conv_pixels_2", diff, True, dt, h)
        bin_logits = layers._head("conv_out", diff, False, torch.float32, h)
        return bin_logits, text_logits, rec


def _crop_cat(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """An up block's output cropped to its skip (odd encoder sizes), as the
    reference does with ConvTranspose2d(output_size=...), then the skip
    concatenated after it."""
    return torch.cat([x[:, :, :skip.shape[2], :skip.shape[3]], skip], dim=1)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

_CONV_BN_BLOCKS = ([f"conv_down_block_{i}" for i in range(1, 6)]
                   + ["mid_block"]
                   + [f"conv_up_block_{i}" for i in range(1, 6)]
                   + ["conv_pixels_1", "conv_pixels_2", "conv_reconstruct",
                      "conv_text_mask_out", "conv_out"])


def fold_batch_norms(state_dict: Dict[str, torch.Tensor], eps: float = 1e-5,
                     differentiable: bool = False,
                     deconv_scales: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Fold every inference BatchNorm affine into the preceding conv/deconv
    weight+bias: y = a*(conv(x)+bias-mean)+b == conv'(x) with weight*a and
    bias a*(bias-mean)+b, in f32. Returns the state dict of a model built
    with ``fold_bn=True``. Conv weights scale on axis 0 (O, I, kh, kw);
    ConvTranspose2d weights on axis 1 (I, O, kh, kw).

    ``differentiable``: keep the autograd graph, so a training step that
    runs the folded model on the result (frozen running statistics; the JAX
    package's ``fold_batch_norms(xp=jnp)`` inside its step) sends the
    gradients back to the original conv and BN parameters.

    ``deconv_scales``: for a model-axis shard (``shard_params``), the
    scale ``a`` of every output channel of a transposed conv (by the
    conv's name) whose BN the shard holds only a slice of: the shard's
    deconv weight holds all output channels (it is cut on its inputs), so
    it takes the whole scale, gathered over the model group
    (``parallel/model_axis.py fold_shards``), while its bias, cut like the
    BN, folds with the local slice."""
    sd = {key: (value if differentiable else value.detach()).float()
          for key, value in state_dict.items()}
    deconv_scales = deconv_scales or {}
    out: Dict[str, torch.Tensor] = {}

    def fold(conv: str, bn: str, out_axis: int) -> None:
        a = sd[f"{bn}.weight"] / torch.sqrt(sd[f"{bn}.running_var"] + eps)
        shift = sd[f"{bn}.bias"] - a * sd[f"{bn}.running_mean"]
        kernel = sd[f"{conv}.weight"]
        shape = [1] * kernel.dim()
        shape[out_axis] = -1
        bias = sd.get(f"{conv}.bias", torch.zeros_like(a))
        out[f"{conv}.weight"] = kernel * deconv_scales.get(conv, a).reshape(
            shape)
        out[f"{conv}.bias"] = a * bias + shift

    # reconstruction-mode checkpoints lack the text/pixel/out heads
    for name in _CONV_BN_BLOCKS:
        if f"{name}.0.weight" in sd:
            fold(f"{name}.0", f"{name}.1", 0)
    for i in range(1, 6):
        fold(f"transposed_conv_{i}", f"upsample_block_{i}.0", 1)
    return out


def fold_model(model: FCNLectureNet) -> FCNLectureNet:
    """A ``fold_bn=True`` copy of ``model`` with its BatchNorms folded in
    (f32 arithmetic, then the model's dtype)."""
    folded = FCNLectureNet(model.config, model.reconstruction_mode,
                           fold_bn=True, plain=model.plain)
    folded.load_state_dict(fold_batch_norms(model.state_dict()), strict=True)
    return folded.to(device=model.mid_block[0].weight.device,
                     dtype=model.dtype)


def init_weights(model: FCNLectureNet, generator: torch.Generator
                 ) -> FCNLectureNet:
    """Random init from an explicit generator: xavier-normal conv and deconv
    weights, zero biases, BatchNorm at identity (the JAX package's init)."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
                nn.init.xavier_normal_(module.weight, generator=generator)
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
    return model


# ---------------------------------------------------------------------------
# inference helpers
# ---------------------------------------------------------------------------

def prepare_images(rgb_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [B,H,W,3] -> float in [-1, 1] (reference: prepare_image
    normalizes with mean 0.5 / std 0.5, FCN_lecturenet.py:607-618)."""
    return rgb_uint8.float() / 127.5 - 1.0


def pad_to_multiple(x: torch.Tensor, multiple: int = 32):
    """Edge-pad H and W of NHWC ``x`` up to a multiple so five 2x pools
    divide evenly. Returns (padded, (h, w))."""
    h, w = x.shape[1], x.shape[2]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph or pw:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                  mode="replicate").permute(0, 2, 3, 1)
    return x, (h, w)


def _to_model_input(x_nhwc: torch.Tensor) -> torch.Tensor:
    """NHWC -> the model's (B, C, H, W) view in channels_last memory."""
    return x_nhwc.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def make_binarizer(model: FCNLectureNet, force_binary: bool = True,
                   threshold: int = 128, forward: Optional[Callable] = None):
    """Batch binarizer: uint8 RGB [B,H,W,3] (on the model's device) -> uint8
    binary [B,H,W] (plus text mask and reconstruction).

    Mirrors reference FCN_LectureNet.binarize (FCN_lecturenet.py:430-505):
    sigmoid, x255, hard threshold at 128 -> {0, 255}. ``forward`` (default
    ``model``) maps the model input to (bin_logits, text_logits, rec): the
    mesh's model axis passes its sharded network."""
    forward = forward or model

    @torch.no_grad()
    def binarize(rgb_uint8: torch.Tensor):
        x, (h, w) = model_input(rgb_uint8)
        bin_logits, text_logits, rec = forward(x)
        bin_u8 = probability_u8(bin_logits[:, 0],
                                threshold if force_binary else None)
        text_u8 = probability_u8(text_logits[:, 0],
                                 threshold if force_binary else None)
        rec_u8 = (rec.float() * 0.5 + 0.5) * 255.0
        rec_u8 = rec_u8.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
        return bin_u8[:, :h, :w], text_u8[:, :h, :w], rec_u8[:, :h, :w]

    return binarize


def probability_u8(logits: torch.Tensor,
                   threshold: Optional[int] = None) -> torch.Tensor:
    """``sigmoid(logits) * 255`` truncated to uint8, or with ``threshold``
    the {0, 255} map of ``>= threshold``."""
    out = (torch.sigmoid(logits.float()) * 255.0).to(torch.uint8)
    if threshold is not None:
        out = torch.where(out >= threshold, 255, 0).to(torch.uint8)
    return out


def yuv420_to_rgb(planes: torch.Tensor) -> torch.Tensor:
    """uint8 I420 planes [B, H*3/2, W] -> uint8 RGB [B, H, W, 3].

    Device-side inverse of cv2.COLOR_RGB2YUV_I420 (BT.601 video range, 2x2
    chroma replication like OpenCV's YUV2RGB_I420)."""
    batch, ht, width = planes.shape
    height = ht * 2 // 3
    y = planes[:, :height, :].float()
    quarter = height // 4
    u = planes[:, height:height + quarter, :].reshape(
        batch, height // 2, width // 2).float()
    v = planes[:, height + quarter:, :].reshape(
        batch, height // 2, width // 2).float()
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0

    # OpenCV ITUR_BT_601 inverse coefficients (modules/imgproc color_yuv)
    yv = (y - 16.0) * 1.1643835616438356
    r = yv + 1.5960267857142858 * v
    g = yv - 0.8129676472377708 * v - 0.39176229009491365 * u
    b = yv + 2.017232142857143 * u
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.round(rgb).clamp(0.0, 255.0).to(torch.uint8)


def rgb_to_yuv420_host(frames: np.ndarray) -> np.ndarray:
    """uint8 RGB [B, H, W, 3] -> uint8 I420 planes [B, H*3/2, W] (host;
    equal to cv2.cvtColor(..., COLOR_RGB2YUV_I420)). H and W must be
    even."""
    frames = np.asarray(frames)
    out = np.empty((frames.shape[0], frames.shape[1] * 3 // 2,
                    frames.shape[2]), np.uint8)
    for k in range(frames.shape[0]):
        out[k] = rgb_to_yuv420(frames[k])
    return out


def device_halve(rgb_uint8: torch.Tensor, halvings: int) -> torch.Tensor:
    """On-device 2x box downscale (INTER_AREA semantics: 2x2 mean, rounded)
    applied ``halvings`` times. Odd trailing rows/columns are dropped, like
    cv2.resize to floor(dim/2)."""
    for _ in range(halvings):
        b, h, w, c = rgb_uint8.shape
        x = rgb_uint8[:, :h - h % 2, :w - w % 2].float()
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
        rgb_uint8 = torch.round(x).clamp(0.0, 255.0).to(torch.uint8)
    return rgb_uint8


def model_input(frames_uint8: torch.Tensor, input_format: str = "rgb",
                pre_halvings: int = 0):
    """uint8 frames on the device -> (the model's input (B, 3, Hp, Wp) in
    [-1, 1], channels_last, edge-padded to multiples of 32; the frames'
    (h, w)). ``input_format='yuv420'`` takes uint8 I420 planes
    [B, H*3/2, W] and reconstructs RGB on the device; ``pre_halvings``
    box-halves the frames on the device first."""
    rgb_uint8 = (yuv420_to_rgb(frames_uint8) if input_format == "yuv420"
                 else frames_uint8)
    if pre_halvings:
        rgb_uint8 = device_halve(rgb_uint8, pre_halvings)
    x, size = pad_to_multiple(prepare_images(rgb_uint8))
    return _to_model_input(x), size


def make_packed_binarizer(model: FCNLectureNet, threshold: int = 128,
                          input_format: str = "rgb", pre_halvings: int = 0,
                          forward: Optional[Callable] = None):
    """Like make_binarizer(force_binary=True) but returns only the packed
    binary bitmap [B, h, ceil(w/8)] (kernel K1 on the card); unpack on the
    host with unpack_bits_host. ``input_format`` and ``pre_halvings`` as
    for ``model_input``; ``forward`` as for ``make_binarizer``."""
    pack = threshold_pack_plain if model.plain else threshold_pack
    forward = forward or model

    @torch.no_grad()
    def binarize(frames_uint8: torch.Tensor) -> torch.Tensor:
        x, (h, w) = model_input(frames_uint8, input_format, pre_halvings)
        bin_logits, _, _ = forward(x)
        return pack(bin_logits[:, 0].float().contiguous(), h, w, threshold)

    return binarize


def unpack_bits_host(packed: np.ndarray, width: int) -> np.ndarray:
    """uint8 bitmap [B, H, ceil(W/8)] -> uint8 binary [B, H, W] in {0, 255}."""
    unpacked = np.unpackbits(np.asarray(packed), axis=-1)[..., :width]
    return unpacked * np.uint8(255)
