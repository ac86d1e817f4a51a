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
exact erf form.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.config import Config
from ..ops.conv7 import conv_same_nhwc, conv_same_plain
from ..ops.postprocess import pack_bits, threshold_pack, threshold_pack_plain

__all__ = ["FCNConfig", "FCNLectureNet", "fold_batch_norms", "fold_model",
           "init_weights", "prepare_images", "pad_to_multiple",
           "make_binarizer", "make_packed_binarizer", "pack_bits",
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
    conv weights (see ``fold_model``); inference only. ``plain``: the heads
    and the packed tail run the plain PyTorch versions of the kernels even
    on the card (the reference the kernels are compared with)."""

    def __init__(self, config: FCNConfig, reconstruction_mode: bool = False,
                 fold_bn: bool = False, plain: bool = False):
        super().__init__()
        self.config = config
        self.reconstruction_mode = reconstruction_mode
        self.fold_bn = fold_bn
        self.plain = plain
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

    @property
    def dtype(self) -> torch.dtype:
        return self.mid_block[0].weight.dtype

    def _head(self, block: nn.Sequential, x: torch.Tensor, gelu: bool,
              out_dtype: torch.dtype,
              x2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One pixel_k head conv through kernel K2 (its plain version with
        ``plain``) on ``x``, or on ``x`` and ``x2`` read as their channel
        concat without building it; bias and GELU fuse into the kernel once
        BN is folded."""
        conv, bn = block[0], block[1]
        folded = isinstance(bn, nn.Identity)
        conv_fn = conv_same_plain if self.plain else conv_same_nhwc
        x = x.contiguous(memory_format=torch.channels_last)
        if x2 is not None:
            x2 = x2.contiguous(memory_format=torch.channels_last)
        if folded:
            return conv_fn(x, conv.weight, conv.bias,
                           "gelu" if gelu else None, out_dtype, x2)
        y = bn(conv_fn(x, conv.weight, conv.bias, None, x.dtype, x2))
        if gelu:
            y = F.gelu(y)
        return y.to(out_dtype)

    def forward(self, x0: torch.Tensor, mode: str = "full"):
        """x0: (B, 3, H, W) float in [-1, 1], H and W multiples of 32.

        mode: 'full' -> (bin_logits, text_logits, rec) (f32 logits, rec in
        the model dtype), 'encode' -> mid-block features (reference
        get_batch_mid_block_features, FCN_lecturenet.py:213-258), 'diff' ->
        (diff_img, decoder features) (reference get_batch_diff_images,
        :325-352). With ``reconstruction_mode``, 'full' returns rec only."""
        if mode not in ("full", "encode", "diff"):
            raise ValueError(f"unknown mode {mode!r}")
        dt = self.dtype
        x = x0.to(dt)

        skips = []
        for level in range(1, 6):
            pre = getattr(self, f"conv_down_block_{level}")(x)
            skips.append(pre)
            x = F.max_pool2d(pre, 2, 2)
        x = self.mid_block(x)
        if mode == "encode":
            return x.float()

        for level in range(5, 0, -1):
            skip = skips[level - 1]
            x = getattr(self, f"transposed_conv_{level}")(x)
            x = getattr(self, f"upsample_block_{level}")(x)
            # crop to the skip (odd encoder sizes), as the reference does
            # with ConvTranspose2d(output_size=...)
            x = x[:, :, :skip.shape[2], :skip.shape[3]]
            x = getattr(self, f"conv_up_block_{level}")(
                torch.cat([x, skip], dim=1))
        x_up1 = x

        rec = self.conv_reconstruct(x_up1)
        if self.reconstruction_mode:
            if mode == "full":
                return rec
            raise ValueError("a reconstruction-mode model has no text head")

        text_logits = self._head(self.conv_text_mask_out, x_up1, False,
                                 torch.float32)
        diff = (x0.to(dt) - rec) * torch.sigmoid(text_logits).to(dt)
        if mode == "diff":
            return diff.float(), x_up1.float()

        # channels_last once: the three heads each read diff beside a
        # feature map
        diff = diff.contiguous(memory_format=torch.channels_last)
        h = self._head(self.conv_pixels_1, diff, True, dt, x_up1)
        h = self._head(self.conv_pixels_2, diff, True, dt, h)
        bin_logits = self._head(self.conv_out, diff, False, torch.float32, h)
        return bin_logits, text_logits, rec


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

_CONV_BN_BLOCKS = ([f"conv_down_block_{i}" for i in range(1, 6)]
                   + ["mid_block"]
                   + [f"conv_up_block_{i}" for i in range(1, 6)]
                   + ["conv_pixels_1", "conv_pixels_2", "conv_reconstruct",
                      "conv_text_mask_out", "conv_out"])


def fold_batch_norms(state_dict: Dict[str, torch.Tensor], eps: float = 1e-5
                     ) -> Dict[str, torch.Tensor]:
    """Fold every inference BatchNorm affine into the preceding conv/deconv
    weight+bias: y = a*(conv(x)+bias-mean)+b == conv'(x) with weight*a and
    bias a*(bias-mean)+b, in f32. Returns the state dict of a model built
    with ``fold_bn=True``. Conv weights scale on axis 0 (O, I, kh, kw);
    ConvTranspose2d weights on axis 1 (I, O, kh, kw)."""
    sd = {key: value.detach().float() for key, value in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}

    def fold(conv: str, bn: str, out_axis: int) -> None:
        a = sd[f"{bn}.weight"] / torch.sqrt(sd[f"{bn}.running_var"] + eps)
        shift = sd[f"{bn}.bias"] - a * sd[f"{bn}.running_mean"]
        kernel = sd[f"{conv}.weight"]
        shape = [1] * kernel.dim()
        shape[out_axis] = -1
        bias = sd.get(f"{conv}.bias", torch.zeros_like(a))
        out[f"{conv}.weight"] = kernel * a.reshape(shape)
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
                   threshold: int = 128):
    """Batch binarizer: uint8 RGB [B,H,W,3] (on the model's device) -> uint8
    binary [B,H,W] (plus text mask and reconstruction).

    Mirrors reference FCN_LectureNet.binarize (FCN_lecturenet.py:430-505):
    sigmoid, x255, hard threshold at 128 -> {0, 255}."""

    @torch.no_grad()
    def binarize(rgb_uint8: torch.Tensor):
        x, (h, w) = pad_to_multiple(prepare_images(rgb_uint8))
        bin_logits, text_logits, rec = model(_to_model_input(x))
        bin_prob = torch.sigmoid(bin_logits[:, 0].float())
        text_prob = torch.sigmoid(text_logits[:, 0].float())
        bin_u8 = (bin_prob * 255.0).to(torch.uint8)
        text_u8 = (text_prob * 255.0).to(torch.uint8)
        if force_binary:
            bin_u8 = torch.where(bin_u8 >= threshold, 255, 0).to(torch.uint8)
            text_u8 = torch.where(text_u8 >= threshold, 255,
                                  0).to(torch.uint8)
        rec_u8 = (rec.float() * 0.5 + 0.5) * 255.0
        rec_u8 = rec_u8.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
        return bin_u8[:, :h, :w], text_u8[:, :h, :w], rec_u8[:, :h, :w]

    return binarize


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
    """uint8 RGB [B, H, W, 3] -> uint8 I420 planes [B, H*3/2, W] (host,
    cv2). H and W must be even."""
    import cv2

    frames = np.asarray(frames)
    out = np.empty((frames.shape[0], frames.shape[1] * 3 // 2,
                    frames.shape[2]), np.uint8)
    for k in range(frames.shape[0]):
        out[k] = cv2.cvtColor(frames[k], cv2.COLOR_RGB2YUV_I420)
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


def make_packed_binarizer(model: FCNLectureNet, threshold: int = 128,
                          input_format: str = "rgb", pre_halvings: int = 0):
    """Like make_binarizer(force_binary=True) but returns only the packed
    binary bitmap [B, h, ceil(w/8)] (kernel K1 on the card); unpack on the
    host with unpack_bits_host.

    ``input_format='yuv420'`` takes uint8 I420 planes [B, H*3/2, W] and
    reconstructs RGB on the device. ``pre_halvings`` box-halves the frames
    on the device before the net."""
    pack = threshold_pack_plain if model.plain else threshold_pack

    @torch.no_grad()
    def binarize(frames_uint8: torch.Tensor) -> torch.Tensor:
        if input_format == "yuv420":
            rgb_uint8 = yuv420_to_rgb(frames_uint8)
        else:
            rgb_uint8 = frames_uint8
        if pre_halvings:
            rgb_uint8 = device_halve(rgb_uint8, pre_halvings)
        x, (h, w) = pad_to_multiple(prepare_images(rgb_uint8))
        bin_logits, _, _ = model(_to_model_input(x))
        return pack(bin_logits[:, 0].float().contiguous(), h, w, threshold)

    return binarize


def unpack_bits_host(packed: np.ndarray, width: int) -> np.ndarray:
    """uint8 bitmap [B, H, ceil(W/8)] -> uint8 binary [B, H, W] in {0, 255}."""
    unpacked = np.unpackbits(np.asarray(packed), axis=-1)[..., :width]
    return unpacked * np.uint8(255)
