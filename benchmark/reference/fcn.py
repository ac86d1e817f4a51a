"""FCN-LectureNet in plain PyTorch: the reference the port is judged by.

Written from the published architecture (AccessMath lecturenet_v1
FCN_lecturenet.py: five conv + BatchNorm + GELU down blocks with 2x2 max
pools, a middle block, five up blocks of a 2x2 stride-2 transposed conv,
BatchNorm + GELU, crop to the skip, concat and conv, the reconstruction,
text-mask and three pixel heads). It reads the state dict under the
published module names, runs BatchNorm from its running statistics, and
imports nothing of the program. Float32 with TF32 off unless ``quant`` says
otherwise: a control that rounds every conv's input and weight.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

EPS = 1e-5


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale a tensor (its largest magnitude
    maps to 448), back in float32: the precision below bf16."""
    scale = t.detach().abs().amax().clamp(min=1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class Reference:
    """The network over a state dict ``sd`` (f32 tensors). ``quant``
    rounds each conv's input and weight (the control)."""

    def __init__(self, sd: Dict[str, torch.Tensor], net: Dict,
                 quant: Optional[Callable] = None):
        self.sd, self.net = sd, net
        self.q = quant or (lambda t: t)

    def _bn(self, name: str, y: torch.Tensor) -> torch.Tensor:
        sd = self.sd
        scale = sd[f"{name}.weight"] / torch.sqrt(
            sd[f"{name}.running_var"] + EPS)
        shift = sd[f"{name}.bias"] - sd[f"{name}.running_mean"] * scale
        return y * scale[:, None, None] + shift[:, None, None]

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w = self.sd[f"{name}.0.weight"]
        y = F.conv2d(self.q(x), self.q(w), self.sd[f"{name}.0.bias"],
                     padding=w.shape[-1] // 2)
        return self._bn(f"{name}.1", y)

    def features(self, x0: torch.Tensor):
        """x0: (B, 3, H, W) in [-1, 1], H and W multiples of 32 ->
        (the last up block's features, the reconstruction)."""
        gelu = F.gelu
        x, skips = x0, []
        for level in range(1, 6):
            x = gelu(self._conv(f"conv_down_block_{level}", x))
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = gelu(self._conv("mid_block", x))
        for level in range(5, 0, -1):
            w = self.sd[f"transposed_conv_{level}.weight"]
            x = F.conv_transpose2d(self.q(x), self.q(w),
                                   self.sd[f"transposed_conv_{level}.bias"],
                                   stride=2)
            x = gelu(self._bn(f"upsample_block_{level}.0", x))
            skip = skips[level - 1]
            x = torch.cat([x[:, :, :skip.shape[2], :skip.shape[3]], skip], 1)
            x = gelu(self._conv(f"conv_up_block_{level}", x))
        rec = torch.tanh(self._conv("conv_reconstruct", x))
        return x, rec

    def forward(self, x0: torch.Tensor):
        """-> (binary logits, text logits, reconstruction), each
        (B, C, H, W)."""
        up1, rec = self.features(x0)
        text = self._conv("conv_text_mask_out", up1)
        diff = (x0 - rec) * torch.sigmoid(text)
        h = F.gelu(self._conv("conv_pixels_1", torch.cat([diff, up1], 1)))
        h = F.gelu(self._conv("conv_pixels_2", torch.cat([diff, h], 1)))
        logits = self._conv("conv_out", torch.cat([diff, h], 1))
        return logits, text, rec

    __call__ = forward


def model_input(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) -> (B, 3, Hp, Wp) in [-1, 1] with the bottom
    and right edges replicated up to multiples of 32."""
    x = rgb.float().permute(0, 3, 1, 2) / 127.5 - 1.0
    ph, pw = (-x.shape[2]) % 32, (-x.shape[3]) % 32
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    return x
