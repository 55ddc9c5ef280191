"""Discriminators of the pose2frame GAN (counterpart of
``text2video_tpu/models/discriminator.py``).

PatchGAN towers over a 2x average-pool pyramid (the reference trains with
``--num_D 2``), a temporal discriminator over stacked frames and a face
discriminator over mouth crops are all :class:`MultiscaleDiscriminator`s of
different widths (``train/trainer.py``). Tensors are NHWC; parameters keep
the flax layout (HWIO f32 kernels), so a converted flax tree loads as it is
(``convert.discriminator_from_flax``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from text2video_tpu_torch.models.layers import Conv, InstanceNorm, downscale2x

DiscOut = Tuple[torch.Tensor, List[torch.Tensor]]  # (logits, features)


class PatchDiscriminator(nn.Module):
    """70x70-receptive-field PatchGAN tower: 4x4 convs with zero pad 2,
    strides 2, ..., 2, 1, 1, instance norm from the second conv on, leaky
    ReLU 0.2; the last conv (the logits) runs in f32. Returns (logits,
    features): the per-patch logits and the activations that the
    feature-matching loss compares."""

    def __init__(self, in_channels: int, base_ch: int = 64,
                 n_layers: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        convs, norms = [], []
        cin, ch = in_channels, base_ch
        for i in range(n_layers + 1):
            stride = 2 if i < n_layers else 1
            convs.append(Conv(cin, ch, kernel=4, stride=stride, dtype=dtype,
                              padding=2))
            if i > 0:
                norms.append(InstanceNorm(ch, dtype))
            cin, ch = ch, min(ch * 2, 512)
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        self.logits = Conv(cin, 1, kernel=4, dtype=torch.float32, padding=2)

    def forward(self, x: torch.Tensor) -> DiscOut:
        feats: List[torch.Tensor] = []
        x = x.to(self.dtype)
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i > 0:
                x = self.norms[i - 1](x)
            x = F.leaky_relu(x, 0.2)
            feats.append(x)
        return self.logits(x), feats


class MultiscaleDiscriminator(nn.Module):
    """``num_d`` PatchGAN towers (``scale0``, ``scale1``, ...) over a 2x
    average-pool pyramid of the input. Returns one (logits, features) pair
    per scale, the finest first."""

    def __init__(self, in_channels: int, num_d: int = 2, base_ch: int = 64,
                 n_layers: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_d = num_d
        for i in range(num_d):
            setattr(self, f"scale{i}", PatchDiscriminator(
                in_channels, base_ch, n_layers, dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded lecun-normal kernels, zero biases, unit norm scales."""
        for m in self.modules():
            if isinstance(m, Conv):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> List[DiscOut]:
        outs = []
        for i in range(self.num_d):
            outs.append(getattr(self, f"scale{i}")(x))
            if i + 1 < self.num_d:
                x = downscale2x(x)
        return outs


def face_crop(imgs: torch.Tensor, centers: torch.Tensor,
              crop: int) -> torch.Tensor:
    """imgs [B, H, W, C], centers [B, 2] (x, y) pixels -> [B, crop, crop, C]
    windows around the centres. A centre is truncated to an integer and the
    window is clamped inside the image, so the shape is fixed. The window is
    gathered by index: gradients flow to ``imgs``, none to ``centers``."""
    b, h, w, _ = imgs.shape
    half = crop // 2
    x0 = torch.clamp(centers[:, 0].to(torch.int64) - half, 0, w - crop)
    y0 = torch.clamp(centers[:, 1].to(torch.int64) - half, 0, h - crop)
    span = torch.arange(crop, device=imgs.device)
    rows = (y0[:, None] + span)[:, :, None]  # [B, crop, 1]
    cols = (x0[:, None] + span)[:, None, :]  # [B, 1, crop]
    batch = torch.arange(b, device=imgs.device)[:, None, None]
    return imgs[batch, rows, cols]
