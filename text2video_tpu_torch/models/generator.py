"""Composite pose2frame generator (counterpart of
``text2video_tpu/models/generator.py`` with ``n_local_enhancers=0`` and the
plain decoder tail).

From the current and previous label maps and the previously generated
frames it predicts a hallucinated frame, a dense flow and an occlusion mask,
and outputs ``mask * hallucinated + (1 - mask) * warp(prev, flow)``; the
first frame of an utterance (``has_prev == 0``) forces the mask open.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from text2video_tpu_torch.models.layers import (
    Conv,
    ConvBlock,
    ResBlock,
    Upsample,
    reflect_pad,
)
from text2video_tpu_torch.ops.warp import flow_warp


class GlobalTrunk(nn.Module):
    """7x7 stem over the channel-concatenated inputs -> stride-2 downsamples
    -> resblocks -> nearest-2x + conv upsamples. Returns the pre-head
    feature map [B, H, W, base_ch]."""

    def __init__(self, in_channels: int, base_ch: int = 64,
                 n_downsample: int = 3, n_blocks: int = 9,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        ch = base_ch
        self.stem = ConvBlock(in_channels, ch, kernel=7, dtype=dtype)
        down = []
        for _ in range(n_downsample):
            down.append(ConvBlock(ch, 2 * ch, stride=2, dtype=dtype))
            ch *= 2
        self.down = nn.ModuleList(down)
        self.res = nn.ModuleList(ResBlock(ch, dtype) for _ in range(n_blocks))
        up = []
        for _ in range(n_downsample):
            up.append(Upsample(ch, ch // 2, dtype))
            ch //= 2
        self.up = nn.ModuleList(up)

    def forward(self, labels: torch.Tensor,
                prev_imgs: torch.Tensor) -> torch.Tensor:
        x = self.stem(torch.cat([labels, prev_imgs], dim=-1))
        for layer in (*self.down, *self.res, *self.up):
            x = layer(x)
        return x


class CompositeGenerator(nn.Module):
    """labels [B, H, W, 3 * n_label_ctx] (current first), prev_imgs
    [B, H, W, 3 * n_prev] (most recent first), has_prev [B] in {0, 1} ->
    (frame [B, H, W, 3] in [-1, 1], flow [B, H, W, 2] pixels,
    mask [B, H, W, 1]), all float32."""

    def __init__(self, in_channels: int, base_ch: int = 64,
                 n_downsample: int = 3, n_blocks: int = 9,
                 flow_scale: float = 10.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.flow_scale = flow_scale
        self.trunk = GlobalTrunk(in_channels, base_ch, n_downsample,
                                 n_blocks, dtype)
        # One 7x7 conv for all six outputs: image 3 + flow 2 + mask 1.
        self.heads = Conv(base_ch, 6, kernel=7, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random init: lecun-normal conv kernels, zero biases,
        unit instance-norm scales (the flax defaults)."""
        for m in self.modules():
            if isinstance(m, Conv):
                m.reset_parameters(generator)

    def forward(
        self,
        labels: torch.Tensor,
        prev_imgs: torch.Tensor,
        has_prev: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        dt = self.dtype
        labels = labels.to(dt)
        prev_imgs = prev_imgs.to(dt)
        feat = self.trunk(labels, prev_imgs)
        heads = self.heads(reflect_pad(feat, 3)).float()
        raw = torch.tanh(heads[..., 0:3])
        flow = heads[..., 3:5] * self.flow_scale
        mask = torch.sigmoid(heads[..., 5:6])
        # The warp gathers in the compute dtype; its weights stay f32.
        warped = flow_warp(prev_imgs[..., :3], flow).float()
        hp = has_prev.float().reshape(-1, 1, 1, 1)
        mask = mask * hp + (1.0 - hp)
        frame = mask * raw + (1.0 - mask) * warped
        return frame, flow, mask
