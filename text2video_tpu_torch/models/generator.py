"""Composite pose2frame generator (counterpart of
``text2video_tpu/models/generator.py``).

From the current and previous label maps and the previously generated
frames it predicts a hallucinated frame, a dense flow and an occlusion mask,
and outputs ``mask * hallucinated + (1 - mask) * warp(prev, flow)``; the
first frame of an utterance (``has_prev == 0``) forces the mask open.

Coarse to fine: the global trunk runs at ``1 / 2**n_local_enhancers`` of the
resolution and each local enhancer refines its feature at the next finer
scale; the heads sit on the finest stage. ``fused_resblocks`` sends the
trunk's resblock convs through the fused conv + statistics op (kernel B1 on
a card), which serves but cannot train; ``False`` runs the plain convs on
the same parameters.

``phase_form`` (the default, as in the JAX package) runs the stem, the
decoder's upsamples and the heads in their exact coarse-resolution phase
forms (``ops/phase_conv.py``): the stem as a half-resolution window conv
feeding the first downsample, each upsample as a 2x2-window conv with four
stacked phase outputs, and the 7x7 heads as a 4x4-window conv over the
decoder's phase tensor. Same parameters and state-dict, same function;
``phase_form=False`` runs the plain full-resolution forms.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from text2video_tpu_torch.models.layers import (
    Conv,
    ConvBlock,
    ResBlock,
    Upsample,
    downscale2x,
    reflect_pad,
)
from text2video_tpu_torch.ops import phase_conv
from text2video_tpu_torch.ops.warp import flow_warp


class GlobalTrunk(nn.Module):
    """7x7 stem over the channel-concatenated inputs -> stride-2 downsamples
    -> resblocks -> nearest-2x + conv upsamples. Returns the pre-head
    feature map [B, H, W, base_ch].

    ``phase_form``: the upsamples run as coarse-resolution phase convs, and
    where H and W are even (and there is a downsample) the stem runs as a
    half-resolution phase conv straight into the first downsample; with
    ``emit_phase_last`` the trunk returns the last upsample's phase tensor
    [B, H/2, W/2, 4*base_ch] (for the phase-form heads)."""

    def __init__(self, in_channels: int, base_ch: int = 64,
                 n_downsample: int = 3, n_blocks: int = 9,
                 dtype: torch.dtype = torch.bfloat16,
                 fused_resblocks: bool = True, phase_form: bool = False,
                 emit_phase_last: bool = False):
        super().__init__()
        self.phase_form = phase_form
        ch = base_ch
        self.stem = ConvBlock(in_channels, ch, kernel=7, dtype=dtype)
        down = []
        for _ in range(n_downsample):
            down.append(ConvBlock(ch, 2 * ch, stride=2, dtype=dtype))
            ch *= 2
        self.down = nn.ModuleList(down)
        self.res = nn.ModuleList(ResBlock(ch, dtype, fused=fused_resblocks)
                                 for _ in range(n_blocks))
        up = []
        for i in range(n_downsample):
            last = i == n_downsample - 1
            up.append(Upsample(ch, ch // 2, dtype, phase_form,
                               emit_phase=phase_form and emit_phase_last
                               and last))
            ch //= 2
        self.up = nn.ModuleList(up)

    def forward(self, labels: torch.Tensor,
                prev_imgs: torch.Tensor) -> torch.Tensor:
        x = torch.cat([labels, prev_imgs], dim=-1)
        down = list(self.down)
        if (self.phase_form and down and x.shape[1] % 2 == 0
                and x.shape[2] % 2 == 0):
            # The [B, H, W, base_ch] stem output is never built.
            x = down.pop(0).from_phase(self.stem.phase_stem(x))
        else:
            x = self.stem(x)
        for layer in (*down, *self.res, *self.up):
            x = layer(x)
        return x


class LocalEnhancer(nn.Module):
    """One pix2pixHD-style refinement stage at a finer scale: a 7x7 stem and
    a stride-2 block over this scale's inputs, the coarser stage's feature
    (nearest-resized, through a zero-padded 3x3 conv) added to it, plain
    resblocks, and a 2x upsample back to this scale (in phase form with
    ``phase_form``, returning its phase tensor with ``emit_phase``)."""

    def __init__(self, in_channels: int, base_ch: int, n_blocks: int,
                 dtype: torch.dtype, phase_form: bool = False,
                 emit_phase: bool = False):
        super().__init__()
        ch = base_ch // 2
        self.stem = ConvBlock(in_channels, ch, kernel=7, dtype=dtype)
        self.down = ConvBlock(ch, 2 * ch, stride=2, dtype=dtype)
        self.merge = Conv(base_ch, 2 * ch, dtype=dtype, padding=1)
        self.res = nn.ModuleList(ResBlock(2 * ch, dtype, fused=False)
                                 for _ in range(n_blocks))
        self.up = Upsample(2 * ch, ch, dtype, phase_form, emit_phase)

    def forward(self, labels: torch.Tensor, prev_imgs: torch.Tensor,
                feat: torch.Tensor) -> torch.Tensor:
        y = self.down(self.stem(torch.cat([labels, prev_imgs], dim=-1)))
        if feat.shape[1:3] != y.shape[1:3]:
            # jax.image.resize "nearest" samples at pixel centres.
            feat = F.interpolate(feat.permute(0, 3, 1, 2), size=y.shape[1:3],
                                 mode="nearest-exact").permute(0, 2, 3, 1)
        y = y + self.merge(feat)
        for block in self.res:
            y = block(y)
        return self.up(y)


class CompositeGenerator(nn.Module):
    """labels [B, H, W, 3 * n_label_ctx] (current first), prev_imgs
    [B, H, W, 3 * n_prev] (most recent first), has_prev [B] in {0, 1} ->
    (frame [B, H, W, 3] in [-1, 1], flow [B, H, W, 2] pixels,
    mask [B, H, W, 1]), all float32. ``phase_form`` (the default) runs the
    phase forms of the stem, upsamples and heads, ``False`` the plain forms;
    the parameters are the same."""

    def __init__(self, in_channels: int, base_ch: int = 64,
                 n_downsample: int = 3, n_blocks: int = 9,
                 flow_scale: float = 10.0,
                 dtype: torch.dtype = torch.bfloat16,
                 n_local_enhancers: int = 0, n_local_blocks: int = 3,
                 fused_resblocks: bool = True, phase_form: bool = True):
        super().__init__()
        self.dtype = dtype
        self.flow_scale = flow_scale
        self.base_ch = base_ch
        self.phase_form = phase_form
        # The last upsample before the heads hands them its phase tensor.
        self.trunk = GlobalTrunk(in_channels, base_ch, n_downsample,
                                 n_blocks, dtype, fused_resblocks,
                                 phase_form, n_local_enhancers == 0)
        # In the order the stages run: the coarsest first.
        last = n_local_enhancers - 1
        self.local = nn.ModuleList(
            LocalEnhancer(in_channels, base_ch, n_local_blocks, dtype,
                          phase_form, phase_form and i == last)
            for i in range(n_local_enhancers))
        # One 7x7 conv for all six outputs: image 3 + flow 2 + mask 1.
        self.heads = Conv(base_ch // 2 if n_local_enhancers else base_ch, 6,
                          kernel=7, dtype=dtype)

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
        pyramid = [(labels, prev_imgs)]
        for _ in self.local:
            pyramid.append(tuple(downscale2x(x) for x in pyramid[-1]))
        feat = self.trunk(*pyramid[-1])
        for stage, (lab, img) in zip(self.local, reversed(pyramid[:-1])):
            feat = stage(lab, img, feat)
        if self.phase_form:
            # feat is the decoder's phase tensor [B, H/2, W/2, 4*C].
            k7, b7 = self.heads.weights(phase_conv.build_head_kernel)
            heads = (phase_conv.head_window(feat, k7) + b7).float()
        else:
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
