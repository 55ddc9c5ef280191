"""The coarse-to-fine generator, plain: pix2pixHD's global trunk at half
resolution and its local enhancers, with vid2vid's composite output.

The global trunk and the composite heads are ``models.py``'s; this module
adds the local enhancer and the coarse-to-fine forward, and the functions
``serve.py`` has, for a configuration with ``local_enhancers`` (0 gives
``models.py``'s generator). It follows the program's layer layout, which the
JAX package defines, and computes in float32: convolutions and matmuls in
IEEE float32 (TF32 off, ``lowp.ieee_f32``, which is ``allow_tf32`` False
for matmul and cuDNN under PyTorch's newer flags; the check runs every
reference step inside it), each convolution's operands rounded by its
:class:`~benchmark.reference.lowp.Precision` (float8 for the control).
Its ``"bf16"`` form (:class:`Bf16`) computes the same step in bfloat16 at
the layout's rounding points (the JAX package's: bfloat16 activations, the
instance norm's statistics and affine as :class:`RoundedNorm` has them):
the float32 reference's function, rounded where the configuration's
precision rounds it, so a sound bfloat16 program lies close to it and a
lower precision or a fault far from it.

Forward, with L local enhancers: the inputs (label maps and previous frames)
are averaged down L times; the trunk (7x7 stem, 3 stride-2 downsamples, the
resblocks, 3 nearest-2x + 3x3 upsamples, at ``base_ch``) runs on the
coarsest; each enhancer, coarse to fine, runs a 7x7 stem to ``base_ch / 2``
and a 3x3 stride-2 block to ``base_ch`` over its scale's inputs, adds the
coarser stage's feature (the trunk's ``base_ch`` channels, or the enhancer
before's ``base_ch / 2``) through a zero-padded 3x3 conv, runs its resblocks
and a nearest-2x + 3x3 upsample back to ``base_ch / 2`` at its scale; one
7x7 conv over the finest feature gives image, flow and mask.

Departures from pix2pixHD (arXiv:1711.11585, ``--netG local``), each the
program's layout:

* the coarser feature reaches the enhancer through a zero-padded 3x3 conv
  (``merge``) before the add; pix2pixHD adds it directly;
* every upsample is a nearest 2x resize and a 3x3 conv block; pix2pixHD's
  is a transposed 3x3 conv;
* the stride-2 convs reflect-pad their input, as every generator conv
  here does; pix2pixHD's zero-pad it;
* the input pyramid is a 3x3 stride-2 average that counts its zero pad
  (flax's ``avg_pool``); pix2pixHD's ``AvgPool2d`` has
  ``count_include_pad=False``;
* the output is vid2vid's (arXiv:1808.06601) composite heads (image, flow,
  mask, and the warp of the previous frame) over 15 input channels, and the
  trunk has 3 downsamples; pix2pixHD's global network has 4 and outputs an
  image;
* every enhancer has ``base_ch / 2`` channels after its stem (pix2pixHD
  halves them again for each further enhancer; with one the two agree).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.lowp import Precision
from benchmark.reference.models import (
    CompositeGenerator,
    Conv,
    ConvBlock,
    InstanceNorm,
    ResBlock,
    Upsample,
    downscale2x,
    flow_warp,
    nchw,
    nhwc,
)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class Bf16:
    """The configuration's bfloat16 at the layout's rounding points, in
    place of a :class:`~benchmark.reference.lowp.Precision`: a convolution
    reads its input and kernel in bfloat16 and writes bfloat16 (f32
    accumulation); each stage's input pyramid, each residual and merge sum
    is rounded to bfloat16; every instance norm is a :class:`RoundedNorm`.
    The float32 reference and the float8 control leave all of these in
    float32."""

    name = "bf16"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16)


class RoundedNorm(InstanceNorm):
    """Instance norm as the layout computes it in bfloat16 (the JAX
    package's ``InstanceNorm``): the mean and the mean of the squares, each
    square rounded to bfloat16, summed in float32, ``var = max(m2 -
    mean^2, 0)``; the affine folded into ``mul = bf16(scale * rstd)`` and
    ``add = bf16(bias - mean * scale * rstd)``; ``bf16(bf16(x * mul) +
    add)``. Where a plane's mean is several times its spread (a stem over
    flat label maps), the rounded squares shift ``var`` by up to
    ``(mean / std)^2 * 2^-9`` of itself, and ``x * mul`` and ``add`` nearly
    cancel: the largest part of the bfloat16 program's distance from the
    float32 reference."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _bf16(x)
        mean = x.mean(dim=(2, 3), keepdim=True)
        m2 = _bf16(x * x).mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(m2 - mean * mean, min=0.0)
        s = torch.rsqrt(var + self.eps) * self.scale[None, :, None, None]
        mul = _bf16(s)
        add = _bf16(self.bias[None, :, None, None] - mean * s)
        return _bf16(_bf16(x * mul) + add)


def _round_output(module, args, out):
    return _bf16(out)


def _round(module: nn.Module) -> None:
    """Every ``InstanceNorm`` under ``module`` made a ``RoundedNorm``, and
    every ``ResBlock``'s sum rounded."""
    for name, child in module.named_children():
        if type(child) is InstanceNorm:
            norm = RoundedNorm(child.scale.shape[0], child.eps)
            setattr(module, name, norm.to(child.scale.device))
            continue
        if isinstance(child, ResBlock):
            child.register_forward_hook(_round_output)
        _round(child)


class LocalEnhancer(nn.Module):
    """One refinement stage at a finer scale (NCHW); ``feat_ch``: the
    channels of the coarser stage's feature."""

    def __init__(self, cin: int, base_ch: int, feat_ch: int, n_blocks: int,
                 prec: Precision = None):
        super().__init__()
        ch = base_ch // 2
        self.stem = ConvBlock(cin, ch, kernel=7, prec=prec)
        self.down = ConvBlock(ch, 2 * ch, stride=2, prec=prec)
        self.merge = Conv(feat_ch, 2 * ch, 3, padding=1, prec=prec)
        self.res = nn.ModuleList(ResBlock(2 * ch, prec)
                                 for _ in range(n_blocks))
        self.up = Upsample(2 * ch, ch, prec)
        self.rounded = isinstance(prec, Bf16)

    def forward(self, x: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        y = self.down(self.stem(x))
        if feat.shape[2:] != y.shape[2:]:
            # The coarser feature sampled at pixel centres (JAX's "nearest").
            feat = F.interpolate(feat, size=y.shape[2:], mode="nearest-exact")
        y = y + self.merge(feat)
        if self.rounded:
            y = _bf16(y)
        for block in self.res:
            y = block(y)
        return self.up(y)


class HDGenerator(CompositeGenerator):
    """``models.CompositeGenerator`` with ``n_local`` enhancers of
    ``n_local_blocks`` resblocks on top of its trunk, the heads on the
    finest stage. Inputs and outputs NHWC, as the program's."""

    def __init__(self, in_channels: int = 15, base_ch: int = 64,
                 n_downsample: int = 3, n_blocks: int = 9, n_local: int = 1,
                 n_local_blocks: int = 3, flow_scale: float = 10.0,
                 prec: Precision = None):
        super().__init__(in_channels, base_ch, n_downsample, n_blocks,
                         flow_scale, prec)
        self.local = nn.ModuleList(
            LocalEnhancer(in_channels, base_ch,
                          base_ch if i == 0 else base_ch // 2,
                          n_local_blocks, prec)
            for i in range(n_local))
        if n_local:
            self.heads = Conv(base_ch // 2, 6, kernel=7, prec=prec)
        self.rounded = isinstance(prec, Bf16)
        if self.rounded:
            _round(self)

    def forward(self, labels, prev_imgs, has_prev
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        pyramid = [nchw(torch.cat([labels, prev_imgs], dim=-1).float())]
        for _ in self.local:
            down = downscale2x(pyramid[-1])
            pyramid.append(_bf16(down) if self.rounded else down)
        feat = self.trunk(pyramid[-1])
        for stage, x in zip(self.local, reversed(pyramid[:-1])):
            feat = stage(x, feat)
        heads = self.heads(F.pad(feat, (3, 3, 3, 3), mode="reflect"))
        raw = torch.tanh(heads[:, 0:3])
        flow = heads[:, 3:5] * self.flow_scale
        mask = torch.sigmoid(heads[:, 5:6])
        warped = flow_warp(nchw(prev_imgs[..., :3].float()), flow)
        hp = has_prev.float().reshape(-1, 1, 1, 1)
        mask = mask * hp + (1.0 - hp)
        frame = mask * raw + (1.0 - mask) * warped
        return nhwc(frame), nhwc(flow), nhwc(mask)


def _build(cfg: dict, prec: Precision = None) -> HDGenerator:
    return HDGenerator(15, cfg["base_ch"], cfg["n_downsample"],
                       cfg["n_blocks"], cfg.get("local_enhancers", 0),
                       cfg.get("local_blocks", 3), prec=prec)


def reference_generator(cfg: dict, prec: str, state: dict, device):
    """The configuration's generator on ``device`` with the weights
    ``state``, its convolutions at precision ``prec``: ``"f32"``, ``"fp8"``
    (the control) or ``"bf16"`` (:class:`Bf16`)."""
    with torch.device(device):
        gen = _build(cfg, Bf16() if prec == "bf16" else Precision(prec))
    gen.load_state_dict(state, strict=True)
    return gen.eval()


def generator_shapes(cfg: dict) -> dict:
    """{name: shape} of the configuration's generator state dict."""
    with torch.device("meta"):
        gen = _build(cfg)
    return {k: v.shape for k, v in gen.state_dict().items()}
