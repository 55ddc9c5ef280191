"""Building blocks of the pose2frame generator, in PyTorch.

Counterpart of ``text2video_tpu/models/layers.py`` (plain forms only; the
TPU phase forms are not ported). Public tensors are NHWC, as in the JAX
package. Parameters keep the flax layout and dtype — conv kernels HWIO
``[k, k, cin, cout]`` float32 under ``kernel``, biases under ``bias``,
instance-norm ``scale``/``bias`` — so a converted flax tree
(``convert.py``) loads without transposes. Each conv keeps a packed copy of
its kernel and bias in the compute dtype, made once and remade only when a
parameter changes, not cast on every call. The copies are detached and serve
inference; when grad mode is on and a parameter requires grad, a conv casts
the live f32 parameter inside the graph instead (what flax does with
``param_dtype=f32, dtype=bf16``), so gradients reach the master parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from text2video_tpu_torch.ops import fused_resblock

# flax's lecun_normal draws from a normal truncated at +-2 std and rescales
# by this constant so the kept samples have the nominal variance.
_TRUNC_STD = 0.87962566103423978


class ParamCopy:
    """A tensor made from parameters, remade only when one of them changes.

    Keyed on each parameter's ``data_ptr()`` and ``_version``: moving a
    module changes the first, and ``load_state_dict`` (which copies in
    place) bumps the second. Parameters made under ``inference_mode`` keep
    no version counter; their copy is made anew on every call."""

    def __init__(self, make: Callable[..., object]):
        self.make = make
        self.key = None
        self.value = None

    def get(self, *params: torch.Tensor):
        if any(p.is_inference() for p in params):
            with torch.no_grad():
                return self.make(*(p.detach() for p in params))
        key = tuple((p.data_ptr(), p._version) for p in params)
        if key != self.key:
            with torch.no_grad():
                self.value = self.make(*(p.detach() for p in params))
            self.key = key
        return self.value


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    return y.permute(0, 2, 3, 1)


def _fold_reflected(g: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """The gradient of a reflect pad of ``pad`` along ``dim``: the interior
    of ``g`` plus its border rows added back onto the rows they mirror
    (padded row ``i < pad`` copies row ``pad - i``)."""
    n = g.shape[dim] - 2 * pad
    out = g.narrow(dim, pad, n).clone()
    out.narrow(dim, 1, pad).add_(g.narrow(dim, 0, pad).flip(dim))
    out.narrow(dim, n - 1 - pad, pad).add_(
        g.narrow(dim, n + pad, pad).flip(dim))
    return out


class _DeterministicReflectPad(torch.autograd.Function):
    """``F.pad(mode="reflect")`` forward; a backward that sums the border
    into the interior by elementwise adds in a fixed order. The CUDA backward
    of ``F.pad`` accumulates with atomics, so its result varies run to run,
    and PyTorch's deterministic mode (the train step runs in it) refuses
    it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, pad: int) -> torch.Tensor:
        ctx.pad = pad
        return _reflect_pad(x, pad)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        p = ctx.pad
        return _fold_reflected(_fold_reflected(g, p, 1), p, 2), None


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the H and W axes of an NHWC tensor. A pad that autograd
    will differentiate takes :class:`_DeterministicReflectPad`."""
    if pad == 0:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _DeterministicReflectPad.apply(x, pad)
    return _reflect_pad(x, pad)


class Conv(nn.Module):
    """NHWC conv, VALID unless ``padding`` (zeros on each side of H and W)
    is given; the bias is added in the compute dtype."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, dtype: torch.dtype = torch.bfloat16,
                 padding: int = 0):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.zeros(kernel, kernel, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        # F.conv2d's OIHW kernel and the bias, in the compute dtype.
        self._packed = ParamCopy(lambda k, b: (
            k.to(dtype).permute(3, 2, 0, 1).contiguous(), b.to(dtype)))
        # The fused op's HWIO kernel in the compute dtype.
        self._hwio = ParamCopy(lambda k: k.to(dtype).contiguous())

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun-normal kernel (flax's default), zero bias."""
        kh, kw, cin, _ = self.kernel.shape
        std = math.sqrt(1.0 / (kh * kw * cin)) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.kernel, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            self.bias.zero_()

    def hwio_kernel(self) -> torch.Tensor:
        """The kernel [k, k, cin, cout] in the compute dtype (cached)."""
        return self._hwio.get(self.kernel)

    def trains(self) -> bool:
        """True when a call must stay on the autograd graph of the
        parameters."""
        return torch.is_grad_enabled() and (
            self.kernel.requires_grad or self.bias.requires_grad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.trains():
            w = self.kernel.to(self.dtype).permute(3, 2, 0, 1)
            b = self.bias.to(self.dtype)
        else:
            w, b = self._packed.get(self.kernel, self.bias)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w,
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1) + b


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over H and W with f32 stats:
    ``var = max(E[x^2] - E[x]^2, 0)``, eps 1e-5, and the affine applied as
    ``x * mul + add`` with ``mul``/``add`` rounded to the compute dtype."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 epsilon: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(
        self,
        x: torch.Tensor,
        stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """``stats``: precomputed ([B, C] mean, [B, C] var), as the fused
        conv kernel emits them from its f32 accumulator."""
        if stats is not None:
            mean, var = stats
        else:
            mean = x.float().mean(dim=(1, 2))
            m2 = x.square().float().mean(dim=(1, 2))
            var = torch.clamp(m2 - mean.square(), min=0.0)
        rstd = torch.rsqrt(var + self.epsilon)
        mul = (rstd * self.scale).to(self.dtype)
        add = (self.bias - mean * rstd * self.scale).to(self.dtype)
        return x * mul[:, None, None, :] + add[:, None, None, :]


class ConvBlock(nn.Module):
    """ReflectPad -> Conv -> InstanceNorm -> ReLU (norm/act optional).

    ``fused`` runs the conv and the norm statistics through
    ``ops/fused_resblock.py::conv3x3_stats`` (kernel B1 on a card) — same
    parameters and math; requires kernel 3, stride 1 and norm."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, norm: bool = True, act: bool = True,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False):
        super().__init__()
        if fused and (kernel != 3 or stride != 1 or not norm):
            raise ValueError("fused requires kernel=3, stride=1, norm")
        self.pad = kernel // 2
        self.act = act
        self.dtype = dtype
        self.fused = fused
        self.conv = Conv(in_features, features, kernel, stride, dtype)
        self.norm = InstanceNorm(features, dtype) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            # Looked up on the module at call time, so a check can swap in
            # the plain version (chip_smoke.py does).
            y, mean, var = fused_resblock.conv3x3_stats(
                x.to(self.dtype).contiguous(), self.conv.hwio_kernel(),
                self.conv.bias)
            y = self.norm(y, stats=(mean, var))
        else:
            y = self.conv(reflect_pad(x, self.pad))
            if self.norm is not None:
                y = self.norm(y)
        return F.relu(y) if self.act else y


class ResBlock(nn.Module):
    """Two reflect-padded 3x3 ConvBlocks with a residual skip. ``fused``
    (the serving default) sends both convs through the fused conv +
    statistics op, at every batch size; ``fused=False`` runs the plain
    reflect-pad conv + InstanceNorm on the same parameters, which is the
    form that trains (the fused op has no backward)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 fused: bool = True):
        super().__init__()
        self.block0 = ConvBlock(features, features, dtype=dtype, fused=fused)
        self.block1 = ConvBlock(features, features, act=False, dtype=dtype,
                                fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block1(self.block0(x))


class Upsample(nn.Module):
    """2x nearest-neighbour upsample followed by a 3x3 ConvBlock."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.block = ConvBlock(in_features, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return self.block(x)


def downscale2x(x: torch.Tensor) -> torch.Tensor:
    """3x3 average pool, stride 2, zero pad 1 on an NHWC tensor; the zero
    pad counts in the average, as flax's ``nn.avg_pool`` counts it. Summed
    in f32 from nine strided slices: ``F.avg_pool2d``'s CUDA backward
    returned wrong input gradients for the channels-last view an NHWC
    tensor gives it (torch 2.11.0+cu128; ``chip_smoke.py`` holds the card's
    gradients through this pyramid against the CPU's)."""
    _, h, w, _ = x.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy: dy + 2 * ho - 1: 2, dx: dx + 2 * wo - 1: 2]
            acc = tap if acc is None else acc + tap
    return (acc / 9.0).to(x.dtype)
