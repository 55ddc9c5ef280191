"""Precision of the reference's convolutions.

The reference computes in float32 with TF32 off. Its control computes the
same function with every convolution's input and kernel rounded to float8
(e4m3, one scale a tensor from its largest magnitude), the step below the
bfloat16 the configurations state. In a backward pass the rounding is a
straight-through estimator: the forward sees the rounded values, the
gradient flows as if it had not been rounded.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a per-tensor scale, back in f32."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x).detach()


def round_bf16(a):
    """A float array rounded to bfloat16 (nearest even), back in float64."""
    import numpy as np
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(
        torch.bfloat16).to(torch.float64).numpy()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to TF32's 10-bit mantissa (nearest even), as
    a tensor core reads its operands."""
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


class Precision:
    """What a reference conv does to its operands: nothing (``"f32"``) or
    :func:`round_fp8` (``"fp8"``)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return round_fp8(x) if self.name == "fp8" else x


@contextlib.contextmanager
def ieee_f32():
    """Float32 convolutions and matmuls in IEEE float32 (no TF32) for the
    block, the caller's settings restored after it. The program sets these
    flags through the same (non-legacy) API; PyTorch refuses a mix."""
    conv, mm = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    old = conv.fp32_precision, mm.fp32_precision
    conv.fp32_precision = mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision, mm.fp32_precision = old
