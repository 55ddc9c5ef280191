"""Reflect-padded 3x3 conv + bias with fused instance-norm statistics.

Counterpart of ``text2video_tpu/ops/fused_resblock.py``. The kernel
(``csrc/conv3x3_stats.cu``) runs every resblock conv of the generator and
emits the conv output in the compute dtype plus per-tile channel sums taken
from its f32 accumulator, which a second small kernel of the same call
finishes exactly as the JAX wrapper does (``mean = s1/n``,
``var = max(s2/n - mean^2, 0)``).

Dispatch: a CPU tensor takes :func:`conv3x3_stats_plain`; a CUDA tensor
launches the kernel or raises. The op has no backward (the JAX kernel
defines no VJP either): under grad mode with an input that requires grad it
raises on both devices, so a training graph cannot pass through it unseen.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from text2video_tpu_torch import kernels

# Kernel launches since import; chip_smoke.py reads and resets it.
launches = 0


def conv3x3_stats_plain(
    x: torch.Tensor, k: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`conv3x3_stats`, on any device.

    The products of compute-dtype values are exact in f32, so the conv runs
    in f32 on the compute-dtype-rounded inputs: the kernel's own contract
    (f32 accumulate, one rounding of y). On a card, set
    ``torch.backends.cudnn.allow_tf32 = False`` before holding the kernel
    against it."""
    dt = x.dtype
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    w = k.to(dt).float().permute(3, 2, 0, 1)
    acc = F.conv2d(xp, w) + b.float()[None, :, None, None]  # [B, C, H, W]
    n = float(acc.shape[2] * acc.shape[3])
    mean = acc.sum(dim=(2, 3)) / n
    var = torch.clamp(acc.square().sum(dim=(2, 3)) / n - mean.square(), min=0.0)
    y = acc.to(dt).permute(0, 2, 3, 1).contiguous()
    return y, mean, var


def conv3x3_stats(
    x: torch.Tensor, k: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, H, W, C] compute dtype (bf16 or f32), k [3, 3, C, C] HWIO in
    f32 or the compute dtype (taken as it is when it already has x's dtype;
    callers keep such a copy), b [C] f32 -> (y [B, H, W, C] compute dtype,
    mean [B, C] f32, var [B, C] f32). Inference only: raises when autograd
    would have to differentiate it."""
    if torch.is_grad_enabled() and (
            x.requires_grad or k.requires_grad or b.requires_grad):
        raise RuntimeError(
            "conv3x3_stats has no backward: build the generator with "
            "fused_resblocks=False to train, or call it under "
            "torch.no_grad() / torch.inference_mode()")
    if x.device.type == "cpu":
        return conv3x3_stats_plain(x, k, b)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_stats: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv3x3_stats: x must be 4-D bf16/f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    bsz, h, w, c = x.shape
    if c % 64 or h < 2 or w < 2:
        raise ValueError(f"conv3x3_stats kernel needs C % 64 == 0 and "
                         f"H, W >= 2, got {tuple(x.shape)}")
    if tuple(k.shape) != (3, 3, c, c) or tuple(b.shape) != (c,):
        raise ValueError(f"conv3x3_stats: k {tuple(k.shape)} / b "
                         f"{tuple(b.shape)} do not match C={c}")
    if k.device != x.device or b.device != x.device:
        raise ValueError("conv3x3_stats: x, k and b must share a device")
    is_bf16 = x.dtype == torch.bfloat16
    kc = k.to(x.dtype).contiguous()  # no copy when k already is
    bf = b.float().contiguous()
    if not x.is_contiguous() or x.data_ptr() % 16 or kc.data_ptr() % 16:
        raise ValueError("conv3x3_stats: x and k must be contiguous and "
                         "16-byte aligned")
    lib = kernels.library()
    tiles = lib.t2v_conv3x3_tiles(h, w, int(is_bf16))
    y = torch.empty_like(x)
    stats = torch.empty((2, bsz, c), dtype=torch.float32, device=x.device)
    parts = torch.empty((bsz, tiles, 2, c), dtype=torch.float32,
                        device=x.device)
    # bf16 loads its A tiles by TMA from a reflect-padded copy of x.
    xp = (torch.empty((bsz, h + 2, w + 2, c), dtype=x.dtype, device=x.device)
          if is_bf16 else None)
    with torch.cuda.device(x.device):
        rc = lib.t2v_conv3x3_stats(
            x.data_ptr(), kc.data_ptr(), bf.data_ptr(), y.data_ptr(),
            parts.data_ptr(), stats.data_ptr(), stats.data_ptr() + bsz * c * 4,
            xp.data_ptr() if is_bf16 else None, bsz, h, w, c, int(is_bf16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check_launch(rc, "conv3x3_stats")
    global launches
    launches += 1
    mean, var = stats
    return y, mean, var
