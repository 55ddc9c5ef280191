"""The instance norm of a generator conv block: its statistics with the conv
bias folded in, and its apply with the ReLU and the residual add.

A generator ``ConvBlock`` ends in a chain of eager ops after its conv: the
conv bias, ``InstanceNorm.forward`` (two f32 reductions, the [B, C] affine
arithmetic, ``x * mul + add``), the ReLU and, in ``ResBlock``, the residual
add. :func:`finish_plain` is that chain as the layers ran it. On a card,
outside autograd, :func:`finish` runs it as two hand-written kernels
(``csrc/fused_norm.cu``): :func:`norm_stats` (one read of the conv output,
where kernel B1 has not already taken the statistics) and :func:`norm_apply`
(one read and one write, two reads with a residual), each keeping the eager
chain's rounding points, so the two paths part only by the f32 sum order
and the rsqrt.

Dispatch, the rule of ``ops/fused_resblock.py``: a CUDA tensor that no
autograd graph follows takes the kernels, anything else the eager chain
(the CPU, and every path that trains, where the chain is differentiated).
A CUDA tensor the kernels cannot take raises. The discriminators' norms do
not come here: they call ``InstanceNorm`` themselves.

Phase tensors: a block's output with G times the norm's C channels is a
phase tensor [B, h, w, G*C] (``ops/phase_conv.py``): the conv bias is tiled
over the G phases and the statistics pool over space and phases. The
kernels see every output as [B, R, C] with R = h * w * G rows, or, where
its NHWC view lies in memory as NCHW (the layout cuDNN gives some strided
convs' outputs), as [B, C, R] planes, read and written in that layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from text2video_tpu_torch import kernels

# Kernel launches since import, by kernel; chip_smoke.py reads and resets
# them, and render.py::StepGraph adds a replayed graph's.
launches = {"norm_stats": 0, "norm_apply": 0}

Stats = Tuple[torch.Tensor, torch.Tensor]


def add_bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``y`` [..., G*C] plus the (C,) bias in each of its G phases (the JAX
    ``tile(b, G)``, by broadcasting); ``y + b`` for G = 1."""
    phase = y.shape[-1] // b.shape[0]
    if phase == 1:
        return y + b
    return (y.unflatten(-1, (phase, b.shape[0])) + b).flatten(-2)


def finish_plain(y: torch.Tensor, norm, bias: Optional[torch.Tensor] = None,
                 stats: Optional[Stats] = None, relu: bool = False,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The eager chain after a block's conv, on any device: ``y`` plus the
    conv ``bias`` (tiled over phases), ``norm`` (an ``InstanceNorm``) with
    ``stats`` where the conv took them, the ReLU, ``residual +``."""
    if bias is not None:
        y = add_bias(y, bias)
    y = norm(y, stats=stats)
    if relu:
        y = F.relu(y)
    return y if residual is None else residual + y


def norm_stats_plain(y: torch.Tensor, norm,
                     bias: Optional[torch.Tensor] = None) -> Stats:
    """What :func:`norm_stats` computes, as the eager chain computes it."""
    if bias is not None:
        y = add_bias(y, bias)
    return norm.statistics(y)


def _differentiated(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def finish(y: torch.Tensor, norm, bias: Optional[torch.Tensor] = None,
           stats: Optional[Stats] = None, relu: bool = False,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`finish_plain`'s function: by the two kernels for a CUDA
    tensor outside autograd, else by :func:`finish_plain`."""
    followed = (y, norm.scale, norm.bias, bias, residual,
                *(stats if stats is not None else ()))
    if not y.is_cuda or _differentiated(*followed):
        return finish_plain(y, norm, bias, stats, relu, residual)
    if stats is None:
        stats = norm_stats(y, norm.scale.shape[0], bias)
    return norm_apply(y, *stats, norm.scale, norm.bias, norm.epsilon,
                      bias=bias, relu=relu, residual=residual)


def _rows(y: torch.Tensor, features: int, what: str) -> Tuple[int, int]:
    """(B, R) of ``y`` seen as [B, R, features]; raises on what the kernels
    do not take."""
    if not y.is_cuda:
        raise ValueError(f"{what}: a CUDA tensor, got {y.device}")
    if y.dtype not in (torch.bfloat16, torch.float32) or y.dim() < 2:
        raise ValueError(f"{what}: y must be bf16/f32 with a batch axis, got "
                         f"{tuple(y.shape)} {y.dtype}")
    if features < 1 or y.shape[-1] % features:
        raise ValueError(f"{what}: {y.shape[-1]} channels are not phases of "
                         f"{features}")
    bsz = y.shape[0]
    rows = y.numel() // max(bsz * features, 1)
    if bsz < 1 or rows < 1 or rows * features >= 2 ** 31 or bsz > 65535:
        raise ValueError(f"{what}: shape {tuple(y.shape)} out of range")
    return bsz, rows


def _planar(y: torch.Tensor, features: int) -> bool:
    """True where NHWC ``y`` [B, H, W, C] lies in memory as NCHW."""
    return (y.dim() == 4 and y.shape[-1] == features
            and not y.is_contiguous()
            and y.permute(0, 3, 1, 2).is_contiguous())


def _layout(y: torch.Tensor, features: int,
            residual: Optional[torch.Tensor] = None):
    """(``y``, ``residual``, planar): the tensors as the kernels read them.
    A dense NHWC or NCHW-in-memory ``y`` is taken as it lies, with a
    residual of its strides; anything else is copied to NHWC."""
    planar = _planar(y, features)
    if not planar:
        y = y.contiguous()  # no copy where y already is
    if residual is not None and residual.stride() != y.stride():
        planar, y, residual = False, y.contiguous(), residual.contiguous()
    return y, residual, int(planar)


def _vec(n: int, *tensors) -> int:
    """1 where every tensor allows 16-byte loads of ``n`` elements in a
    row (the channels, or a plane's rows where planar)."""
    esz = tensors[0].element_size()
    return int(n * esz % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _param(t: torch.Tensor, n: int, dtype, device, what: str) -> torch.Tensor:
    if tuple(t.shape) != (n,) or t.device != device:
        raise ValueError(f"{what}: a ({n},) tensor on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.to(dtype).contiguous()


def norm_stats(y: torch.Tensor, features: int,
               bias: Optional[torch.Tensor] = None) -> Stats:
    """y [B, ..., G*C] bf16 or f32 on a card (C = ``features``), bias (C,)
    or None -> (mean, var) [B, C] f32 of ``round(y + bias)`` over every axis
    but the batch and the phase's channel. Inference only: its callers
    decide that (:func:`finish`)."""
    bsz, rows = _rows(y, features, "norm_stats")
    y, _, planar = _layout(y, features)
    if bias is not None:
        bias = _param(bias, features, y.dtype, y.device, "norm_stats bias")
    is_bf16 = int(y.dtype == torch.bfloat16)
    vec = _vec(rows if planar else features, y)
    lib = kernels.library()
    splits = lib.t2v_norm_splits(bsz, rows, features, is_bf16, vec, planar)
    stats = torch.empty((2, bsz, features), dtype=torch.float32,
                        device=y.device)
    parts = torch.empty((bsz, splits, 2, features), dtype=torch.float32,
                        device=y.device)
    with torch.cuda.device(y.device):
        rc = lib.t2v_norm_stats(
            y.data_ptr(), bias.data_ptr() if bias is not None else None,
            parts.data_ptr(), stats.data_ptr(),
            stats.data_ptr() + bsz * features * 4, bsz, rows, features,
            splits, is_bf16, vec, planar,
            torch.cuda.current_stream(y.device).cuda_stream)
    kernels.check_launch(rc, "norm_stats")
    launches["norm_stats"] += 1
    mean, var = stats
    return mean, var


def norm_apply(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               scale: torch.Tensor, shift: torch.Tensor, eps: float,
               bias: Optional[torch.Tensor] = None, relu: bool = False,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y [B, ..., G*C] bf16 or f32 on a card, mean and var [B, C] f32, the
    norm's scale and shift (C,) -> ``[residual +] [relu](round(round(
    round(y [+ bias]) * mul) + add))`` in y's dtype and shape, with mul and
    add rounded to it from ``rsqrt(var + eps) * scale`` and ``shift - mean
    * rsqrt(var + eps) * scale``, the C channels' parameters applied to
    every phase. Inference only: its callers decide that (:func:`finish`)."""
    features = scale.shape[0]
    bsz, rows = _rows(y, features, "norm_apply")
    dev = y.device
    mean = mean.float().contiguous()
    var = var.float().contiguous()
    if (tuple(mean.shape) != (bsz, features) or var.shape != mean.shape
            or mean.device != dev or var.device != dev):
        raise ValueError(f"norm_apply: mean and var must be ({bsz}, "
                         f"{features}) on {dev}")
    scale = _param(scale, features, torch.float32, dev, "norm_apply scale")
    shift = _param(shift, features, torch.float32, dev, "norm_apply shift")
    if bias is not None:
        bias = _param(bias, features, y.dtype, dev, "norm_apply bias")
    if residual is not None and (residual.shape != y.shape
                                 or residual.dtype != y.dtype
                                 or residual.device != dev):
        raise ValueError(
            f"norm_apply: residual {tuple(residual.shape)} {residual.dtype} "
            f"does not match y {tuple(y.shape)} {y.dtype}")
    y, residual, planar = _layout(y, features, residual)
    out = torch.empty_like(y)  # y's strides: NHWC, or NCHW where planar
    is_bf16 = int(y.dtype == torch.bfloat16)
    vec = _vec(rows if planar else features, y, out,
               *(() if residual is None else (residual,)))
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.t2v_norm_apply(
            y.data_ptr(), bias.data_ptr() if bias is not None else None,
            residual.data_ptr() if residual is not None else None,
            mean.data_ptr(), var.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), out.data_ptr(), bsz, rows, features,
            float(eps), int(relu), is_bf16, vec, planar,
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(rc, "norm_apply")
    launches["norm_apply"] += 1
    return out
