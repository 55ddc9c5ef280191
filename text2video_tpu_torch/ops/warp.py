"""Dense bilinear flow warping (counterpart of ``text2video_tpu/ops/warp.py``).

The gather form of the JAX package, value for value: sample positions are
clamped to the border in f32, the 2x2 neighbourhood is stacked on the
channel axis and gathered once, and the blend weights stay f32 while the
gathered values keep the image dtype. ``F.grid_sample`` normalises the
coordinates and rounds differently, so it is not used.
"""

from __future__ import annotations

import torch


def flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """img [B, H, W, C] (any float dtype), flow [B, H, W, 2] pixel offsets
    (``flow[..., 0]`` = dx, ``flow[..., 1]`` = dy) -> [B, H, W, C] in img's
    dtype: output (y, x) samples img at (y + dy, x + dx), border-clamped."""
    b, h, w, c = img.shape
    f32 = torch.float32
    yy = torch.arange(h, dtype=f32, device=img.device)[:, None]
    xx = torch.arange(w, dtype=f32, device=img.device)[None, :]
    sx = torch.clamp(xx + flow[..., 0].to(f32), 0.0, w - 1.0)
    sy = torch.clamp(yy + flow[..., 1].to(f32), 0.0, h - 1.0)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[..., None]
    wy = (sy - y0)[..., None]

    right = torch.cat([img[:, :, 1:], img[:, :, -1:]], dim=2)
    down = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    down_right = torch.cat([right[:, 1:], right[:, -1:]], dim=1)
    stacked = torch.cat([img, right, down, down_right], dim=-1)
    flat = stacked.reshape(b, h * w, 4 * c)
    idx = (y0.long() * w + x0.long()).reshape(b, h * w, 1)
    gathered = torch.gather(flat, 1, idx.expand(b, h * w, 4 * c))
    gathered = gathered.reshape(b, h, w, 4, c)
    v00, v01, v10, v11 = gathered.unbind(dim=3)

    top = v00.to(f32) + (v01 - v00).to(f32) * wx
    bot = v10.to(f32) + (v11 - v10).to(f32) * wx
    return (top + (bot - top) * wy).to(img.dtype)


def flow_tv(flow: torch.Tensor) -> torch.Tensor:
    """Total-variation smoothness penalty on a [B, H, W, 2] flow field: the
    mean absolute forward difference along each spatial axis, summed."""
    dy = (flow[:, 1:] - flow[:, :-1]).abs()
    dx = (flow[:, :, 1:] - flow[:, :, :-1]).abs()
    return dy.mean() + dx.mean()
