"""BT.601 studio-swing RGB -> YUV420 on the device (counterpart of
``text2video_tpu/ops/colorspace.py``): frames leave the card at 1.5 bytes a
pixel instead of 3, and every container the muxer writes is 4:2:0 anyway.
Chroma is the mean of each 2x2 block."""

from __future__ import annotations

from typing import Tuple

import torch


def rgb_norm_to_yuv420_float(
    frames: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., H, W, 3] frames in [-1, 1] (H, W even) -> (y [..., H, W],
    u [..., H/2, W/2], v [..., H/2, W/2]) f32 planes in 0..255, unrounded."""
    x = (frames.float() + 1.0) * 127.5
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 16.0 + (65.738 * r + 129.057 * g + 25.064 * b) * (1.0 / 256.0)
    u = 128.0 + (-37.945 * r - 74.494 * g + 112.439 * b) * (1.0 / 256.0)
    v = 128.0 + (112.439 * r - 94.154 * g - 18.285 * b) * (1.0 / 256.0)

    def sub(c: torch.Tensor) -> torch.Tensor:
        s = c.shape
        c = c.reshape(*s[:-2], s[-2] // 2, 2, s[-1] // 2, 2)
        return c.mean(dim=(-3, -1))

    return y, sub(u), sub(v)


def rgb_norm_to_yuv420(
    frames: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like :func:`rgb_norm_to_yuv420_float`, rounded half to even and
    clamped to uint8."""
    return tuple(
        torch.clamp(torch.round(c), 0.0, 255.0).to(torch.uint8)
        for c in rgb_norm_to_yuv420_float(frames)
    )
