"""The luma a player decodes from the written file, plain.

The frame-return wire sends each frame's YUV420 planes as 8x8 DCT
coefficients quantized with the JPEG quality-75 tables, truncated to the
first 12 (luma) zigzag coefficients, each block's ACs coarsened by a
per-block shift of 0-3 bits so that they fit 5 bits; the file's JPEGs are
made from those coefficients. This module computes, from float frames, the
luma plane that a baseline JPEG decoder reconstructs from such a stream:
BT.601 studio-swing Y, the DCT, the same quantization, truncation and
shift; the JPEG writer's rescale of the video-range coefficients to
JFIF's full range (x 255/219, the DC offset folded in, requantized with
the same steps, rounded half away from zero); then dequantization and the
inverse DCT, rounded to uint8.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.lowp import round_tf32

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# JPEG Annex K luminance table (quality 50).
LUMA_BASE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.float64)


def luma_quant(quality: int) -> np.ndarray:
    """IJG quality scaling of the luma table, each step floored at 5 (the
    DC at 9) so that a coefficient fits int8."""
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    q = np.clip(np.floor((LUMA_BASE * scale + 50.0) / 100.0), 5.0, 255.0)
    q[0, 0] = max(q[0, 0], 9.0)
    return q


def dct8() -> np.ndarray:
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    d = np.cos((2 * n + 1) * k * np.pi / 16.0) * 0.5
    d[0] /= np.sqrt(2.0)
    return d


def luma_y(frames: torch.Tensor) -> torch.Tensor:
    """[T, H, W, 3] frames in [-1, 1] -> [T, H, W] float Y in 0..255."""
    x = (frames.double() + 1.0) * 127.5
    return 16.0 + (65.738 * x[..., 0] + 129.057 * x[..., 1]
                   + 25.064 * x[..., 2]) / 256.0


def wire_luma(frames: torch.Tensor, quality: int = 75, k: int = 12,
              ac_bits: int = 5, tf32: bool = False) -> np.ndarray:
    """[T, H, W, 3] frames in [-1, 1] (H, W multiples of 8) -> [T, H, W]
    uint8 decoded luma. ``tf32`` (the control) takes the forward DCT's
    product in float32 with TF32 operands, the precision below the wire's
    IEEE float32."""
    y = luma_y(frames) - 128.0
    t, h, w = y.shape
    blocks = y.reshape(t, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    blocks = blocks.reshape(-1, 64)
    d = dct8()
    zr, zc = ZIGZAG[:k] // 8, ZIGZAG[:k] % 8
    basis = d[zr][:, :, None] * d[zc][:, None, :]           # [k, 8, 8]
    quant = luma_quant(quality)[zr, zc]                     # [k]
    fwd = torch.as_tensor((basis / quant[:, None, None]).reshape(k, 64).T,
                          device=y.device)
    if tf32:
        prod = (round_tf32(blocks.float()) @ round_tf32(fwd.float())).double()
    else:
        prod = blocks @ fwd
    q = torch.clamp(torch.round(prod), -127.0, 127.0)
    # Per-block shift s: the least of 0..3 with max|AC| <= lim * 2^s; the
    # ACs become round-half-up(ac / 2^s) * 2^s, clipped to ac_bits.
    lim = (1 << (ac_bits - 1)) - 1
    m = q[:, 1:].abs().amax(dim=1)
    s = ((m > lim).double() + (m > 2 * lim).double()
         + (m > 4 * lim).double())[:, None]
    step = torch.pow(2.0, s)
    ac = torch.clamp(torch.floor(q[:, 1:] / step + 0.5 * (s > 0)),
                     -lim - 1, lim) * step
    q = torch.cat([q[:, :1], ac], dim=1)
    scale = 255.0 / 219.0
    f = q * scale
    f[:, 0] += 8.0 * (scale * 128.0 - 16.0 * scale - 128.0) / quant[0]
    q = torch.sign(f) * torch.floor(f.abs() + 0.5)
    inv = torch.as_tensor((basis * quant[:, None, None]).reshape(k, 64),
                          device=y.device)
    pix = (q @ inv).reshape(t, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4)
    pix = torch.clamp(torch.round(pix.reshape(t, h, w) + 128.0), 0.0, 255.0)
    return pix.to(torch.uint8).cpu().numpy()
