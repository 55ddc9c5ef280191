"""Operation and byte counts, and the table of peaks.

``frame_flops`` is the model's work, not the executed work: the plain
generator's convolutions at ``2 * H * W * Cin * Cout * K^2`` each, the same
whatever form (phase, fused) a program runs them in, so no form can inflate
it; elementwise, norm and warp work (<1%) are left out. ``b1_bound_s`` is
the least time of one fused 3x3 conv + statistics launch: the larger of its
operations over the bf16 peak and its bytes (x, kernel and bias read once;
y, mean and var written once) over the memory bandwidth.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

PEAKS = Path(__file__).resolve().parent.parent / "peaks.json"


def frame_flops(h: int, w: int, base_ch: int = 64, n_downsample: int = 3,
                n_blocks: int = 9, label_ch: int = 9,
                prev_ch: int = 6) -> float:
    """Convolution FLOPs of one generator forward at h x w."""
    mac = 0.0
    ch = base_ch
    mac += h * w * (label_ch + prev_ch) * ch * 49  # 7x7 stem
    hh, ww = h, w
    for _ in range(n_downsample):
        hh, ww = hh // 2, ww // 2
        mac += hh * ww * ch * (2 * ch) * 9
        ch *= 2
    mac += n_blocks * 2 * (hh * ww * ch * ch * 9)
    for _ in range(n_downsample):
        hh, ww = hh * 2, ww * 2
        mac += hh * ww * ch * (ch // 2) * 9
        ch //= 2
    mac += h * w * ch * 6 * 49  # merged heads, 7x7
    return 2.0 * mac


def b1_ops_bytes(b: int, h: int, w: int, c: int, esz: int = 2):
    """(operations, bytes) of one ``conv3x3_stats`` launch on [b, h, w, c]
    activations of ``esz`` bytes, a c -> c 3x3 kernel, a float32 bias and
    float32 per-(b, c) mean and variance."""
    npx = b * h * w
    ops = 2.0 * npx * c * 9 * c
    nbytes = 2 * npx * c * esz + 9 * c * c * esz + 4 * c + 2 * 4 * b * c
    return ops, nbytes


def peaks(device_name: str) -> Optional[dict]:
    """The published peaks of the card named ``device_name``, or None."""
    return json.loads(PEAKS.read_text()).get(device_name)


def bound_s(ops: float, nbytes: float, peak: dict) -> float:
    return max(ops / peak["bf16_flops_per_s"], nbytes / peak["hbm_bytes_per_s"])
