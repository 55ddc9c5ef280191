"""Seeded random weights, made on the device in a few large calls.

Conv kernels (4-D ``kernel`` leaves, HWIO) are lecun-normal, truncated at
two standard deviations and rescaled to the nominal variance; biases are
zero and instance-norm scales one. One ``torch.Generator`` on the device
draws every kernel element of a model in one call; the leaves are views cut
from it. The same dict is loaded into the program and handed to the
reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated at +-2


def make(shapes: Dict[str, torch.Size], seed: int, device,
         scales: Dict[str, float] = None) -> Dict[str, torch.Tensor]:
    """Float32 weights for a state dict's ``{name: shape}``; a kernel whose
    name ends with a key of ``scales`` is drawn at that multiple of the
    lecun standard deviation."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    kernels = [n for n, s in shapes.items()
               if n.endswith("kernel") and len(s) == 4]
    total = sum(math.prod(shapes[n]) for n in kernels)
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name in kernels:
            kh, kw, cin, _ = shape
            size = math.prod(shape)
            std = math.sqrt(1.0 / (kh * kw * cin)) / TRUNC_STD
            std *= next((v for k, v in (scales or {}).items()
                         if name.endswith(k)), 1.0)
            out[name] = flat[at: at + size].view(shape).mul_(std)
            at += size
        elif name.endswith("scale"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
