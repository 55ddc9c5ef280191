"""Serving, plain: the configuration's generator, which the check runs one
step at a time from the inputs the program fed each step (``lib/tap.py``).

Frame t sees label maps t, t-1, t-2 and the frames generated at t-1 and
t-2 (zeros before the utterance starts); frame 0 has no previous frame.
"""

from __future__ import annotations

import torch

from benchmark.reference.lowp import Precision
from benchmark.reference.models import CompositeGenerator


def reference_generator(cfg: dict, prec: str, state: dict, device):
    """The configuration's generator on ``device`` with the weights
    ``state``, its convolutions at precision ``prec``."""
    with torch.device(device):
        gen = CompositeGenerator(
            15, cfg["base_ch"], cfg["n_downsample"], cfg["n_blocks"],
            prec=Precision(prec))
    gen.load_state_dict(state, strict=True)
    return gen.eval()


def generator_shapes(cfg: dict) -> dict:
    """{name: shape} of the configuration's generator state dict."""
    with torch.device("meta"):
        gen = CompositeGenerator(15, cfg["base_ch"],
                                 cfg["n_downsample"], cfg["n_blocks"])
    return {k: v.shape for k, v in gen.state_dict().items()}

