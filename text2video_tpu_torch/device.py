"""Where the port's entry points run: on the card unless the caller names
another device."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device``, or ``cuda`` when it is None. A CUDA device on a machine
    without one raises: nothing carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the plain versions on the CPU")
    return dev
