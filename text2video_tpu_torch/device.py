"""Where the port's entry points run: on the card unless the caller names
another device; and which card that is."""

from __future__ import annotations

import subprocess
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


def device_info(device: torch.device) -> dict:
    """The name and power limit of the card ``device`` as ``nvidia-smi
    --query-gpu=name,power.limit`` gives them; the CPU has neither."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[device.index or 0]
    name, limit = line.rsplit(",", 1)
    return {"name": name.strip(), "power_limit": limit.strip()}
