"""The port's renderer checkpoints (the inference half of
``text2video_tpu/train/checkpoints.py``, in the port's own format).

A checkpoint is a directory holding

* ``config.json``: the generator's hyperparameters under the JAX
  checkpoint's meta keys (``base_ch``, ``n_blocks`` and, where the model
  was trained at a fixed height, ``height``);
* ``generator.pt``: the generator's ``state_dict`` (flax layout: HWIO f32
  kernels; ``convert.params_from_flax`` makes one from a flax tree).

Orbax checkpoints of the JAX package are not read here.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from text2video_tpu_torch import device as devices
from text2video_tpu_torch.config import PersonProfile, RenderConfig
from text2video_tpu_torch.render import Renderer

CONFIG_NAME = "config.json"
WEIGHTS_NAME = "generator.pt"


def save_renderer(renderer: Renderer, ckpt_dir: str,
                  height: Optional[int] = None) -> None:
    """Write ``renderer``'s generator to ``ckpt_dir``. ``height``: the
    height the model works at (the loader's ``load_size``), or None to
    render at each person's canvas."""
    gen = renderer.generator
    meta = {"base_ch": int(gen.heads.kernel.shape[2]),
            "n_blocks": len(gen.trunk.res)}
    if height is not None:
        meta["height"] = int(height)
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, CONFIG_NAME), "w") as f:
        json.dump(meta, f, indent=1)
    state = {k: v.detach().cpu() for k, v in gen.state_dict().items()}
    torch.save(state, os.path.join(ckpt_dir, WEIGHTS_NAME))


def load_renderer(
    ckpt_dir: str,
    profile: PersonProfile,
    decode_mode: str = "scan",
    jacobi_sweeps: int = 3,
    device=None,
) -> Renderer:
    """Build an inference Renderer (bf16, as the JAX loader builds it) from
    a checkpoint directory, on ``device``, the card unless the caller names
    another. ``profile`` is taken for the JAX loader's signature; the
    working height comes from the checkpoint's ``height``, so a model
    trained at 384 renders a 1080p person at 384 rows (reference:
    --loadSize 512 --resize_or_crop scaleHeight, text2video_audio.sh:42)."""
    if decode_mode != "scan":
        raise NotImplementedError(
            f"decode_mode {decode_mode!r}: the port decodes with the exact "
            "sequential scan only")
    device = devices.resolve(device)
    with open(os.path.join(ckpt_dir, CONFIG_NAME)) as f:
        meta = json.load(f)
    load_size = int(meta["height"]) if "height" in meta else None
    renderer = Renderer.create(
        config=RenderConfig(load_size=load_size, decode_mode=decode_mode,
                            jacobi_sweeps=jacobi_sweeps),
        base_ch=int(meta.get("base_ch", 64)),
        n_blocks=int(meta.get("n_blocks", 9)),
        dtype=torch.bfloat16,
        device=device,
    )
    state = torch.load(os.path.join(ckpt_dir, WEIGHTS_NAME),
                       map_location=device, weights_only=True)
    renderer.generator.load_state_dict(state, strict=True)
    return renderer
