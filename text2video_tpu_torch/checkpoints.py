"""The port's checkpoints (counterpart of
``text2video_tpu/train/checkpoints.py``, in the port's own format).

A renderer checkpoint (``save_renderer``) is a directory holding

* ``config.json``: the generator's hyperparameters under the JAX
  checkpoint's meta keys (``base_ch``, ``n_blocks`` and, where the model
  was trained at a fixed height, ``height``);
* ``generator.pt``: the generator's ``state_dict`` (flax layout: HWIO f32
  kernels; ``convert.params_from_flax`` makes one from a flax tree).

A training directory (``save_state``) holds ``config.json`` with every field
of the ``TrainConfig``, as the JAX package writes it, and one
``step_%08d/state.pt`` per kept step: the step, the generator's and the
discriminators' ``state_dict``s, the VGG filters where used, and both Adam
states. A step directory is written under a temporary name and renamed, so a
directory named ``step_*`` is always a finished save. ``load_renderer`` reads
either kind. A run over the mesh's model axis saves the same format: its
sharded kernels and their moments are gathered whole first, so its directory
loads in one process and a one-process directory resumes under the axis.

Orbax checkpoints of the JAX package are not read here:
``tools/orbax_to_torch.py`` (which needs JAX) converts one into this format.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional

import torch

from text2video_tpu_torch import device as devices
from text2video_tpu_torch.config import PersonProfile, RenderConfig
from text2video_tpu_torch.parallel.model_axis import gather_full
from text2video_tpu_torch.render import Renderer

CONFIG_NAME = "config.json"
WEIGHTS_NAME = "generator.pt"
STATE_NAME = "state.pt"
_TMP_MARK = ".tmp"


def _cpu(tree):
    """A (nested) state_dict with every tensor detached on the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def save_state(ckpt_dir: str, state, cfg=None, keep_last: int = 3,
               mesh=None) -> None:
    """Save ``state`` (a ``train.trainer.TrainerState``) as
    ``step_%08d/state.pt`` and, with ``cfg`` (its ``TrainConfig``),
    ``config.json``; keep only the newest ``keep_last`` steps.

    Where the state's kernels are sharded over ``mesh``'s model axis, every
    rank of the model group of data index 0 calls: the shards and their Adam
    moments are gathered whole (``parallel.model_axis.gather_full``) and
    global rank 0 alone writes them, in the format of one process."""
    generator, g_opt = gather_full(state.generator, mesh, state.g_opt)
    discriminators, d_opt = gather_full(state.discriminators, mesh,
                                        state.d_opt)
    if mesh is not None and not mesh.is_main:
        return
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    if cfg is not None:
        meta = {k: (str(v) if k == "dtype" else v)
                for k, v in dataclasses.asdict(cfg).items()}
        with open(os.path.join(ckpt_dir, CONFIG_NAME), "w") as f:
            json.dump(meta, f, indent=1)
    payload = {
        "step": int(state.step),
        "generator": _cpu(generator),
        "discriminators": _cpu(discriminators),
        "vgg": None if state.vgg is None else _cpu(state.vgg.state_dict()),
        "g_opt": _cpu(g_opt),
        "d_opt": _cpu(d_opt),
    }
    final = os.path.join(ckpt_dir, f"step_{int(state.step):08d}")
    tmp = final + _TMP_MARK
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_NAME))
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    if keep_last > 0:
        for old in _step_dirs(ckpt_dir)[:-keep_last]:
            shutil.rmtree(os.path.join(ckpt_dir, old), ignore_errors=True)


def load_config(ckpt_dir: str) -> Optional[dict]:
    path = os.path.join(ckpt_dir, CONFIG_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _step_dirs(ckpt_dir: str) -> list:
    """Finished step directories, oldest first."""
    return sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and _TMP_MARK not in d)


def latest_step_dir(ckpt_dir: str) -> Optional[str]:
    """The newest finished step directory, or None. An unfinished save (a
    kill during a save leaves ``step_*.tmp``) is never a candidate."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _step_dirs(ckpt_dir)
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def _load_step(ckpt_dir: str, map_location) -> dict:
    path = latest_step_dir(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return torch.load(os.path.join(path, STATE_NAME),
                      map_location=map_location, weights_only=True)


def restore_state(ckpt_dir: str, template):
    """Load the newest step into ``template`` (a ``TrainerState`` of the same
    configuration, on its device) and return it. A discriminator the
    checkpoint lacks or a shape that differs raises."""
    payload = _load_step(ckpt_dir, template.device)
    template.step = int(payload["step"])
    template.generator.load_state_dict(payload["generator"], strict=True)
    template.discriminators.load_state_dict(payload["discriminators"],
                                            strict=True)
    if template.vgg is not None and payload["vgg"] is not None:
        template.vgg.load_state_dict(payload["vgg"], strict=True)
    template.g_opt.load_state_dict(payload["g_opt"])
    template.d_opt.load_state_dict(payload["d_opt"])
    return template


def restore_generator_state(ckpt_dir: str) -> dict:
    """Only the generator's ``state_dict`` (for inference), on the host: the
    newest step of a training directory, or a renderer checkpoint's
    ``generator.pt``. ``load_state_dict`` copies it into a renderer that is
    already built, on its device; the optimizer moments of a training step
    never reach that device."""
    if latest_step_dir(ckpt_dir) is not None:
        return _load_step(ckpt_dir, "cpu")["generator"]
    weights = os.path.join(ckpt_dir, WEIGHTS_NAME)
    if not os.path.exists(weights):
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return torch.load(weights, map_location="cpu", weights_only=True)


def save_renderer(renderer: Renderer, ckpt_dir: str,
                  height: Optional[int] = None) -> None:
    """Write ``renderer``'s generator to ``ckpt_dir``. ``height``: the
    height the model works at (the loader's ``load_size``), or None to
    render at each person's canvas."""
    gen = renderer.generator
    meta = {"base_ch": int(gen.base_ch),
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
    a renderer checkpoint or a training directory (the newest step's
    generator), on ``device``, the card unless the caller names another.
    ``profile`` is taken for the JAX loader's signature; the working height
    comes from the checkpoint's ``height``, so a model trained at 384
    renders a 1080p person at 384 rows (reference: --loadSize 512
    --resize_or_crop scaleHeight, text2video_audio.sh:42).

    ``decode_mode``/``jacobi_sweeps``: the exact sequential scan, or that
    many batched Jacobi sweeps over the whole timeline
    (``config.RenderConfig``)."""
    if decode_mode not in ("scan", "jacobi"):
        raise ValueError(f"unknown decode_mode {decode_mode!r}")
    device = devices.resolve(device)
    meta = load_config(ckpt_dir) or {}
    load_size = int(meta["height"]) if "height" in meta else None
    renderer = Renderer.create(
        config=RenderConfig(load_size=load_size, decode_mode=decode_mode,
                            jacobi_sweeps=jacobi_sweeps),
        base_ch=int(meta.get("base_ch", 64)),
        n_blocks=int(meta.get("n_blocks", 9)),
        dtype=torch.bfloat16,
        device=device,
    )
    renderer.generator.load_state_dict(
        restore_generator_state(ckpt_dir), strict=True)
    return renderer
