#!/usr/bin/env python3
"""Convert a checkpoint directory of the JAX package (Orbax) into the
PyTorch port's format.

    python tools/orbax_to_torch.py --src checkpoints/fadg0 --dst ckpt_torch
    python tools/orbax_to_torch.py --src ... --dst ... --generator-only

This is the one bridge between the two packages: it reads Orbax through
``text2video_tpu`` and writes through ``text2video_tpu_torch``, so it needs
JAX, Orbax and PyTorch together and runs on a CPU host that has them (it
forces JAX onto the CPU). The port itself never imports it.

Default: the whole training state. ``restore_state`` of the JAX package
reads the newest step against a template built from the directory's
``config.json`` (a legacy layout is migrated there, with fresh Adam moments),
``convert.trainer_state_from_flax`` turns it into the port's state, and the
port's ``save_state`` writes ``step_%08d/state.pt`` and ``config.json``:
``train-gan --ckpt DST`` resumes from it and ``--gan-checkpoint DST`` serves
from it.

``--generator-only``: just the generator, as a renderer checkpoint
(``generator.pt`` + ``config.json``), for inference.
"""

import argparse
import dataclasses
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _config(cls, meta: dict, dtype):
    """``cls`` (either package's ``TrainConfig``) from a ``config.json``:
    fields the file lacks keep their defaults, lists become tuples."""
    names = {f.name for f in dataclasses.fields(cls)} - {"dtype"}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in meta.items() if k in names}
    return cls(dtype=dtype, **kw)


def convert_state(src: str, dst: str) -> int:
    """The newest step of ``src`` as a training directory ``dst`` of the
    port. Returns the step."""
    import jax
    import jax.numpy as jnp
    import torch

    from text2video_tpu.train import checkpoints as jax_ckpt
    from text2video_tpu.train import trainer as jax_trainer
    from text2video_tpu_torch import checkpoints, convert
    from text2video_tpu_torch.train import trainer

    meta = jax_ckpt.load_config(src) or {}
    bf16 = "bfloat16" in str(meta.get("dtype", "bfloat16"))
    jax_cfg = _config(jax_trainer.TrainConfig, meta,
                      jnp.bfloat16 if bf16 else jnp.float32)
    cfg = _config(trainer.TrainConfig, meta,
                  torch.bfloat16 if bf16 else torch.float32)
    # The template's random init as one compiled program: op by op it takes
    # several times as long on a CPU.
    template = jax.jit(jax_trainer.create_trainer_state,
                       static_argnums=(0, 1))(jax_cfg, 0)
    state = jax_ckpt.restore_state(src, template)
    out = convert.trainer_state_from_flax(state, cfg, device="cpu")
    checkpoints.save_state(dst, out, cfg)
    return out.step


def convert_generator(src: str, dst: str) -> None:
    """The newest step's generator of ``src`` as a renderer checkpoint
    ``dst`` of the port."""
    import torch

    from text2video_tpu.train import checkpoints as jax_ckpt
    from text2video_tpu_torch import checkpoints, convert
    from text2video_tpu_torch.render import Renderer

    meta = jax_ckpt.load_config(src) or {}
    renderer = Renderer.create(base_ch=int(meta.get("base_ch", 64)),
                               n_blocks=int(meta.get("n_blocks", 9)),
                               dtype=torch.bfloat16, device="cpu")
    renderer.generator.load_state_dict(
        convert.params_from_flax(jax_ckpt.restore_generator_params(src)),
        strict=True)
    checkpoints.save_renderer(renderer, dst, height=meta.get("height"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", required=True,
                   help="checkpoint directory written by the JAX package")
    p.add_argument("--dst", required=True,
                   help="directory to write in the port's format")
    p.add_argument("--generator-only", action="store_true",
                   help="write a renderer checkpoint (generator.pt) instead "
                   "of the whole training state")
    args = p.parse_args(argv)
    if args.generator_only:
        convert_generator(args.src, args.dst)
        print(json.dumps({"dst": args.dst, "kind": "renderer"}))
    else:
        step = convert_state(args.src, args.dst)
        print(json.dumps({"dst": args.dst, "kind": "state", "step": step}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
