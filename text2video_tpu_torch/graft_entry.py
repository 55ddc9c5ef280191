"""The port's counterparts of the repository's ``__graft_entry__.py``: the
flagship forward (``entry``) and the multi-process dry run
(``dryrun_multichip``).

    python -c "from text2video_tpu_torch import graft_entry as g; \\
        g.dryrun_multichip(4)"

``entry`` builds the pose2frame composite generator at production size
(512x384 canvas, base 64, 9 resblocks, bf16, every resblock conv through
kernel B1) with seeded random weights. ``dryrun_multichip(n)`` starts ``n``
ranks (``parallel.spawn``) that run what the JAX dry run runs on ``n``
devices: one full GAN train step of the tiny configuration over an
``(n / 2, 2)`` ("data", "model") grid when ``n`` is even and at least 4,
else ``(n, 1)``; Jacobi decoding with the timeline sharded over ``(n, 1)``;
the exact recursive smoother over the same axis, byte-equal to the host
loop; and frame-parallel rasterization. On a card the ranks take
``cuda:rank % cards`` (several share a card when there are fewer cards than
ranks, over gloo; one rank a card runs over NCCL); ``device="cpu"`` runs
them over gloo on the host.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from text2video_tpu_torch import device as devices

# Modules a dry-run rank must not import: the port runs without JAX.
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "text2video_tpu")
# The dry run's deadline: four ranks on one card take ~30 s.
TIMEOUT_S = 600.0


def entry(device=None) -> Tuple[Callable, Tuple[torch.Tensor, ...]]:
    """(``fn``, example arguments) of the flagship forward on ``device``,
    the card unless the caller names another: ``fn(labels [1, 384, 512, 9],
    prev [1, 384, 512, 6], has_prev [1]) -> (frame, flow, mask)``, run under
    ``torch.inference_mode`` with the seeded generator's weights."""
    from text2video_tpu_torch.models.generator import CompositeGenerator

    dev = devices.resolve(device)
    gen = CompositeGenerator(in_channels=15, base_ch=64, n_blocks=9,
                             dtype=torch.bfloat16)
    gen.reset_parameters(torch.Generator().manual_seed(0))
    gen.to(dev).eval()
    h, w = 384, 512
    labels = torch.zeros((1, h, w, 9), device=dev)
    prev = torch.zeros((1, h, w, 6), device=dev)
    has_prev = torch.ones((1,), device=dev)

    @torch.inference_mode()
    def fn(labels, prev, has_prev):
        return gen(labels, prev, has_prev)

    return fn, (labels, prev, has_prev)


def _grid(n: int) -> Tuple[int, int]:
    """(n_data, n_model) of the dry run's train step, as the JAX one."""
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    return n // n_model, n_model


def _dryrun_rank(rank: int, world: int, device_type: str,
                 tmp: str) -> None:
    """One rank of :func:`dryrun_multichip`; writes ``rank<r>.json``."""
    from text2video_tpu_torch.ops import fused_pose, fused_resblock
    from text2video_tpu_torch.ops.rasterize import rasterize_batch_sharded
    from text2video_tpu_torch.ops.smooth import (
        smooth_host,
        smooth_recursive_sharded,
    )
    from text2video_tpu_torch.parallel import (
        make_mesh,
        mesh as meshes,
        model_axis,
    )
    from text2video_tpu_torch.render import Renderer
    from text2video_tpu_torch.train.trainer import (
        TrainConfig,
        create_trainer_state,
        make_train_step,
    )

    if device_type == "cpu":
        torch.set_num_threads(1)
    fused_resblock.launches = fused_pose.launches = 0
    # NCCL takes one rank a card; ranks that share a card meet over gloo.
    backend = ("nccl" if device_type == "cuda"
               and torch.cuda.device_count() >= world else "gloo")
    n_data, n_model = _grid(world)
    mesh = make_mesh(n_data=n_data, n_model=n_model, device=device_type,
                     backend=backend,
                     init_method="file://" + os.path.join(tmp, "store"),
                     rank=rank, world_size=world)
    dev = mesh.device

    cfg = TrainConfig(height=32, width=32, face_crop=8, base_ch=8,
                      n_blocks=1, d_base_ch=8, use_vgg=True,
                      dtype=torch.float32)
    state = create_trainer_state(cfg, seed=0, device=dev)
    meshes.replicate([*state.generator.parameters(),
                      *state.discriminators.parameters()], mesh)
    # Base 8 reaches no 256-wide kernel: as in the JAX dry run, the rule
    # shards nothing at this size.
    wide = (meshes.shard_params(state.generator, mesh, state.g_opt)
            + meshes.shard_params(state.discriminators, mesh, state.d_opt))
    step = make_train_step(cfg, mesh=mesh)
    b, t = n_data * 2, 4
    rng = np.random.RandomState(0)
    batch = {
        "labels": rng.rand(b, t, 32, 32, 3).astype(np.float32) * 2 - 1,
        "reals": rng.rand(b, t, 32, 32, 3).astype(np.float32) * 2 - 1,
        "face_centers": np.full((b, t, 2), 16.0, np.float32),
    }
    rows = slice(mesh.rank * 2, mesh.rank * 2 + 2)
    gathers = model_axis.gathers
    state, metrics = step(state, {k: torch.from_numpy(v[rows]).to(dev)
                                  for k, v in batch.items()})
    g, d = float(metrics["g_loss"]), float(metrics["d_loss"])
    assert np.isfinite(g) and np.isfinite(d), (g, d)

    # Inference-side sequence parallelism: one utterance's timeline sharded
    # over every rank (time-sharded Jacobi decoding).
    sp_mesh = make_mesh(n_data=world, n_model=1, device=device_type,
                        backend=backend)
    r = Renderer.create(base_ch=8, n_blocks=1, dtype=torch.float32,
                        device=dev)
    labels = rng.randint(0, 256, size=(2 * world, 32, 32, 3)).astype(
        np.uint8)
    frames = r.render_jacobi_sharded(labels, sp_mesh, sweeps=2)
    assert frames.shape == labels.shape, frames.shape

    # The sharded pose stage: the exact recursive smoother over the same
    # axis, byte-equal to the host loop, then frame-parallel rasterization.
    t_pose = 4 * world
    face_tr = rng.rand(t_pose, 210) * 24.0 + 4.0
    pose_tr = rng.rand(t_pose, 75) * 24.0 + 4.0
    face_s, pose_s = smooth_recursive_sharded(face_tr, pose_tr, sp_mesh)
    ref_f, ref_p = smooth_host(face_tr, pose_tr)
    assert np.array_equal(face_s, ref_f) and np.array_equal(pose_s, ref_p)
    face_s, pose_s = face_s.astype(np.float32), pose_s.astype(np.float32)
    assert face_s.shape == face_tr.shape and np.isfinite(face_s).all()
    hands = np.zeros((t_pose, 63), np.float32)
    label_maps = rasterize_batch_sharded(face_s, pose_s, hands, hands,
                                         (32, 32), sp_mesh)
    assert label_maps.shape == (t_pose, 32, 32, 3), label_maps.shape
    assert label_maps.max() > 0  # something was drawn

    line = (f"dryrun_multichip ok: mesh={dict(mesh.shape)} "
            f"g_loss={g:.4f} d_loss={d:.4f} "
            f"jacobi_sp={dict(sp_mesh.shape)} "
            f"pose_sharded: exact-recursive-smooth+rasterize T={t_pose} "
            f"over {sp_mesh.n_data} ranks (byte-equal to host)")
    if mesh.is_main:
        print(line, flush=True)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(dict(rank=rank, data_rank=mesh.rank,
                       model_rank=mesh.model_rank, backend=mesh.backend,
                       device=str(dev), mesh=mesh.shape, g_loss=g, d_loss=d,
                       sharded=wide,
                       kernels_gathered=model_axis.gathers - gathers,
                       jacobi_sp=sp_mesh.shape, line=line,
                       # Kernel launches of the whole rank (the card's).
                       launches={"conv3x3_stats": fused_resblock.launches,
                                 "synthesize_and_smooth":
                                     fused_pose.launches}), f)
    torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> Dict[str, object]:
    """Run the dry run in ``n_devices`` ranks on ``device`` (the card unless
    the caller names another; ``"cpu"``: gloo on the host), at most
    ``TIMEOUT_S`` seconds. Rank 0 prints the JAX dry run's line. Returns
    ``{"line": ..., "ranks": [each rank's record]}``; raises if a rank
    fails."""
    from text2video_tpu_torch.parallel import spawn

    dev = devices.resolve(device)
    with tempfile.TemporaryDirectory() as tmp:
        spawn("text2video_tpu_torch.graft_entry:_dryrun_rank", n_devices,
              (dev.type, tmp), timeout_s=TIMEOUT_S, block=BLOCKED)
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return {"line": ranks[0]["line"], "ranks": ranks}
