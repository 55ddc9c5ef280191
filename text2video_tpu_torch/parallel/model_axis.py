"""The mesh's "model" axis in a train step: the wide conv kernels, sharded
by output channel (``mesh.shard_params``), gathered whole once a micro-batch.

The JAX package places such a kernel with ``P(None, None, None, "model")``
and lets XLA insert the all-gathers. Here a rank keeps its f32 shard as the
master (with its Adam moments), and :func:`gathered_kernels` gathers every
sharded kernel of a step's modules in one ``all_gather`` over the model
group, cast to the compute dtype first (half the bytes, the same bits as
casting the whole kernel), before the forward and outside every
``torch.utils.checkpoint`` region: a collective inside a recomputed segment
would run again in the backward.

Each use of a gathered kernel enters the autograd graph through
:class:`_ShardUse`, whose backward returns this rank's slice of that use's
gradient in the master's dtype. So the gradients of a kernel's several uses
(one a frame of the unrolled clip) are summed in f32, as one process sums
the gradients of its per-use casts, and the step is the same arithmetic as a
step without the axis. The backward needs no collective: every model rank of
a data group runs the same rows with the same weights in deterministic mode,
so each computes the same whole gradient and keeps its slice.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch
from torch import nn

from text2video_tpu_torch.models.layers import Conv
from text2video_tpu_torch.parallel.mesh import Mesh, _as_bytes, _gather_bytes
from text2video_tpu_torch.utils import profiling

# Sharded kernels gathered since import, one a kernel a gather; the train
# step checks its count and chip_smoke.py reads it.
gathers = 0


class _ShardUse(torch.autograd.Function):
    """One use of a gathered kernel: the forward is the whole kernel; the
    backward hands the local shard its slice ``[..., lo:hi]`` of the
    gradient, in the shard's dtype."""

    @staticmethod
    def forward(ctx, shard: torch.Tensor, full: torch.Tensor, lo: int,
                hi: int) -> torch.Tensor:
        ctx.lo, ctx.hi, ctx.dtype = lo, hi, shard.dtype
        return full.view_as(full)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad[..., ctx.lo:ctx.hi].to(ctx.dtype), None, None, None


class GatheredKernel:
    """A conv's whole kernel for one step (compute dtype, no grad) and the
    slice of it that this rank's shard holds."""

    def __init__(self, full: torch.Tensor, lo: int, hi: int):
        self.full, self.lo, self.hi = full, lo, hi

    def use(self, shard: torch.Tensor) -> torch.Tensor:
        """The whole kernel, on the autograd graph of ``shard``."""
        return _ShardUse.apply(shard, self.full, self.lo, self.hi)


def sharded_convs(modules: Iterable[nn.Module]) -> List[Conv]:
    """The convs of ``modules`` whose kernels hold a model-axis shard, in
    module order."""
    return [m for mod in modules for m in mod.modules()
            if isinstance(m, Conv) and m.shard is not None]


def _gather_last_axis(shards: List[torch.Tensor],
                      mesh: Mesh) -> List[torch.Tensor]:
    """Each tensor of ``shards`` whole: every model rank's piece (one layout
    on every rank) concatenated on the last axis in model-rank order, from
    one ``all_gather`` of one byte bucket."""
    parts = _gather_bytes(torch.cat([_as_bytes(s).to(mesh.comm_device)
                                     for s in shards]), mesh, "model")
    parts = [p.to(shards[0].device) for p in parts]
    out, lo = [], 0
    for s in shards:
        n = s.numel() * s.element_size()
        out.append(torch.cat([p[lo: lo + n].view(s.dtype).reshape(s.shape)
                              for p in parts], dim=-1))
        lo += n
    return out


@contextlib.contextmanager
def gathered_kernels(modules: Iterable[nn.Module],
                     mesh: Optional[Mesh]) -> Iterator[None]:
    """For the length of the block, every sharded conv of ``modules`` runs
    on its whole kernel, gathered here over the model axis in the conv's
    compute dtype (no collective when none is sharded) under the span
    ``train.model_gather``; gradients reach the local shards. Every rank of
    the model group must enter the block."""
    global gathers
    convs = sharded_convs(modules)
    if not convs:
        yield
        return
    if mesh is None or mesh.n_model == 1:
        raise ValueError("sharded conv kernels need the mesh they were "
                         "sharded over")
    with torch.no_grad(), profiling.span("train.model_gather"):
        fulls = _gather_last_axis(
            [c.kernel.detach().to(c.dtype) for c in convs], mesh)
    gathers += len(convs)
    for c, full in zip(convs, fulls):
        c.gathered = GatheredKernel(full, c.shard[0], c.shard[1])
    try:
        yield
    finally:
        for c in convs:
            c.gathered = None


def gather_full(module: nn.Module, mesh: Optional[Mesh],
                optimizer: torch.optim.Optimizer
                ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(``module``'s ``state_dict``, ``optimizer``'s) with every sharded
    kernel, and the optimizer's per-element state of it (Adam's moments),
    whole: the layout of a process without the model axis, for a
    checkpoint. One ``all_gather`` over the model group, which every rank of
    it must call; without sharded kernels, the plain state dicts."""
    convs = [(name, m) for name, m in module.named_modules()
             if isinstance(m, Conv) and m.shard is not None]
    sd, opt_sd = module.state_dict(), optimizer.state_dict()
    if not convs:
        return sd, opt_sd
    if mesh is None or mesh.n_model == 1:
        raise ValueError("sharded conv kernels need the mesh they were "
                         "sharded over")
    # The optimizer's state dict numbers its parameters in group order.
    index = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])}
    # [(state dict key or (optimizer index, state key), shard)]
    items = []
    for name, c in convs:
        items.append((f"{name}.kernel" if name else "kernel", c.kernel))
        items += [((index[id(c.kernel)], k), v)
                  for k, v in optimizer.state.get(c.kernel, {}).items()
                  if isinstance(v, torch.Tensor)
                  and v.shape == c.kernel.shape]
    fulls = _gather_last_axis([v.detach() for _, v in items], mesh)
    for (key, _), full in zip(items, fulls):
        if isinstance(key, str):
            sd[key] = full
        else:
            i, k = key
            # A copy: the optimizer's own state dict stays the shard's.
            opt_sd["state"][i] = dict(opt_sd["state"][i], **{k: full})
    return sd, opt_sd
