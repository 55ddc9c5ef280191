"""Mesh construction and the collectives the sharded paths use (counterpart
of ``text2video_tpu/parallel/mesh.py``).

``make_mesh`` returns this process's place on a ("data", "model") grid of
processes, one a card, laid out as the JAX package lays out its devices:
global rank ``g`` sits at data index ``g // n_model`` and model index
``g % n_model``. The ranks of one model index form a "data" group, the ranks
of one data index a "model" group. The helpers move a tensor's leading axis
between the ranks of the "data" axis, as the JAX package's ``P("data")``
sharding and ``P()`` replication move it between devices:

* ``shard_rows``: this rank's block of the leading axis, padded with zeros to
  a multiple of the axis size, as JAX pads;
* ``gather_rows``: every rank's block, concatenated in rank order;
* ``replicate``: tensors broadcast from global rank 0, over both axes;
* ``halo_rows``: the rows just before and just after this rank's block, from
  its neighbours (the halo of a time-sharded window), built from one
  ``all_gather`` of the blocks' edges, which every backend runs;
* ``barrier``: every rank of the grid waits for the others;
* ``mean_ordered``: the mean over the ranks of a list of tensors, summed in
  rank order after an ``all_gather``, so that it does not depend on timing
  and every rank gets the same bits.

The partition rule of the "model" axis is the JAX package's, on shapes only
(``param_specs``): a 4-D HWIO conv kernel whose output channels number at
least 256 and divide over the axis is split on its last axis, model rank
``m`` holding the contiguous slice ``[m * c / n, (m + 1) * c / n)``;
everything else is replicated. ``shard_params`` keeps only that slice;
``parallel/model_axis.py`` gathers the whole kernels for a train step.

Every collective moves bytes (a tensor viewed as ``uint8``), so any dtype
travels exactly on any backend. Backend: NCCL for cards, gloo for the CPU.
Gloo also runs with tensors on a card (two ranks sharing one card, which
NCCL refuses): the helpers then stage through host memory. Every init and
collective has ``make_mesh``'s timeout, so a lost rank fails a run instead
of hanging it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from text2video_tpu_torch import device as devices
from text2video_tpu_torch.models.layers import Conv

DEFAULT_TIMEOUT_S = 300.0
# The JAX package's rule: conv kernels at least this wide shard over "model".
MIN_SHARDED_FEATURES = 256


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on a ("data", "model") grid of processes."""

    shape: Dict[str, int]      # {"data": n_data, "model": n_model}
    rank: int                  # this process's index on the "data" axis
    group: object              # the data group of this process's model index
    device: torch.device       # this rank's device
    backend: str
    model_rank: int = 0        # this process's index on the "model" axis
    model_group: object = None  # the model group of its data index

    @property
    def n_data(self) -> int:
        return self.shape["data"]

    @property
    def n_model(self) -> int:
        return self.shape["model"]

    @property
    def is_main(self) -> bool:
        """Global rank 0 writes the files of a sharded run."""
        return self.rank == 0 and self.model_rank == 0

    @property
    def comm_device(self) -> torch.device:
        """Where collectives run: the rank's card under NCCL, host memory
        under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def axis(self, name: str) -> Tuple[int, object]:
        """(size, this process's group) of the axis ``name``."""
        if name == "data":
            return self.n_data, self.group
        if name == "model":
            return self.n_model, self.model_group
        raise ValueError(f"unknown mesh axis {name!r}")


def local_device(device=None, rank: Optional[int] = None) -> torch.device:
    """``device`` (the card unless the caller names another); a card without
    an index becomes this process's card: ``LOCAL_RANK`` (torchrun), else
    ``rank``, else the process group's rank, modulo the cards on the host.
    Two ranks on a one-card host share it."""
    dev = devices.resolve(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        idx = int(local)
    elif rank is not None:
        idx = rank
    else:
        idx = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", idx % torch.cuda.device_count())


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    device=None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Optional[Mesh]:
    """A ("data", "model") grid over the processes of ``torch.distributed``.

    Joins the default process group if it is not up yet: from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``; ``init_method``
    None), or from an explicit ``init_method`` (``file://`` or
    ``tcp://127.0.0.1:<port>``) with ``rank`` and ``world_size``. Backend:
    ``backend``, else NCCL for a card and gloo for the CPU; a group that is
    already up keeps its own. Global ranks ``0 .. n_data * n_model - 1``
    form the grid, rank ``g`` at data index ``g // n_model`` and model index
    ``g % n_model`` (``n_data`` defaults to every process the model axis
    leaves); a process outside it gets None. A grid larger than the group
    raises ``ValueError``. Every process of the group must call this, as it
    makes the axes' groups."""
    dev = local_device(device, rank)
    timeout = datetime.timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        if init_method is None and "MASTER_ADDR" not in os.environ:
            raise RuntimeError(
                "make_mesh: no process group and no way to start one: run "
                "under torchrun or pass init_method (file:// or tcp://)")
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=init_method or "env://",
            rank=-1 if rank is None else rank,
            world_size=-1 if world_size is None else world_size,
            timeout=timeout)
    world, grank = dist.get_world_size(), dist.get_rank()
    n_data = world // max(n_model, 1) if n_data is None else int(n_data)
    if n_model < 1 or not 1 <= n_data * n_model <= world:
        raise ValueError(f"a mesh of {n_data} x {n_model} needs that many "
                         f"processes; the group has {world}")
    # Every process of the default group takes part in making each group.
    data_groups = [
        dist.new_group(ranks=[d * n_model + m for d in range(n_data)],
                       timeout=timeout) for m in range(n_model)]
    model_groups = [
        dist.new_group(ranks=[d * n_model + m for m in range(n_model)],
                       timeout=timeout)
        for d in range(n_data)] if n_model > 1 else None
    if grank >= n_data * n_model:
        return None
    d, m = divmod(grank, n_model)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(shape={"data": n_data, "model": n_model}, rank=d,
                group=data_groups[m], device=dev,
                backend=dist.get_backend(), model_rank=m,
                model_group=None if model_groups is None else model_groups[d])


def _gather_bytes(flat: torch.Tensor, mesh: Mesh,
                  axis: str = "data") -> List[torch.Tensor]:
    """Every rank's ``flat`` uint8 vector (equal lengths) on ``axis``, in
    rank order, on the mesh's collective device."""
    n, group = mesh.axis(axis)
    flat = flat.to(mesh.comm_device)
    parts = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(parts, flat, group=group)
    return parts


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def _gather_all(x: torch.Tensor, mesh: Mesh,
                axis: str = "data") -> List[torch.Tensor]:
    """Every rank's ``x`` on ``axis`` (one shape and dtype on every rank),
    in rank order, on ``x``'s device."""
    if mesh.axis(axis)[0] == 1:
        return [x]
    return [p.to(x.device).view(x.dtype).reshape(x.shape)
            for p in _gather_bytes(_as_bytes(x), mesh, axis)]


def padded_rows(n_rows: int, mesh: Mesh) -> Tuple[int, int]:
    """(rows a rank holds, the padded length): ``n_rows`` rounded up to a
    multiple of the data axis."""
    per = -(-n_rows // mesh.n_data)
    return per, per * mesh.n_data


def shard_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``x``'s leading axis, after zero rows pad it to a
    multiple of the data axis (rank r holds rows ``r * per`` to
    ``(r + 1) * per``). No communication: every rank holds ``x``."""
    per, total = padded_rows(x.shape[0], mesh)
    lo, hi = mesh.rank * per, (mesh.rank + 1) * per
    block = x[lo: min(hi, x.shape[0])]
    pad = per - block.shape[0]
    if pad:
        block = torch.cat([block, block.new_zeros((pad,) + block.shape[1:])])
    return block


def gather_rows(x: torch.Tensor, mesh: Mesh,
                n_rows: Optional[int] = None) -> torch.Tensor:
    """Every rank's block (one shape on every rank) concatenated along the
    leading axis in rank order, cut to ``n_rows`` (the unpadded length)."""
    out = torch.cat(_gather_all(x, mesh), dim=0)
    return out if n_rows is None else out[:n_rows]


def replicate(tensors: Union[torch.Tensor, Iterable[torch.Tensor]],
              mesh: Mesh):
    """Overwrite ``tensors`` (one, or an iterable: a module's parameters and
    buffers; one layout on every rank) with global rank 0's values: one
    broadcast over the model axis from data index 0's first rank, then one
    over the data axis. Returns them."""
    single = isinstance(tensors, torch.Tensor)
    ts = [tensors] if single else list(tensors)
    # The global rank of each axis's first member: (d, 0) on the model
    # axis, (0, m) on the data axis.
    roots = {"model": mesh.rank * mesh.n_model, "data": mesh.model_rank}
    for axis in ("model", "data"):
        n, group = mesh.axis(axis)
        if n == 1 or not ts:
            continue
        flat = torch.cat([_as_bytes(t).to(mesh.comm_device) for t in ts])
        dist.broadcast(flat, src=roots[axis], group=group)
        lo = 0
        with torch.no_grad():
            for t in ts:
                n_bytes = t.numel() * t.element_size()
                t.copy_(flat[lo: lo + n_bytes].to(t.device).view(t.dtype)
                        .reshape(t.shape))
                lo += n_bytes
    return tensors if single else ts


def halo_rows(x: torch.Tensor, mesh: Mesh, before: int,
              after: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the ``before`` rows that precede this rank's block ``x`` on the
    leading axis, the ``after`` rows that follow it), zeros past either end
    of the mesh. Every rank's block has ``x``'s shape. One ``all_gather`` of
    each block's first ``after`` and last ``before`` rows; a halo wider than
    a block spans several ranks."""
    tl = x.shape[0]
    m_b, m_a = min(before, tl), min(after, tl)
    edges = _gather_all(torch.cat([x[:m_a], x[tl - m_b:]]), mesh)
    r = mesh.rank
    prev = [e[m_a:] for e in edges[:r]]
    nxt = [e[:m_a] for e in edges[r + 1:]]
    zeros = x.new_zeros((max(before, after),) + x.shape[1:])
    prev = torch.cat([zeros[:before]] + prev)
    prev = prev[prev.shape[0] - before:]  # [-before:] would keep all at 0
    nxt = torch.cat(nxt + [zeros[:after]])[:after]
    return prev, nxt


def barrier(mesh: Mesh) -> None:
    """Wait until every rank of the grid gets here (one byte gathered over
    the data axis, then over the model axis: a rank passes the second only
    when every rank of its data index has passed the first, so only when
    every rank has arrived; under ``make_mesh``'s timeout)."""
    one = torch.zeros(1, dtype=torch.uint8)
    for axis in ("data", "model"):
        if mesh.axis(axis)[0] > 1:
            _gather_bytes(one, mesh, axis)


def mean_ordered(tensors: Sequence[torch.Tensor],
                 mesh: Mesh) -> List[torch.Tensor]:
    """The mean over the data axis of each tensor of ``tensors`` (one list
    layout on every rank, one float dtype): one ``all_gather`` of the list
    flattened into one bucket, then the ranks' buckets summed in rank order
    and divided by their count. The sum does not depend on which rank
    finishes first, so the result is the same bits on every rank and from
    run to run."""
    ts = list(tensors)
    if mesh.n_data == 1 or not ts:
        return ts
    flat = torch.cat([t.detach().reshape(-1) for t in ts])
    parts = _gather_all(flat, mesh)
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    total /= mesh.n_data
    out, lo = [], 0
    for t in ts:
        out.append(total[lo: lo + t.numel()].reshape(t.shape))
        lo += t.numel()
    return out


def _leaf_spec(shape: Sequence[int], n_model: int) -> Optional[int]:
    """The axis a parameter of ``shape`` splits on over ``n_model`` ranks,
    or None (replicated): the last axis of a 4-D HWIO kernel with at least
    ``MIN_SHARDED_FEATURES`` output channels that divide evenly."""
    if (len(shape) == 4 and shape[-1] >= MIN_SHARDED_FEATURES
            and shape[-1] % n_model == 0):
        return 3
    return None


def param_specs(module: nn.Module, mesh: Mesh) -> Dict[str, Optional[int]]:
    """For each named parameter of ``module`` (whole tensors, before
    :func:`shard_params`), the axis it splits on over the mesh's "model"
    axis, or None where it is replicated (the JAX package's
    ``P(None, None, None, "model")`` and ``P()``)."""
    return {name: _leaf_spec(tuple(p.shape), mesh.n_model)
            for name, p in module.named_parameters()}


def _slice_last(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return x.detach()[..., lo:hi].clone(memory_format=torch.contiguous_format)


def shard_params(module: nn.Module, mesh: Mesh,
                 optimizer: Optional[torch.optim.Optimizer] = None
                 ) -> List[str]:
    """Keep, in place, only this rank's output channels of every parameter
    that :func:`param_specs` splits: each such ``Conv.kernel`` becomes a
    leaf ``nn.Parameter`` holding ``[..., lo:hi]`` (``lo = model_rank * c /
    n_model``) and its conv records ``(lo, hi, c)`` in ``Conv.shard``. With
    ``optimizer``, the optimizer's entry for each kernel moves to the shard
    and its per-element state (Adam's moments) is sliced the same way.
    Returns the sharded names; nothing changes when ``n_model`` is 1. No
    communication: every rank holds the whole tensors before the call."""
    if mesh.n_model == 1:
        return []
    owners = dict(module.named_modules())
    sharded = []
    for name, axis in param_specs(module, mesh).items():
        if axis is None:
            continue
        owner, _, leaf = name.rpartition(".")
        conv = owners[owner]
        if not isinstance(conv, Conv) or leaf != "kernel":
            raise TypeError(f"{name}: only conv kernels shard over the "
                            "model axis")
        old = conv.kernel
        c = old.shape[-1]
        lo = mesh.model_rank * c // mesh.n_model
        hi = lo + c // mesh.n_model
        new = nn.Parameter(_slice_last(old, lo, hi),
                           requires_grad=old.requires_grad)
        conv.kernel = new
        conv.shard = (lo, hi, c)
        if optimizer is not None:
            for group in optimizer.param_groups:
                group["params"] = [new if p is old else p
                                   for p in group["params"]]
            state = optimizer.state.pop(old, None)
            if state:
                optimizer.state[new] = {
                    k: (_slice_last(v, lo, hi) if isinstance(v, torch.Tensor)
                        and v.shape == old.shape else v)
                    for k, v in state.items()}
        sharded.append(name)
    return sharded
