"""Mesh construction and the collectives the sharded paths use (counterpart
of ``text2video_tpu/parallel/mesh.py``).

``make_mesh`` returns this process's place on a ("data", "model") mesh of
processes, one a card. The helpers move a tensor's leading axis between the
ranks of the "data" axis, as the JAX package's ``P("data")`` sharding and
``P()`` replication move it between devices:

* ``shard_rows``: this rank's block of the leading axis, padded with zeros to
  a multiple of the axis size, as JAX pads;
* ``gather_rows``: every rank's block, concatenated in rank order;
* ``replicate``: tensors broadcast from rank 0;
* ``halo_rows``: the rows just before and just after this rank's block, from
  its neighbours (the halo of a time-sharded window), built from one
  ``all_gather`` of the blocks' edges, which every backend runs;
* ``barrier``: every rank waits for the others;
* ``mean_ordered``: the mean over the ranks of a list of tensors, summed in
  rank order after an ``all_gather``, so that it does not depend on timing
  and every rank gets the same bits.

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

from text2video_tpu_torch import device as devices

DEFAULT_TIMEOUT_S = 300.0
MODEL_AXIS_TODO = (
    "the mesh's model axis (output-channel sharding of the wide conv "
    "kernels, param_specs / shard_params) is not ported: ROADMAP A12, "
    "model axis")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on a ("data", "model") mesh of processes."""

    shape: Dict[str, int]      # {"data": n, "model": 1}
    rank: int                  # this process's index on the "data" axis
    group: object              # the data axis's process group
    device: torch.device       # this rank's device
    backend: str

    @property
    def n_data(self) -> int:
        return self.shape["data"]

    @property
    def is_main(self) -> bool:
        """Rank 0 writes the files of a sharded run."""
        return self.rank == 0

    @property
    def comm_device(self) -> torch.device:
        """Where collectives run: the rank's card under NCCL, host memory
        under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


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
    """A ("data", "model") mesh over the processes of ``torch.distributed``.

    Joins the default process group if it is not up yet: from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``; ``init_method``
    None), or from an explicit ``init_method`` (``file://`` or
    ``tcp://127.0.0.1:<port>``) with ``rank`` and ``world_size``. Backend:
    ``backend``, else NCCL for a card and gloo for the CPU; a group that is
    already up keeps its own. Ranks ``0 .. n_data - 1`` form the data axis
    (``n_data`` defaults to every process); a process outside it gets None.

    ``n_model > 1`` raises ``NotImplementedError``."""
    if n_model != 1:
        raise NotImplementedError(f"n_model={n_model}: {MODEL_AXIS_TODO}")
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
    n_data = world // n_model if n_data is None else int(n_data)
    if not 1 <= n_data * n_model <= world:
        raise ValueError(f"a mesh of {n_data} x {n_model} needs that many "
                         f"processes; the group has {world}")
    # Every process of the default group takes part in making a group.
    group = dist.new_group(ranks=list(range(n_data)), timeout=timeout)
    if grank >= n_data:
        return None
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(shape={"data": n_data, "model": n_model}, rank=grank,
                group=group, device=dev, backend=dist.get_backend())


def _gather_bytes(flat: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Every rank's ``flat`` uint8 vector (equal lengths), in rank order, on
    the mesh's collective device."""
    flat = flat.to(mesh.comm_device)
    parts = [torch.empty_like(flat) for _ in range(mesh.n_data)]
    dist.all_gather(parts, flat, group=mesh.group)
    return parts


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def _gather_all(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Every rank's ``x`` (one shape and dtype on every rank), in rank
    order, on ``x``'s device."""
    if mesh.n_data == 1:
        return [x]
    return [p.to(x.device).view(x.dtype).reshape(x.shape)
            for p in _gather_bytes(_as_bytes(x), mesh)]


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
    buffers) with rank 0's values, in one broadcast. Returns them."""
    single = isinstance(tensors, torch.Tensor)
    ts = [tensors] if single else list(tensors)
    if mesh.n_data > 1 and ts:
        flat = torch.cat([_as_bytes(t).to(mesh.comm_device) for t in ts])
        dist.broadcast(flat, src=0, group=mesh.group)
        lo = 0
        with torch.no_grad():
            for t in ts:
                n = t.numel() * t.element_size()
                t.copy_(flat[lo: lo + n].to(t.device).view(t.dtype)
                        .reshape(t.shape))
                lo += n
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
    """Wait until every rank of the data axis gets here (one byte
    gathered, under ``make_mesh``'s timeout)."""
    if mesh.n_data > 1:
        _gather_bytes(torch.zeros(1, dtype=torch.uint8), mesh)


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
