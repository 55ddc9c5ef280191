"""Start the ranks of a mesh on one host without torchrun, with a deadline.

``spawn("package.module:function", n, args)`` starts ``n`` fresh Python
processes (the ``spawn`` start method) and calls ``function(rank, n, *args)``
in each. A rank that raises fails the call with its traceback and the other
ranks are stopped; so is every rank still running at the deadline. The
ranks make their own mesh (``make_mesh(init_method="file://...", rank=rank,
world_size=n)``) and hand results back through files.

``block`` names top-level modules that a rank must not import (for example
``("jax", "text2video_tpu")``): each is made unimportable in the rank before
``function``'s module loads.
"""

from __future__ import annotations

import importlib
import sys
import time
from typing import Sequence

import torch.multiprocessing as mp


def _rank_main(rank: int, target: str, nprocs: int, args: tuple,
               block: Sequence[str]) -> None:
    for name in block:
        sys.modules[name] = None  # any import of it raises ImportError
    module, name = target.split(":")
    getattr(importlib.import_module(module), name)(rank, nprocs, *args)


def spawn(target: str, nprocs: int, args: Sequence = (),
          timeout_s: float = 600.0, block: Sequence[str] = ()) -> None:
    """Run ``target`` (``"module:function"``) in ``nprocs`` new processes
    as ``function(rank, nprocs, *args)`` and wait for all of them, at most
    ``timeout_s`` seconds. Raises if a rank fails or the deadline passes;
    no rank outlives the call."""
    ctx = mp.start_processes(
        _rank_main, args=(target, nprocs, tuple(args), tuple(block)),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.05)):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{target}: {nprocs} ranks still running after "
                    f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
