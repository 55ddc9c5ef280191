"""Per-stage wall-clock timing and device tracing (counterpart of
``text2video_tpu/utils/profiling.py``): a :class:`StageTimer` that pipeline
stages wrap themselves in, and :func:`device_trace`, a ``torch.profiler``
trace of the host and the card written to a directory."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional, Tuple


class StageTimer:
    """Collects (stage, seconds) pairs; nestable via context manager."""

    def __init__(self):
        self.records: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append((name, time.perf_counter() - t0))

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.records:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self) -> str:
        totals = self.totals()
        whole = sum(totals.values()) or 1.0
        lines = [
            f"  {name:<24s} {dt * 1e3:9.1f} ms  ({dt / whole:5.1%})"
            for name, dt in sorted(totals.items(), key=lambda kv: -kv[1])
        ]
        return "stage timings:\n" + "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` trace of the block (CPU, and CUDA where a card is
    present), written to ``log_dir`` as a TensorBoard-loadable Chrome trace.
    No-op when log_dir is None, so call sites can be unconditional."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
