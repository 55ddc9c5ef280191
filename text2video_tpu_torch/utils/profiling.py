"""Per-stage wall-clock timing (counterpart of ``StageTimer`` in
``text2video_tpu/utils/profiling.py``)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Tuple


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

