"""The traced window: ``torch.profiler`` (CUPTI) over a part of the
measured window, reduced to what the per-layer metrics read.

Inside the profile the harness opens one host span, ``bench.window``, and
the drivers open ``bench.<layer>`` spans around their calls into the
program's layers. Kineto puts the host spans and the device's kernels,
copies and memsets on one clock. The reduction clips every device interval
to the window, merges them into busy time, and labels each idle gap with the
innermost ``bench.*`` span open at its middle: what the host was doing while
the device waited.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

WINDOW = "bench.window"
Interval = Tuple[str, int, int]  # (name, start ns, end ns)


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: int                       # kernel launches (no copies, memsets)
    kernel_s: float                    # summed kernel time
    by_name: Dict[str, List[float]]    # name -> [launches, seconds]
    gaps: List[Tuple[str, float]]      # the longest idle gaps, labelled

    def kernel_times(self, fragment: str) -> List[float]:
        """[launches, seconds] summed over kernels whose name holds
        ``fragment``."""
        n = s = 0.0
        for name, (k, t) in self.by_name.items():
            if fragment in name:
                n, s = n + k, s + t
        return [n, s]

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[name[:160], t] for name, (_, t) in ops],
                "idle_gaps": [[label, s] for label, s in self.gaps[:10]]}


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def summarize(window: Tuple[int, int], device: Sequence[Interval],
              spans: Sequence[Interval]) -> TraceSummary:
    """Reduce one traced window: ``window`` (start, end) ns, the device's
    (name, start, end) intervals, the host's ``bench.*`` spans."""
    w0, w1 = window
    inside = sorted((max(a, w0), min(b, w1), n) for n, a, b in device
                    if b > w0 and a < w1)
    merged: List[List[int]] = []
    for a, b, _ in inside:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps, edge = [], w0
    for a, b in merged:
        if a > edge:
            gaps.append((edge, a))
        edge = b
    if w1 > edge:
        gaps.append((edge, w1))
    by_name: Dict[str, List[float]] = {}
    kernels, kernel_ns = 0, 0
    for a, b, name in inside:
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (b - a) / 1e9
        if is_kernel(name):
            kernels += 1
            kernel_ns += b - a
    spans = [s for s in spans if s[0] != WINDOW]
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) // 2
        open_ = [s for s in spans if s[1] <= mid < s[2]]
        label = max(open_, key=lambda s: s[1])[0] if open_ else WINDOW
        labelled.append((label, (b - a) / 1e9))
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                        kernels=kernels, kernel_s=kernel_ns / 1e9,
                        by_name=by_name, gaps=labelled)


def _get(event, attr):
    value = getattr(event, attr)
    return value() if callable(value) else value


def _annotation(event) -> bool:
    try:
        return bool(_get(event, "is_user_annotation"))
    except AttributeError:
        return False


def _intervals(prof) -> Tuple[Tuple[int, int], List[Interval], List[Interval]]:
    """(window, device intervals, bench spans) of a finished profile."""
    device, spans, window = [], [], None
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = _get(e, "name")
        a = _get(e, "start_ns")
        b = a + _get(e, "duration_ns")
        if _get(e, "device_type") == cuda:
            # The device timeline also carries the host spans' annotations.
            if not (name.startswith("bench.") or _annotation(e)):
                device.append((name, a, b))
        elif name == WINDOW:
            window = (a, b)
        elif name.startswith("bench."):
            spans.append((name, a, b))
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    return window, device, spans


def warm_up(device) -> None:
    """Start and stop the profiler once, in set-up: the first CUPTI start
    costs seconds that must not fall into a window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device=device).add_(1)
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def traced(device) -> Iterator[list]:
    """Profile the block inside a ``bench.window`` span; the yielded list
    receives the finished profile when the block ends (reduce it with
    :func:`reduce` once the measured window has closed)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    out: list = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        with record_function(WINDOW):
            yield out
            torch.cuda.synchronize(device)
    out.append(prof)


def reduce(prof) -> TraceSummary:
    """The :class:`TraceSummary` of a finished profile."""
    return summarize(*_intervals(prof))


def span(name: str):
    """A ``bench.<name>`` host span (a no-op outside a profile)."""
    return torch.profiler.record_function(f"bench.{name}")


def idle_share(summary) -> float:
    """The device's idle share of a traced window, in %, or None without a
    trace."""
    if summary is None or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
