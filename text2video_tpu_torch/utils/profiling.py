"""Per-stage timing, the program's spans and counters, and device tracing
(counterpart of ``text2video_tpu/utils/profiling.py``).

:class:`StageTimer` collects (stage, seconds) pairs that pipeline stages
wrap themselves in. :func:`span` and :func:`count` are the program's
recorder. They are off unless a ``torch.profiler`` profile runs in the
process, and then cost one flag read. On, a span opens the profiler range
``t2v.<name>``, so that it lands beside the card's work in the kineto
trace, and appends a record on the trace's clock (``time.time_ns``) to a
process-wide list; a count adds to a process-wide counter. Every
``StageTimer`` stage is a span of its name. :func:`records`,
:func:`counters` and :func:`reset` read and clear them; :func:`request`
sets the request id that the spans under it carry. :func:`device_trace`
writes a ``torch.profiler`` trace of the host and the card, the ``t2v.*``
ranges included, to a directory.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
from typing import Dict, Hashable, Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def enabled() -> bool:
        """Whether a ``torch.profiler`` profile runs in this process (the
        process-wide flag: a thread the profile did not start reads it
        too)."""
        return _autograd_profiler._is_profiler_enabled
else:  # a torch without the process-wide flag
    enabled = torch._C._autograd._profiler_enabled

_RECORDS: List[dict] = []
_COUNTERS: Dict[str, int] = {}
_PENDING: Dict[int, Tuple[dict, object, object]] = {}  # id -> record, events
_LOCK = threading.Lock()
_IDS = itertools.count()
# The ids of the spans open in this thread (a span's parent is the last).
_STACK: contextvars.ContextVar = contextvars.ContextVar("t2v_spans",
                                                        default=())
_REQUEST: contextvars.ContextVar = contextvars.ContextVar("t2v_request",
                                                          default=None)
_OFF = contextlib.nullcontext()


class _Span:
    """One span while a profile runs: the range ``t2v.<name>`` and a record
    appended when it closes."""

    __slots__ = ("rec", "device", "_range", "_token", "_start")

    def __init__(self, name: str, device: bool, attrs: dict):
        self.rec = {"id": next(_IDS), "name": name, "start_ns": 0,
                    "end_ns": 0, "parent": None, "request": None,
                    "thread": threading.current_thread().name,
                    "attrs": attrs, "device_ms": None}
        self.device = device and torch.cuda.is_available()

    def __enter__(self) -> None:
        rec = self.rec
        self._range = _autograd_profiler.record_function("t2v." + rec["name"])
        self._range.__enter__()
        rec["start_ns"] = time.time_ns()
        stack = _STACK.get()
        rec["parent"] = stack[-1] if stack else None
        rec["request"] = _REQUEST.get()
        self._token = _STACK.set(stack + (rec["id"],))
        if self.device:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        if self.device:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            with _LOCK:
                _PENDING[rec["id"]] = (rec, self._start, end)
        rec["end_ns"] = time.time_ns()
        _STACK.reset(self._token)
        self._range.__exit__(*exc)
        _RECORDS.append(rec)
        return False


def span(name: str, device: bool = False, **attrs):
    """Context manager: the span ``name`` around the block, with ``attrs``.
    Its record: ``id``, ``name``, ``start_ns`` and ``end_ns``
    (``time.time_ns``, kineto's clock), ``parent`` (the id of the span open
    around it in this thread, or None), ``request`` (see :func:`request`),
    ``thread`` (its name), ``attrs`` and ``device_ms``. ``device=True``
    also records a CUDA event pair on the current stream at entry and exit,
    without a sync; :func:`records` turns the pair into ``device_ms``.
    Off (no profile running) it records nothing."""
    if not enabled():
        return _OFF
    return _Span(name, device, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profile runs."""
    if not enabled():
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


@contextlib.contextmanager
def request(rid: Hashable) -> Iterator[None]:
    """Every span opened in the block (in this thread) carries ``rid`` as
    its ``request``."""
    token = _REQUEST.set(rid)
    try:
        yield
    finally:
        _REQUEST.reset(token)


def current_request() -> Optional[Hashable]:
    """The request id set around the caller, or None."""
    return _REQUEST.get()


def records() -> List[dict]:
    """The spans closed since the last :func:`reset`, in the order they
    closed. A device span's ``device_ms`` is resolved here, waiting for its
    end event: read after the work has been synchronized."""
    with _LOCK:
        pending = list(_PENDING.values())
        _PENDING.clear()
    for rec, start, end in pending:
        end.synchronize()
        rec["device_ms"] = start.elapsed_time(end)
    return list(_RECORDS)


def counters() -> Dict[str, int]:
    """The counters since the last :func:`reset`."""
    with _LOCK:
        return dict(_COUNTERS)


def reset() -> None:
    """Forget every record and counter."""
    with _LOCK:
        _RECORDS.clear()
        _COUNTERS.clear()
        _PENDING.clear()


class StageTimer:
    """Collects (stage, seconds) pairs; nestable via context manager. Each
    stage is also the span of its name.

    ``rasterize`` times the enqueue of the drawing: nothing waits for the
    card, so its seconds are the host's. Its span, opened with
    ``device=True`` on a card, gives the stage's device time as
    ``device_ms``: the card's extent of the stage, from reaching its first
    launch to finishing its last."""

    def __init__(self):
        self.records: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str, device: bool = False) -> Iterator[None]:
        with span(name, device=device):
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
    present), written to ``log_dir`` as a TensorBoard-loadable Chrome trace
    that carries the program's ``t2v.*`` ranges; :func:`records` and
    :func:`counters` after it hold the block's spans and counts. No-op when
    log_dir is None, so call sites can be unconditional."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    reset()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
