"""The port's recorder (``text2video_tpu_torch/utils/profiling.py``): off
without a profile, where a span and a count record nothing and open no
profiler range; under ``torch.profiler`` each span is a ``t2v.<name>``
range and a record on the trace's clock, with its parent, request, thread
and attributes; ``StageTimer`` stages are spans and keep their seconds;
``device_trace`` starts from an empty recorder."""

import json
import os
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from text2video_tpu_torch.utils import profiling

torch.set_num_threads(1)

SLACK_NS = 50_000  # the kineto range and the record share a clock


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _kineto_ranges(prof):
    """(name, start ns, end ns) of the profile's ``t2v.*`` ranges."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("t2v."):
            out.append((e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    return out


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    opened, clock = [], []
    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        lambda *a: opened.append(a))
    time_ns = time.time_ns
    monkeypatch.setattr(profiling.time, "time_ns",
                        lambda: clock.append(1) or time_ns())
    assert not profiling.enabled()
    with profiling.request("r"), profiling.span("a", frames=3):
        with profiling.span("b", device=True):
            profiling.count("n", 5)
    timer = profiling.StageTimer()
    with timer.stage("render"):
        pass
    assert profiling.records() == [] and profiling.counters() == {}
    assert opened == [] and clock == []
    assert [name for name, _ in timer.records] == ["render"]


def test_nested_spans_parent_request_attrs_and_order():
    with _cpu_profile() as prof:
        assert profiling.enabled()
        with profiling.request("utt"):
            with profiling.span("outer", frames=8):
                torch.ones(64).sum()
                with profiling.span("inner"):
                    profiling.count("wire_bytes", 100)
                    with profiling.request("other"):
                        with profiling.span("innermost", k=1):
                            pass
                profiling.count("wire_bytes", 23)
                with profiling.span("second"):
                    pass
        with profiling.span("alone"):
            pass
    assert not profiling.enabled()
    recs = {r["name"]: r for r in profiling.records()}
    # Records are appended as spans close.
    assert [r["name"] for r in profiling.records()] == [
        "innermost", "inner", "second", "outer", "alone"]
    outer = recs["outer"]
    assert outer["parent"] is None and outer["attrs"] == {"frames": 8}
    assert recs["inner"]["parent"] == outer["id"]
    assert recs["second"]["parent"] == outer["id"]
    assert recs["innermost"]["parent"] == recs["inner"]["id"]
    assert recs["innermost"]["attrs"] == {"k": 1}
    assert [recs[n]["request"] for n in ("outer", "inner", "innermost",
                                         "second", "alone")] == [
        "utt", "utt", "other", "utt", None]
    assert {r["thread"] for r in recs.values()} == {
        threading.current_thread().name}
    assert all(r["device_ms"] is None for r in recs.values())
    assert (outer["start_ns"] <= recs["inner"]["start_ns"]
            <= recs["innermost"]["start_ns"] <= recs["innermost"]["end_ns"]
            <= recs["inner"]["end_ns"] <= recs["second"]["start_ns"]
            <= recs["second"]["end_ns"] <= outer["end_ns"])
    assert profiling.counters() == {"wire_bytes": 123}
    # Each record starts inside its kineto range: one clock.
    ranges = _kineto_ranges(prof)
    assert sorted(n for n, _, _ in ranges) == sorted(
        "t2v." + n for n in recs)
    for name, a, b in ranges:
        start = recs[name[len("t2v."):]]["start_ns"]
        assert a - SLACK_NS <= start <= b + SLACK_NS, (name, start - a)


def test_a_span_in_another_thread_is_recorded():
    def work():
        with profiling.request("worker-request"):
            with profiling.span("mux.encode", frames=4):
                time.sleep(0.001)

    with _cpu_profile():
        with profiling.request("main"), profiling.span("render"):
            t = threading.Thread(target=work, name="muxer")
            t.start()
            t.join()
    recs = {r["name"]: r for r in profiling.records()}
    worker = recs["mux.encode"]
    assert worker["thread"] == "muxer" and worker["parent"] is None
    assert worker["request"] == "worker-request"
    assert worker["attrs"] == {"frames": 4}
    assert worker["end_ns"] - worker["start_ns"] >= 1_000_000
    assert recs["render"]["thread"] == threading.current_thread().name


def test_stage_timer_keeps_its_seconds_under_a_profile():
    def stages(timer):
        for name in ("pose_synthesis", "rasterize", "render", "mux"):
            with timer.stage(name):
                time.sleep(0.002)

    plain = profiling.StageTimer()
    stages(plain)
    traced = profiling.StageTimer()
    with _cpu_profile():
        stages(traced)
    assert [n for n, _ in traced.records] == [n for n, _ in plain.records]
    assert set(traced.totals()) == set(plain.totals())
    spans = {r["name"]: r for r in profiling.records()}
    for name, seconds in traced.records:
        assert seconds >= 0.002
        # The stage's seconds are measured inside its span.
        span_s = (spans[name]["end_ns"] - spans[name]["start_ns"]) / 1e9
        assert seconds <= span_s


def test_device_span_without_a_card_has_no_device_time():
    with _cpu_profile():
        with profiling.span("rasterize", device=True):
            pass
    rec, = profiling.records()
    assert rec["name"] == "rasterize"
    if not torch.cuda.is_available():
        assert rec["device_ms"] is None


def test_device_trace_resets_and_carries_the_ranges(tmp_path):
    with _cpu_profile():
        with profiling.span("before"):
            profiling.count("param_copy_builds")
    assert len(profiling.records()) == 1
    with profiling.device_trace(str(tmp_path / "trace")):
        with profiling.request("utt"), profiling.span("synthesize"):
            torch.ones(8).sum()
    assert [r["name"] for r in profiling.records()] == ["synthesize"]
    assert profiling.counters() == {}
    written = os.listdir(tmp_path / "trace")
    assert len(written) == 1 and written[0].endswith(".pt.trace.json")
    with open(tmp_path / "trace" / written[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "t2v.synthesize" in names


def test_threads_lose_no_count_and_no_record():
    """More threads than cores, the interpreter switching threads every
    microsecond: every count and every span of every thread is kept."""
    n_threads, n_each = 2 * len(os.sched_getaffinity(0)) + 2, 100
    switch = sys.getswitchinterval()

    def work(k):
        with profiling.request(k):
            for _ in range(n_each):
                with profiling.span("w"):
                    profiling.count("n")
                    profiling.count("bytes", 3)

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    recs = profiling.records()
    assert profiling.counters() == {"n": n_threads * n_each,
                                    "bytes": 3 * n_threads * n_each}
    assert len(recs) == n_threads * n_each
    assert len({r["id"] for r in recs}) == len(recs)
    for k in range(n_threads):
        mine = [r for r in recs if r["request"] == k]
        assert len(mine) == n_each and len({r["thread"] for r in mine}) == 1
        assert all(r["parent"] is None for r in mine)
