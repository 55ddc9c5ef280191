"""The per-layer metrics that read the program's recorder
(``text2video_tpu_torch/utils/profiling.py``), on hand-built records: each
reads what its docstring says, and each returns None where the program
has no recorder or the window holds none of its spans."""

import json

import pytest

from benchmark import run
from text2video_tpu_torch.utils import profiling

MS = 1_000_000  # ns
METRICS = ("pipeline_self_ms.clip", "pose_stage_ms.clip",
           "rasterize_device_ms.clip", "scan_host_ms_per_frame.clip",
           "mux_encode_ms_per_frame.clip", "wire_bytes_per_frame.clip",
           "train_host_ms_per_step")


def _span(i, name, a, b, parent=None, thread="MainThread", request="r0",
          device_ms=None, **attrs):
    return {"id": i, "name": name, "start_ns": a * MS, "end_ns": b * MS,
            "parent": parent, "request": request, "thread": thread,
            "attrs": attrs, "device_ms": device_ms}


# Two requests and two train steps. Request r0 (0-100 ms): children
# 10-30, 20-40 (overlapping: 10-40 once) and 60-70 cover 40 ms; its
# grandchildren and the muxer worker's span do not count. Request r1
# (200-250 ms): children 200-240, 240-241 and 241-243.
RECORDS = [
    _span(1, "pose_synthesis", 10, 30, parent=0),
    _span(2, "rasterize", 20, 40, parent=0, device_ms=3.0),
    _span(3, "render", 60, 70, parent=0),
    _span(4, "render.chunk", 61, 65, parent=3, frames=64),
    _span(5, "wire.encode", 65, 66, parent=3),
    _span(6, "mux.encode", 40, 60, parent=None, thread="Thread-1 (_work)",
          frames=64),
    _span(0, "synthesize", 0, 100),
    _span(8, "pose_synthesis", 200, 240, parent=7, request="r1"),
    _span(9, "rasterize", 240, 241, parent=7, request="r1"),
    _span(10, "render.chunk", 241, 243, parent=7, request="r1", frames=36),
    _span(11, "mux.encode", 243, 245, thread="Thread-2 (_work)",
          request="r1", frames=36),
    _span(7, "synthesize", 200, 250, request="r1"),
    _span(12, "train.step", 300, 1100, request=0),
    _span(13, "train.step", 1100, 2000, request=1),
]
COUNTERS = {"wire_bytes": 100 * 30720, "param_copy_builds": 0}


@pytest.fixture
def recorder(monkeypatch):
    monkeypatch.setattr(profiling, "records", lambda: list(RECORDS))
    monkeypatch.setattr(profiling, "counters", lambda: dict(COUNTERS))


def _read(name):
    return run.load_module(
        run.ROOT / "benchmark" / "metrics" / f"{name}.py").read(None)


@pytest.mark.parametrize("name,value", [
    # r0: 100 - 40 ms; r1: 50 - 43 ms.
    ("pipeline_self_ms.clip", (60 + 7) / 2),
    ("pose_stage_ms.clip", (20 + 40) / 2),
    ("rasterize_device_ms.clip", 3.0),  # r1's span has no event pair
    ("scan_host_ms_per_frame.clip", (4 + 2) / 100),
    ("mux_encode_ms_per_frame.clip", (20 + 2) / 100),
    ("wire_bytes_per_frame.clip", 30720.0),
    ("train_host_ms_per_step", (800 + 900) / 2),
])
def test_metric_reads_the_records(recorder, name, value):
    assert _read(name) == pytest.approx(value)


@pytest.mark.parametrize("name", METRICS)
def test_metric_is_none_without_a_recorder(monkeypatch, name):
    """The parent commit's program has no ``records`` or ``counters``."""
    monkeypatch.delattr(profiling, "records", raising=False)
    monkeypatch.delattr(profiling, "counters", raising=False)
    assert _read(name) is None


@pytest.mark.parametrize("name", METRICS)
def test_metric_is_none_without_its_spans(monkeypatch, name):
    monkeypatch.setattr(profiling, "records", lambda: [])
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert _read(name) is None


def test_each_metric_is_declared_with_its_cell():
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in spec["per_layer"]}
    for name in METRICS:
        m = declared[name]
        assert m["source"] in ("program_span", "program_counter")
        assert m["better"] == "lower"
        cell = ("henan-896x512.train" if name == "train_host_ms_per_step"
                else "fadg0-512x384.text2mp4")
        assert m["workloads"] == [cell]
