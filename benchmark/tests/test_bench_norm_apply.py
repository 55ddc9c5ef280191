"""``norm_apply_per_frame.clip`` and ``.serve`` on hand-built trace
summaries: the launches of kernels named ``norm_apply`` over the traced
window's frames, 0 where the trace holds none (a program without the
kernel), None without a trace or without frames."""

import json
import types

import pytest

from benchmark import run
from benchmark.lib.trace import TraceSummary

NAMES = ("norm_apply_per_frame.clip", "norm_apply_per_frame.serve")
CELLS = {"norm_apply_per_frame.clip": ("realtime_x",
                                       "fadg0-512x384.text2mp4"),
         "norm_apply_per_frame.serve": ("frames_per_s",
                                        "henan-896x512.batch4")}


def _summary(by_name):
    return TraceSummary(window_s=1.0, busy_s=0.5, kernels=sum(
        n for n, _ in by_name.values()), kernel_s=0.1, by_name=by_name,
        gaps=[])


def _readings(trace, frames=(8, 12)):
    traced = [{"frames": f} for f in frames]
    r = types.SimpleNamespace(trace=trace, traced=traced)
    r.total = lambda key, traced=False: float(sum(
        u.get(key, 0) for u in r.traced))
    return r


def _read(name, readings):
    return run.load_module(
        run.ROOT / "benchmark" / "metrics" / f"{name}.py").read(readings)


KERNELS = {
    "void (anonymous namespace)::norm_apply_kernel<__nv_bfloat16, 8>(...)":
        [400.0, 0.01],
    "void (anonymous namespace)::norm_apply_planar_kernel<__nv_bfloat16, "
    "8>(...)": [100.0, 0.002],
    "void (anonymous namespace)::norm_stats_kernel<__nv_bfloat16, 8>(...)":
        [140.0, 0.01],
    "void (anonymous namespace)::conv3x3_wgmma_kernel<128, 128>(...)":
        [360.0, 0.05],
}


@pytest.mark.parametrize("name", NAMES)
def test_reads_the_apply_launches_over_the_frames(name):
    got = _read(name, _readings(_summary(KERNELS)))
    assert got == pytest.approx(500 / 20)


@pytest.mark.parametrize("name", NAMES)
def test_zero_without_the_kernel(name):
    """The parent: a trace with the generator's kernels but no apply."""
    parent = {k: v for k, v in KERNELS.items() if "norm_" not in k}
    assert _read(name, _readings(_summary(parent))) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_none_without_a_trace_or_frames(name):
    assert _read(name, _readings(None)) is None
    assert _read(name, _readings(_summary(KERNELS), frames=())) is None


@pytest.mark.parametrize("name", NAMES)
def test_declared_with_its_cell(name):
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in spec["per_layer"]}[name]
    assert (m["source"], m["layer"], m["unit"]) == (
        "device_trace", "Generator", "kernels/frame")
    assert (m["moves"], m["workloads"]) == (CELLS[name][0],
                                            [CELLS[name][1]])
    assert [m["name"] for m in spec["per_layer"][-2:]] == list(NAMES)
