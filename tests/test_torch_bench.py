"""The port's bench (``text2video_tpu_torch/bench.py``) against the root
``bench.py`` it mirrors: the same analytic FLOP count, and in every mode one
JSON line with the root line's metric name and keys (plus ``device``), run
tiny on the CPU, where ``mfu`` is null. The CLI's ``bench`` forwards its
flags, and without ``--device`` the bench raises where there is no card."""

import functools
import importlib.util
import json
import os

import pytest
import torch

from text2video_tpu_torch import bench, cli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(base_ch=4, n_blocks=1)
SHAPE = dict(height=32, width=48, frames=6)
# The keys of each mode's line in the root bench.py (:107-132, :165-180,
# :256-268); the port adds "device".
ROOT_KEYS = {
    "gen": {"metric", "value", "unit", "vs_baseline", "mfu",
            "flops_per_frame", "batch4"},
    "batch": {"metric", "value", "unit", "vs_baseline", "mfu",
              "flops_per_frame"},
    "jacobi": {"metric", "value", "unit", "vs_baseline", "mfu",
               "mfu_executed"},
    "e2e": {"metric", "value", "unit", "vs_baseline", "stage_seconds"},
}


def _root_bench():
    """The root ``bench.py`` by path (it imports only numpy at the top)."""
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape,kw", [
    ((384, 512), {}),                            # the flagship generator
    ((384, 704), {}),                            # henan at height 384
    ((32, 48), dict(base_ch=4, n_blocks=1)),     # the tests' tiny one
])
def test_analytic_frame_flops_match_root_bench(shape, kw):
    ours = bench._analytic_frame_flops(*shape, **kw)
    assert ours == _root_bench()._analytic_frame_flops(*shape, **kw)
    if shape == (384, 512):
        assert round(ours) == 395531255808  # 395.53 GFLOP a frame


def _run_cli(monkeypatch, capsys, mode_args, fn_name, **shape):
    """``cli bench --device cpu ...`` with the measuring function ``fn_name``
    cut to a tiny shape: (its one printed line as JSON, the kwargs the
    command passed)."""
    seen = {}
    fn = getattr(bench, fn_name)

    def tiny(*args, **kw):
        seen.update(kw, args=args)
        return functools.partial(fn, **TINY, **shape)(*args, **kw)

    monkeypatch.setattr(bench, fn_name, tiny)
    assert cli.main(["bench", "--device", "cpu", *mode_args]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0]), seen


def _check_line(line, mode, metric):
    assert set(line) == ROOT_KEYS[mode] | {"device"}
    assert line["metric"] == metric
    assert line["value"] > 0
    assert line["device"] == {"name": "cpu", "power_limit": None}


def test_gen_mode(monkeypatch, capsys):
    line, seen = _run_cli(monkeypatch, capsys, ["--mode", "gen"],
                          "gen_bench", **SHAPE)
    assert seen["batch"] == 1 and seen["with_extras"] is True
    assert str(seen["device"]) == "cpu"
    _check_line(line, "gen", "pose2frame_generation_fps_48x32_1chip")
    assert line["unit"] == "frames/sec" and line["mfu"] is None
    assert line["flops_per_frame"] == round(
        bench._analytic_frame_flops(32, 48, **TINY))
    assert line["vs_baseline"] == round(line["value"] / 25.0, 3)
    assert set(line["batch4"]) == {"fps", "vs_baseline", "mfu"}
    assert line["batch4"]["fps"] > 0 and line["batch4"]["mfu"] is None


def test_batch_mode(monkeypatch, capsys):
    line, seen = _run_cli(monkeypatch, capsys, ["--mode", "batch"],
                          "gen_bench", **SHAPE)
    assert seen["batch"] == 4
    _check_line(line, "batch", "pose2frame_generation_fps_48x32_1chip_b4")
    assert line["mfu"] is None


def test_jacobi_mode(monkeypatch, capsys):
    line, seen = _run_cli(monkeypatch, capsys,
                          ["--mode", "jacobi", "--sweeps", "3"],
                          "jacobi_bench", **SHAPE)
    assert seen["args"] == (3,)
    _check_line(line, "jacobi", "pose2frame_jacobi3_fps_48x32_1chip")
    assert line["mfu"] is None and line["mfu_executed"] is None


def test_e2e_mode(monkeypatch, capsys):
    line, seen = _run_cli(
        monkeypatch, capsys, ["--mode", "e2e", "--bucket", "16"],
        "e2e_bench", render_height=64)
    assert seen["load_size"] == 0 and seen["bucket"] == 16
    _check_line(line, "e2e", "e2e_text2video_realtime_factor_64x64_1chip")
    assert line["unit"].startswith("x realtime (audio ")
    assert {"pose_synthesis", "rasterize", "render", "mux"} <= set(
        line["stage_seconds"])


def test_peak_is_the_cards_own():
    assert bench.peak_bf16_flops(torch.device("cpu")) is None
    assert bench.PEAK_BF16_FLOPS == {"NVIDIA H100 80GB HBM3": 989e12}


def test_bench_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: bench.main(["--mode", "gen"]),
                 lambda: cli.main(["bench", "--mode", "e2e"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
