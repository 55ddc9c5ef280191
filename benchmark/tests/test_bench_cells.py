"""Tiny cells driven through the whole run on the CPU, the look for a card
skipped: a sound run of the program is correct; the run with the timed
path broken underneath (each fault the cell can have) is not; the float8
control sits well above the program. At this size the limits are the
tiny cells' own (``TINY``); the cells' limits were set on the card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.lib.tap import GeneratorTap
from benchmark.tests.tiny import make_root

SEED = 2147483987  # beyond 32 signed bits: the command takes such seeds
TINY = {
    "tiny.text2mp4": {"gen_mae": 0.3, "gen_worst": 0.5},
    "tiny.batch": {"gen_mae": 0.3, "gen_worst": 0.5},
    "tiny.train": {"loss1_gap": 0.002, "grad_norm_gap": 0.5,
                   "change_norm_gap": 0.5},
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("bench"), TINY)


def _run(root, cell, **kw):
    c = run.find_cell(cell, root)
    return run.run_cell(c, SEED, 1.0, False, torch.device("cpu"), **kw)


@pytest.mark.parametrize("cell", ["tiny.text2mp4", "tiny.batch",
                                  "tiny.train"])
def test_sound_run_is_correct(root, cell):
    res = _run(root, cell)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "check"
    for key in ("carry_mismatch", "label_px", "frames_missing",
                "delivered_mismatch"):
        if key in res["check"]:
            assert res["check"][key]["value"] == 0


@pytest.mark.parametrize("cell,fault", [
    ("tiny.text2mp4", "frame_offset"),   # an answer altered where made
    ("tiny.text2mp4", "label_shift"),    # the drawing's input moved 1 px
    ("tiny.batch", "frame_offset"),
    ("tiny.train", "state_unchanged"),   # the step leaves its state
    ("tiny.train", "half_batch"),        # half the rows, the mean of those
])
def test_broken_timed_path_is_not_correct(root, cell, fault):
    assert not _run(root, cell, fault=fault)["correct"]


@pytest.mark.parametrize("cell,number", [
    ("tiny.text2mp4", "gen_mae"), ("tiny.batch", "gen_worst"),
    ("tiny.train", "loss1_gap")])
def test_float8_control_fails_where_the_program_passes(root, cell, number):
    sound = _run(root, cell)["check"][number]
    control = _run(root, cell, control=True)
    assert control["correct"] is False, control["check"]
    control = control["check"][number]
    assert control["value"] > 3 * sound["value"]
    assert control["value"] > control["limit"] >= sound["value"]


@pytest.mark.card
def test_module_run_prints_one_line_on_a_card():
    """The command line on a card: one result line, check last."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the run refuses to measure on the CPU")
    env = {**os.environ, "PYTHONPATH": str(run.ROOT)}
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "henan-896x512.batch4", "--seed", str(SEED), "--seconds", "3",
         "--trace", "0"], cwd=run.ROOT, env=env, capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "check" and line["device"]["platform"] == "gpu"


def test_tap_records_through_the_programs_step_seam():
    """A generator that offers ``register_step_tap`` (as a frame loop
    captured in a graph would) is seen through it, with no call of its
    ``forward``."""

    class Captured(torch.nn.Module):
        def register_step_tap(self, fn):
            self.fn = fn

        def forward(self, *a):
            raise AssertionError("a replayed step calls no forward")

        def replay(self, t):
            x = torch.full((1, 2), float(t))
            self.fn(x, x + 1, torch.ones(1), x * 2)

    gen = Captured()
    tap = GeneratorTap(gen)
    tap.arm([1, 3])
    for t in range(5):
        gen.replay(t)
    calls = tap.disarm()
    assert sorted(calls) == [1, 3]
    assert torch.equal(calls[3][3], torch.full((1, 2), 6.0))
    gen.replay(7)
    assert sorted(calls) == [1, 3]
