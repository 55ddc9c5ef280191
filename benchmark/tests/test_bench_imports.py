"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole), and the reference loads nothing of the measured
package."""

import json
import os
import subprocess
import sys

from benchmark import run

REPO = str(run.ROOT)

LOAD_ALL = """
import json, sys
from pathlib import Path
import benchmark.run as run
from benchmark.lib import arith, mp4, servecheck, tap, trace, traffic, weights
for p in sorted(Path(run.BENCH, "drivers").glob("*.py")) + sorted(
        Path(run.BENCH, "metrics").glob("*.py")):
    run.load_module(p)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

LOAD_REFERENCE = """
import json, sys
from benchmark.reference import lowp, models, pose, raster, serve, train, wire
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code):
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(LOAD_ALL)
    assert not names & set(run.FORBIDDEN), names & set(run.FORBIDDEN)


def test_reference_loads_neither_jax_nor_the_program():
    names = _top_level(LOAD_REFERENCE)
    assert not names & set(run.FORBIDDEN)
    assert "text2video_tpu_torch" not in names


def test_names_are_compared_whole():
    sys.modules.setdefault("text2video_tpu_torch_probe", type(sys)("x"))
    try:
        assert "text2video_tpu_torch_probe" not in run.forbidden_loaded()
        assert all(n in run.FORBIDDEN for n in run.forbidden_loaded())
    finally:
        sys.modules.pop("text2video_tpu_torch_probe", None)


def test_no_card_exits_nonzero_with_no_result():
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "henan-896x512.batch4", "--seed", "2147483999", "--seconds", "1",
         "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == run.NO_CARD
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_outside_the_repository_it_fails_without_a_result(tmp_path):
    import shutil
    shutil.copytree(run.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "henan-896x512.batch4", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
