"""Tiny cells for the CPU tests: a copy of the benchmark's files under a
temporary root, with configurations and workloads of a few pixels and
frames added as files, and a ``BENCHMARK.json`` naming them."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent


def _load(path: Path) -> dict:
    return json.loads(path.read_text())


def make_root(tmp: Path, limits=None) -> Path:
    """A root holding ``benchmark/`` (copied) plus three tiny cells
    (``tiny.text2mp4``, ``tiny.batch``, ``tiny.train``) added by files."""
    root = tmp / "root"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = _load(REPO / "BENCHMARK.json")
    small = {"height": 96, "width": 128, "canvas": [128, 96], "base_ch": 8,
             "n_blocks": 1}
    fadg0 = {**_load(BENCH / "configs/fadg0-512x384.json"), **small,
             "name": "tiny-fadg0"}
    henan = {**_load(BENCH / "configs/henan-896x512.json"), **small,
             "name": "tiny-henan"}
    henan["train"] = {**henan["train"], "d_base_ch": 8, "face_crop": 32}
    (root / "benchmark/configs/tiny-fadg0.json").write_text(json.dumps(fadg0))
    (root / "benchmark/configs/tiny-henan.json").write_text(json.dumps(henan))
    t2m = _load(BENCH / "workloads/fadg0-512x384.text2mp4.json")
    t2m.update(config="tiny-fadg0", frames=[10, 20], lengths=4, cycles=2,
               time_bucket=8, recording={"clips": 3, "clip_frames": 20})
    t2m["check"] = {**t2m["check"], "among": 2, "requests": 2}
    batch = _load(BENCH / "workloads/henan-896x512.batch4.json")
    batch.update(config="tiny-henan", pool=3, frames=6, batch=2, calls=4,
                 time_bucket=4)
    train = _load(BENCH / "workloads/henan-896x512.train.json")
    train.update(config="tiny-henan", dataset_frames=12, batch=2, clip_len=4)
    cells = {"tiny.text2mp4": t2m, "tiny.batch": batch, "tiny.train": train}
    for name, wl in cells.items():
        if limits and name in limits:
            wl["check"]["limits"].update(limits[name])
        (root / f"benchmark/workloads/{name}.json").write_text(json.dumps(wl))
    spec = copy.deepcopy(spec)
    real = [w["name"] for w in spec["workloads"]]
    spec["workloads"] += [
        {"name": n, "config": c, "traffic": n.split(".")[1], "chips": 1,
         "why": "a CPU test's tiny cell"}
        for n, c in (("tiny.text2mp4", "tiny-fadg0"), ("tiny.batch", "tiny-henan"),
                     ("tiny.train", "tiny-henan"))]
    twin = dict(zip(real, ("tiny.text2mp4", "tiny.batch", "tiny.train")))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [twin[w] for w in m["workloads"] if w in twin]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
