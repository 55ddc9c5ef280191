"""BENCHMARK.json keeps to its contract, and every cell's files are found by
name."""

import json
import re
from pathlib import Path

import pytest

from benchmark import run
from benchmark.tests.tiny import make_root

ROOT = Path(run.ROOT)
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(TEXT.match(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    assert all(PATH.match(p) and not p.endswith("_torch")
               for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text_fields():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    names += CELLS
    assert all(NAME.match(n) for n in names)
    for group in (SPEC["configs"], SPEC["workloads"],
                  SPEC["end_to_end"] + SPEC["per_layer"]):
        assert len({g["name"] for g in group}) == len(group)


def test_metric_entries():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = run.find_cell(cell)
    assert c.driver_file().exists()
    for m in c.end_to_end + c.per_layer:
        assert c.metric_file(m["name"]).exists(), m["name"]
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    config = next(x for x in SPEC["configs"] if x["name"] == entry["config"])
    assert config["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
    assert (ROOT / config["file"]).exists()


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_e2e_and_a_layer(cell):
    c = run.find_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_moves_is_reported_by_each_listed_cell(metric):
    m = next(x for x in SPEC["per_layer"] if x["name"] == metric)
    for cell in m["workloads"]:
        reported = {e["name"] for e in run.find_cell(cell).end_to_end}
        assert m["moves"] in reported, (metric, cell)


def test_configs_used_and_four_chip_share():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_a_cell_is_added_by_files_alone(tmp_path):
    before = {p: p.read_bytes() for p in (ROOT / "benchmark").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    root = make_root(tmp_path)
    for name in ("tiny.text2mp4", "tiny.batch", "tiny.train"):
        cell = run.find_cell(name, root)
        assert cell.driver_file().exists() and cell.per_layer
    for p, data in before.items():
        copy = root / p.relative_to(ROOT)
        if copy.exists():
            assert copy.read_bytes() == data, p
