"""Run one cell of the benchmark of ``text2video_tpu_torch`` once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``; its file
``benchmark/workloads/<cell>.json`` names a configuration
(``benchmark/configs/<config>.json``), a driver
(``benchmark/drivers/<driver>.py``) and the traffic's parameters. Each
metric of ``BENCHMARK.json`` is read by ``benchmark/metrics/<metric>.py``.
So a cell, a configuration or a metric is added by adding files and entries.

A run sets up the cell (weights and inputs from ``--seed``, every shape the
traffic uses warmed), then runs the units of work of the cell's
``drivers/`` module (requests, calls, steps) back to back for
``--seconds``, closed loop; the window closes when the last unit started in
it ends. ``--trace 0`` reports the cell's
end-to-end metrics; ``--trace 1`` profiles the window's units 1 to
``trace_units`` (unit 0 runs untraced) and reports its per-layer metrics,
the device's busy seconds and a breakdown. After the window the program's
state is freed and the plain reference checks what the window produced.
The last line of standard output is one JSON object; the numbers compared,
each beside its limit, are the last lines of standard error and the last
key of that object.

Without a card, or with fewer cards than the cell needs, the run exits with
code 3 and prints no result. It also fails, printing no result, when JAX or
the JAX package is loaded in this process once the window has closed.

``--control 1`` runs no window: it sets the cell up, puts the reference's
lower-precision controls in the program's place, and judges their numbers
against the cell's limits by the rule of ``correct``, which has to come out
false. ``--fault <name>`` plants one of that module's faults in the program
before the window. Both are for setting and proving the limits; the
benchmark's own runs use neither.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names that may not be loaded, compared whole: the port
# ``text2video_tpu_torch`` begins with the JAX package's name and is fine.
FORBIDDEN = ("jax", "jaxlib", "flax", "text2video_tpu")
NO_CARD = 3


def seconds_since_process_start() -> float:
    """Seconds since this process started (from /proc), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def use_checkout_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a checkout's first run builds; the program's own kernels and
    native libraries already build under ``build/``."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def program_host_defaults() -> None:
    """The host settings the program's own command line starts with
    (``cli.py``): one thread for OpenMP and OpenBLAS, unless the environment
    says otherwise. The process keeps the cores its launcher gives it."""
    for var in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A driver or metric file, imported by its path (its name may hold
    dots)."""
    name = "benchmark._loaded." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """Everything a run knows of its cell, found by name."""

    name: str
    chips: int
    workload: dict
    config: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench: Path

    def metric_file(self, metric: str) -> Path:
        return self.bench / "metrics" / f"{metric}.py"

    def driver_file(self) -> Path:
        return self.bench / "drivers" / f"{self.workload['driver']}.py"


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files under
    ``root/benchmark``."""
    spec = load_json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    bench = root / "benchmark"
    workload = load_json(bench / "workloads" / f"{name}.json")
    config = load_json(bench / "configs" / f"{entry['config']}.json")

    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    layer = [m for m in spec["per_layer"] if name in m["workloads"]]
    return Cell(name=name, chips=int(entry["chips"]), workload=workload,
                config=config, end_to_end=e2e, per_layer=layer, bench=bench)


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell, the run's arguments, its device and
    a scratch directory under ``TMPDIR`` that the run deletes."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    tmp: Path
    fault: Optional[str] = None


@dataclasses.dataclass
class Readings:
    """What a metric file reads: every unit's record and the window's
    length; in a traced run the traced units' records and the trace."""

    units: List[dict]
    window_s: float
    setup_s: float
    traced: List[dict]
    trace: object
    cell: Cell
    device_name: str

    def total(self, key: str, traced: bool = False) -> float:
        return float(sum(u.get(key, 0) for u in
                         (self.traced if traced else self.units)))


def device_info(device) -> dict:
    """The card's name and the power limit ``nvidia-smi`` reports."""
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device)}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        info["power_limit"] = smi.stdout.strip().splitlines()[
            device.index or 0].rsplit(",", 1)[1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = None
    return info


def read_metrics(entries: List[dict], cell: Cell, readings: Readings) -> Dict:
    out = {}
    for m in entries:
        value = load_module(cell.metric_file(m["name"])).read(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def within_limits(check: Dict) -> bool:
    """The rule of ``correct``: some number compared, each at or under its
    limit. A control is judged by it too, and has to come out false."""
    return bool(check) and all(c["value"] <= c["limit"]
                               for c in check.values())


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             control: bool = False, fault: Optional[str] = None,
             t_start: float = 0.0) -> dict:
    """Set up, measure, check; the result object (without printing it).
    ``t_start``: seconds between process start and this call."""
    import torch
    from benchmark.lib import trace as tracing

    t0 = time.perf_counter() - t_start
    driver = load_module(cell.driver_file())
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                      device=device, tmp=Path(tmp), fault=fault)
        if trace and device.type == "cuda":
            tracing.warm_up(device)
        runner = driver.Cell(ctx)
        if control:
            check = runner.control()
            runner.release()
            return {"control": True, "correct": within_limits(check),
                    "check": check}
        k = int(cell.workload.get("trace_units", 1)) if trace else 0
        units: List[dict] = []
        attempted = failed = 0
        summary: list = []
        sync = (torch.cuda.synchronize if device.type == "cuda"
                else (lambda *_: None))
        sync(device)
        t_w0 = time.perf_counter()
        setup_s = t_w0 - t0
        deadline = t_w0 + seconds
        i = 0
        with contextlib.ExitStack() as stack:
            while time.perf_counter() < deadline or (trace and i <= k):
                if trace and i == 1 and device.type == "cuda":
                    summary = stack.enter_context(tracing.traced(device))
                attempted += 1
                try:
                    units.append(runner.unit(i))
                except Exception:  # a failed unit is counted and shown
                    failed += 1
                    traceback.print_exc()
                    units.append({})
                if trace and i == k:
                    stack.close()
                i += 1
        sync(device)
        window_s = time.perf_counter() - t_w0
        if summary:
            summary[0] = tracing.reduce(summary[0])
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        readings = Readings(
            units=units, window_s=window_s, setup_s=setup_s,
            traced=units[1:1 + k], trace=summary[0] if summary else None,
            cell=cell, device_name=(torch.cuda.get_device_name(device)
                                    if device.type == "cuda" else "cpu"))
        if trace:
            metrics = read_metrics(cell.per_layer, cell, readings)
        else:
            metrics = read_metrics(cell.end_to_end, cell, readings)
        runner.release()
        check = runner.check()
    correct = failed == 0 and within_limits(check)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"count": cell.chips, "memory_peak_bytes": peak}}
    if summary:
        result["device"].update(busy_s=summary[0].busy_s,
                                window_s=summary[0].window_s)
        result["breakdown"] = summary[0].breakdown()
    result["check"] = check
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a non-negative whole number")
    use_checkout_caches()
    program_host_defaults()
    cell = find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return NO_CARD
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    info = device_info(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                      control=bool(args.control), fault=args.fault,
                      t_start=seconds_since_process_start())
    loaded = forbidden_loaded()
    if loaded:
        print(f"benchmark: {loaded} loaded in the measuring process: no "
              "result", file=sys.stderr)
        return 4
    if "device" in result:
        result["device"] = {**info, **result["device"]}
        result["check"] = result.pop("check")
    for name, c in result["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
