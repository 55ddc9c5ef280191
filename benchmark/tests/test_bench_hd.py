"""The coarse-to-fine generator's cell (``henan-1792x1024.batch4``): its FLOP
count against the reference's own convolutions, the reference's bfloat16
form (``reference/hd.py``'s ``Bf16``: the layout's rounding points), its
per-layer metrics on hand-built readings, their entries, and a tiny copy of
the cell driven through the whole run on the CPU (sound, faulted, float8
control), with the driver at ``local_enhancers`` 0 giving
``render_batch.py``'s numbers."""

import json
import types

import pytest
import torch

from benchmark import run
from benchmark.lib.arith import frame_flops
from benchmark.lib.arith_hd import hd_frame_flops
from benchmark.lib.trace import TraceSummary
from benchmark.reference import hd, models
from benchmark.tests.tiny import make_root
from text2video_tpu_torch.models.layers import InstanceNorm as PortNorm

CELL = "henan-1792x1024.batch4"
SPEC = json.loads((run.ROOT / "BENCHMARK.json").read_text())
SEED = 2147483987
TINY = {"gen_mae": 0.3, "gen_worst": 0.5}
# The tiny HD cell's limits on its bfloat16 numbers (sound 0.09-0.15,
# float8 1.1-1.8 at the test's size and seeds).
TINY_HD = {"bf16_mae": 0.4, "bf16_worst": 0.6}


def _read(name, readings):
    return run.load_module(
        run.ROOT / "benchmark" / "metrics" / f"{name}.py").read(readings)


def _conv_flops(gen, h, w):
    """2 * MACs of every conv the reference runs in one forward at h x w."""
    total = []

    def hook(mod, args, out):
        k, _, ci, co = mod.kernel.shape
        total.append(2.0 * out.shape[2] * out.shape[3] * ci * co * k * k)
    for m in gen.modules():
        if isinstance(m, models.Conv):
            m.register_forward_hook(hook)
    with torch.no_grad():
        gen(torch.zeros(1, h, w, 9), torch.zeros(1, h, w, 6), torch.ones(1))
    return sum(total)


@pytest.mark.parametrize("local", [0, 1, 2])
def test_flops_count_the_references_convolutions(local):
    cfg = {"base_ch": 8, "n_downsample": 3, "n_blocks": 2,
           "local_enhancers": local, "local_blocks": 3}
    gen = hd._build(cfg)
    assert _conv_flops(gen, 64, 128) == hd_frame_flops(64, 128, 8, 3, 2,
                                                       local, 3)


def test_flops_at_the_cells_size():
    c = json.loads((run.ROOT / "benchmark/configs/henan-1792x1024.json")
                   .read_text())
    got = hd_frame_flops(c["height"], c["width"], c["base_ch"],
                         c["n_downsample"], c["n_blocks"],
                         c["local_enhancers"], c["local_blocks"])
    assert got == pytest.approx(1347.806e9, rel=1e-6)
    # The trunk at 896x512 without its heads, and the enhancer's 442.2.
    trunk = frame_flops(512, 896) - 2.0 * 512 * 896 * 64 * 6 * 49
    assert got - trunk == pytest.approx(442.2e9, rel=1e-3)
    assert hd_frame_flops(512, 896) == frame_flops(512, 896)


def test_reference_without_enhancers_is_the_single_scale_one():
    cfg = {"base_ch": 8, "n_downsample": 3, "n_blocks": 1}
    shapes = hd.generator_shapes(cfg)
    with torch.device("meta"):
        plain = models.CompositeGenerator(15, 8, 3, 1)
    assert {k: v.shape for k, v in plain.state_dict().items()} == shapes
    g = torch.Generator().manual_seed(0)
    state = {k: torch.randn(s, generator=g) * 0.1 for k, s in shapes.items()}
    plain = models.CompositeGenerator(15, 8, 3, 1)
    plain.load_state_dict(state)
    args = (torch.rand(2, 32, 48, 9, generator=g),
            torch.rand(2, 32, 48, 6, generator=g), torch.tensor([0.0, 1.0]))
    with torch.no_grad():
        for a, b in zip(hd.reference_generator(cfg, "f32", state, "cpu")(
                *args), plain(*args)):
            assert torch.equal(a, b)


def _trace(kernel_s=2.0, window_s=3.0, apply=4352.0):
    by_name = {"void norm_apply_kernel<__nv_bfloat16, 8>(...)": [apply, 0.1],
               "void conv3x3_wgmma_kernel<128, 128>(...)": [2304.0, 0.6]}
    return TraceSummary(window_s=window_s, busy_s=2.9, kernels=9000,
                        kernel_s=kernel_s, by_name=by_name, gaps=[])


def _readings(trace, frames=(512,)):
    cfg = json.loads((run.ROOT / "benchmark/configs/henan-1792x1024.json")
                     .read_text())
    r = types.SimpleNamespace(
        trace=trace, traced=[{"frames": f} for f in frames],
        device_name="NVIDIA H100 80GB HBM3",
        cell=types.SimpleNamespace(config=cfg))
    r.total = lambda key, traced=False: float(sum(
        u.get(key, 0) for u in r.traced))
    return r


def test_device_metrics_on_a_hand_built_trace():
    """The cell's readings through batch4's metric files and its own
    ``mfu.serve_hd``."""
    r = _readings(_trace())
    assert _read("gen_device_ms_per_frame", r) == pytest.approx(
        2000.0 / 512)
    # 512 frames in 3 s at 1347.8 GFLOP a frame over 989 TFLOP/s.
    assert _read("mfu.serve_hd", r) == pytest.approx(
        100 * 1347.806e9 * 512 / 3.0 / 989e12, rel=1e-5)
    # The trunk's 25 normed blocks and the enhancer's 9, at batch 4.
    assert _read("norm_apply_per_frame.serve", r) == pytest.approx(8.5)
    parent = _readings(_trace(apply=0.0))
    assert _read("norm_apply_per_frame.serve", parent) == 0.0


@pytest.mark.parametrize("name", ["gen_device_ms_per_frame", "mfu.serve_hd",
                                  "norm_apply_per_frame.serve"])
def test_device_metrics_none_without_a_trace_or_frames(name):
    assert _read(name, _readings(None)) is None
    assert _read(name, _readings(_trace(), frames=())) is None


def test_declared_with_its_cell():
    layer = {m["name"]: m for m in SPEC["per_layer"]}
    m = layer["mfu.serve_hd"]
    assert (m["source"], m["unit"], m["layer"], m["moves"],
            m["workloads"]) == ("device_trace", "%", "Generator",
                                "frames_per_s", [CELL])
    # Batch4's entries list the cell too (appended), and nothing else of
    # theirs changed.
    for name in ("gen_device_ms_per_frame", "b1_roofline",
                 "idle_share.serve", "norm_apply_per_frame.serve"):
        assert layer[name]["workloads"] == ["henan-896x512.batch4", CELL]
    assert [m["name"] for m in SPEC["per_layer"]][-1] == "mfu.serve_hd"
    fps = next(m for m in SPEC["end_to_end"] if m["name"] == "frames_per_s")
    assert CELL in fps["workloads"]
    entry = next(w for w in SPEC["workloads"] if w["name"] == CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        "henan-1792x1024", "batch4", 1)
    c = run.find_cell(CELL)
    assert c.driver_file().name == "render_batch_hd.py"
    assert {m["name"] for m in c.end_to_end} == {"frames_per_s", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "gen_device_ms_per_frame", "b1_roofline", "idle_share.serve",
        "norm_apply_per_frame.serve", "mfu.serve_hd"}
    limits = c.workload["check"]["limits"]
    assert set(limits) == {"carry_mismatch", "bf16_mae", "bf16_worst",
                           "delivered_mismatch"}


def _flat_planes(seed=0, shape=(2, 8, 24, 40), ratio=8.0):
    """NCHW planes whose mean is ``ratio`` times their spread, as a stem's
    over flat label maps."""
    g = torch.Generator().manual_seed(seed)
    offset = ratio * (torch.rand(shape[:2], generator=g) * 2 - 1)
    x = torch.randn(shape, generator=g) + offset[..., None, None]
    return x.to(torch.bfloat16).float()


def test_rounded_norm_follows_the_layouts_rounding_points():
    """``RoundedNorm`` against the program's eager bfloat16 instance norm
    on the same planes: the same rounding points, so they part by the f32
    sum order alone (a bfloat16 ulp on a few elements); both stand off the
    float32 norm by the rounded squares' bias, far more than that."""
    x = _flat_planes()
    c = x.shape[1]
    g = torch.Generator().manual_seed(1)
    scale, bias = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g)
    ref = hd.RoundedNorm(c)
    plain = models.InstanceNorm(c)
    port = PortNorm(c, torch.bfloat16)
    with torch.no_grad():
        for m in (ref, plain, port):
            m.scale.copy_(scale)
            m.bias.copy_(bias)
        got = ref(x)
        want = port(x.permute(0, 2, 3, 1).to(torch.bfloat16)).permute(
            0, 3, 1, 2).float()
        exact = plain(x)
    apart = (got - want).abs()
    assert float(apart.max()) <= 2 * 2.0 ** -8 * float(want.abs().max())
    assert float((apart > 0).float().mean()) < 0.01
    assert float((got - exact).abs().mean()) > 20 * float(apart.mean())


def test_bf16_reference_is_the_f32_one_rounded():
    """The bfloat16 form computes the f32 reference's function: near it at
    a small size, and not equal to it; the float8 control lies further."""
    cfg = {"base_ch": 8, "n_downsample": 3, "n_blocks": 1,
           "local_enhancers": 1, "local_blocks": 3}
    g = torch.Generator().manual_seed(2)
    state = {k: torch.randn(s, generator=g) * (0.03 if "heads" in k else 0.1)
             for k, s in hd.generator_shapes(cfg).items()}
    args = ((torch.rand(2, 64, 96, 9, generator=g) * 2 - 1),
            (torch.rand(2, 64, 96, 6, generator=g) * 2 - 1).to(
                torch.bfloat16).float(), torch.tensor([0.0, 1.0]))
    with torch.no_grad():
        f32, bf16, fp8 = (hd.reference_generator(cfg, p, state, "cpu")(
            *args)[0] for p in ("f32", "bf16", "fp8"))
    off = float((bf16 - f32).abs().mean())
    assert 0.0 < off < 0.01
    assert float((fp8 - f32).abs().mean()) > 3 * off
    assert isinstance(hd.reference_generator(cfg, "bf16", state, "cpu")
                      .local[0].res[0].block0.norm, hd.RoundedNorm)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny cells of ``tiny.py`` plus ``tiny.hd`` (the HD cell at
    128x64, base 8, a pool of 3 utterances of 6 frames, batch 2, with the
    tiny cells' limits) and ``tiny.batch0`` (batch4's tiny cell through
    this cell's driver)."""
    torch.set_num_threads(2)
    root = make_root(tmp_path_factory.mktemp("hd"), {"tiny.batch": TINY})
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs/henan-1792x1024.json").read_text())
    cfg.update(name="tiny-hd", height=64, width=128, base_ch=8, n_blocks=1)
    (bench / "configs/tiny-hd.json").write_text(json.dumps(cfg))
    wl = json.loads((bench / f"workloads/{CELL}.json").read_text())
    wl.update(config="tiny-hd", pool=3, frames=6, batch=2, calls=4,
              time_bucket=4)
    wl["check"]["limits"].update(TINY_HD)
    (bench / "workloads/tiny.hd.json").write_text(json.dumps(wl))
    batch = json.loads((bench / "workloads/tiny.batch.json").read_text())
    (bench / "workloads/tiny.batch0.json").write_text(json.dumps(
        dict(batch, driver="render_batch_hd")))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"] += [
        {"name": "tiny.hd", "config": "tiny-hd", "traffic": "hd",
         "chips": 1, "why": "a CPU test's tiny cell"},
        {"name": "tiny.batch0", "config": "tiny-henan", "traffic": "batch0",
         "chips": 1, "why": "a CPU test's tiny cell"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"] += ["tiny.hd"]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run(root, cell, **kw):
    c = run.find_cell(cell, root)
    return run.run_cell(c, SEED, 1.0, False, torch.device("cpu"), **kw)


def test_tiny_hd_cell_sound_faulted_and_control(root):
    sound = _run(root, "tiny.hd")
    assert sound["correct"], sound["check"]
    assert sound["failed"] == 0 and "frames_per_s" in sound["metrics"]
    for key in ("carry_mismatch", "delivered_mismatch"):
        assert sound["check"][key]["value"] == 0
    assert not _run(root, "tiny.hd", fault="frame_offset")["correct"]
    control = _run(root, "tiny.hd", control=True)
    assert control["correct"] is False, control["check"]
    for key in ("bf16_mae", "bf16_worst"):
        assert (control["check"][key]["value"]
                > 3 * sound["check"][key]["value"])


def test_without_enhancers_it_is_render_batch(root):
    """Batch4's tiny cell, through ``render_batch.py`` and through this
    driver: the same numbers from the same seed."""
    old, new = _run(root, "tiny.batch"), _run(root, "tiny.batch0")
    assert old["correct"] and new["correct"]
    assert old["check"] == new["check"]
