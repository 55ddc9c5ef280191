"""The mesh's "model" axis in the port on the CPU: the JAX package's
partition rule, the placement of a shard, and the train step with its wide
conv kernels sharded by output channel over gloo ranks
(``tests/torch_mesh_workers.py::model_ops``, one spawn of four ranks with a
deadline and JAX blocked in each).

The configuration is the JAX train-step test's tiny one (32x32, T 4, f32,
no VGG) at base 32 and ``d_base_ch`` 32, so that wide kernels exist: at base
8 no kernel reaches 256 output channels and the axis would shard nothing.
The ranks step at (2, 2), held against the JAX package's step with its state
placed by ``param_specs`` on a (2, 2) virtual CPU mesh, and at (1, 2), held
bit for bit against the port's single process; they save whole checkpoints,
run ``train-gan --n-model 2`` through the CLI and resume a one-process
directory under the axis. ``graft_entry.dryrun_multichip`` runs in four
ranks of its own."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import torch_mesh_workers as workers
from torch_train_parity import (
    BASE,
    _batch,
    _check_params,
    _discs_from_flax,
    _jax_state_and_step,
    _to_np,
    _torch_batch,
)

from text2video_tpu_torch import checkpoints
from text2video_tpu_torch.convert import params_from_flax
from text2video_tpu_torch.parallel import Mesh, param_specs, spawn
from text2video_tpu_torch.train import trainer as tt

torch.set_num_threads(1)

WORLD = 4
SPAWN_TIMEOUT_S = 300.0
WIDE = dict(base_ch=32, d_base_ch=32)
CFG = tt.TrainConfig(**dict(BASE, **WIDE), dtype=torch.float32)
BLOCK = ("jax", "text2video_tpu")
TRAIN_ARGS = ["--width", "128", "--height", "96", "--source-width", "512",
              "--source-height", "384", "--clip-len", "4", "--base-ch", "8",
              "--batch-size", "2", "--device-data", "--device", "cpu"]


def _cpu_mesh(n_data: int, n_model: int, model_rank: int = 0) -> Mesh:
    """A mesh record for the rules, which need no process group."""
    return Mesh(shape={"data": n_data, "model": n_model}, rank=0,
                group=None, device=torch.device("cpu"), backend="gloo",
                model_rank=model_rank)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX state before, its sharded steps' states and metrics, the
    batch and the ranks' output directory."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from text2video_tpu.parallel.mesh import make_mesh
    from text2video_tpu.parallel.mesh import param_specs as jax_specs

    from text2video_tpu_torch import cli
    from text2video_tpu_torch.convert import trainer_state_from_flax
    from text2video_tpu_torch.golden import write_training_assets

    root = tmp_path_factory.mktemp("model_axis")
    batch = _batch(b=4, t=4)
    state, step = _jax_state_and_step(WIDE)
    mesh = make_mesh(n_data=2, n_model=2)
    specs = jax.tree.map(lambda _: P(), state).replace(
        g_params=jax_specs(state.g_params, mesh),
        d_params=jax_specs(state.d_params, mesh))
    placed = jax.device_put(state, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, P)))
    sharded_batch = {k: jax.device_put(v, NamedSharding(mesh, P("data")))
                     for k, v in batch.items()}
    after1, m1 = step(placed, sharded_batch)
    _, m2 = step(after1, sharded_batch)
    before = _to_np(state)

    checkpoints.save_state(str(root / "init"),
                           trainer_state_from_flax(before, CFG, device="cpu"),
                           CFG)
    with open(root / "cfg.json", "w") as f:
        json.dump(dict(BASE, **WIDE), f)
    np.savez(root / "batch.npz", **batch)
    images, keypoints = write_training_assets(str(root / "data"), 24,
                                              (128, 96))
    argv = ["train-gan", "--images", images, "--keypoints", keypoints]
    out = root / "out"
    out.mkdir()
    # A one-process directory for the ranks to resume under the axis.
    assert cli.main(argv + ["--steps", "1", "--ckpt", str(root / "one")]
                    + TRAIN_ARGS) == 0
    shutil.copytree(root / "one", out / "resume")
    with open(root / "train_argv.json", "w") as f:
        json.dump(argv + TRAIN_ARGS + ["--n-model", "2"], f)
    torch.save(_serving_weights(), root / "generator.pt")
    spawn("torch_mesh_workers:model_ops", WORLD,
          (str(root / "store"), str(root), str(out)),
          timeout_s=SPAWN_TIMEOUT_S, block=BLOCK)
    return dict(before=before, state=state, after=[_to_np(after1)],
                metrics=[{k: float(v) for k, v in m.items()}
                         for m in (m1, m2)],
                batch=batch, out=str(out), root=str(root))


def _serving_weights():
    """The serving cases' tiny generator (``torch_mesh_workers.
    tiny_renderer``): seeded, a tenth of the heads' kernel, as the JAX
    weights of ``test_torch_mesh.py`` are scaled."""
    from text2video_tpu_torch.render import Renderer

    state = Renderer.create(seed=3, base_ch=8, n_blocks=1,
                            dtype=torch.float32,
                            device="cpu").generator.state_dict()
    state["heads.kernel"] = state["heads.kernel"] * 0.1
    return state


def _read(out, case, rank):
    with open(os.path.join(out, f"{case}_rank{rank}.json")) as f:
        return json.load(f)


def _step_state(ckpt_dir, step):
    path = os.path.join(ckpt_dir, f"step_{step:08d}", checkpoints.STATE_NAME)
    return torch.load(path, map_location="cpu", weights_only=True)


def _equal(x, y) -> bool:
    if isinstance(x, torch.Tensor):
        return torch.equal(x, y)
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_equal(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(_equal(p, q) for p, q in zip(x, y))
    return x == y


# ---- the partition rule and the placement -----------------------------------


@pytest.mark.parametrize("name,shape,axis", [
    ("wide_conv", (3, 3, 64, 512), 3),
    ("narrow_conv", (3, 3, 8, 16), None),
    ("odd_channels", (3, 3, 64, 257), None),  # not divisible by n_model
    ("bias", (512,), None),
])
def test_param_specs_rules(name, shape, axis):
    """The four cases of ``tests/test_parallel.py::test_param_specs_rules``
    at (4, 2), on parameters of those shapes."""
    module = torch.nn.Module()
    module.register_parameter(name, torch.nn.Parameter(torch.zeros(shape)))
    assert param_specs(module, _cpu_mesh(4, 2)) == {name: axis}


def test_param_specs_match_jax(run):
    """The port's rule on the converted G and Ds equals the JAX package's
    ``param_specs`` on the flax trees, leaf for leaf, at (4, 2); some leaves
    of each network are sharded."""
    import jax
    from jax.sharding import PartitionSpec as P

    from text2video_tpu.parallel.mesh import make_mesh
    from text2video_tpu.parallel.mesh import param_specs as jax_specs

    from text2video_tpu_torch.convert import trainer_state_from_flax

    mesh = make_mesh(n_data=4, n_model=2)
    state = trainer_state_from_flax(run["before"], CFG, device="cpu")
    model = P(None, None, None, "model")
    for tree, module, convert in (
            (run["state"].g_params, state.generator, params_from_flax),
            (run["state"].d_params, state.discriminators, _discs_from_flax)):
        marks = jax.tree.map(lambda s: np.float32(s == model),
                             jax_specs(tree, mesh),
                             is_leaf=lambda x: isinstance(x, P))
        ref = {k: bool(v) for k, v in convert(marks).items()}
        got = {k: v == 3 for k, v in
               param_specs(module, _cpu_mesh(4, 2)).items()}
        assert got == ref
        assert any(got.values())


def test_shard_params_placement(run):
    """Each rank's shard of each wide kernel is ``[..., m*c/2:(m+1)*c/2]``
    of the whole kernel (``tests/test_parallel.py::
    test_shard_params_placement``); a kernel 512 wide splits into two of
    256. The sharded G leaves are the wide ones of the rule."""
    full = params_from_flax(run["before"].g_params)
    got = [_read(run["out"], "m22", r)["sharded"] for r in range(WORLD)]
    assert got == [got[0]] * WORLD
    wide = [k for k, v in param_specs(
        tt.create_trainer_state(CFG, device="cpu").generator,
        _cpu_mesh(2, 2)).items() if v == 3]
    assert wide and set(wide) <= set(got[0])
    for r in range(WORLD):
        shards = dict(np.load(os.path.join(run["out"],
                                           f"m22_shards_rank{r}.npz")))
        assert sorted(shards) == sorted(wide)
        m = r % 2
        for k, v in shards.items():
            c = full[k].shape[-1]
            np.testing.assert_array_equal(
                v, full[k][..., m * c // 2:(m + 1) * c // 2].numpy())


def test_grid_layout(run):
    """Global rank g sits at data index g // 2 and model index g % 2; only
    global rank 0 is the main rank."""
    for r in range(WORLD):
        g = _read(run["out"], "grid", r)
        assert g["shape"] == {"data": 2, "model": 2}
        assert (g["rank"], g["model_rank"]) == divmod(r, 2)
        assert g["is_main"] == (r == 0)


# ---- serving on the grid -------------------------------------------------------


def test_grid_serving_bit_equal_one_process(run):
    """Jacobi (8 frames in 2 sweeps, 7 in 3: blocks on ``time_bucket``
    boundaries) and ``render_many`` (one and two rows a data index) on the
    (2, 2) grid: every rank's frames are the single process's bits (rows
    held against the same batch size, ROADMAP C2), and the two model ranks
    of a data index return the same bytes."""
    r = workers.tiny_renderer(run["root"])
    clips, utt = workers.render_inputs()
    ref = dict(jac8=r.render_jacobi(utt, sweeps=2),
               jac7=r.render_jacobi(utt[:7], sweeps=3),
               many1=np.stack([r.render(clips[i]) for i in range(2)]),
               many2=np.concatenate([r.render_many(clips[i: i + 2])
                                     for i in (0, 2)]))
    got = [dict(np.load(os.path.join(run["out"], f"serve_rank{k}.npz")))
           for k in range(WORLD)]
    for k, g in enumerate(got):
        for key, want in ref.items():
            np.testing.assert_array_equal(g[key], want,
                                          err_msg=f"rank {k}: {key}")
    for d in range(2):  # global ranks 2d and 2d + 1 share data index d
        for key in ref:
            assert got[2 * d][key].tobytes() == got[2 * d + 1][key].tobytes()


def test_grid_skeleton_pipeline_writes_one_mp4(run, tmp_path, monkeypatch):
    """``Text2VideoPipeline(mesh=)`` without a renderer on the (2, 2) grid:
    every rank's labels equal one process's, and global rank 0 alone writes
    the run's one mp4."""
    from text2video_tpu_torch import pipeline
    from text2video_tpu_torch.config import PipelineConfig
    from text2video_tpu_torch.golden import golden_pose_inputs

    profile, pdict, table, ts = golden_pose_inputs(n_frames=9)
    port_stage = pipeline.PoseStage
    monkeypatch.setattr(pipeline, "PoseStage", lambda p, device="cpu":
                        port_stage(p, pdict, table, device))
    ref = pipeline.Text2VideoPipeline(
        PipelineConfig(person=profile, out_dir=str(tmp_path)),
        device="cpu").synthesize(ts, "grid", keep_arrays=True)
    for k in range(WORLD):
        got = np.load(os.path.join(run["out"], f"serve_rank{k}.npz"))
        np.testing.assert_array_equal(got["labels"], ref.label_maps)
        meta = _read(run["out"], "serve", k)
        assert meta["frames"] == ref.num_frames == 9
        assert meta["files"] == (["grid.mp4"] if k == 0 else [])
    out = os.path.join(run["out"], "serve", "fadg0")
    assert os.listdir(out) == ["grid.mp4"]
    assert os.path.getsize(os.path.join(out, "grid.mp4")) > 0


# ---- the train step ------------------------------------------------------------


@pytest.mark.parametrize("step", [1, 2])
def test_model_axis_step_matches_jax_sharded_step(run, step):
    """(2, 2) over four ranks against the JAX package's step on a (2, 2)
    mesh with ``param_specs`` placing its state, at steps 1 and 2: every
    rank's metrics at ``tests/test_train_step.py``'s bound (rtol 2e-3,
    atol 2e-5), every rank gathering each wide kernel once a step. After
    step 1 the saved whole weights are held at ``_check_params``'s bound,
    the one the data-parallel step of ``test_torch_mesh_train.py`` meets
    (almost all within 1e-5, none past 2.5 lr: a near-zero gradient may
    flip its sign). After step 2
    weights are not compared: there Adam's update is no longer the sign of
    the gradient, and the JAX package's own (2, 2) step leaves 21% of G's
    weights more than 1e-5 from its unsharded step's (the warp's gradient
    jumps where float noise moves a sample across a pixel)."""
    wide = len(_read(run["out"], "m22", 0)["sharded"])  # G's and D's
    for r in range(WORLD):
        got = _read(run["out"], "m22", r)
        assert got["gathers"] == [wide, wide]
        for k, ref in run["metrics"][step - 1].items():
            np.testing.assert_allclose(got["metrics"][step - 1][k], ref,
                                       rtol=2e-3, atol=2e-5, err_msg=k)
    if step == 1:
        saved = _step_state(os.path.join(run["out"], "m22"), 1)
        after = run["after"][0]
        for net, ref in (("generator", params_from_flax(after.g_params)),
                         ("discriminators",
                          _discs_from_flax(after.d_params))):
            _check_params(list(saved[net].items()), ref, CFG.lr, net)


def _single_process_steps(root, batch):
    """The port's single process: two steps on the whole batch from the init
    state in ``root``; (its state after each step, as saved; its
    metrics)."""
    import tempfile

    state = checkpoints.restore_state(
        os.path.join(root, "init"),
        tt.create_trainer_state(CFG, seed=1, device="cpu"))
    step = tt.make_train_step(CFG)
    saved, metrics = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for i in (1, 2):
            state, m = step(state, _torch_batch(batch))
            metrics.append({k: float(v) for k, v in m.items()})
            checkpoints.save_state(tmp, state, CFG)
            saved.append(_step_state(tmp, i))
    return saved, metrics


def test_model_axis_one_by_two_bit_equal_to_one_process(run):
    """(1, 2): two model ranks on the whole batch of 4, against the port's
    single process on it: metrics of both steps and the whole weights and
    Adam moments after each (gathered for the save) bit-equal; ranks 2 and
    3 are outside that grid."""
    saved, metrics = _single_process_steps(run["root"], run["batch"])
    for r in range(2):
        got = _read(run["out"], "m12", r)
        assert got["metrics"] == metrics
        assert got["gathers"][0] > 0
    assert not any(os.path.exists(os.path.join(run["out"],
                                               f"m12_rank{r}.json"))
                   for r in (2, 3))
    for i, ref in enumerate(saved, start=1):
        got = _step_state(os.path.join(run["out"], "m12"), i)
        assert _equal(got, ref), i


# ---- checkpoints, the CLI and the dry run ---------------------------------------


def test_model_axis_checkpoint_loads_in_one_process(run):
    """A directory written at (2, 2) holds whole tensors: it restores into a
    one-process state with no shape left sharded and serves through
    ``load_renderer``; the CLI's (2, 2) run left it at step 2."""
    from text2video_tpu_torch.config import get_profile

    for name, steps in (("m22", 2), ("cli", 2)):
        src = os.path.join(run["out"], name)
        cfg = CFG if name == "m22" else None
        state = tt.create_trainer_state(
            cfg or tt.TrainConfig(height=96, width=128, base_ch=8,
                                  dtype=torch.bfloat16), device="cpu")
        state = checkpoints.restore_state(src, state)
        assert state.step == steps
        for module, opt in ((state.generator, state.g_opt),
                             (state.discriminators, state.d_opt)):
            for p in module.parameters():
                assert opt.state[p]["exp_avg"].shape == p.shape
    r = checkpoints.load_renderer(os.path.join(run["out"], "cli"),
                                  get_profile("fadg0"), device="cpu")
    labels = np.random.RandomState(0).randint(0, 256, (3, 96, 128, 3),
                                              np.uint8)
    frames = r.render(labels)
    assert frames.shape == (3, 96, 128, 3) and frames.std() > 0


def test_one_process_checkpoint_resumes_under_model_axis(run):
    """``train-gan --n-model 2 --steps 1`` over the four ranks resumes the
    one-process directory at step 1 and saves step 2 whole: the shapes are
    the one-process run's and the weights moved."""
    one = _step_state(os.path.join(run["root"], "one"), 1)
    got = _step_state(os.path.join(run["out"], "resume"), 2)
    assert got["step"] == 2
    for net in ("generator", "discriminators"):
        assert {k: v.shape for k, v in got[net].items()} == {
            k: v.shape for k, v in one[net].items()}
    assert not torch.equal(got["discriminators"]["image.scale0.convs.3.kernel"],
                           one["discriminators"]["image.scale0.convs.3.kernel"])


def test_cli_train_gan_n_model_two(run):
    """``train-gan --n-model 2`` over four spawned ranks trains a 2 x 2
    grid: its directory holds step 2, and the Ds' wide kernels (the
    default ``d_base_ch`` 64 reaches 256 and 512 channels) are whole."""
    got = _step_state(os.path.join(run["out"], "cli"), 2)
    k = got["discriminators"]["image.scale0.convs.3.kernel"]
    assert k.shape == (4, 4, 256, 512)
    assert got["g_opt"]["state"] and got["d_opt"]["state"]


def test_ranks_import_no_jax(run):
    """No rank loaded JAX or the JAX package (spawned with them blocked)."""
    for r in range(WORLD):
        assert _read(run["out"], "loaded", r) == []


def test_dryrun_multichip_cpu():
    """The port's dry run in four gloo ranks: the train step over (2, 2)
    (nothing reaches 256 channels at base 8: nothing sharded, nothing
    gathered), Jacobi over (4, 1), the smoother byte-equal to the host
    loop, labels drawn; finite losses; rank 0's line."""
    from text2video_tpu_torch import graft_entry

    out = graft_entry.dryrun_multichip(4, device="cpu")
    assert out["line"].startswith(
        "dryrun_multichip ok: mesh={'data': 2, 'model': 2} ")
    assert "jacobi_sp={'data': 4, 'model': 1}" in out["line"]
    for r, rank in enumerate(out["ranks"]):
        assert (rank["data_rank"], rank["model_rank"]) == divmod(r, 2)
        assert rank["sharded"] == [] and rank["kernels_gathered"] == 0
        assert np.isfinite(rank["g_loss"]) and np.isfinite(rank["d_loss"])
        assert rank["g_loss"] == out["ranks"][0]["g_loss"]
