"""Rank workers of ``test_torch_mesh*.py`` and ``test_torch_nojax.py``.

Started by ``text2video_tpu_torch.parallel.spawn`` as ``fn(rank, world,
store, in_dir, out_dir)``: each joins a gloo group through the ``file://``
store, runs the port's mesh paths on the CPU at a tiny size, and writes what
it got to ``out_dir/<case>_rank<r>.npz`` (or ``.json``) for the test process
to hold against the JAX package and the port's single-process paths. Imports
only numpy, torch and the port, never JAX or the JAX package."""

import json
import os

import numpy as np
import torch

INIT_TIMEOUT_S = 60.0  # every init and collective of a test rank


def _mesh(rank: int, world: int, store: str, **grid):
    """This rank's mesh (``grid``: ``n_data``, ``n_model``)."""
    from text2video_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    return make_mesh(device="cpu", backend="gloo",
                     init_method="file://" + store, rank=rank,
                     world_size=world, timeout_s=INIT_TIMEOUT_S, **grid)


def _save(out_dir: str, case: str, rank: int, **arrays) -> None:
    np.savez(os.path.join(out_dir, f"{case}_rank{rank}.npz"), **arrays)


def _json(out_dir: str, case: str, rank: int, obj) -> None:
    with open(os.path.join(out_dir, f"{case}_rank{rank}.json"), "w") as f:
        json.dump(obj, f)


def smooth_inputs():
    """The smoothing cases' inputs, made from seeds as
    ``tests/test_smooth_sharded.py`` makes them."""
    rng = np.random.RandomState(0)
    rec = {T: (rng.rand(T, 210) * 500, rng.rand(T, 75) * 500)
           for T in (64, 1200)}
    rng = np.random.RandomState(3)
    tail = (rng.rand(37, 210) * 500, rng.rand(37, 75) * 500)
    rng = np.random.RandomState(0)
    fir = (rng.rand(64, 210) * 300, rng.rand(64, 75) * 300)
    rng = np.random.RandomState(3)
    fir_tail = (rng.randn(37, 210).astype(np.float32),
                rng.randn(37, 75).astype(np.float32))
    return rec, tail, fir, fir_tail


def raster_inputs(n_frames: int = 10, size=(128, 96)):
    """(face, pose, hand_l, hand_r, size) of golden fadg0 frames, smoothed
    on the host and scaled from the 512x384 canvas to ``size``."""
    from text2video_tpu_torch.golden import golden_pose_inputs
    from text2video_tpu_torch.ops.interp import (
        plan_pose_track,
        synthesize_host,
    )
    from text2video_tpu_torch.ops.smooth import smooth_host
    from text2video_tpu_torch.pipeline import _scale_tracks

    profile, pdict, table, ts = golden_pose_inputs(n_frames=n_frames)
    plan = plan_pose_track(ts, pdict, table, profile)
    face, pose = smooth_host(*synthesize_host(plan, table),
                             profile.smooth_width)
    hands = table.hands[plan.carrier]
    sx, sy = size[0] / profile.canvas[0], size[1] / profile.canvas[1]
    return (_scale_tracks(face, sx, sy), _scale_tracks(pose, sx, sy),
            _scale_tracks(hands[:, 0], sx, sy),
            _scale_tracks(hands[:, 1], sx, sy), size)


def host_ops(rank, world, store, in_dir, out_dir):
    """make_mesh, the collectives, the sharded smoothers, the sharded
    rasterizer and ``Text2VideoPipeline(mesh=)`` on the skeleton path."""
    del in_dir
    from text2video_tpu_torch import parallel
    from text2video_tpu_torch.ops import smooth
    from text2video_tpu_torch.ops.rasterize import rasterize_batch_sharded

    mesh = _mesh(rank, world, store)
    _json(out_dir, "mesh", rank, dict(
        shape=mesh.shape, rank=mesh.rank, backend=mesh.backend,
        device=str(mesh.device), is_main=mesh.is_main))

    # The collectives, on 10 rows (padded to a multiple of the world).
    x = torch.arange(30, dtype=torch.float64).reshape(10, 3)
    blk = parallel.shard_rows(x, mesh)
    prev, nxt = parallel.halo_rows(blk, mesh, 2, 1)
    wide, _ = parallel.halo_rows(blk, mesh, 5, 0)  # spans two ranks
    rep = parallel.replicate(torch.full((3,), float(rank + 7)), mesh)
    mean = parallel.mean_ordered(
        [torch.full((2,), float(rank)), torch.full((1, 3), 2.0 * rank)], mesh)
    bf16 = parallel.gather_rows(
        torch.full((1, 2), rank + 0.5, dtype=torch.bfloat16), mesh)
    parallel.barrier(mesh)
    _save(out_dir, "collectives", rank, block=blk.numpy(),
          gathered=parallel.gather_rows(blk, mesh, 10).numpy(),
          prev=prev.numpy(), next=nxt.numpy(), wide=wide.numpy(),
          replicated=rep.numpy(), mean0=mean[0].numpy(),
          mean1=mean[1].numpy(), bf16=bf16.float().numpy())

    rec, tail, fir, fir_tail = smooth_inputs()
    out = {}
    for T, (face, pose) in rec.items():
        out[f"rec{T}_f"], out[f"rec{T}_p"] = smooth.smooth_recursive_sharded(
            face, pose, mesh)
    pad = ((0, 3), (0, 0))
    out["tail_f"], out["tail_p"] = smooth.smooth_recursive_sharded(
        np.pad(tail[0], pad), np.pad(tail[1], pad), mesh, 4, t_valid=37)
    out["fir_f"], out["fir_p"] = smooth.smooth_fir_sharded(
        fir[0].astype(np.float32), fir[1].astype(np.float32), mesh)
    out["fir_const_f"], out["fir_const_p"] = smooth.smooth_fir_sharded(
        np.full((32, 210), 7.0, np.float32), np.full((32, 75), 3.0,
                                                      np.float32), mesh)
    out["fir_tail_f"], out["fir_tail_p"] = smooth.smooth_fir_sharded(
        np.pad(fir_tail[0], pad), np.pad(fir_tail[1], pad), mesh, 4,
        t_valid=37)
    try:
        smooth.smooth_recursive_sharded(tail[0], tail[1], mesh)
        out["indivisible_raises"] = False
    except ValueError:
        out["indivisible_raises"] = True
    _save(out_dir, "smooth", rank, **out)

    _save(out_dir, "raster", rank,
          labels=rasterize_batch_sharded(*raster_inputs(), mesh))

    run, res, pipe = skeleton_run(mesh, out_dir, "utt")
    _save(out_dir, "pipeline", rank, labels=run.label_maps,
          face_smooth=res.face_smooth, pose_smooth=res.pose_smooth)
    _json(out_dir, "pipeline", rank, dict(
        files=[os.path.basename(f) for f in run.files],
        frames=int(run.num_frames), device=str(pipe.device)))


def skeleton_run(mesh, out_dir: str, name: str):
    """One 9-frame golden utterance through ``Text2VideoPipeline(mesh=)`` on
    the skeleton path (sharded smoothing and rasterization), its files
    written under ``out_dir`` by global rank 0: (the run, the pose stage's
    result over the mesh, the pipeline)."""
    from text2video_tpu_torch import pipeline
    from text2video_tpu_torch.config import PipelineConfig
    from text2video_tpu_torch.golden import golden_pose_inputs

    profile, pdict, table, ts = golden_pose_inputs(n_frames=9)
    port_stage = pipeline.PoseStage
    pipeline.PoseStage = (
        lambda p, device="cpu": port_stage(p, pdict, table, device))
    try:
        pipe = pipeline.Text2VideoPipeline(
            PipelineConfig(person=profile, out_dir=out_dir), mesh=mesh)
        run = pipe.synthesize(ts, name, keep_arrays=True)
        res = pipe.pose_stage.run(ts, mesh=mesh)
    finally:
        pipeline.PoseStage = port_stage
    return run, res, pipe


def tiny_renderer(in_dir: str, config=None):
    """The test's tiny f32 renderer (``config``: a ``RenderConfig``, the
    default without): the weights the test process saved to
    ``in_dir/generator.pt``, time bucket 4."""
    from text2video_tpu_torch.render import Renderer

    r = Renderer.create(config=config, base_ch=8, n_blocks=1,
                        dtype=torch.float32, device="cpu")
    r.generator.load_state_dict(
        torch.load(os.path.join(in_dir, "generator.pt"), weights_only=True),
        strict=True)
    r.time_bucket = 4
    return r


def render_inputs():
    """(four 6-frame clips, an 8-frame utterance) of uint8 32x32 labels."""
    rng = np.random.RandomState(3)
    clips = rng.randint(0, 256, size=(4, 6, 32, 32, 3), dtype=np.uint8)
    utt = np.random.RandomState(5).randint(0, 256, (8, 32, 32, 3), np.uint8)
    return clips, utt


def audio_batch(in_dir: str, out_dir: str, items=None, mesh=None):
    """``Text2VideoPipeline.run_audio_batch`` of ``items`` (default: every
    pair of ``in_dir/batch.json``, whose data directory, aligner model and
    dictionary it also names) on the tiny renderer at 64 rows and 6 frames,
    writing under ``out_dir``; ``mesh=None`` is the process without a
    mesh."""
    from text2video_tpu_torch import config as tconfig
    from text2video_tpu_torch.frontend.align_english import EnglishAligner
    from text2video_tpu_torch.pipeline import Text2VideoPipeline

    with open(os.path.join(in_dir, "batch.json")) as f:
        spec = json.load(f)
    renderer = tiny_renderer(in_dir, tconfig.RenderConfig(load_size=64,
                                                          max_frames=6))
    pipe = Text2VideoPipeline(
        tconfig.PipelineConfig(
            person=tconfig.get_profile("fadg0", spec["data_dir"]),
            out_dir=out_dir, frame_chunk=8),
        renderer=renderer,
        aligner=EnglishAligner.load(spec["model"], spec["dict"]), mesh=mesh)
    items = [tuple(i) for i in spec["items"]] if items is None else items
    return pipe.run_audio_batch(items, keep_arrays=True)


def render_ops(rank, world, store, in_dir, out_dir):
    """``render_many(mesh=)`` (one row and two rows a rank, and a batch that
    does not divide), Jacobi with the timeline sharded (8 and 7 frames, f32
    and uint8) and ``run_audio_batch(mesh=)`` (one utterance a rank, the
    files written by rank 0 alone)."""
    mesh = _mesh(rank, world, store)
    r = tiny_renderer(in_dir)
    clips, utt = render_inputs()
    out = dict(
        many1=r.render_many(clips[:world], mesh=mesh),
        many2=r.render_many(clips[:2 * world], mesh=mesh),
        many_device=r.render_many_device(torch.from_numpy(clips[:world]),
                                         mesh=mesh),
        jac8=r.render_jacobi_sharded(utt, mesh, sweeps=2),
        jac7=r.render_jacobi_sharded(utt[:7], mesh, sweeps=3),
        jac8_f32=r.jacobi_sharded(
            torch.from_numpy(utt).float() / 127.5 - 1.0, 1, mesh).numpy(),
    )
    try:
        r.render_many(clips[:world + 1], mesh=mesh)
        out["indivisible_raises"] = False
    except ValueError:
        out["indivisible_raises"] = True
    _save(out_dir, "render", rank, **out)

    runs = audio_batch(in_dir, os.path.join(out_dir, "batch"), mesh=mesh)
    _save(out_dir, "audio_batch", rank,
          **{f"frames{i}": run.frames for i, run in enumerate(runs)},
          **{f"labels{i}": run.label_maps for i, run in enumerate(runs)})
    _json(out_dir, "audio_batch", rank, [dict(
        name=run.name, frames=int(run.num_frames),
        files=[os.path.basename(f) for f in run.files]) for run in runs])


def train_ops(rank, world, store, in_dir, out_dir):
    """One data-parallel train step from the converted JAX state that the
    test process saved in ``in_dir/init``, on this rank's rows of
    ``in_dir/batch.npz``; then ``train-gan`` through the CLI twice (a group
    is up, so the CLI trains over it) on the training set in ``in_dir``."""
    from text2video_tpu_torch import checkpoints, cli
    from text2video_tpu_torch.train import trainer

    mesh = _mesh(rank, world, store)
    with open(os.path.join(in_dir, "cfg.json")) as f:
        cfg = trainer.TrainConfig(**json.load(f), dtype=torch.float32)
    state = checkpoints.restore_state(
        os.path.join(in_dir, "init"),
        trainer.create_trainer_state(cfg, seed=1, device="cpu"))
    batch = dict(np.load(os.path.join(in_dir, "batch.npz")))
    per = batch["labels"].shape[0] // world
    mine = {k: torch.from_numpy(v[rank * per: (rank + 1) * per])
            for k, v in batch.items()}
    state, metrics = trainer.make_train_step(cfg, mesh=mesh)(state, mine)
    _save(out_dir, "step", rank,
          **{"metric." + k: float(v) for k, v in metrics.items()},
          **{"G.grad." + k: p.grad.numpy()
             for k, p in state.generator.named_parameters()},
          **{"D.grad." + k: p.grad.numpy()
             for k, p in state.discriminators.named_parameters()},
          **{"G." + k: p.detach().numpy()
             for k, p in state.generator.named_parameters()},
          **{"D." + k: p.detach().numpy()
             for k, p in state.discriminators.named_parameters()})

    with open(os.path.join(in_dir, "train_argv.json")) as f:
        argv = json.load(f)
    for run in ("dp_a", "dp_b"):
        assert cli.main(argv + ["--ckpt", os.path.join(out_dir, run)]) == 0


def model_ops(rank, world, store, in_dir, out_dir):
    """The mesh's model axis in four ranks: two steps at (2, 2) and two at
    (1, 2) from the converted JAX state in ``in_dir/init`` on
    ``in_dir/batch.npz`` (each saved whole after every step), then
    ``train-gan --n-model 2`` through the CLI from scratch and resumed from
    the one-process directory ``out_dir/resume``."""
    import sys

    from text2video_tpu_torch import checkpoints, cli
    from text2video_tpu_torch.parallel import make_mesh, model_axis
    from text2video_tpu_torch.parallel import mesh as meshes
    from text2video_tpu_torch.train import trainer

    mesh = _mesh(rank, world, store, n_data=2, n_model=2)
    _json(out_dir, "grid", rank, dict(
        shape=mesh.shape, rank=mesh.rank, model_rank=mesh.model_rank,
        is_main=mesh.is_main, backend=mesh.backend))
    serve_grid(rank, mesh, in_dir, out_dir)
    with open(os.path.join(in_dir, "cfg.json")) as f:
        cfg = trainer.TrainConfig(**json.load(f), dtype=torch.float32)
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(os.path.join(in_dir, "batch.npz")).items()}

    def steps(m, rows, name):
        """Two steps on ``m`` from the init state, on ``rows`` of the
        batch; the whole state saved after each."""
        state = checkpoints.restore_state(
            os.path.join(in_dir, "init"),
            trainer.create_trainer_state(cfg, seed=1, device="cpu"))
        wide = (meshes.shard_params(state.generator, m, state.g_opt)
                + meshes.shard_params(state.discriminators, m, state.d_opt))
        shards = {k: v.numpy().copy() for k, v in
                  state.generator.state_dict().items() if k in wide}
        step = trainer.make_train_step(cfg, mesh=m)
        metrics, gathers = [], []
        for _ in range(2):
            before = model_axis.gathers
            state, met = step(state, {k: v[rows] for k, v in batch.items()})
            gathers.append(model_axis.gathers - before)
            metrics.append({k: float(v) for k, v in met.items()})
            if m.rank == 0:
                checkpoints.save_state(os.path.join(out_dir, name), state,
                                       cfg, mesh=m)
        _json(out_dir, name, rank, dict(sharded=wide, metrics=metrics,
                                        gathers=gathers))
        _save(out_dir, name + "_shards", rank, **shards)

    per = batch["labels"].shape[0] // mesh.n_data
    steps(mesh, slice(mesh.rank * per, (mesh.rank + 1) * per), "m22")
    # Every rank takes part in making a mesh; ranks 2 and 3 are outside.
    mesh12 = make_mesh(n_data=1, n_model=2, device="cpu")
    if mesh12 is not None:
        steps(mesh12, slice(None), "m12")

    with open(os.path.join(in_dir, "train_argv.json")) as f:
        argv = json.load(f)
    assert cli.main(argv + ["--steps", "2", "--ckpt",
                            os.path.join(out_dir, "cli")]) == 0
    assert cli.main(argv + ["--steps", "1", "--ckpt",
                            os.path.join(out_dir, "resume")]) == 0
    _json(out_dir, "loaded", rank, sorted(
        k for k, v in sys.modules.items()
        if v is not None and k.split(".")[0] in BLOCKED))


def serve_grid(rank, mesh, in_dir, out_dir):
    """The serving paths on the (2, 2) grid, sharded over "data" and
    replicated over "model": Jacobi with the timeline sharded, ``render_many``
    (one and two rows a data index) on the tiny renderer of
    ``in_dir/generator.pt``, and ``Text2VideoPipeline(mesh=)`` on the
    skeleton path, its mp4 under ``out_dir/serve``."""
    r = tiny_renderer(in_dir)
    clips, utt = render_inputs()
    n = mesh.n_data
    run, _, _ = skeleton_run(mesh, os.path.join(out_dir, "serve"), "grid")
    _save(out_dir, "serve", rank,
          jac8=r.render_jacobi_sharded(utt, mesh, sweeps=2),
          jac7=r.render_jacobi_sharded(utt[:7], mesh, sweeps=3),
          many1=r.render_many(clips[:n], mesh=mesh),
          many2=r.render_many(clips[:2 * n], mesh=mesh),
          labels=run.label_maps)
    _json(out_dir, "serve", rank, dict(
        files=[os.path.basename(f) for f in run.files],
        frames=int(run.num_frames)))


BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "text2video_tpu")


def nojax_ops(rank, world, store, in_dir, out_dir):
    """The mesh paths of the renderer, the smoother and the rasterizer in a
    rank where JAX and the JAX package cannot be imported; writes the names
    of those modules that got loaded (none) and a checksum of the frames."""
    del in_dir
    import sys

    from text2video_tpu_torch.ops.rasterize import rasterize_batch_sharded
    from text2video_tpu_torch.ops.smooth import smooth_recursive_sharded
    from text2video_tpu_torch.render import Renderer

    mesh = _mesh(rank, world, store)
    r = Renderer.create(base_ch=4, n_blocks=1, dtype=torch.float32,
                        device="cpu")
    r.time_bucket = 2
    clips, utt = render_inputs()
    frames = r.render_jacobi_sharded(utt[:4], mesh, sweeps=2)
    many = r.render_many(clips[:world, :3], mesh=mesh)
    face, pose = smooth_inputs()[0][64]
    smoothed, _ = smooth_recursive_sharded(face, pose, mesh)
    labels = rasterize_batch_sharded(*raster_inputs(4), mesh)
    loaded = sorted(k for k, v in sys.modules.items()
                    if v is not None and k.split(".")[0] in BLOCKED)
    _json(out_dir, "nojax", rank, dict(
        loaded=loaded, blocked=[sys.modules.get(k, 1) is None
                                for k in BLOCKED],
        sums=[int(frames.sum()), int(many.sum()), float(smoothed.sum()),
              int(labels.sum())]))
