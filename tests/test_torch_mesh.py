"""The port's mesh (``text2video_tpu_torch.parallel``) on the CPU: gloo ranks
spawned through a ``file://`` store, each running the port's sharded paths
(``tests/torch_mesh_workers.py``), held against the JAX package's functions
on the 8-device virtual CPU mesh of ``tests/conftest.py`` and against the
port's single-process paths.

Two spawns hold every case: four ranks for the collectives, the smoothers,
the rasterizer and the pipeline's skeleton path; two ranks for the renderer
(batch-sharded ``render_many``, time-sharded Jacobi). Each spawn has a
deadline (``SPAWN_TIMEOUT_S``), and every init and collective of a rank its
own timeout (``torch_mesh_workers.INIT_TIMEOUT_S``), so a lost rank fails its
test instead of hanging the run."""

import json
import os

import numpy as np
import pytest
import torch
import torch_mesh_workers as workers

from text2video_tpu_torch.parallel import spawn

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 240.0
HOST_WORLD, RENDER_WORLD = 4, 2


def _spawn(fn: str, world: int, root) -> str:
    """Run ``fn`` of the workers in ``world`` ranks, their inputs in
    ``root``; returns the directory of their outputs."""
    out = root / "out"
    out.mkdir()
    spawn(f"torch_mesh_workers:{fn}", world,
          (str(root / "store"), str(root), str(out)),
          timeout_s=SPAWN_TIMEOUT_S)
    return str(out)


def _ranks(out: str, case: str, world: int):
    return [dict(np.load(os.path.join(out, f"{case}_rank{r}.npz")))
            for r in range(world)]


def _jax_mesh():
    from text2video_tpu.parallel.mesh import make_mesh

    return make_mesh(n_data=8, n_model=1)


@pytest.fixture(scope="module")
def host_out(tmp_path_factory):
    return _spawn("host_ops", HOST_WORLD, tmp_path_factory.mktemp("host"))


# ---- make_mesh and the collectives ------------------------------------------


def test_make_mesh_shape_and_ranks(host_out):
    metas = [json.load(open(os.path.join(host_out, f"mesh_rank{r}.json")))
             for r in range(HOST_WORLD)]
    assert [m["rank"] for m in metas] == list(range(HOST_WORLD))
    for m in metas:
        assert m["shape"] == {"data": HOST_WORLD, "model": 1}
        assert (m["backend"], m["device"]) == ("gloo", "cpu")
        assert m["is_main"] == (m["rank"] == 0)


def test_make_mesh_model_axis_and_missing_group_raise(monkeypatch,
                                                      tmp_path):
    """A (data, model) grid larger than the process group raises
    ``ValueError`` (here a group of one process, left again after);
    without a process group and without an init method there is nothing to
    join."""
    import torch.distributed as dist

    from text2video_tpu_torch.parallel import make_mesh

    try:
        with pytest.raises(ValueError, match="1 x 2 needs"):
            make_mesh(n_data=1, n_model=2, device="cpu", backend="gloo",
                      init_method="file://" + str(tmp_path / "store"),
                      rank=0, world_size=1, timeout_s=60)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(device="cpu")


def test_collectives(host_out):
    """10 rows over 4 ranks: blocks of 3 (the tail padded with zeros),
    gathered back in order; a 2-before / 1-after halo and a 5-row halo that
    spans two ranks, zeros past the ends; rank 0's values broadcast; the
    ordered mean; bf16 carried bit for bit."""
    x = np.arange(30, dtype=np.float64).reshape(10, 3)
    xp = np.concatenate([np.zeros((5, 3)), x, np.zeros((5, 3))])
    for r, got in enumerate(_ranks(host_out, "collectives", HOST_WORLD)):
        lo = 5 + 3 * r
        np.testing.assert_array_equal(got["block"],
                                      np.pad(x, ((0, 2), (0, 0)))[3 * r:
                                                                  3 * r + 3])
        np.testing.assert_array_equal(got["gathered"], x)
        np.testing.assert_array_equal(got["prev"], xp[lo - 2: lo])
        np.testing.assert_array_equal(got["next"], xp[lo + 3: lo + 4])
        np.testing.assert_array_equal(got["wide"], xp[lo - 5: lo])
        np.testing.assert_array_equal(got["replicated"], [7.0] * 3)
        np.testing.assert_array_equal(got["mean0"], [1.5, 1.5])
        np.testing.assert_array_equal(got["mean1"], [[3.0] * 3])
        np.testing.assert_array_equal(
            got["bf16"], np.arange(HOST_WORLD)[:, None] + np.full((1, 2), .5))


# ---- smoothing ----------------------------------------------------------------


@pytest.mark.parametrize("T", [64, 1200])  # replay-exact and decay regimes
def test_smooth_recursive_sharded_byte_equal(host_out, T):
    """Every rank's result is byte-equal to ``smooth_host`` (the port's and
    the JAX package's) and to the JAX package's sharded smoother on 8
    devices. At T=1200 three of the four ranks start from the warm-up."""
    from text2video_tpu.ops.smooth import smooth_host as jax_host
    from text2video_tpu.ops.smooth import smooth_recursive_sharded

    from text2video_tpu_torch.ops.smooth import smooth_host

    face, pose = workers.smooth_inputs()[0][T]
    ref_f, ref_p = smooth_host(face, pose)
    jf, jp = jax_host(face, pose)
    np.testing.assert_array_equal(ref_f, jf)
    np.testing.assert_array_equal(ref_p, jp)
    sf, sp = smooth_recursive_sharded(face, pose, _jax_mesh())
    for got in _ranks(host_out, "smooth", HOST_WORLD):
        for out, ref, jax_out in ((got[f"rec{T}_f"], ref_f, sf),
                                  (got[f"rec{T}_p"], ref_p, sp)):
            assert out.dtype == np.float64
            np.testing.assert_array_equal(out, ref)
            np.testing.assert_array_equal(out, np.asarray(jax_out))


def test_smooth_recursive_sharded_padded_tail(host_out):
    """37 frames padded to 40: the valid prefix is byte-equal to the host
    smoother's; a length that does not divide raises."""
    from text2video_tpu_torch.ops.smooth import smooth_host

    face, pose = workers.smooth_inputs()[1]
    ref_f, ref_p = smooth_host(face, pose)
    for got in _ranks(host_out, "smooth", HOST_WORLD):
        np.testing.assert_array_equal(got["tail_f"][:37], ref_f)
        np.testing.assert_array_equal(got["tail_p"][:37], ref_p)
        assert bool(got["indivisible_raises"])


def test_smooth_fir_sharded_matches_host(host_out):
    """The FIR smoother with its halo exchange, against the host FIR loop
    (the port's copy equals the JAX package's) and the JAX package's sharded
    FIR, at JAX's bound (rtol 2e-4, atol 2e-3)."""
    from text2video_tpu.ops.smooth import smooth_fir_host as jax_fir
    from text2video_tpu.ops.smooth import smooth_fir_sharded

    from text2video_tpu_torch.ops.smooth import smooth_fir_host

    face, pose = workers.smooth_inputs()[2]
    ref_f, ref_p = smooth_fir_host(face, pose)
    jf, jp = jax_fir(face, pose)
    np.testing.assert_array_equal(ref_f, jf)
    np.testing.assert_array_equal(ref_p, jp)
    sf, sp = smooth_fir_sharded(face.astype(np.float32),
                                pose.astype(np.float32), _jax_mesh())
    for got in _ranks(host_out, "smooth", HOST_WORLD):
        for out, ref, jax_out in ((got["fir_f"], ref_f, sf),
                                  (got["fir_p"], ref_p, sp)):
            np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-3)
            np.testing.assert_allclose(out, np.asarray(jax_out), rtol=2e-4,
                                       atol=2e-3)


def test_smooth_fir_sharded_edges_and_tail(host_out):
    """Constant input stays constant at the mesh's edges (the halo past
    either end is masked), and padding past ``t_valid`` never bleeds into
    the last valid frames (JAX's bounds: 1e-4 and rtol/atol 1e-4)."""
    from text2video_tpu_torch.ops.smooth import smooth_fir_host

    face, pose = workers.smooth_inputs()[3]
    ref_f, ref_p = smooth_fir_host(face.astype(np.float64),
                                   pose.astype(np.float64))
    for got in _ranks(host_out, "smooth", HOST_WORLD):
        np.testing.assert_allclose(got["fir_const_f"], 7.0, atol=1e-4)
        np.testing.assert_allclose(got["fir_const_p"], 3.0, atol=1e-4)
        np.testing.assert_allclose(got["fir_tail_f"][:37], ref_f, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got["fir_tail_p"][:37], ref_p, rtol=1e-4,
                                   atol=1e-4)


# ---- rasterization and the pipeline -------------------------------------------


def test_rasterize_batch_sharded_pixel_equal(host_out):
    """10 golden frames over 4 ranks (padded to 12): pixel-equal to the
    port's ``rasterize_batch`` and to the JAX package's sharded rasterizer
    on 8 devices."""
    from text2video_tpu.ops.rasterize import (
        rasterize_batch_sharded as jax_sharded,
    )

    from text2video_tpu_torch.ops.rasterize import rasterize_batch

    inputs = workers.raster_inputs()
    ref = rasterize_batch(*inputs, chunk=4, device="cpu")
    jax_out = jax_sharded(*inputs, _jax_mesh())
    assert (ref > 0).mean() > 0.01
    for got in _ranks(host_out, "raster", HOST_WORLD):
        assert got["labels"].shape == ref.shape == (10, 96, 128, 3)
        np.testing.assert_array_equal(got["labels"], ref)
        np.testing.assert_array_equal(got["labels"], jax_out)


def test_pipeline_mesh_skeleton_path(host_out, tmp_path, monkeypatch):
    """``Text2VideoPipeline(mesh=)`` without a renderer: the pose stage's
    smoothed tracks are byte-equal to the host path's, the labels are
    pixel-equal to a single process's run, every rank gets them, and only
    rank 0 writes the mp4."""
    from text2video_tpu_torch import pipeline
    from text2video_tpu_torch.config import PipelineConfig
    from text2video_tpu_torch.golden import golden_pose_inputs

    profile, pdict, table, ts = golden_pose_inputs(n_frames=9)
    port_stage = pipeline.PoseStage
    monkeypatch.setattr(pipeline, "PoseStage", lambda p, device="cpu":
                        port_stage(p, pdict, table, device))
    pipe = pipeline.Text2VideoPipeline(
        PipelineConfig(person=profile, out_dir=str(tmp_path)), device="cpu")
    host = pipe.pose_stage.run(ts, device=False)
    ref = pipe.synthesize(ts, "utt", keep_arrays=True)
    for r, got in enumerate(_ranks(host_out, "pipeline", HOST_WORLD)):
        np.testing.assert_array_equal(got["face_smooth"], host.face_smooth)
        np.testing.assert_array_equal(got["pose_smooth"], host.pose_smooth)
        np.testing.assert_array_equal(got["labels"], ref.label_maps)
        meta = json.load(open(os.path.join(host_out,
                                           f"pipeline_rank{r}.json")))
        assert meta["frames"] == ref.num_frames == 9
        assert meta["files"] == (["utt.mp4"] if r == 0 else [])
    mp4 = os.path.join(host_out, "fadg0", "utt.mp4")
    assert os.listdir(os.path.dirname(mp4)) == ["utt.mp4"]
    assert os.path.getsize(mp4) > 0


# ---- the renderer ---------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_renderer():
    """The JAX package's tiny f32 renderer (as in test_torch_jacobi.py)."""
    import jax
    import jax.numpy as jnp

    from text2video_tpu import config as jconfig
    from text2video_tpu.models.generator import CompositeGenerator
    from text2video_tpu.render import Renderer as JaxRenderer

    gen = CompositeGenerator(base_ch=8, n_blocks=1, dtype=jnp.float32)
    params = jax.jit(gen.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 9)),
                               jnp.zeros((1, 32, 32, 6)), jnp.ones((1,)))
    params = jax.tree_util.tree_map(np.array, params)
    # A tenth of the lecun heads keeps flows at a few pixels.
    params["params"]["heads"]["kernel"] *= 0.1
    return JaxRenderer(generator=gen, params=params,
                       config=jconfig.RenderConfig(), time_bucket=4)


@pytest.fixture(scope="module")
def render_out(tmp_path_factory, jax_renderer):
    from text2video_tpu_torch.convert import params_from_flax

    root = tmp_path_factory.mktemp("render")
    torch.save(params_from_flax(jax_renderer.params),
               str(root / "generator.pt"))
    _batch_inputs(root)
    return _spawn("render_ops", RENDER_WORLD, root)


BATCH_TEXTS = ("Do they make it", "She had your dark suit")


def _batch_inputs(root) -> None:
    """``run_audio_batch``'s inputs for the ranks (``root/batch.json``): a
    golden data directory, two synthesized utterances of different lengths,
    the packaged fadg0 aligner; its native library built before the spawn."""
    from text2video_tpu_torch.config import PACKAGED_DATA_DIR
    from text2video_tpu_torch.frontend import native
    from text2video_tpu_torch.frontend.audio import save_wav
    from text2video_tpu_torch.frontend.tts import FormantTTS
    from text2video_tpu_torch.golden import write_golden_assets

    native.ensure_built()
    data = write_golden_assets(str(root / "golden"))
    items = []
    for i, text in enumerate(BATCH_TEXTS):
        wav = str(root / f"u{i}.wav")
        save_wav(wav, FormantTTS().synthesize(text, 16000), 16000)
        items.append((text, wav))
    with open(root / "batch.json", "w") as f:
        json.dump(dict(items=items, data_dir=data,
                       model=str(PACKAGED_DATA_DIR / "english_fadg0.am"),
                       dict=os.path.join(data, "aligner", "english", "dict")),
                  f)


@pytest.fixture(scope="module")
def port_renderer(render_out):
    return workers.tiny_renderer(os.path.dirname(render_out))


def test_render_many_mesh_matches_rows(render_out, port_renderer):
    """One utterance a rank (host and device labels): each row is exactly
    the single-process render of that utterance alone."""
    clips, _ = workers.render_inputs()
    singles = np.stack([port_renderer.render(clips[i])
                        for i in range(RENDER_WORLD)])
    for got in _ranks(render_out, "render", RENDER_WORLD):
        np.testing.assert_array_equal(got["many1"], singles)
        np.testing.assert_array_equal(got["many_device"], singles)


def test_render_many_mesh_two_rows(render_out, port_renderer):
    """Two utterances a rank: each rank's rows are exactly a single process's
    ``render_many`` of those two rows (rows depend on the batch size,
    ROADMAP C2, so batch 2 is held against batch 2); a batch that does not
    divide raises."""
    clips, _ = workers.render_inputs()
    ref = np.concatenate([port_renderer.render_many(clips[i: i + 2])
                          for i in range(0, 2 * RENDER_WORLD, 2)])
    for got in _ranks(render_out, "render", RENDER_WORLD):
        assert got["many2"].shape == (4, 6, 32, 32, 3)
        np.testing.assert_array_equal(got["many2"], ref)
        assert bool(got["indivisible_raises"])


def test_jacobi_sharded_bit_equal_single_process(render_out, port_renderer):
    """The timeline over two ranks with blocks on ``time_bucket`` boundaries
    (8 frames: blocks of 4; 7 frames: 4 and 3) makes exactly the single
    process's generator calls, so the frames are its bits: uint8 after 2 and
    3 sweeps, f32 after 1."""
    _, utt = workers.render_inputs()
    jac8 = port_renderer.render_jacobi(utt, sweeps=2)
    jac7 = port_renderer.render_jacobi(utt[:7], sweeps=3)
    f32 = port_renderer.jacobi_device(
        torch.from_numpy(utt).float() / 127.5 - 1.0, 1).numpy()
    for got in _ranks(render_out, "render", RENDER_WORLD):
        np.testing.assert_array_equal(got["jac8"], jac8)
        np.testing.assert_array_equal(got["jac7"], jac7)
        np.testing.assert_array_equal(got["jac8_f32"], f32)


def test_jacobi_sharded_matches_jax(render_out, jax_renderer):
    """Against the JAX package: one sweep's f32 frames within 2e-5 of its
    ``jacobi_device`` (f32 sums in another order, the bound of
    test_torch_jacobi.py), and the uint8 frames of 2 sweeps within one level
    of its ``render_jacobi_sharded`` on 8 devices (a value within 2e-5 of a
    level boundary may truncate to the neighbouring level)."""
    import jax.numpy as jnp

    _, utt = workers.render_inputs()
    ref32 = np.asarray(jax_renderer.jacobi_device(
        jnp.asarray(utt.astype(np.float32) / 127.5 - 1.0), 1))
    ref8 = jax_renderer.render_jacobi_sharded(utt, _jax_mesh(), sweeps=2)
    for got in _ranks(render_out, "render", RENDER_WORLD):
        np.testing.assert_allclose(got["jac8_f32"], ref32, atol=2e-5, rtol=0)
        assert got["jac8"].shape == ref8.shape == (8, 32, 32, 3)
        assert np.abs(got["jac8"].astype(int) - ref8.astype(int)).max() <= 1


def test_run_audio_batch_mesh_equals_no_mesh(render_out, tmp_path):
    """``run_audio_batch(mesh=)`` over two ranks, one utterance a rank,
    against the process without a mesh (the JAX counterpart is
    ``tests/test_pipeline_e2e.py::test_run_audio_batch_sharded``): labels
    equal to its batch's; frames bit-equal to its run of each utterance at
    the rank's batch size, 1 (a row depends on the batch size, ROADMAP C2);
    every rank gets both; rank 0 alone writes the files."""
    root = os.path.dirname(render_out)
    with open(os.path.join(root, "batch.json")) as f:
        items = [tuple(i) for i in json.load(f)["items"]]
    ref = workers.audio_batch(root, str(tmp_path / "batch"))
    singles = [workers.audio_batch(root, str(tmp_path / f"single{i}"),
                                   items=[item])[0]
               for i, item in enumerate(items)]
    assert ref[0].num_frames != ref[1].num_frames  # a ragged batch
    for r, got in enumerate(_ranks(render_out, "audio_batch", RENDER_WORLD)):
        for i, (want, single) in enumerate(zip(ref, singles)):
            np.testing.assert_array_equal(got[f"labels{i}"], want.label_maps)
            np.testing.assert_array_equal(got[f"frames{i}"], single.frames)
            assert got[f"frames{i}"].shape == (6, 64, 64, 3)
        with open(os.path.join(render_out,
                               f"audio_batch_rank{r}.json")) as f:
            meta = json.load(f)
        assert [m["name"] for m in meta] == [run.name for run in ref]
        assert [m["frames"] for m in meta] == [run.num_frames for run in ref]
        assert [m["files"] for m in meta] == (
            [[os.path.basename(p) for p in run.files] for run in ref]
            if r == 0 else [[], []])
    written = sorted(os.listdir(os.path.join(render_out, "batch", "fadg0")))
    assert written == sorted(os.path.basename(p) for run in ref
                             for p in run.files)
    assert sum(p.endswith(".mp4") for p in written) == 2
