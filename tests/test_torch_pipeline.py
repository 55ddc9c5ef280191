"""Text2VideoPipeline.synthesize: the port against the JAX pipeline on the
golden-derived pose inputs, with the same converted weights."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from text2video_tpu import config as jconfig
from text2video_tpu_torch import config as tconfig
from text2video_tpu_torch import pipeline as tpipe
from text2video_tpu_torch.convert import params_from_flax
from text2video_tpu_torch.golden import golden_pose_inputs
from text2video_tpu_torch.render import Renderer

torch.set_num_threads(1)

T = 8  # frames in the utterance; also the render chunk


@pytest.fixture(scope="module")
def pose_inputs():
    return golden_pose_inputs(n_frames=T, seed=1)


def _patch_pose_stages(monkeypatch, pose_inputs):
    """Both constructors build PoseStage(profile), which would load the
    reference data set; serve the golden table and dictionary instead."""
    import text2video_tpu.pipeline as jpipe
    from text2video_tpu.pose_stage import PoseStage as JaxPoseStage

    _, pdict, table, _ = pose_inputs
    monkeypatch.setattr(jpipe, "PoseStage",
                        lambda profile: JaxPoseStage(profile, pdict, table))
    port_stage = tpipe.PoseStage
    monkeypatch.setattr(
        tpipe, "PoseStage",
        lambda profile, device="cpu": port_stage(profile, pdict, table, device))


def _renderers():
    import jax
    import jax.numpy as jnp

    from text2video_tpu.models.generator import CompositeGenerator
    from text2video_tpu.render import Renderer as JaxRenderer

    gen = CompositeGenerator(base_ch=8, n_blocks=1, dtype=jnp.float32)
    params = jax.jit(gen.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 384, 512, 9)),
                               jnp.zeros((1, 384, 512, 6)), jnp.ones((1,)))
    params = jax.tree_util.tree_map(np.array, params)
    params["params"]["heads"]["kernel"] *= 0.1  # see test_torch_generator
    jr = JaxRenderer(generator=gen, params=params,
                     config=jconfig.RenderConfig(), time_bucket=T)
    tr = Renderer.create(config=tconfig.RenderConfig(), base_ch=8, n_blocks=1,
                         dtype=torch.float32, device="cpu")
    tr.generator.load_state_dict(params_from_flax(params), strict=True)
    tr.time_bucket = T
    return jr, tr


def test_synthesize_matches_jax(monkeypatch, tmp_path, pose_inputs):
    from text2video_tpu.pipeline import Text2VideoPipeline as JaxPipeline

    _patch_pose_stages(monkeypatch, pose_inputs)
    profile, _, _, ts = pose_inputs
    jr, tr = _renderers()
    audio = np.zeros(int(16000 * T / profile.fps), np.float32)

    def cfg(sub, mod=tconfig):
        return mod.PipelineConfig(person=profile, out_dir=str(tmp_path / sub),
                                  stream=False)

    ref = JaxPipeline(cfg("jax", jconfig), renderer=jr).synthesize(
        ts, "utt", audio=audio, keep_arrays=True)
    out = tpipe.Text2VideoPipeline(cfg("torch"), renderer=tr).synthesize(
        ts, "utt", audio=audio, keep_arrays=True)

    assert out.num_frames == ref.num_frames == T
    assert out.label_maps.shape == (T, 384, 512, 3)
    np.testing.assert_array_equal(out.label_maps, ref.label_maps)
    assert out.frames.shape == ref.frames.shape == (T, 384, 512, 3)
    # Random weights make the warp recurrence chaotic: hold the first
    # frames only.
    diff = np.abs(out.frames[:3].astype(int) - ref.frames[:3].astype(int))
    assert diff.max() <= 2, diff.max()
    assert [os.path.basename(f) for f in out.files] == [
        os.path.basename(f) for f in ref.files]
    assert all(os.path.getsize(f) > 0 for f in out.files)
    assert set(out.stage_seconds) == {"pose_synthesis", "rasterize", "render",
                                      "mux"}

    # The streaming branch (the default DCT wire: coefficients into the
    # StreamingMuxer's native JPEG assembly) on the same inputs, with the
    # pose stage's fused device op.
    run = tpipe.Text2VideoPipeline(
        dataclasses.replace(cfg("stream"), stream=True, pose_device="device"),
        renderer=tr,
    ).synthesize(ts, "utt", audio=audio)
    assert run.num_frames == T and run.frames is None
    assert any(f.endswith(".mp4") for f in run.files)
    assert all(os.path.getsize(f) > 0 for f in run.files)
    assert "render_pull" in run.stage_seconds
    import cv2

    cap = cv2.VideoCapture(run.files[0])
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == T
    cap.release()


def test_skeleton_passthrough_matches_jax(monkeypatch, tmp_path, pose_inputs):
    from text2video_tpu.pipeline import Text2VideoPipeline as JaxPipeline

    _patch_pose_stages(monkeypatch, pose_inputs)
    profile, _, _, ts = pose_inputs

    def cfg(sub, mod=tconfig):
        return mod.PipelineConfig(person=profile, out_dir=str(tmp_path / sub),
                                  frame_chunk=T)

    ref = JaxPipeline(cfg("jax", jconfig)).synthesize(ts, "utt",
                                                      keep_arrays=True)
    out = tpipe.Text2VideoPipeline(cfg("torch"), device="cpu").synthesize(
        ts, "utt", keep_arrays=True)
    np.testing.assert_array_equal(out.label_maps, ref.label_maps)
    np.testing.assert_array_equal(out.frames, out.label_maps)
    assert all(os.path.getsize(f) > 0 for f in out.files)
