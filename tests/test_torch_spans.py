"""The port's spans and counters where the work happens, on the CPU under
``torch.profiler``: ``Text2VideoPipeline.synthesize`` (the streaming dct
path of ``tests/test_torch_pipeline.py``'s tiny setup, the pose stage on
the device path) and a train step, each span under its parent in order and
carrying its request."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from text2video_tpu_torch import config as tconfig
from text2video_tpu_torch import pipeline as tpipe
from text2video_tpu_torch.golden import golden_pose_inputs
from text2video_tpu_torch.render import Renderer
from text2video_tpu_torch.train import trainer as tt
from text2video_tpu_torch.utils import profiling

torch.set_num_threads(1)

T = 8  # frames in the utterance
BUCKET = 4  # frames a render chunk: two chunks


def _traced(fn):
    """``fn()`` under a CPU profile: (its result, the records, counters)."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    recs, counts = profiling.records(), profiling.counters()
    profiling.reset()
    return out, recs, counts


def _children(recs, parent):
    return [r["name"] for r in sorted(recs, key=lambda r: r["start_ns"])
            if r["parent"] == parent["id"]]


@pytest.fixture(scope="module")
def synthesized(tmp_path_factory):
    """Two streamed ``synthesize`` calls of one utterance, each traced:
    (result, records, counters, bytes of the wire tensors it encoded)."""
    profile_, pdict, table, ts = golden_pose_inputs(n_frames=T, seed=1)
    port_stage = tpipe.PoseStage
    mp = pytest.MonkeyPatch()
    mp.setattr(tpipe, "PoseStage", lambda profile, device="cpu": port_stage(
        profile, pdict, table, device))
    renderer = Renderer.create(config=tconfig.RenderConfig(), base_ch=8,
                               n_blocks=1, dtype=torch.float32, device="cpu")
    renderer.time_bucket = BUCKET
    encode = renderer._encode_wire
    wires = []

    def kept(frames):
        wire = encode(frames)
        wires.append(wire.nbytes)
        return wire

    mp.setattr(renderer, "_encode_wire", kept)
    pipe = tpipe.Text2VideoPipeline(
        tconfig.PipelineConfig(person=profile_, pose_device="device",
                               out_dir=str(tmp_path_factory.mktemp("out")),
                               stream=True),
        renderer=renderer)
    audio = np.zeros(int(16000 * T / profile_.fps), np.float32)
    runs = []
    for _ in range(2):
        wires.clear()
        runs.append(_traced(lambda: pipe.synthesize(ts, "utt", audio=audio))
                    + (sum(wires),))
    mp.undo()
    return runs


def test_synthesize_spans_nest_under_the_request(synthesized):
    run, recs, _, _ = synthesized[1]
    root, = [r for r in recs if r["name"] == "synthesize"]
    main = [r for r in recs if r["thread"] == root["thread"]]
    assert root["parent"] is None and root["request"] == "utt"
    assert _children(recs, root) == ["pose_synthesis", "rasterize", "render",
                                     "mux"]
    render, = [r for r in recs if r["name"] == "render"]
    assert _children(recs, render) == [
        "render.chunk", "wire.encode", "render.chunk", "wire.encode",
        "render_pull", "render_pull"]
    assert [r["attrs"]["frames"] for r in recs
            if r["name"] == "render.chunk"] == [BUCKET, T - BUCKET]
    assert all(r["request"] == "utt" for r in recs)
    # Every main-thread span lies inside the root.
    assert all(root["start_ns"] <= r["start_ns"] <= r["end_ns"]
               <= root["end_ns"] for r in main)
    assert set(run.stage_seconds) == {"pose_synthesis", "rasterize", "render",
                                      "render_pull", "mux"}


def test_the_muxer_worker_records_its_chunks(synthesized):
    _, recs, _, _ = synthesized[1]
    root, = [r for r in recs if r["name"] == "synthesize"]
    work = [r for r in recs if r["name"] == "mux.encode"]
    assert [r["attrs"]["frames"] for r in work] == [BUCKET, T - BUCKET]
    assert all(r["parent"] is None and r["request"] == "utt"
               and r["thread"] != root["thread"] for r in work)


@pytest.mark.parametrize("call", [0, 1])
def test_wire_bytes_count_the_wire_tensors(synthesized, call):
    _, _, counts, wire_bytes = synthesized[call]
    assert wire_bytes > 0 and counts["wire_bytes"] == wire_bytes


def test_param_copies_are_built_once(synthesized):
    """The first call builds the generator's kernel copies; the second,
    with the same weights, builds none."""
    assert synthesized[0][2].get("param_copy_builds", 0) > 0
    assert synthesized[1][2].get("param_copy_builds", 0) == 0


CFG = tt.TrainConfig(height=32, width=32, face_crop=8, base_ch=8, n_blocks=1,
                     d_base_ch=8, dtype=torch.float32)


def _batch(b=2, t=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"labels": torch.rand((b, t, 32, 32, 3), generator=g) * 2 - 1,
            "reals": torch.rand((b, t, 32, 32, 3), generator=g) * 2 - 1,
            "face_centers": torch.full((b, t, 2), 16.0)}


@pytest.mark.parametrize("accum,lambda_adv", [(1, 1.0), (2, 1.0), (1, 0.0)])
def test_train_step_spans_in_order(accum, lambda_adv):
    cfg = dataclasses.replace(CFG, grad_accum=accum, lambda_adv=lambda_adv)
    state = tt.create_trainer_state(cfg, seed=0, device="cpu")
    step = tt.make_train_step(cfg)
    state, _ = step(state, _batch())
    (state, metrics), recs, _ = _traced(lambda: step(state, _batch(seed=1)))
    assert torch.isfinite(metrics["g_loss"])
    root, = [r for r in recs if r["name"] == "train.step"]
    assert root["parent"] is None and root["request"] == 1
    phases = ["train.g_forward", "train.g_backward"]
    if lambda_adv > 0:
        phases += ["train.d_forward", "train.d_backward"]
    assert _children(recs, root) == phases * accum + ["train.optimizer"]
    assert all(r["request"] == 1 for r in recs)
