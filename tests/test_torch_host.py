"""The port's own host modules against their JAX-package originals on the
same inputs (golden fadg0 frames, seeded timestamps and frames): the pose
planner, blend and smoother, timestamps, config, keypoint table and
dictionary loading, and the muxers' bytes. Also: the entry points run on
the card unless asked, and the compute-dtype weight copies follow
``load_state_dict``."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from text2video_tpu import config as jconfig
from text2video_tpu_torch import config as tconfig
from text2video_tpu_torch.golden import GOLDEN_POSE_DIR, golden_pose_inputs

torch.set_num_threads(1)


def _jax_pose_inputs(pdict, table, ts):
    """The same dictionary, table and timestamps as JAX-package objects."""
    from text2video_tpu.frontend.timestamps import Timestamps
    from text2video_tpu.io.dicts import KeypointTable, PoseDictionary

    return (PoseDictionary(entries=dict(pdict.entries), layout=pdict.layout),
            KeypointTable(table.face, table.pose, table.hands,
                          table.has_hands, table.raws, table._index),
            Timestamps(entries=ts.entries))


@pytest.mark.parametrize("n_frames,seed", [(64, 0), (200, 3), (256, 1)])
def test_plan_blend_and_smooth_bit_equal(n_frames, seed):
    from text2video_tpu.ops import interp as jinterp
    from text2video_tpu.ops import smooth as jsmooth

    from text2video_tpu_torch.ops import interp, smooth

    profile, pdict, table, ts = golden_pose_inputs(n_frames, seed)
    jdict, jtable, jts = _jax_pose_inputs(pdict, table, ts)
    jprofile = jconfig.get_profile("fadg0")
    plan = interp.plan_pose_track(ts, pdict, table, profile)
    ref = jinterp.plan_pose_track(jts, jdict, jtable, jprofile)
    for f in ("i1", "i2", "w2", "carrier", "verbatim"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(ref, f))
    face, pose = interp.synthesize_host(plan, table)
    rface, rpose = jinterp.synthesize_host(ref, jtable)
    np.testing.assert_array_equal(face, rface)
    np.testing.assert_array_equal(pose, rpose)
    for a, r in zip(smooth.smooth_host(face, pose, profile.smooth_width),
                    jsmooth.smooth_host(rface, rpose, jprofile.smooth_width)):
        np.testing.assert_array_equal(a, r)


@pytest.mark.parametrize("text", [
    "0 sil\n3 AA\n\n7 B\n12 sil\n",
    "5 ni3\n9 hao3\n",
    "1 AA extra\n",
    "\n\n",
])
def test_timestamps_parse_like_jax(text):
    from text2video_tpu.frontend import timestamps as jts

    from text2video_tpu_torch.frontend import timestamps as tts

    lines = text.splitlines(keepends=True)
    try:
        ref = jts.parse_timestamp_lines(lines)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:12]):
            tts.parse_timestamp_lines(lines)
        return
    out = tts.parse_timestamp_lines(lines)
    assert out.entries == ref.entries
    assert (out.first_frame, out.last_frame) == (ref.first_frame,
                                                 ref.last_frame)
    assert tts.format_timestamp_lines(out) == jts.format_timestamp_lines(ref)


@pytest.mark.parametrize("cls", ["PersonProfile", "RenderConfig",
                                 "PipelineConfig"])
def test_config_fields_and_defaults_match(cls):
    ours = dataclasses.fields(getattr(tconfig, cls))
    theirs = dataclasses.fields(getattr(jconfig, cls))
    assert [(f.name, f.type, f.default) for f in ours] == [
        (f.name, f.type, f.default) for f in theirs]
    if cls == "RenderConfig":
        assert dataclasses.asdict(tconfig.RenderConfig()) == \
            dataclasses.asdict(jconfig.RenderConfig())


@pytest.mark.parametrize("name", ["fadg0", "henan", "xuesong"])
def test_profiles_match(name):
    assert dataclasses.asdict(tconfig.get_profile(name, "/data")) == \
        dataclasses.asdict(jconfig.get_profile(name, "/data"))
    with pytest.raises(KeyError):
        tconfig.get_profile("nobody")


@pytest.mark.parametrize("layout", ["clip", "flat"])
def test_keypoint_table_and_dictionary_load_like_jax(tmp_path, layout):
    from text2video_tpu.io import dicts as jdicts

    from text2video_tpu_torch.io import dicts as tdicts

    kp = tmp_path / "keypoints"
    kp.mkdir()
    for i, src in enumerate(sorted(GOLDEN_POSE_DIR.glob("*.json"))[:12]):
        name = (f"sa{1 + i // 6}_{i % 6:03d}_keypoints.json"
                if layout == "clip" else f"{3 * i:05d}_keypoints.json")
        shutil.copy(src, kp / name)
    dict_path = tmp_path / "dict.txt"
    dict_path.write_text(
        "AA sa1 002\nB sa2 004\n\n" if layout == "clip" else "ba 3\nma 30\n")
    table = tdicts.KeypointTable.load_dir(str(kp), layout)
    ref = jdicts.KeypointTable.load_dir(str(kp), layout)
    for f in ("face", "pose", "hands", "has_hands"):
        np.testing.assert_array_equal(getattr(table, f), getattr(ref, f))
    assert table.raws == ref.raws and table._index == ref._index
    for key in list(ref._index)[:3] + [("sa1", 99), ("", 5)]:
        try:
            want = ref.row_nearest(key)
        except KeyError:
            with pytest.raises(KeyError):
                table.row_nearest(key)
            continue
        assert table.row_nearest(key) == want
    pd = tdicts.PoseDictionary.load(str(dict_path), layout)
    ref_pd = jdicts.PoseDictionary.load(str(dict_path), layout)
    assert (pd.entries, pd.layout) == (ref_pd.entries, ref_pd.layout)


def _frames(t=5, h=48, w=64):
    return np.random.RandomState(t).randint(0, 256, (t, h, w, 3), np.uint8)


@pytest.mark.parametrize("with_audio", [False, True])
def test_mux_writes_the_same_bytes(tmp_path, with_audio):
    from text2video_tpu.io import video as jvideo

    from text2video_tpu_torch.io import video as tvideo

    frames = _frames()
    audio = (np.sin(np.arange(3200) / 7.0) * 0.3).astype(np.float32) \
        if with_audio else None
    ours = tvideo.mux(frames, audio, str(tmp_path / "ours"), fps=25.0)
    theirs = jvideo.mux(frames, audio, str(tmp_path / "theirs"), fps=25.0)
    assert [os.path.basename(f).replace("ours", "x") for f in ours] == [
        os.path.basename(f).replace("theirs", "x") for f in theirs]
    for a, b in zip(ours, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)


def test_streaming_muxer_writes_the_same_bytes(tmp_path):
    from text2video_tpu.io import video as jvideo

    from text2video_tpu_torch.io import video as tvideo

    rng = np.random.RandomState(7)
    chunks = [(rng.randint(0, 256, (n, 48, 64), np.uint8),
               rng.randint(0, 256, (n, 24, 32), np.uint8),
               rng.randint(0, 256, (n, 24, 32), np.uint8)) for n in (4, 3)]
    audio = (np.cos(np.arange(4480) / 5.0) * 0.2).astype(np.float32)
    outs = []
    for mod, sub in ((tvideo, "ours"), (jvideo, "theirs")):
        m = mod.StreamingMuxer(str(tmp_path / sub), 64, 48, fps=25.0,
                               audio=audio)
        for y, u, v in chunks:
            m.add_yuv(y, u, v)
        outs.append(m.close())
        assert m.n_frames == 7
    for a, b in zip(*outs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)


def test_stage_timer_and_logger(capsys):
    from text2video_tpu_torch.utils.logging import JsonLogger
    from text2video_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    for name in ("a", "b", "a"):
        with timer.stage(name):
            pass
    assert set(timer.totals()) == {"a", "b"} and len(timer.records) == 3
    assert "stage timings" in timer.report()
    JsonLogger().log("evt", n=1)
    rec = json.loads(capsys.readouterr().err)
    assert rec["event"] == "evt" and rec["n"] == 1


# ---- entry points run on the card unless asked -----------------------------

def _entry_points(ckpt):
    from text2video_tpu_torch import cli, pipeline
    from text2video_tpu_torch.checkpoints import load_renderer
    from text2video_tpu_torch.frontend.align_english import (
        EnglishAligner,
        PronouncingDict,
    )
    from text2video_tpu_torch.ops.fused_pose import synthesize_and_smooth
    from text2video_tpu_torch.ops.interp import plan_pose_track
    from text2video_tpu_torch.ops.rasterize import rasterize_batch
    from text2video_tpu_torch.pose_stage import PoseStage
    from text2video_tpu_torch.render import Renderer

    profile, pdict, table, ts = golden_pose_inputs(8)
    plan = plan_pose_track(ts, pdict, table, profile)
    z = np.zeros((2, 210)), np.zeros((2, 75)), np.zeros((2, 63))
    return {
        "Renderer.create": lambda: Renderer.create(base_ch=8, n_blocks=1),
        "PoseStage": lambda: PoseStage(profile, pdict, table),
        "synthesize_and_smooth": lambda: synthesize_and_smooth(plan, table),
        "rasterize_batch": lambda: rasterize_batch(z[0], z[1], z[2], z[2],
                                                   (64, 48), chunk=2),
        "Text2VideoPipeline": lambda: pipeline.Text2VideoPipeline(
            tconfig.PipelineConfig(person=profile)),
        "Text2VideoPipeline with an aligner": lambda: (
            pipeline.Text2VideoPipeline(
                tconfig.PipelineConfig(person=profile),
                aligner=EnglishAligner(None, PronouncingDict({})))),
        "load_renderer": lambda: load_renderer(ckpt, profile),
        "cli": lambda: cli.main(["tts-chinese", "你好", "henan"]),
        "create_trainer_state": lambda: _tiny_trainer_state(None),
        "train_gan": lambda: _tiny_train_gan(ckpt),
        "cli train-gan": lambda: cli.main(
            ["train-gan", *_training_dirs(ckpt), "--ckpt", ckpt, "--width",
             "32", "--height", "32", "--source-width", "512",
             "--source-height", "384", "--clip-len", "4", "--steps", "1"]),
        "trainer_state_from_flax": lambda: _converted_trainer_state(),
    }


TRAIN_KW = dict(height=32, width=32, face_crop=8, base_ch=8, n_blocks=1,
                d_base_ch=8)


def _tiny_trainer_state(device):
    from text2video_tpu_torch.train.trainer import (
        TrainConfig,
        create_trainer_state,
    )

    return create_trainer_state(TrainConfig(**TRAIN_KW), device=device)


def _training_dirs(root):
    from text2video_tpu_torch.golden import write_training_assets

    images, keypoints = write_training_assets(root + "/train", n_frames=8,
                                              canvas=(32, 32))
    return ["--images", images, "--keypoints", keypoints]


def _tiny_train_gan(root):
    from text2video_tpu_torch.train.data import PoseClipDataset
    from text2video_tpu_torch.train.loop import train_gan
    from text2video_tpu_torch.train.trainer import TrainConfig

    _, images, _, keypoints = _training_dirs(root)
    # The dataset is asked for the CPU, so the raise is train_gan's own.
    dataset = PoseClipDataset(images, keypoints, canvas=(32, 32),
                              source_canvas=(512, 384), clip_len=4,
                              device="cpu")
    return train_gan(dataset, TrainConfig(**TRAIN_KW), steps=1)


def _converted_trainer_state():
    """``convert.trainer_state_from_flax`` builds its state through
    ``create_trainer_state``: the same default."""
    from text2video_tpu_torch.convert import trainer_state_from_flax
    from text2video_tpu_torch.train.trainer import TrainConfig

    return trainer_state_from_flax(None, TrainConfig(**TRAIN_KW))


def _saved_checkpoint(tmp_path):
    from text2video_tpu_torch.checkpoints import save_renderer
    from text2video_tpu_torch.render import Renderer

    save_renderer(Renderer.create(base_ch=8, n_blocks=1, device="cpu"),
                  str(tmp_path), height=64)
    return str(tmp_path)


@pytest.mark.parametrize("name", ["Renderer.create", "PoseStage",
                                  "synthesize_and_smooth", "rasterize_batch",
                                  "Text2VideoPipeline",
                                  "Text2VideoPipeline with an aligner",
                                  "load_renderer", "cli",
                                  "create_trainer_state", "train_gan",
                                  "cli train-gan",
                                  "trainer_state_from_flax"])
def test_entry_point_defaults_to_the_card(monkeypatch, tmp_path, name):
    """Called without ``device`` (the CLI without ``--device``) where there
    is no card, each entry point raises instead of running on the CPU."""
    entry = _entry_points(_saved_checkpoint(tmp_path))[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


# ---- compute-dtype weights are made once and follow load_state_dict -------

def _conv_block(seed):
    from text2video_tpu_torch.models.layers import ConvBlock

    block = ConvBlock(64, 64, dtype=torch.bfloat16, fused=True)
    block.conv.reset_parameters(torch.Generator().manual_seed(seed))
    return block


def test_fused_weights_cached_and_follow_load_state_dict():
    block = _conv_block(0)
    k1 = block.conv.hwio_kernel()
    assert k1.dtype == torch.bfloat16 and block.conv.hwio_kernel() is k1
    x = torch.from_numpy(
        np.random.RandomState(0).randn(1, 6, 8, 64).astype(np.float32))
    with torch.no_grad():
        y1 = block(x)
    block.load_state_dict(_conv_block(1).state_dict())
    k2 = block.conv.hwio_kernel()
    assert k2 is not k1
    assert torch.equal(k2, block.conv.kernel.detach().bfloat16())
    with torch.no_grad():
        assert not torch.equal(block(x), y1)
        assert torch.equal(block(x), _conv_block(1)(x))


def test_plain_conv_weights_cached_and_follow_load_state_dict():
    from text2video_tpu_torch.models.layers import Conv

    conv = Conv(8, 16, kernel=7, stride=2, dtype=torch.bfloat16)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(
        np.random.RandomState(1).randn(1, 20, 24, 8).astype(np.float32))
    # The cached copy serves inference; under grad the live kernel is cast.
    with torch.no_grad():
        y1 = conv(x)
        w1 = conv._packed.value[0]
        conv(x)
    assert conv._packed.value[0] is w1  # no new cast on the second call
    other = Conv(8, 16, kernel=7, stride=2, dtype=torch.bfloat16)
    other.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        other.bias.fill_(0.5)
    conv.load_state_dict(other.state_dict())
    with torch.no_grad():
        y2 = conv(x)
        assert conv._packed.value[0] is not w1
        assert torch.equal(y2, other(x)) and not torch.equal(y2, y1)
    assert torch.equal(conv(x).detach(), y2)  # the live cast, same values
