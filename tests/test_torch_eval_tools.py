"""The port's evaluation and data tools on the CPU: ``tools/eval_gan.py``'s
metrics against the JAX package's tool, ``eval_gan`` and ``eval_gan_many``
on a tiny checkpoint written by the port's ``train-gan`` (weights swapped
under a live renderer), ``restore_generator_state``, and
``make_synthetic_frames`` against the JAX package's tool."""

import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from text2video_tpu_torch import checkpoints as ckpt
from text2video_tpu_torch import cli
from text2video_tpu_torch import config as tconfig
from text2video_tpu_torch.golden import GOLDEN_POSE_DIR, write_training_assets
from text2video_tpu_torch.tools import (
    eval_gan,
    eval_gan_many,
    make_synthetic_frames,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = ["--width", "128", "--height", "96", "--source-width", "512",
        "--source-height", "384"]
KEYS = {"psnr_db", "ssim", "mouth_psnr_db", "mouth_ssim", "mouth_crop_px",
        "split", "clips", "frames"}


def _jax_tool(name):
    """A script of the JAX package's ``tools/`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_" + name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return write_training_assets(str(tmp_path_factory.mktemp("eval")),
                                 n_frames=16, canvas=(128, 96))


@pytest.fixture(scope="module")
def checkpoints(assets, tmp_path_factory):
    """Two snapshots of one ``train-gan`` directory, at steps 1 and 2."""
    root = tmp_path_factory.mktemp("ckpts")
    d = str(root / "gan")
    argv = ["train-gan", "--images", assets[0], "--keypoints", assets[1],
            "--ckpt", d, *SIZE, "--clip-len", "4", "--batch-size", "1",
            "--base-ch", "8", "--steps", "1", "--lr", "0.01", "--device",
            "cpu"]
    out = []
    for name in ("step1", "step2"):
        assert cli.main(argv) == 0
        out.append(str(root / name))
        shutil.copytree(d, out[-1])
    return out


def test_windowed_ssim_psnr_and_mouth_side_match_the_jax_tool():
    """The same arrays through both tools' ``windowed_ssim``: within 1e-12
    (the same cv2 calls in the same order)."""
    ref = _jax_tool("eval_gan")
    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    noise = rng.randint(-20, 21, a.shape)
    b = np.clip(a.astype(int) + noise, 0, 255).astype(np.uint8)
    for x, y in ((a, b), (a, a), (a[:32, :32], b[:32, :32])):
        assert abs(eval_gan.windowed_ssim(x, y)
                   - ref.windowed_ssim(x, y)) <= 1e-12
    assert eval_gan.windowed_ssim(a, a) == pytest.approx(1.0, abs=1e-12)
    assert 0.0 < eval_gan.windowed_ssim(a, b) < 1.0
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    assert eval_gan.psnr(a, b) == pytest.approx(
        10 * np.log10(255.0**2 / mse), abs=1e-12)
    assert [eval_gan.mouth_side(h) for h in (96, 384, 512, 1080)] == [
        32, 96, 128, 270]
    img = np.arange(96 * 128 * 3, dtype=np.int64).reshape(96, 128, 3)
    # Inside the frame, and pushed back in at a corner.
    np.testing.assert_array_equal(
        eval_gan.mouth_crop(img, np.array([60.4, 50.6]), 32),
        img[51 - 16: 51 + 16, 60 - 16: 60 + 16])
    np.testing.assert_array_equal(
        eval_gan.mouth_crop(img, np.array([2.0, 200.0]), 32),
        img[96 - 32:, :32])


class _FakeRenderer:
    """Frames that depend on the labels only: both tools score the same."""

    time_bucket = 64

    def render(self, labels):
        import cv2

        return np.stack([cv2.GaussianBlur(x, (9, 9), 3.0) // 2 + 90
                         for x in labels])


def test_eval_gan_rows_equal_the_jax_tool_on_the_same_frames(
        assets, monkeypatch, capsys):
    """Both tools' ``main`` on the same files with the same stand-in
    renderer: the same JSON line, mouth crop, PSNR and SSIM included."""
    from text2video_tpu.train import checkpoints as jax_ckpt

    argv = ["--ckpt", "unused", "--images", assets[0], "--keypoints",
            assets[1], *SIZE, "--clips", "2", "--clip-len", "6"]
    monkeypatch.setattr(jax_ckpt, "load_renderer",
                        lambda *a, **k: _FakeRenderer())
    monkeypatch.setattr(sys, "argv", ["eval_gan.py", *argv])
    capsys.readouterr()
    _jax_tool("eval_gan").main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    monkeypatch.setattr(ckpt, "load_renderer",
                        lambda *a, **k: _FakeRenderer())
    assert eval_gan.main(argv + ["--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row == ref
    assert set(row) == KEYS and row["frames"] == 12
    assert row["mouth_crop_px"] == 32 and row["split"] == "holdout"
    assert 5 < row["psnr_db"] < 40 and 0 < row["mouth_ssim"] < 1


def test_restore_generator_state_reads_both_kinds(checkpoints, tmp_path):
    a, b = checkpoints
    state = ckpt.restore_generator_state(b)
    newest = torch.load(os.path.join(b, "step_00000002", "state.pt"),
                        weights_only=True)["generator"]
    assert state.keys() == newest.keys()
    assert all(torch.equal(state[k], newest[k]) for k in state)
    assert not all(torch.equal(state[k], v) for k, v in
                   ckpt.restore_generator_state(a).items())
    # A renderer checkpoint (generator.pt), as save_renderer writes it.
    r = ckpt.load_renderer(b, tconfig.get_profile("fadg0"), device="cpu")
    ckpt.save_renderer(r, str(tmp_path / "renderer"), height=96)
    again = ckpt.restore_generator_state(str(tmp_path / "renderer"))
    assert all(torch.equal(state[k], again[k]) for k in state)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_generator_state(str(tmp_path / "none"))


def test_swapped_weights_render_as_a_fresh_load(checkpoints):
    """``load_state_dict`` under a renderer that has already rendered (its
    layers hold bf16 copies of the old weights): the frames of a fresh
    ``load_renderer`` on the second checkpoint, not the first's."""
    a, b = checkpoints
    profile = tconfig.get_profile("fadg0")
    labels = np.random.RandomState(0).randint(
        0, 256, (5, 96, 128, 3)).astype(np.uint8)
    live = ckpt.load_renderer(a, profile, device="cpu")
    live.time_bucket = 4
    first = live.render(labels)
    live.generator.load_state_dict(ckpt.restore_generator_state(b))
    swapped = live.render(labels)
    fresh = ckpt.load_renderer(b, profile, device="cpu")
    fresh.time_bucket = 4
    np.testing.assert_array_equal(swapped, fresh.render(labels))
    assert not np.array_equal(swapped, first)


def test_eval_gan_and_eval_gan_many_on_a_trained_directory(
        assets, checkpoints, tmp_path, capsys):
    a, b = checkpoints
    common = ["--images", assets[0], "--keypoints", assets[1], *SIZE,
              "--clips", "2", "--clip-len", "4", "--device", "cpu"]
    rows = {}
    for name, path in (("a", a), ("b", b)):
        capsys.readouterr()
        assert eval_gan.main(["--ckpt", path, *common]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        rows[name] = json.loads(lines[-1])
        assert set(rows[name]) == KEYS and rows[name]["frames"] == 8
        assert rows[name]["clips"] == 2 and rows[name]["split"] == "holdout"
        assert all(np.isfinite(rows[name][k]) for k in
                   ("psnr_db", "ssim", "mouth_psnr_db", "mouth_ssim"))

    prefix = str(tmp_path / "eval_")
    capsys.readouterr()
    assert eval_gan_many.main(["--ckpts", a, b, "--out-prefix", prefix,
                               *common]) == 0
    many = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert [r.pop("ckpt") for r in many] == [a, b]
    # One renderer, the weights swapped: each row is a fresh eval_gan's.
    assert many == [rows["a"], rows["b"]]
    assert many[0] != many[1]
    for name, row in (("step1", rows["a"]), ("step2", rows["b"])):
        with open(f"{prefix}{name}_holdout.json") as f:
            assert json.load(f) == {"ckpt": a if name == "step1" else b,
                                    **row}


def test_render_avatar_byte_equal_to_the_jax_tool(tmp_path, capsys):
    """Every golden pose frame at 896x512 from its 512x384 source, and a
    blank frame; then ``main`` writes frames a dataset loads."""
    from text2video_tpu_torch.io.openpose import load_keypoint_frame
    from text2video_tpu_torch.train.data import PoseClipDataset

    ref = _jax_tool("make_synthetic_frames")
    paths = sorted(GOLDEN_POSE_DIR.glob("*.json"))
    assert len(paths) >= 20
    for path in paths[::4]:
        kf = load_keypoint_frame(str(path))
        for size in ((896, 512), (128, 96)):
            a = make_synthetic_frames.render_avatar(kf.face, kf.pose, size,
                                                    (512, 384))
            b = ref.render_avatar(kf.face, kf.pose, size, (512, 384))
            assert a.dtype == np.uint8 and a.shape == (size[1], size[0], 3)
            assert a.tobytes() == b.tobytes()
    assert a.std() > 10  # an avatar, not only the background
    blank = make_synthetic_frames.render_avatar(
        np.zeros(210), np.zeros(75), (64, 48), (512, 384))
    assert blank.tobytes() == ref.render_avatar(
        np.zeros(210), np.zeros(75), (64, 48), (512, 384)).tobytes()

    keypoints = tmp_path / "keypoints"
    keypoints.mkdir()
    for i, path in enumerate(paths[:6]):
        shutil.copyfile(path, keypoints / f"clip_{i:03d}_keypoints.json")
    out = str(tmp_path / "frames")
    capsys.readouterr()
    assert make_synthetic_frames.main([
        "--keypoints", str(keypoints), "--out", out, "--width", "128",
        "--height", "96", "--source-width", "512", "--source-height", "384",
        "--limit", "5"]) == 0
    assert "wrote 5 frames" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == [f"clip_{i:03d}.jpg" for i in range(5)]
    ds = PoseClipDataset(out, str(keypoints), canvas=(128, 96),
                         source_canvas=(512, 384), clip_len=4, device="cpu")
    assert ds.num_frames == 5
    labels, reals, centers = ds.sample_clip(np.random.RandomState(0))
    assert reals.shape == labels.shape == (4, 96, 128, 3)
    assert reals.std() > 10 and centers.shape == (4, 2)
