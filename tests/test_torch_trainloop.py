"""Training data, loop and checkpoints of the port on the CPU: the dataset
against the JAX dataset on files written by ``golden.write_training_assets``,
``train_gan`` in its host-data and device-data modes, save / restore / resume,
``load_renderer`` on a training directory, and the CLI's ``train-gan``
(label augmentation has ``tests/test_torch_augment.py``)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from text2video_tpu_torch import checkpoints as ckpt
from text2video_tpu_torch import config as tconfig
from text2video_tpu_torch.golden import write_training_assets
from text2video_tpu_torch.train import trainer as tt
from text2video_tpu_torch.train.data import PoseClipDataset
from text2video_tpu_torch.train.loop import train_gan

torch.set_num_threads(1)

CANVAS = (32, 32)
SOURCE = (512, 384)  # the golden keypoints' canvas
CFG = tt.TrainConfig(height=32, width=32, face_crop=8, base_ch=8, n_blocks=1,
                     d_base_ch=8, dtype=torch.float32)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return write_training_assets(str(tmp_path_factory.mktemp("train")),
                                 n_frames=16, canvas=(64, 48))


def _dataset(assets, **kw):
    kw.setdefault("canvas", CANVAS)
    kw.setdefault("clip_len", 4)
    return PoseClipDataset(*assets, source_canvas=SOURCE, device="cpu", **kw)


def test_training_assets_layout(assets):
    import cv2

    images, keypoints = assets
    stems = sorted(f[:-4] for f in os.listdir(images))
    assert stems == [f"run{r}_{i:03d}" for r in (0, 1) for i in range(16)]
    assert sorted(os.listdir(keypoints)) == [
        s + "_keypoints.json" for s in stems]
    a = cv2.imread(os.path.join(images, "run0_000.jpg"))
    b = cv2.imread(os.path.join(images, "run0_008.jpg"))
    assert a.shape == (48, 64, 3) and a.std() > 5
    assert np.abs(a.astype(int) - b.astype(int)).max() > 30  # the mouth moves
    # Deterministic: a second write gives the same bytes.
    again = write_training_assets(os.path.dirname(images) + "_again",
                                  n_frames=16, canvas=(64, 48))
    for name in ("run0_000.jpg", "run1_015.jpg"):
        with open(os.path.join(images, name), "rb") as f, \
                open(os.path.join(again[0], name), "rb") as g:
            assert f.read() == g.read()
    with pytest.raises(ValueError):
        write_training_assets(os.path.dirname(images) + "_bad", n_frames=500)


@pytest.mark.parametrize("split", ["all", "train", "holdout"])
def test_dataset_matches_jax_dataset(assets, split):
    """Same files, same ``RandomState``: the same split, clip indices and
    batches (labels through each package's rasterizer, pixel-equal)."""
    from text2video_tpu.train.data import PoseClipDataset as JaxDataset

    kw = dict(canvas=(64, 48), clip_len=4, split=split)
    ours = _dataset(assets, **kw)
    ref = JaxDataset(*assets, source_canvas=SOURCE, **kw)
    assert ours.num_frames == ref.num_frames
    assert [[f.stem for f in c] for c in ours.clips] == [
        [f.stem for f in c] for c in ref.clips]
    if split != "all":  # one whole run is held out
        assert ours.num_frames == 16
        assert ours.clips[0][0].stem.startswith(
            "run0" if split == "train" else "run1")
    a = ours.batch(np.random.RandomState(5), 2, with_flow=True)
    b = ref.batch(np.random.RandomState(5), 2, with_flow=True)
    assert a.keys() == b.keys() == {"labels", "reals", "face_centers",
                                    "flow_gt"}
    for k in a:
        assert a[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["labels"].shape == (2, 4, 48, 64, 3) and a["labels"].std() > 0.1
    for x, y in zip(ours.flat_arrays(), ref.flat_arrays()):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(ours.flat_track_arrays(), ref.flat_track_arrays()):
        np.testing.assert_array_equal(x, y)
    r1, r2 = np.random.RandomState(6), np.random.RandomState(6)
    for _ in range(3):
        np.testing.assert_array_equal(ours.sample_clip_indices(r1),
                                      ref.sample_clip_indices(r2))


def _metric_lines(log):
    return [ln.split(" | ")[0] for ln in log if ln.startswith("step ")]


def test_train_gan_host_and_device_data_agree(assets):
    """Two steps in each mode from the same seed: the same clips are drawn,
    so the logged metrics and the final parameters agree."""
    runs = {}
    for device_data in (False, True):
        log = []
        state = train_gan(_dataset(assets), CFG, steps=2, batch_size=2,
                          seed=3, log_every=1, device_data=device_data,
                          log_fn=log.append, device="cpu")
        assert state.step == 2
        runs[device_data] = (state, log)
    host, dev = runs[False], runs[True]
    assert len(_metric_lines(host[1])) == 2
    assert _metric_lines(host[1]) == _metric_lines(dev[1])
    assert "g_loss=" in host[1][0] and "nan" not in " ".join(host[1])
    assert any("device-resident dataset" in ln for ln in dev[1])
    for p, q in zip(host[0].generator.parameters(),
                    dev[0].generator.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-6, rtol=0)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "labels": torch.from_numpy(
            rng.rand(2, 4, 32, 32, 3).astype(np.float32) * 2 - 1),
        "reals": torch.from_numpy(
            rng.rand(2, 4, 32, 32, 3).astype(np.float32) * 2 - 1),
        "face_centers": torch.full((2, 4, 2), 16.0),
    }


def test_save_restore_reproduces_the_next_step(tmp_path):
    """A restored state takes the next step bit for bit as the state that
    was saved does: parameters, both Adam states and the step come back."""
    cfg = dataclasses.replace(CFG, use_vgg=True)
    step = tt.make_train_step(cfg)
    state = tt.create_trainer_state(cfg, seed=1, device="cpu")
    for i in range(2):
        state, _ = step(state, _batch(i))
    ckpt.save_state(str(tmp_path), state, cfg)
    meta = ckpt.load_config(str(tmp_path))
    assert meta["base_ch"] == 8 and meta["height"] == 32
    assert meta["dtype"] == "torch.float32"
    assert set(meta) == {f.name for f in dataclasses.fields(cfg)}
    assert os.path.isfile(tmp_path / "step_00000002" / "state.pt")

    restored = ckpt.restore_state(
        str(tmp_path), tt.create_trainer_state(cfg, seed=9, device="cpu"))
    assert restored.step == 2
    a, ma = step(state, _batch(7))
    b, mb = step(restored, _batch(7))
    assert a.step == b.step == 3
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for mod in ("generator", "discriminators", "vgg"):
        for p, q in zip(getattr(a, mod).parameters(),
                        getattr(b, mod).parameters()):
            assert torch.equal(p, q)
    for opt in ("g_opt", "d_opt"):
        sa = getattr(a, opt).state_dict()["state"]
        sb = getattr(b, opt).state_dict()["state"]
        assert sa.keys() == sb.keys() and len(sa) > 0
        for i in sa:
            assert float(sa[i]["step"]) == float(sb[i]["step"]) == 3
            assert torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"])
            assert torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"])
    with pytest.raises(FileNotFoundError):
        ckpt.restore_state(str(tmp_path / "none"), restored)


def test_latest_step_ignores_unfinished_saves_and_keep_last(tmp_path):
    state = tt.create_trainer_state(CFG, seed=0, device="cpu")
    d = str(tmp_path)
    assert ckpt.latest_step_dir(d + "/missing") is None
    assert ckpt.load_config(d) is None
    for s in (1, 2, 3, 4):
        state.step = s
        ckpt.save_state(d, state, CFG, keep_last=2)
    assert sorted(n for n in os.listdir(d) if n.startswith("step_")) == [
        "step_00000003", "step_00000004"]
    # A save that was killed midway leaves its temporary directory.
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert ckpt.latest_step_dir(d) == os.path.join(d, "step_00000004")
    state.step = 5
    ckpt.save_state(d, state, CFG, keep_last=2)
    assert ckpt.latest_step_dir(d).endswith("step_00000005")
    assert not any(n.endswith(".tmp") and n != "step_00000009.tmp"
                   for n in os.listdir(d))


def test_train_gan_resumes_and_load_renderer_reads_the_directory(assets,
                                                                 tmp_path):
    d = str(tmp_path / "ckpt")
    log = []
    kw = dict(batch_size=1, ckpt_dir=d, save_every=2, sample_every=2,
              log_fn=log.append, device="cpu")
    state = train_gan(_dataset(assets), CFG, steps=3, **kw)
    assert state.step == 3
    assert sorted(os.listdir(d)) == ["config.json", "sample_00000002.jpg",
                                     "step_00000002", "step_00000003"]
    resumed = train_gan(_dataset(assets), CFG, steps=1, **kw)
    assert resumed.step == 4 and "resumed from step 3" in log

    r = ckpt.load_renderer(d, tconfig.get_profile("fadg0"), device="cpu")
    assert r.config.load_size == 32 and r.generator.dtype == torch.bfloat16
    for (k, v), (k2, v2) in zip(
            sorted(resumed.generator.state_dict().items()),
            sorted(r.generator.state_dict().items())):
        assert k == k2 and torch.equal(v, v2)
    r.time_bucket = 4
    labels = np.random.RandomState(0).randint(0, 256, (5, 32, 32, 3), np.uint8)
    frames = r.render(labels)
    assert frames.shape == (5, 32, 32, 3) and frames.std() > 0
    rj = ckpt.load_renderer(d, tconfig.get_profile("fadg0"), device="cpu",
                            decode_mode="jacobi", jacobi_sweeps=2)
    assert rj.config.decode_mode == "jacobi" and rj.config.jacobi_sweeps == 2
    with pytest.raises(ValueError, match="decode_mode"):
        ckpt.load_renderer(d, tconfig.get_profile("fadg0"), device="cpu",
                           decode_mode="other")


def test_cli_train_gan_on_cpu(assets, tmp_path, capsys):
    """The CLI's defaults apart from the size: bf16, remat, adversarial on,
    9 resblocks; then a resumed run through ``--device-data``, and
    ``jacobi_quality`` on the directory it wrote."""
    from text2video_tpu_torch import cli
    from text2video_tpu_torch.tools import jacobi_quality

    d = str(tmp_path / "ckpt")
    argv = ["train-gan", "--images", assets[0], "--keypoints", assets[1],
            "--ckpt", d, "--width", "128", "--height", "96",
            "--source-width", "512", "--source-height", "384", "--clip-len",
            "4", "--batch-size", "2", "--base-ch", "8", "--device", "cpu"]
    capsys.readouterr()
    assert cli.main(argv + ["--steps", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == {"steps": 1, "ckpt": d}
    assert cli.main(argv + ["--steps", "1", "--device-data", "--grad-accum",
                            "2", "--lambda-adv", "0"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == {"steps": 2, "ckpt": d}
    assert ckpt.load_config(d)["dtype"] == "torch.bfloat16"
    # Label augmentation: the dataset is built without its label cache and
    # the labels are drawn from perturbed tracks every step.
    assert cli.main(argv + ["--steps", "1", "--device-data", "--aug-jitter",
                            "1.0", "--aug-drop", "0.05", "--aug-face-drop",
                            "0.1", "--aug-scale-crop"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == {"steps": 3, "ckpt": d}
    assert any("device-resident dataset (augmented)" in ln for ln in out)

    capsys.readouterr()
    assert jacobi_quality.main([
        "--ckpt", d, "--images", assets[0], "--keypoints", assets[1],
        "--width", "128", "--height", "96", "--source-width", "512",
        "--source-height", "384", "--clip-len", "6", "--sweeps", "1,2",
        "--device", "cpu"]) == 0
    q = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert q["frames"] == 6 and q["split"] == "holdout"
    assert set(q["psnr_vs_scan"]) == set(q["psnr_vs_real"]) == {"1", "2"}
    assert all(np.isfinite(v) for v in q["psnr_vs_scan"].values())
    assert np.isfinite(q["scan_vs_real_psnr"])
