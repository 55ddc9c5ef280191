"""The port imports and runs without JAX and without the JAX package: every
submodule imports, the plain slice (pose stage -> rasterizer -> renderer ->
mux) runs at a tiny size, the CLI's ``tts`` turns text into an mp4 on the
golden data directory with a tiny checkpoint (scan and Jacobi decoding,
through the default DCT wire: coefficients streamed from the renderer and
JPEGs assembled from them by the native codec),
``train-gan`` takes a step on files written from the golden frames (and an
augmented one), ``jacobi_quality``, ``eval_gan`` and ``eval_gan_many`` read
its directory, ``make_synthetic_frames`` draws frames, and the host
rasterizer and the recipe's selection run, and the coarse-to-fine generator
serves and reloads, in a child process where importing
jax, flax, optax, orbax or text2video_tpu fails. The mesh paths (Jacobi over
the timeline, ``render_many``, the sharded smoother and rasterizer) run the
same way in two gloo ranks that the child spawns, with the same modules
blocked in each rank."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import sys
    for name in ("jax", "jaxlib", "flax", "optax", "orbax",
                 "text2video_tpu"):
        sys.modules[name] = None  # any import of them raises ImportError

    import importlib, pkgutil, tempfile
    import numpy as np
    import torch

    torch.set_num_threads(1)
    import text2video_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(
        text2video_tpu_torch.__path__, "text2video_tpu_torch.")]
    for name in mods:
        importlib.import_module(name)
    for sub in ("device", "ops.dct", "io.wire_native", "train.trainer",
                "train.data", "train.loop", "train.augment",
                "tools.jacobi_quality", "tools.eval_gan",
                "tools.eval_gan_many", "tools.make_synthetic_frames",
                "tools.mouth_recipe", "models.discriminator",
                "models.losses", "models.vgg", "parallel.model_axis",
                "graft_entry", "ops.phase_conv"):
        assert "text2video_tpu_torch." + sub in mods, sub

    from text2video_tpu_torch import pipeline
    from text2video_tpu_torch.config import PipelineConfig, RenderConfig
    from text2video_tpu_torch.golden import golden_pose_inputs
    from text2video_tpu_torch.render import Renderer

    profile, pdict, table, ts = golden_pose_inputs(n_frames=6)
    port_stage = pipeline.PoseStage
    pipeline.PoseStage = (
        lambda p, device="cpu": port_stage(p, pdict, table, device))
    renderer = Renderer.create(config=RenderConfig(load_size=64), base_ch=8,
                               n_blocks=1, dtype=torch.float32, device="cpu")
    assert renderer.generator.phase_form  # the default, as in JAX
    renderer.time_bucket = 4
    with tempfile.TemporaryDirectory() as tmp:
        cfg = PipelineConfig(person=profile, out_dir=tmp, stream=False,
                             pose_device="device")
        run = pipeline.Text2VideoPipeline(cfg, renderer).synthesize(
            ts, "utt", keep_arrays=True)
    assert run.frames.shape == (6, 64, 64, 3), run.frames.shape
    assert run.frames.std() > 0

    # The coarse-to-fine generator: built, served in a batch and reloaded
    # from its renderer checkpoint.
    from text2video_tpu_torch.checkpoints import load_renderer, save_renderer

    hd = Renderer.create(base_ch=8, n_blocks=1, dtype=torch.float32,
                         device="cpu", n_local_enhancers=1)
    hd.time_bucket = 4
    hd_labels = torch.randint(0, 256, (2, 6, 64, 64, 3), dtype=torch.uint8)
    hd_frames = hd.render_many_device(hd_labels)
    assert hd_frames.shape == (2, 6, 64, 64, 3) and hd_frames.std() > 0
    with tempfile.TemporaryDirectory() as tmp:
        save_renderer(hd, tmp)
        back = load_renderer(tmp, profile, device="cpu")
    assert len(back.generator.local) == 1

    from text2video_tpu_torch import cli
    from text2video_tpu_torch.golden import write_golden_assets

    pipeline.PoseStage = port_stage  # the CLI reads the data directory
    from text2video_tpu_torch.io import wire_native

    assert wire_native.available()
    to_jpegs, jpeg_chunks = wire_native.to_jpegs, []
    wire_native.to_jpegs = (  # the muxer's worker calls it by this name
        lambda *a, **k: jpeg_chunks.append(a[0].shape[0]) or to_jpegs(*a, **k))
    with tempfile.TemporaryDirectory() as tmp:
        data = write_golden_assets(tmp + "/data")
        save_renderer(renderer, tmp + "/ckpt", height=64)
        assert cli.main(["tts", "Do they make it", "fadg0", "--data-dir",
                         data, "--gan-checkpoint", tmp + "/ckpt", "--out",
                         tmp + "/out", "--device", "cpu"]) == 0
        import os
        assert os.path.getsize(tmp + "/out/fadg0/Dotheymake.mp4") > 0
        assert cli.main(["tts", "Do they make it", "fadg0", "--data-dir",
                         data, "--gan-checkpoint", tmp + "/ckpt", "--out",
                         tmp + "/jac", "--device", "cpu", "--decode",
                         "jacobi", "--sweeps", "2"]) == 0
        assert os.path.getsize(tmp + "/jac/fadg0/Dotheymake.mp4") > 0
        # Both runs muxed the wire's coefficients: one call a chunk.
        assert len(jpeg_chunks) >= 2 and all(jpeg_chunks), jpeg_chunks
        wire_native.to_jpegs = to_jpegs

        from text2video_tpu_torch.golden import write_training_assets
        from text2video_tpu_torch.tools import (
            eval_gan,
            eval_gan_many,
            jacobi_quality,
            make_synthetic_frames,
        )

        images, keypoints = write_training_assets(tmp + "/train", 12,
                                                  (128, 96))
        size = ["--width", "128", "--height", "96", "--source-width", "512",
                "--source-height", "384", "--device", "cpu"]
        assert cli.main(["train-gan", "--images", images, "--keypoints",
                         keypoints, "--ckpt", tmp + "/gan", "--clip-len", "4",
                         "--batch-size", "1", "--base-ch", "8", "--steps",
                         "1", *size]) == 0
        assert os.path.isfile(tmp + "/gan/step_00000001/state.pt")
        assert jacobi_quality.main(["--ckpt", tmp + "/gan", "--images",
                                    images, "--keypoints", keypoints,
                                    "--clip-len", "4", "--sweeps", "1",
                                    *size]) == 0
        assert cli.main(["train-gan", "--images", images, "--keypoints",
                         keypoints, "--ckpt", tmp + "/gan", "--clip-len", "4",
                         "--batch-size", "1", "--base-ch", "8", "--steps",
                         "1", "--device-data", "--aug-jitter", "1.0",
                         "--aug-scale-crop", *size]) == 0
        assert os.path.isfile(tmp + "/gan/step_00000002/state.pt")
        data_args = ["--images", images, "--keypoints", keypoints,
                     "--clips", "1", "--clip-len", "4", *size]
        assert eval_gan.main(["--ckpt", tmp + "/gan", *data_args]) == 0
        assert eval_gan_many.main(["--ckpts", tmp + "/gan", "--out-prefix",
                                   tmp + "/eval_", *data_args]) == 0
        assert os.path.isfile(tmp + "/eval_gan_holdout.json")
        assert make_synthetic_frames.main([
            "--keypoints", keypoints, "--out", tmp + "/frames", "--width",
            "128", "--height", "96", "--source-width", "512",
            "--source-height", "384", "--limit", "2"]) == 0
        assert len(os.listdir(tmp + "/frames")) == 2

    from text2video_tpu_torch.ops.rasterize import rasterize_frame_host
    from text2video_tpu_torch.tools.mouth_recipe import select_checkpoint

    hand = np.zeros(63)
    corner = rasterize_frame_host(np.zeros(210), np.zeros(75), hand, hand,
                                  (64, 48))
    assert corner[0, 0].tolist() == [255, 0, 0], corner[0, 0]
    assert select_checkpoint([dict(psnr_db=30.0, mouth_psnr_db=20.0),
                              dict(psnr_db=30.1, mouth_psnr_db=21.0)]) == 1
    loaded = [k for k, v in sys.modules.items() if v is not None
              and k.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                      "text2video_tpu")]
    assert not loaded, loaded
    print("NOJAX_OK", len(mods))
    """
)


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout


MESH_SCRIPT = textwrap.dedent(
    """
    import json, os, sys, tempfile
    from torch_mesh_workers import BLOCKED
    for name in BLOCKED:
        sys.modules[name] = None

    from text2video_tpu_torch.parallel import spawn

    if __name__ == "__main__":
        with tempfile.TemporaryDirectory() as tmp:
            spawn("torch_mesh_workers:nojax_ops", 2,
                  (tmp + "/store", tmp, tmp), timeout_s=120, block=BLOCKED)
            outs = [json.load(open(f"{tmp}/nojax_rank{r}.json"))
                    for r in range(2)]
        assert all(o["loaded"] == [] and all(o["blocked"]) for o in outs), outs
        assert outs[0]["sums"] == outs[1]["sums"], outs
        loaded = [k for k, v in sys.modules.items() if v is not None
                  and k.split(".")[0] in BLOCKED]
        assert not loaded, loaded
        print("NOJAX_MESH_OK")
    """
)


def test_mesh_paths_run_without_jax_in_every_rank():
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]))
    proc = subprocess.run(
        [sys.executable, "-c", MESH_SCRIPT],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_MESH_OK" in proc.stdout
