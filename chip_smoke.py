"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``text2video_tpu_torch/csrc``, holds
each against its plain PyTorch version at the shapes the serving path gives
it, runs one full-width generator forward through the kernel against the
same forward through the plain version, then drives the serving path end to
end at the flagship model's full width (512x384, base 64, 9 resblocks,
bf16, seeded random weights, a 256-frame utterance from the golden pose
frames): ``Text2VideoPipeline.synthesize`` with the fused pose op, the
device rasterizer, the autoregressive renderer and the muxer.

Prints one line per phase, then a JSON line with each kernel's launches on
the serving path, its error against the plain version and both times, then
the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
non-zero and the last line is not printed. Needs a CUDA device; the checks
do not fall back to the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

B1_SHAPES = [  # (shape, kernel scale or None for lecun)
    ((1, 48, 64, 512), None),   # the scan at 512x384 (batch 1)
    ((4, 48, 64, 512), None),   # batch 4
    ((2, 16, 24, 64), None),
    ((1, 12, 28, 128), 0.05),   # odd sizes of the JAX package's tests
    ((1, 8, 112, 128), 0.05),
    ((1, 4, 16, 128), 0.05),
]
B1_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.05}
B2_TOL = 2e-3
GEN_TOL = 1e-3
N_FRAMES = 256  # ~10 s at 25 fps
CHUNK = 64


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def median_ms(fn, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` calls, CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() "
                 "is False)")
    # The plain references run in full f32, not TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    from text2video_tpu_torch import kernels

    # ---- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = kernels.build()
    kernels.library()
    regs = [ln.split("info    : ")[-1] for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          lib=os.path.relpath(lib_path), ptxas=json.dumps(regs))

    from text2video_tpu_torch.ops import fused_pose, fused_resblock

    # ---- 2. B1 against its plain version -------------------------------------
    gen = torch.Generator().manual_seed(0)
    b1_err = b1_ms = b1_plain_ms = None
    for shape, kscale in B1_SHAPES:
        c = shape[-1]
        x32 = torch.randn(shape, generator=gen).to(dev)
        scale = kscale if kscale else (1.0 / (9 * c)) ** 0.5
        k = (torch.randn((3, 3, c, c), generator=gen) * scale).to(dev)
        b = torch.randn((c,), generator=gen).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            y, mean, var = fused_resblock.conv3x3_stats(x, k, b)
            y0, mean0, var0 = fused_resblock.conv3x3_stats_plain(x, k, b)
            torch.cuda.synchronize()
            errs = [(y.float() - y0.float()).abs().max().item(),
                    (mean - mean0).abs().max().item(),
                    (var - var0).abs().max().item()]
            check(max(errs) <= B1_TOL[dt],
                  f"B1 {shape} {dt}: errors {errs} > {B1_TOL[dt]}")
            fields = dict(shape=list(shape), dtype=str(dt).split(".")[-1],
                          err_y_mean_var=errs)
            if c == 512:
                ms = median_ms(lambda: fused_resblock.conv3x3_stats(x, k, b))
                plain_ms = median_ms(
                    lambda: fused_resblock.conv3x3_stats_plain(x, k, b))
                fields.update(ms=ms, plain_ms=plain_ms)
                if shape[0] == 1 and dt == torch.bfloat16:
                    b1_err, b1_ms, b1_plain_ms = errs[0], ms, plain_ms
            phase("B1", **fields)

    # ---- 3. B2 against its plain version and the host smoother ---------------
    from text2video_tpu_torch.golden import golden_pose_inputs
    from text2video_tpu_torch.pose_stage import (
        plan_pose_track,
        smooth_host,
        synthesize_host,
    )

    profile, pdict, table, ts = golden_pose_inputs(n_frames=N_FRAMES)
    plan = plan_pose_track(ts, pdict, table, profile)
    sw = profile.smooth_width
    ref_f, ref_p = smooth_host(*synthesize_host(plan, table), sw)
    args = [torch.as_tensor(a, dtype=dt, device=dev) for a, dt in (
        (table.face, torch.float32), (table.pose, torch.float32),
        (plan.i1, torch.int32), (plan.i2, torch.int32),
        (plan.w2, torch.float32))]
    face, pose = fused_pose.blend_and_smooth(*args, sw)
    face0, pose0 = fused_pose.blend_and_smooth_plain(*args, sw)
    torch.cuda.synchronize()
    b2_err = max((face - face0).abs().max().item(),
                 (pose - pose0).abs().max().item())
    host_err = max(np.abs(face.cpu().numpy() - ref_f).max(),
                   np.abs(pose.cpu().numpy() - ref_p).max())
    check(b2_err <= B2_TOL and host_err <= B2_TOL,
          f"B2: error {b2_err} vs plain, {host_err} vs smooth_host")
    b2_ms = median_ms(lambda: fused_pose.blend_and_smooth(*args, sw))
    b2_plain_ms = median_ms(lambda: fused_pose.blend_and_smooth_plain(*args, sw))
    phase("B2", frames=plan.num_frames, table_rows=len(table),
          err_vs_plain=b2_err, err_vs_smooth_host=float(host_err), ms=b2_ms,
          plain_ms=b2_plain_ms)

    # ---- 4. one full-width f32 generator forward, kernel vs plain ------------
    from text2video_tpu_torch.render import Renderer

    r32 = Renderer.create(seed=0, dtype=torch.float32, device=dev)
    gin = (torch.rand((1, 384, 512, 9), generator=gen).to(dev) * 2 - 1,
           torch.rand((1, 384, 512, 6), generator=gen).to(dev) * 2 - 1,
           torch.ones((1,), device=dev))
    with torch.inference_mode():
        before = fused_resblock.launches
        out_k = r32.generator(*gin)
        torch.cuda.synchronize()
        n_launch = fused_resblock.launches - before
        kernel_fn = fused_resblock.conv3x3_stats
        fused_resblock.conv3x3_stats = fused_resblock.conv3x3_stats_plain
        try:
            out_p = r32.generator(*gin)
        finally:
            fused_resblock.conv3x3_stats = kernel_fn
    gen_errs = [(a - b).abs().max().item() for a, b in zip(out_k, out_p)]
    check(n_launch == 18, f"generator forward launched B1 {n_launch} times")
    check(gen_errs[0] <= GEN_TOL, f"generator frame error {gen_errs[0]}")
    phase("generator_f32", hw="512x384", base_ch=64, n_blocks=9,
          b1_launches=n_launch, err_frame_flow_mask=gen_errs)
    del r32, out_k, out_p

    # ---- 5. the serving path, bf16 -----------------------------------------
    import cv2

    from text2video_tpu_torch import pipeline
    from text2video_tpu_torch.ops.rasterize import rasterize_batch

    port_stage = pipeline.PoseStage
    pipeline.PoseStage = (
        lambda prof, device="cpu": port_stage(prof, pdict, table, device))
    renderer = Renderer.create(seed=0, dtype=torch.bfloat16, device=dev)
    renderer.time_bucket = CHUNK
    rng = np.random.RandomState(0)
    audio = (0.1 * np.sin(np.arange(int(16000 * N_FRAMES / profile.fps))
                          * 2 * np.pi * 220 / 16000)
             + 0.01 * rng.randn(int(16000 * N_FRAMES / profile.fps))
             ).astype(np.float32)
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = pipeline.PipelineConfig(person=profile, out_dir=out_dir,
                             pose_device="device")
        # Warm-up, non-streaming: frames and labels come back to the host.
        warm = pipeline.Text2VideoPipeline(
            dataclasses.replace(cfg, stream=False), renderer
        ).synthesize(ts, "warm", audio=audio, keep_arrays=True)
        check(warm.frames.shape == (N_FRAMES, 384, 512, 3)
              and warm.label_maps.shape == (N_FRAMES, 384, 512, 3),
              f"slice shapes {warm.frames.shape} {warm.label_maps.shape}")
        check(warm.frames.std() > 1.0 and warm.label_maps.std() > 1.0,
              "slice frames or labels are constant")
        # The device rasterizer draws the same pixels as its CPU version.
        res = pipeline.PoseStage(profile).run(ts, device=False)
        tracks = (res.face_smooth[:8], res.pose_smooth[:8],
                  table.hands[res.plan.carrier[:8], 0],
                  table.hands[res.plan.carrier[:8], 1])
        label_diff = np.abs(
            rasterize_batch(*tracks, (512, 384), chunk=8).astype(int)
            - rasterize_batch(*tracks, (512, 384), chunk=8,
                              device=dev).astype(int)).max()
        check(label_diff == 0, f"device labels differ from CPU by {label_diff}")

        # The counted run: the default streaming path into the muxer.
        fused_resblock.launches = 0
        fused_pose.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = pipeline.Text2VideoPipeline(cfg, renderer).synthesize(
            ts, "smoke", audio=audio)
        wall = time.perf_counter() - t0
        launches = {"conv3x3_stats": fused_resblock.launches,
                    "synthesize_and_smooth": fused_pose.launches}
        check(run.num_frames == N_FRAMES, f"streamed {run.num_frames} frames")
        check(all(v > 0 for v in launches.values()),
              f"a kernel was not launched on the serving path: {launches}")
        check(launches["conv3x3_stats"] == 18 * N_FRAMES,
              f"B1 launches {launches['conv3x3_stats']} != 18 per frame")
        mp4 = next(f for f in run.files if f.endswith(".mp4"))
        cap = cv2.VideoCapture(mp4)
        ok, first = cap.read()
        n_mp4 = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        check(ok and first.shape == (384, 512, 3) and first.std() > 1.0
              and n_mp4 == N_FRAMES, f"muxed mp4 unreadable: {ok} {n_mp4}")
        files = {os.path.basename(f): os.path.getsize(f) for f in run.files}
        check(all(files.values()), f"empty output file: {files}")
        phase("slice", frames=run.num_frames, wall_s=wall,
              stage_seconds=json.dumps(run.stage_seconds), files=files,
              label_diff_vs_cpu=int(label_diff))

    # Warm generation rate at batch 1 (the renderer alone, 256 frames).
    labels = (torch.from_numpy(warm.label_maps).to(dev)[None].float()
              / 127.5 - 1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks = renderer.generate_device(labels)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(len(chunks) == N_FRAMES // CHUNK, "generate_device chunks")
    phase("generate", frames=N_FRAMES, seconds=gen_s,
          fps=N_FRAMES / gen_s, peak_mem_gib=torch.cuda.max_memory_allocated()
          / 2**30)
    check("jax" not in sys.modules, "jax was imported")

    # ---- 6. the card, 7. the result -----------------------------------------
    print(json.dumps({"kernels": [
        {"name": "conv3x3_stats", "route": "cuda",
         "source": "text2video_tpu_torch/csrc/conv3x3_stats.cu",
         "replaces": "text2video_tpu/ops/fused_resblock.py:64",
         "launches": launches["conv3x3_stats"], "max_abs_err": b1_err,
         "ms": b1_ms, "plain_ms": b1_plain_ms},
        {"name": "synthesize_and_smooth", "route": "cuda",
         "source": "text2video_tpu_torch/csrc/fused_pose.cu",
         "replaces": "text2video_tpu/ops/fused_pose.py:46",
         "launches": launches["synthesize_and_smooth"], "max_abs_err": b2_err,
         "ms": b2_ms, "plain_ms": b2_plain_ms},
    ]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
