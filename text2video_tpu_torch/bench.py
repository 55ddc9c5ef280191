"""Benchmarks of the pose2frame stack on one card (counterpart of the root
``bench.py``, which measures the JAX package on a TPU; the modes, metric
names and keys are the same, so the two lines read side by side).

    python -m text2video_tpu_torch.bench [--mode gen|batch|jacobi|e2e]
        [--sweeps K] [--bucket N] [--load-size N] [--device cuda]

(also ``python -m text2video_tpu_torch.cli bench ...``). Each mode prints ONE
JSON line, and every line carries ``device``: the card's name and power
limit as ``nvidia-smi`` reports them.

  gen     warm autoregressive generation fps at batch 1 (256 frames at
          512x384, base 64, 9 resblocks, bf16, seeded random weights and
          labels, time_bucket 128; best of 3 after a warm run), with the
          batch-4 extra (time_bucket 64). Baseline: real-time playback at
          25 fps.
  batch   the batch-4 rate alone (metric suffix ``_b4``).
  jacobi  ``--sweeps k`` Jacobi sweeps over the 256-frame timeline
          (``Renderer.jacobi_device``, time_bucket 64): delivered fps, MFU of
          the delivered frames and of every sweep executed.
  e2e     text -> video wall clock of ``Text2VideoPipeline.synthesize`` for
          an English utterance (the port's formant TTS of sa1 twice,
          aligned by the packaged fadg0 acoustic model, the pose stage on the
          device), warm, best of 2, as a real-time factor with the stage
          split. The data directory is written from the committed golden
          frames (``golden.write_golden_assets``). ``--load-size N``: a
          square N x N canvas; ``--bucket N``: the renderer's time_bucket.

MFU counts the generator's conv FLOPs (``_analytic_frame_flops``) against
the dense bf16 peak of the card found (``PEAK_BF16_FLOPS``); on the CPU or a
card not in the table it is null. The measuring functions take the shape as
parameters so that they can run tiny on the CPU; the command always runs the
sizes above, on ``cuda`` unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from text2video_tpu_torch import device as devices
from text2video_tpu_torch.render import Renderer

BASELINE_FPS = 25.0  # real-time at the reference's output frame rate
H, W = 384, 512
T = 256  # ~10 s at 25 fps
TIMED_RUNS = 3
# Dense bf16 tensor-core peak by torch.cuda.get_device_name(): NVIDIA's H100
# SXM data sheet at 700 W.
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}
SA1 = "She had your dark suit in greasy wash water all year"


def _analytic_frame_flops(
    h: int,
    w: int,
    base_ch: int = 64,
    n_downsample: int = 3,
    n_blocks: int = 9,
    label_ch: int = 9,
    prev_ch: int = 6,
) -> float:
    """Closed-form conv FLOPs of one CompositeGenerator forward: every conv
    at 2*H*W*Cin*Cout*K^2; elementwise, norm and warp work is <1% and
    ignored (the root ``bench.py``'s count, copied)."""
    mac = 0.0
    ch = base_ch
    mac += h * w * (label_ch + prev_ch) * ch * 49  # 7x7 stem
    hh, ww = h, w
    for _ in range(n_downsample):
        hh, ww = hh // 2, ww // 2
        mac += hh * ww * ch * (2 * ch) * 9
        ch *= 2
    mac += n_blocks * 2 * (hh * ww * ch * ch * 9)
    for _ in range(n_downsample):
        hh, ww = hh * 2, ww * 2
        mac += hh * ww * ch * (ch // 2) * 9
        ch //= 2
    mac += h * w * ch * 6 * 49  # merged heads, 7x7
    return 2.0 * mac


def peak_bf16_flops(device: torch.device) -> Optional[float]:
    """The dense bf16 peak of ``device``, or None (the CPU, or a card that
    is not in ``PEAK_BF16_FLOPS``)."""
    if device.type != "cuda":
        return None
    return PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(device))


def _mfu(flops_per_s: float, peak: Optional[float]) -> Optional[float]:
    return None if peak is None else round(flops_per_s / peak, 4)


def device_info(device: torch.device) -> dict:
    """The name and power limit of the card ``device`` as ``nvidia-smi
    --query-gpu=name,power.limit`` gives them; the CPU has neither."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[device.index or 0]
    name, limit = line.rsplit(",", 1)
    return {"name": name.strip(), "power_limit": limit.strip()}


def _seeded_labels(shape, device: torch.device) -> torch.Tensor:
    """uint8 label maps of ``shape`` from ``RandomState(0)``, on ``device``."""
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 256, size=shape, dtype=np.uint8)
    return torch.from_numpy(labels).to(device)


def _best_seconds(once, runs: int) -> float:
    """One warm call of ``once``, then the least wall time of ``runs``."""
    once()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    return min(times)


def _measure_gen(renderer: Renderer, batch: int, frames: int, height: int,
                 width: int) -> float:
    """Warm + timed autoregressive generation; returns frames per second
    (``batch`` utterances' frames)."""
    labels = _seeded_labels((batch, frames, height, width, 3),
                            renderer.device)

    def generate_once() -> None:
        chunks = renderer.generate_device(labels)
        # Synchronise on a small checksum, not a pull of the frames.
        int(chunks[-1][:, -1, ::64, ::64].sum())

    return batch * frames / _best_seconds(generate_once, TIMED_RUNS)


def gen_bench(batch: int = 1, with_extras: bool = False, height: int = H,
              width: int = W, frames: int = T, base_ch: int = 64,
              n_blocks: int = 9, device=None) -> dict:
    """Generation fps at ``batch`` (``--mode gen``: batch 1 with the batch-4
    extra; ``--mode batch``: batch 4): the JSON line as a dict."""
    device = devices.resolve(device)
    renderer = Renderer.create(seed=0, base_ch=base_ch, n_blocks=n_blocks,
                               dtype=torch.bfloat16, device=device)
    renderer.time_bucket = 128
    fps = _measure_gen(renderer, batch, frames, height, width)
    frame_flops = _analytic_frame_flops(height, width, base_ch,
                                        n_blocks=n_blocks)
    peak = peak_bf16_flops(device)
    suffix = "" if batch == 1 else f"_b{batch}"
    line = {
        "metric": f"pose2frame_generation_fps_{width}x{height}_1chip{suffix}",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "mfu": _mfu(frame_flops * fps, peak),
        "flops_per_frame": round(frame_flops),
    }
    if with_extras:
        # Batched serving is the throughput config; at batch 4 the scan runs
        # 64-frame chunks, as run_audio_batch does.
        renderer.time_bucket = 64
        fps4 = _measure_gen(renderer, 4, frames, height, width)
        line["batch4"] = {
            "fps": round(fps4, 2),
            "vs_baseline": round(fps4 / BASELINE_FPS, 3),
            "mfu": _mfu(frame_flops * fps4, peak),
        }
    line["device"] = device_info(device)
    return line


def jacobi_bench(sweeps: int, height: int = H, width: int = W,
                 frames: int = T, base_ch: int = 64, n_blocks: int = 9,
                 device=None) -> dict:
    """Jacobi decoding of a ``frames``-frame timeline in ``sweeps`` sweeps:
    delivered fps, with the MFU of the delivered frames (``mfu``) and of
    every sweep executed (``mfu_executed``)."""
    device = devices.resolve(device)
    renderer = Renderer.create(seed=0, base_ch=base_ch, n_blocks=n_blocks,
                               dtype=torch.bfloat16, device=device)
    labels = (_seeded_labels((frames, height, width, 3), device).float()
              / 127.5 - 1.0)

    def once() -> None:
        out = renderer.jacobi_device(labels, sweeps)
        float(out[-1, ::64, ::64].abs().sum())

    fps = frames / _best_seconds(once, TIMED_RUNS)
    frame_flops = _analytic_frame_flops(height, width, base_ch,
                                        n_blocks=n_blocks)
    peak = peak_bf16_flops(device)
    return {
        "metric": f"pose2frame_jacobi{sweeps}_fps_{width}x{height}_1chip",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "mfu": _mfu(frame_flops * fps, peak),
        "mfu_executed": _mfu(sweeps * frame_flops * fps, peak),
        "device": device_info(device),
    }


def e2e_bench(load_size: int = 0, bucket: int = 0,
              render_height: Optional[int] = None, base_ch: int = 64,
              n_blocks: int = 9, device=None) -> dict:
    """Text -> video wall clock, warm, best of 2. ``load_size > 0``: a
    square canvas of that size, fadg0's keypoints kept in their 512x384
    coordinates (as in the root ``bench.py``); else fadg0's own 512x384.
    ``render_height``: the generator's working height
    (``RenderConfig.load_size``, the tracks scaled to it), else the canvas."""
    from text2video_tpu_torch.config import (
        PACKAGED_DATA_DIR,
        PipelineConfig,
        RenderConfig,
        get_profile,
    )
    from text2video_tpu_torch.frontend.align_english import EnglishAligner
    from text2video_tpu_torch.frontend.audio import ALIGN_SAMPLE_RATE
    from text2video_tpu_torch.frontend.tts import FormantTTS
    from text2video_tpu_torch.golden import write_golden_assets
    from text2video_tpu_torch.pipeline import Text2VideoPipeline

    device = devices.resolve(device)
    text = SA1 + " " + SA1
    with tempfile.TemporaryDirectory() as tmp:
        data = write_golden_assets(os.path.join(tmp, "data"))
        profile = get_profile("fadg0", data_dir=data)
        if load_size:
            profile = dataclasses.replace(profile,
                                          canvas=(load_size, load_size))
        aligner = EnglishAligner.load(
            str(PACKAGED_DATA_DIR / "english_fadg0.am"),
            os.path.join(data, "aligner", "english", "dict"), profile.fps)
        audio = FormantTTS().synthesize(text, ALIGN_SAMPLE_RATE)
        dur_s = len(audio) / ALIGN_SAMPLE_RATE

        renderer = Renderer.create(RenderConfig(load_size=render_height),
                                   seed=0, base_ch=base_ch,
                                   n_blocks=n_blocks, dtype=torch.bfloat16,
                                   device=device)
        h, w = renderer.target_hw(profile.canvas[1], profile.canvas[0])
        if bucket:
            renderer.time_bucket = bucket
        pipe = Text2VideoPipeline(
            PipelineConfig(person=profile, out_dir=os.path.join(tmp, "out"),
                           pose_device="device"),
            renderer=renderer, aligner=aligner)
        res = aligner.align(audio, text)

        def once():
            return pipe.synthesize(res.phones, "bench", audio=audio)

        once()  # warm
        walls, runs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            runs.append(once())
            walls.append(time.perf_counter() - t0)
        wall = min(walls)
        run = runs[walls.index(wall)]

    clip_s = run.num_frames / profile.fps
    return {
        "metric": f"e2e_text2video_realtime_factor_{w}x{h}_1chip",
        "value": round(clip_s / wall, 3),
        "unit": "x realtime (audio %.1fs, video %.1fs, wall %.2fs)"
        % (dur_s, clip_s, wall),
        "vs_baseline": round(clip_s / wall, 3),
        "stage_seconds": {k: round(v, 3)
                          for k, v in (run.stage_seconds or {}).items()},
        "device": device_info(device),
    }


def add_arguments(p: argparse.ArgumentParser) -> None:
    """The bench's flags: the root ``bench.py``'s, plus ``--device``."""
    p.add_argument("--mode", choices=["gen", "e2e", "batch", "jacobi"],
                   default="gen")
    p.add_argument("--bucket", type=int, default=0,
                   help="e2e mode: override renderer.time_bucket")
    p.add_argument("--sweeps", type=int, default=2)
    p.add_argument("--load-size", type=int, default=None,
                   help="e2e mode: square canvas at this size (omit for the "
                   "native 512x384)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                   "plain versions)")


def run(args: argparse.Namespace) -> int:
    """Measure the mode ``args`` name and print its JSON line."""
    device = args.device
    if args.mode == "gen":
        line = gen_bench(batch=1, with_extras=True, device=device)
    elif args.mode == "batch":
        line = gen_bench(batch=4, device=device)
    elif args.mode == "jacobi":
        line = jacobi_bench(args.sweeps, device=device)
    else:
        line = e2e_bench(load_size=args.load_size or 0, bucket=args.bucket,
                         device=device)
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="text2video_tpu_torch.bench")
    add_arguments(parser)
    return run(parser.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
