"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``text2video_tpu_torch/csrc``, holds
each against its plain PyTorch version at the shapes the serving path gives
it, runs one full-width generator forward through the kernel against the
same forward through the plain version, holds the generator's phase forms
(the default, as in the JAX package: the stem, the decoder's upsamples and
the heads as coarse-resolution window convs, ``ops/phase_conv.py``) against
the plain forms op by op and as whole calls at batch 1, 4 and 64, with their
device times, kernels and memory (``[phase_form]``), then drives the serving
path end to
end at the flagship model's full width (512x384, base 64, 9 resblocks,
bf16, seeded random weights, a 256-frame utterance from the golden pose
frames): ``Text2VideoPipeline.synthesize`` with the fused pose op, the
device rasterizer, the autoregressive renderer and the muxer, through the
default DCT wire (coefficients encoded and packed on the card, JPEGs
assembled from them on the host by the native codec); the wire's
coefficients are held against the CPU's encode of the same frames (with
TF32 switched on), and the slice runs under each wire in turns (``[wire]``).
The fadg0 keypoints are also drawn on a 64x64 canvas, card against CPU
(``[raster_small]``), and the 22 golden frames of
``tests/goldens/fadg0_Shehadyour`` by the port's bit-exact host drawing,
pixel-equal to the PNGs the original pipeline drew, with the card's labels
of the same keypoints held against it by SSIM (``[raster_host]``). Then it
runs
the user's entry points the way a user calls them: first the port's bench
(``cli.main(["bench", ...])`` in the modes ``gen``, ``jacobi --sweeps 3``
and ``e2e``, each line checked and its kernel launches counted; ``gen``
gives the warm generation rate), then ``cli.main`` with the
port's ``tts``, ``audio``, ``tts-chinese`` and ``audio-batch`` commands, on
a data directory written from the golden frames and that renderer saved as
a checkpoint at height 384: text becomes an mp4 through the frontend (TTS,
forced alignment) and both kernels, and four utterances render as one
batch, held at frame 0 against batch 1. Then Jacobi decoding (``--decode
jacobi``: the 256-frame utterance in three sweeps of four 64-frame generator
calls, kernel B1 at batch 64, held against the scan; and the CLI's ``tts``
that way), and training:
``cli.main(["train-gan", ...])`` takes steps at full width on a data set
written from the golden frames, resumes, and its directory renders (a batch
row against batch 1 on its weights); a tiny f32 model's gradients on the
card are held against the CPU's; two runs from one seed give bit-equal
losses and weights, beside two without the step's deterministic scope (its
cost), and so do two runs each with VGG's loss, with ``bptt`` and with a
local enhancer; one step runs at 896x512, batch 4 x clip 8. Then the rest of
the training workflow: an augmented batch (keypoint jitter, drops, face drops,
zoom and crop) made on the card and on the CPU from the same draws,
``train-gan --device-data --aug-*``, ``tools.eval_gan`` and
``tools.eval_gan_many`` on snapshots of the directory it trained (rendered
through B1, the weights swapped under one renderer), and
``tools.make_synthetic_frames`` feeding a dataset; and the mouth-selected
recipe end to end (``tools.mouth_recipe``: avatar frames, recon, three
adversarial segments each resuming the last, ``eval_gan_many`` on the
holdout, the selection, the winner's train-split ``eval_gan`` and a ``tts``
clip from it; the train stages in subprocesses). Last, the mesh: two
ranks of ``torch.distributed`` share the card over gloo (and, on a host with
two cards or more, run over NCCL across them), started by the port's
``parallel.spawn`` with JAX and the JAX package unimportable in each: the
slice's 256 frames decoded by Jacobi with the timeline split over the ranks
and four 64-frame clips rendered with the batch split over them (each
bit-equal to one process's, B1's launches counted on each rank),
``Text2VideoPipeline(mesh=)`` on the skeleton path (tracks byte-equal to
``smooth_host``, labels pixel-equal to ``rasterize_batch``, one mp4), and
``train-gan`` data-parallel over the ranks twice (step 1 against one
process's, the runs bit-equal, the checkpoint served by one process); then
the mesh's model axis: ``train-gan --n-model 2`` in four ranks on a 2 x 2
(data, model) grid, its wide conv kernels held as output-channel shards and
gathered once a micro-batch, bit-equal to the two-rank (2, 1) run (losses,
whole weights and Adam moments), its checkpoint restored in one process and
served, and then, in the same four ranks, the serving paths above on the
(2, 2) grid, bit-equal to the two ranks' frames;
``graft_entry.dryrun_multichip(4)`` (a train step over (2, 2),
Jacobi, the smoother and the rasterizer over four ranks); one call of
``graft_entry.entry()``'s flagship forward through B1; and ``train-gan``
under ``torchrun --nproc-per-node 1`` against a plain process (bit-equal
checkpoints). ``python3 chip_smoke.py --mesh`` runs the mesh phases alone
(over NCCL too on a host with several cards; the model axis on four), and
``--mesh-model`` the model axis alone.

Prints one line per phase (each with ``at_s``, the seconds since the start),
then a JSON line with each kernel's launches on
the serving path (and on each CLI and bench path), its error against the plain
version, its time beside the
plain version's, a library call's (where one computes the same function)
and its bound (the least time the card could take: bytes over 3.35 TB/s or
operations over 989 TFLOP/s bf16, NVIDIA's H100 SXM data sheet), then the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Kernel times are device times: the calls are captured in a CUDA graph and
replayed, so the Python wrappers' host time is not counted. Any failure
raises: the exit code is non-zero and the last line is not printed. Needs a
CUDA device; the checks do not fall back to the CPU. Imports nothing of JAX
and nothing of the JAX package ``text2video_tpu``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import signal
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

B1_SHAPES = [  # (shape, kernel scale or None for lecun)
    ((1, 48, 64, 512), None),   # the scan at 512x384 (batch 1)
    ((4, 48, 64, 512), None),   # batch 4 (audio-batch)
    ((2, 48, 64, 512), None),   # a rank's two rows of a sharded batch of 4
    ((1, 48, 88, 512), None),   # henan at 384x704 (tts-chinese)
    ((64, 48, 64, 512), None),  # a Jacobi sweep's full bucket
    ((32, 48, 64, 512), None),  # the tail bucket of a 224-frame clip
    ((2, 16, 24, 64), None),
    ((2, 4, 4, 64), None),      # a dry-run rank's Jacobi block (base 8)
    ((1, 12, 28, 128), 0.05),   # odd sizes of the JAX package's tests
    ((1, 8, 112, 128), 0.05),
    ((1, 4, 16, 128), 0.05),
]
B1_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.05}
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12    # H100 SXM dense bf16 tensor cores, FLOP/s
PEAK_F32 = 67e12      # H100 SXM f32 outside the tensor cores, FLOP/s
B2_TOL = 2e-3
GEN_TOL = 1e-3
N_FRAMES = 256  # ~10 s at 25 fps
CHUNK = 64
JACOBI_SWEEPS = 3
# Generator steps a scan profile covers: the profiler costs ~0.3 s of host
# time a step, and the means a step hold at this depth.
PROFILE_STEPS = 16
GRAD_TOL = 1e-4  # card against CPU gradients, of a tensor's largest


START = time.perf_counter()


def phase(name: str, **fields) -> None:
    """One line of ``name=value`` fields, ending with ``at_s``: the seconds
    since the script started."""
    fields["at_s"] = round(time.perf_counter() - START, 1)
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events; the median replay
    over ``calls``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def ptxas_lines(log: str) -> list:
    """``kernel: registers, barriers, smem; stack, spills`` per kernel of an
    ``nvcc -Xptxas -v`` log (empty for a reused build)."""
    out, name, frame = [], "?", ""
    for ln in log.splitlines():
        # ..._cu_<8 hex><length><name>[ILi<N>E]...: the mangled name
        m = re.search(r"_cu_[0-9a-f]{8}(\d+)(\w+)", ln)
        if "Compiling entry function" in ln and m:
            n = int(m.group(1))
            name, rest = m.group(2)[:n], m.group(2)[n:]
            t = re.match(r"I((?:Li\d+E)+)E", rest)
            if t:
                name += f"<{', '.join(re.findall(r'Li(\d+)E', t.group(1)))}>"
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "registers" in ln:
            out.append(f"{name}: {ln.split('Used ')[-1].strip()}; {frame}")
    return out


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    """(bound ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


EN_TEXT = ("She had your dark suit in greasy wash water all year. Don't ask "
           "me to carry an oily rag like that. Do they make it")  # ~10.8 s
ZH_TEXT = "今天天气很好我们一起去公园散步吧"  # 16 hanzi, ~5.2 s
BATCH_TEXTS = (  # four utterances of different lengths and names
    "Do they make it",
    "Don't ask me to carry an oily rag like that",
    "She had your dark suit in greasy wash water all year",
    "Ask me to carry an oily rag like that. She had your dark suit in "
    "greasy wash water all year. Do they make it",
)


def run_main(main_fn, argv):
    """``main_fn(argv)`` (an entry point that returns its exit code) in this
    process with the launch counters at 0: (the lines it printed, wall
    seconds, launches by kernel)."""
    from text2video_tpu_torch.ops import fused_pose, fused_resblock

    buf = io.StringIO()
    fused_resblock.launches = 0
    fused_pose.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"{main_fn.__module__} {argv[0]} returned {rc}")
    launches = {"conv3x3_stats": fused_resblock.launches,
                "synthesize_and_smooth": fused_pose.launches}
    return buf.getvalue().strip().splitlines(), wall, launches


def run_cli(argv):
    """``cli.main(argv)`` through :func:`run_main`: (the JSON of its last
    line, wall seconds, launches by kernel)."""
    from text2video_tpu_torch import cli

    lines, wall, launches = run_main(cli.main, argv)
    return json.loads(lines[-1]), wall, launches


def check_mp4(out: dict, hw) -> None:
    """The run's mp4 holds ``out["frames"]`` frames of ``hw`` that are not
    constant."""
    import cv2

    mp4 = next(f for f in out["files"] if f.endswith(".mp4"))
    cap = cv2.VideoCapture(mp4)
    frames = []
    ok, img = cap.read()
    while ok:
        frames.append(img)
        ok, img = cap.read()
    cap.release()
    check(len(frames) == out["frames"],
          f"{mp4}: {len(frames)} frames, the run said {out['frames']}")
    stack = np.stack(frames)
    check(stack.shape[1:3] == tuple(hw), f"{mp4}: frames {stack.shape}")
    check(stack[0].std() > 1.0 and np.abs(
        stack[-1].astype(int) - stack[0].astype(int)).max() > 0,
        f"{mp4}: constant frames")


def check_launches(name: str, launches: dict, steps: int, b2: int) -> None:
    check(launches["conv3x3_stats"] == 18 * steps,
          f"{name}: B1 launched {launches['conv3x3_stats']} times, not 18 "
          f"a generator step ({steps} steps)")
    check(launches["synthesize_and_smooth"] == b2,
          f"{name}: B2 launched {launches['synthesize_and_smooth']} times, "
          f"not {b2}")


def device_profile(fn, steps: int):
    """Run ``fn`` (``steps`` generator steps) under ``torch.profiler``:
    (device ms a step, kernels a step, JSON of the ten longest kernels'
    [ms, launches] a step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    check(by_name, "the profiler saw no device time")
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return (busy / steps, sum(n for _, n in by_name.values()) / steps,
            json.dumps({name[:60]: [ms / steps, n / steps]
                        for name, (ms, n) in top}))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def first_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Index of the first frame where ``a`` and ``b`` differ, -1 if none."""
    ne = np.flatnonzero((a != b).reshape(len(a), -1).any(axis=1))
    return int(ne[0]) if len(ne) else -1


WIRE_EQ = 0.9999  # card against CPU coefficients: share equal (<= 1 level)


def mp4_frame_count(path: str) -> int:
    import cv2

    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def wire_phase(renderer, frames_u8: np.ndarray, run_slice) -> None:
    """The DCT wire on the card: the first CHUNK frames of the slice encoded
    and packed on the card (TF32 switched on around it, which the encode
    must ignore) and on the CPU with the port's own functions, unpacked and
    compared; the native unpack against the numpy one on the card's bytes;
    the decoded frames' PSNR against the uint8 frames; bytes a frame of
    each wire; what the muxer's worker spends a frame under each (JPEGs
    from coefficients, or cv2's I420->BGR + encode) and the AVI assembly of
    a clip of those JPEGs; and the slice run under each wire (dct, yuv420,
    yuv420, dct) with its render / render_pull / mux seconds."""
    import cv2

    from text2video_tpu_torch.io import wire_native
    from text2video_tpu_torch.io.video import (
        _assemble_avi,
        _encode_jpeg,
        yuv420_to_bgr,
    )
    from text2video_tpu_torch.ops import dct

    cfg = renderer.config
    check(cfg.wire_format == "dct" and cfg.wire_packed,
          f"the default wire is {cfg.wire_format}, packed {cfg.wire_packed}")
    n, h, w = CHUNK, *frames_u8.shape[1:3]
    x = torch.from_numpy(frames_u8[:n]).float() / 127.5 - 1.0  # on the CPU
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        card = renderer._encode_wire(x.cuda()).cpu().numpy()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    host = renderer._encode_wire(x).numpy()
    check(card.dtype == host.dtype == np.uint8 and card.shape == host.shape,
          f"wire {card.dtype} {card.shape} vs {host.dtype} {host.shape}")
    got = renderer._split_wire(card, n, h, w)
    want = renderer._split_wire(host, n, h, w)
    n_eq = sum(int((a == b).sum()) for a, b in zip(got, want))
    n_all = sum(a.size for a in got)
    max_diff = max(int(np.abs(a.astype(int) - b.astype(int)).max())
                   for a, b in zip(got, want))
    check(n_eq / n_all >= WIRE_EQ and max_diff <= 1,
          f"wire: card coefficients {n_eq / n_all:.6f} equal to the CPU's, "
          f"max {max_diff} levels apart")
    # The native unpack (the stream's) against the numpy reference.
    luma, chroma = got[0].shape, got[1].shape
    sy = dct.packed_plane_bytes(int(np.prod(luma[:-1])), luma[-1],
                                dct.W_AC_LUMA)
    su = dct.packed_plane_bytes(int(np.prod(chroma[:-1])), chroma[-1],
                                dct.W_AC_CHROMA)
    for lo, hi, shape, w_ac in ((0, sy, luma, dct.W_AC_LUMA),
                                (sy, sy + su, chroma, dct.W_AC_CHROMA),
                                (sy + su, sy + 2 * su, chroma,
                                 dct.W_AC_CHROMA)):
        check(np.array_equal(
            wire_native.unpack_plane(card[lo:hi], shape, w_ac),
            dct._unpack_plane_shift_numpy(card[lo:hi], shape, w_ac)),
            f"native unpack differs from numpy on {shape}")
    # Quality: the wire decoded (numpy and the muxer's JPEGs) and the
    # yuv420 wire, each against the uint8 frames.
    ref = frames_u8[:n, :, :, ::-1]  # BGR
    decoded = yuv420_to_bgr(*renderer._unpack_wire(card, n, h, w))
    t0 = time.perf_counter()
    jpegs = wire_native.to_jpegs(*got, h, w, quality=cfg.wire_quality)
    jpeg_ms = {"dct": (time.perf_counter() - t0) / n * 1e3}
    from_jpegs = np.stack([
        cv2.imdecode(np.frombuffer(j, np.uint8), cv2.IMREAD_COLOR)
        for j in jpegs])
    psnr_dct, psnr_jpeg = psnr(decoded, ref), psnr(from_jpegs, ref)
    # The muxer's JPEGs show the picture the wire decodes to.
    psnr_jpeg_vs_decode = psnr(from_jpegs, decoded)
    yuv_cfg = dataclasses.replace(cfg, wire_format="yuv420")
    yuv_renderer = dataclasses.replace(renderer, config=yuv_cfg)
    yuv = yuv_renderer._encode_wire(x.cuda()).cpu().numpy()
    planes = yuv_renderer._split_wire(yuv, n, h, w)
    psnr_yuv = psnr(yuv420_to_bgr(*planes), ref)
    t0 = time.perf_counter()  # the yuv420 worker's encode, as it runs it
    yuv_jpegs = [_encode_jpeg(b, 95) for b in yuv420_to_bgr(*planes)]
    jpeg_ms["yuv420"] = (time.perf_counter() - t0) / n * 1e3
    # The last step of the mux tail: the AVI of a clip's JPEGs (the slice's
    # N_FRAMES, these 64 repeated) with its audio.
    avi_s = {}
    pcm = np.zeros(N_FRAMES * 16000 // 25, "<i2")
    with tempfile.TemporaryDirectory() as tmp:
        for wire, js in (("dct", jpegs), ("yuv420", yuv_jpegs)):
            t0 = time.perf_counter()
            _assemble_avi(js * (N_FRAMES // n), pcm,
                          os.path.join(tmp, "a.avi"), 25.0, 16000, w, h)
            avi_s[wire] = time.perf_counter() - t0
    check(psnr_jpeg_vs_decode > 30.0,
          f"JPEGs {psnr_jpeg_vs_decode} dB from the wire's decode")
    # The slice under each wire, in turns.
    runs = {"dct": [], "yuv420": []}
    for wire in ("dct", "yuv420", "yuv420", "dct"):
        r = renderer if wire == "dct" else yuv_renderer
        run, wall = run_slice(r, f"wire_{wire}")
        mp4 = next(f for f in run.files if f.endswith(".mp4"))
        check(run.num_frames == N_FRAMES == mp4_frame_count(mp4),
              f"{wire} slice: {run.num_frames} frames, mp4 "
              f"{mp4_frame_count(mp4)}")
        st = run.stage_seconds
        runs[wire].append({"wall_s": round(wall, 3), **{
            k: round(st[k], 3) for k in ("render", "render_pull", "mux")}})
    phase("wire", frames=n, hw=f"{w}x{h}", quality=cfg.wire_quality,
          k_luma=cfg.wire_k_luma, k_chroma=cfg.wire_k_chroma,
          coeffs_equal_card_cpu=n_eq / n_all, coeffs=n_all,
          max_level_diff=max_diff, tf32_on_during_card_encode=True,
          bytes_per_frame_dct=card.size / n,
          bytes_per_frame_yuv420=yuv.size / n,
          jpeg_bytes_per_frame=json.dumps({
              "dct": sum(map(len, jpegs)) / n,
              "yuv420": sum(map(len, yuv_jpegs)) / n}),
          jpeg_ms_per_frame=json.dumps(jpeg_ms),
          avi_s_per_clip=json.dumps(avi_s),
          psnr_db_dct_decode=psnr_dct, psnr_db_dct_jpeg=psnr_jpeg,
          psnr_db_yuv420=psnr_yuv, psnr_db_jpeg_vs_decode=psnr_jpeg_vs_decode,
          slice_runs=json.dumps(runs))


def cli_phases(tmp: str, data: str, ckpt: str, renderer,
               fps_batch1: float) -> dict:
    """The CLI's tts, audio, tts-chinese and audio-batch commands, each
    through ``cli.main`` with the golden data directory ``data`` and
    ``renderer`` saved as the checkpoint ``ckpt`` at height 384. Returns the
    launches by path."""
    from text2video_tpu_torch.frontend.audio import save_wav
    from text2video_tpu_torch.frontend.tts import FormantTTS
    from text2video_tpu_torch.render import Renderer

    out_dir = os.path.join(tmp, "out")
    common = ["--data-dir", data, "--gan-checkpoint", ckpt, "--out", out_dir,
              "--pose-device", "device"]
    by_path = {}

    out, wall, n = run_cli(["tts", EN_TEXT, "fadg0", "f", *common])
    check_mp4(out, (384, 512))
    check_launches("cli_tts", n, out["frames"], 1)
    by_path["cli_tts"] = n
    st = out["stage_seconds"]
    phase("cli_tts", frames=out["frames"], wall_s=wall,
          frontend_host_s=st["tts"] + st["align"],
          stage_seconds=json.dumps(st), b1_launches=n["conv3x3_stats"],
          b2_launches=n["synthesize_and_smooth"])
    wav = next(f for f in out["files"] if f.endswith(".wav"))
    tts_frames = out["frames"]

    out, wall, n = run_cli(["audio", EN_TEXT, "fadg0", "--wav", wav,
                            *common])
    check_mp4(out, (384, 512))
    check(abs(out["frames"] - tts_frames) <= 2,
          f"cli_audio: {out['frames']} frames, cli_tts {tts_frames}")
    check_launches("cli_audio", n, out["frames"], 1)
    by_path["cli_audio"] = n
    phase("cli_audio", frames=out["frames"], wall_s=wall,
          stage_seconds=json.dumps(out["stage_seconds"]),
          b1_launches=n["conv3x3_stats"],
          b2_launches=n["synthesize_and_smooth"])

    out, wall, n = run_cli(["tts-chinese", ZH_TEXT, "henan", "f", *common])
    check_mp4(out, (384, 704))  # henan's 1920x1080 canvas at height 384
    check_launches("cli_tts_chinese", n, out["frames"], 1)
    by_path["cli_tts_chinese"] = n
    st = out["stage_seconds"]
    phase("cli_tts_chinese", frames=out["frames"], hw="384x704",
          wall_s=wall, frontend_host_s=st["tts"] + st["align"],
          stage_seconds=json.dumps(st), b1_launches=n["conv3x3_stats"],
          b2_launches=n["synthesize_and_smooth"])

    # audio-batch: four wavs of the port's own TTS, one generator batch.
    # Wrappers record the shapes B1 is called at, and the labels, frames and
    # renderer of the batch's render (both call through).
    pairs = []
    for i, text in enumerate(BATCH_TEXTS):
        path = os.path.join(tmp, f"utt{i}.wav")
        save_wav(path, FormantTTS().synthesize(text, 16000), 16000)
        pairs += [text, path]
    seen = {}
    render_fn = Renderer.render_many_device

    def recording_render(model, labels_u8, **kw):
        frames = render_fn(model, labels_u8, **kw)
        seen.update(model=model, labels=labels_u8, frames=frames)
        return frames

    torch.cuda.reset_peak_memory_stats()
    Renderer.render_many_device = recording_render
    try:
        with RecordB1Shapes() as shapes:
            outs, wall, n = run_cli([
                "audio-batch", "fadg0", "--data-dir", data,
                "--gan-checkpoint", ckpt, "--out", os.path.join(tmp, "batch"),
                "--pose-device", "device", *pairs])
    finally:
        Renderer.render_many_device = render_fn
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    lengths = [o["frames"] for o in outs]
    t_max = max(lengths)
    check(len(outs) == 4 and len(set(lengths)) == 4,
          f"cli_audio_batch: frames {lengths}")
    check_launches("cli_audio_batch", n, t_max, len(outs))
    # The resblocks work at 1/8 of 384x512 with 8 x base_ch channels.
    res_shape = (4, 48, 64, renderer.generator.heads.kernel.shape[2] * 8)
    check(shapes == {res_shape}, f"B1 shapes in the batch: {shapes}")
    for o in outs:
        check_mp4(o, (384, 512))
    by_path["cli_audio_batch"] = n
    render_s = outs[0]["stage_seconds"]["render"]

    # Each utterance at batch 1 on the labels the batch rendered, with the
    # CLI's renderer: frame 0 gated, the rest reported (random weights make
    # later frames chaotic), with the first frame that differs.
    model, labels, frames_b = seen["model"], seen["labels"], seen["frames"]
    singles, single_s = [], 0.0
    for i, t in enumerate(lengths):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        singles.append(model.render_many_device(labels[i:i + 1, :t])[0])
        single_s += time.perf_counter() - t0
    errs = [int(np.abs(s[0].astype(int) - frames_b[i, 0].astype(int)).max())
            for i, s in enumerate(singles)]
    check(max(errs) <= 2, f"batch frame 0 vs batch 1: max |diff| {errs}")
    psnrs = [psnr(s, frames_b[i, :len(s)]) for i, s in enumerate(singles)]
    firsts = [first_diff(s, frames_b[i, :len(s)])
              for i, s in enumerate(singles)]
    # Where the longest clip's frames part from batch 1: batch 1 again (is
    # the render deterministic?), four copies of it in one batch, and it
    # beside three rows of zero labels from the start. A row of a batch
    # must depend on its own labels and the batch size only: the four
    # copies and the row beside zero rows are gated to be equal.
    k = int(np.argmax(lengths))
    one = labels[k:k + 1, :t_max]
    alone = torch.zeros_like(labels)
    alone[k] = labels[k]
    copies = model.render_many_device(one.repeat(4, 1, 1, 1, 1))
    beside_zeros = model.render_many_device(alone)[k]
    longest = {
        "batch1_again": first_diff(model.render_many_device(one)[0],
                                   singles[k]),
        "four_copies": [first_diff(f, singles[k]) for f in copies],
        "zero_rows": first_diff(beside_zeros, singles[k]),
    }
    check(longest["batch1_again"] == -1
          and all(np.array_equal(f, copies[0]) for f in copies)
          and np.array_equal(beside_zeros, copies[0]),
          f"batch rows not independent or not deterministic: {longest}, "
          f"copies vs copy 0 {[first_diff(f, copies[0]) for f in copies]}, "
          f"beside zero rows vs copy 0 {first_diff(beside_zeros, copies[0])}")
    del copies
    # The plain instance norm's f32 statistics (the norm layers outside B1)
    # of one row, at batch 4 and alone, at the generator's widths: equal?
    norm_rows_equal = []
    for hwc in ((384, 512, 64), (192, 256, 128), (96, 128, 256),
                (48, 64, 512)):
        x = torch.randn((4, *hwc), device="cuda").to(torch.bfloat16)
        norm_rows_equal.append([torch.equal(  # E[x] and E[x^2], as the layer
            f(x).float().mean(dim=(1, 2))[k],
            f(x[k:k + 1]).float().mean(dim=(1, 2))[0])
            for f in (lambda v: v, torch.square)])
    total = sum(lengths)
    busy4, n_kernels4, top4 = device_profile(
        lambda: model.generate_device(labels[:, :PROFILE_STEPS]),
        PROFILE_STEPS)
    phase("cli_audio_batch", frames=lengths, wall_s=wall,
          stage_seconds=json.dumps(outs[0]["stage_seconds"]),
          b1_launches=n["conv3x3_stats"], b1_shapes=sorted(shapes),
          b2_launches=n["synthesize_and_smooth"],
          frame0_max_diff_vs_batch1=errs, psnr_vs_batch1_db=psnrs,
          first_diff_frame_vs_batch1=firsts,
          longest_first_diff=json.dumps(longest),
          norm_stats_row_b4_equal_b1=norm_rows_equal,
          utt_fps_batch4=total / render_s, utt_fps_batch1=total / single_s,
          generate_fps_batch1=fps_batch1, peak_mem_gib=peak_gib,
          device_ms_per_step_b4=busy4, kernels_per_step_b4=n_kernels4,
          top_ms_launches_per_step_b4=top4)
    return by_path


class RecordB1Shapes:
    """While active, ``fused_resblock.conv3x3_stats`` records the shapes it
    is called at (and calls through)."""

    def __enter__(self):
        from text2video_tpu_torch.ops import fused_resblock

        self.module, self.fn = fused_resblock, fused_resblock.conv3x3_stats
        self.shapes = set()

        def recording(x, *args, **kw):
            self.shapes.add(tuple(x.shape))
            return self.fn(x, *args, **kw)

        fused_resblock.conv3x3_stats = recording
        return self.shapes

    def __exit__(self, *exc):
        self.module.conv3x3_stats = self.fn


def timed(fn):
    """(result, wall seconds) of ``fn()`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def jacobi_phases(data: str, ckpt: str, out_dir: str, scan_renderer,
                  labels: torch.Tensor) -> dict:
    """Jacobi decoding through ``load_renderer(decode_mode="jacobi")`` on the
    slice's 256 label maps (``labels`` [256, 384, 512, 3] uint8 on the
    card), against the scan of the same checkpoint in the same call; then
    the CLI's ``tts --decode jacobi``. Returns the launches by path."""
    from text2video_tpu_torch.checkpoints import load_renderer
    from text2video_tpu_torch.config import get_profile
    from text2video_tpu_torch.ops import fused_pose, fused_resblock

    profile = get_profile("fadg0", data_dir=data)
    t = labels.shape[0]
    chunks = [labels[lo: lo + CHUNK] for lo in range(0, t, CHUNK)]
    res_ch = scan_renderer.generator.heads.kernel.shape[2] * 8

    def jacobi(sweeps):
        r = load_renderer(ckpt, profile, decode_mode="jacobi",
                          jacobi_sweeps=sweeps)
        check(r.device.type == "cuda" and r.time_bucket == CHUNK,
              f"jacobi renderer on {r.device}, bucket {r.time_bucket}")
        return r

    scan, scan_s = timed(
        lambda: scan_renderer.render_from_device_chunks(chunks, t))
    jac = jacobi(JACOBI_SWEEPS)
    jac.render_from_device_chunks(chunks[:1], CHUNK)  # warm the batch-64 path
    # The counted run.
    torch.cuda.reset_peak_memory_stats()
    fused_resblock.launches = 0
    fused_pose.launches = 0
    with RecordB1Shapes() as shapes:
        frames, jac_s = timed(
            lambda: jac.render_from_device_chunks(chunks, t))
    launches = {"conv3x3_stats": fused_resblock.launches,
                "synthesize_and_smooth": fused_pose.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_buckets = -(-t // CHUNK)
    check(launches["conv3x3_stats"] == 18 * n_buckets * JACOBI_SWEEPS,
          f"jacobi: B1 launched {launches['conv3x3_stats']} times, not 18 x "
          f"{n_buckets} buckets x {JACOBI_SWEEPS} sweeps")
    check(shapes == {(CHUNK, 48, 64, res_ch)},
          f"jacobi: B1 shapes {sorted(shapes)}")
    check(frames.shape == scan.shape == (t, 384, 512, 3)
          and frames.dtype == np.uint8, f"jacobi frames {frames.shape}")
    diff = np.abs(frames[:3].astype(int) - scan[:3].astype(int))
    check(diff[0].max() <= 1 and diff.max() <= 2,
          f"jacobi vs scan: frame 0 max |diff| {diff[0].max()}, frames 0-2 "
          f"{diff.max()}")
    check(frames.std() > 1.0, "jacobi frames are constant")
    psnrs = {JACOBI_SWEEPS: psnr(frames, scan)}
    seconds = {JACOBI_SWEEPS: jac_s}
    for k in (1, 2):
        fewer = jacobi(k)
        out, seconds[k] = timed(
            lambda: fewer.render_from_device_chunks(chunks, t))
        psnrs[k] = psnr(out, scan)
    # Where a sweep's device time goes: one sweep under the profiler.
    one = jacobi(1)
    busy, n_kernels, top = device_profile(
        lambda: one.render_from_device_chunks(chunks, t), 1)
    # A short clip decoded to the end: 8 frames, 8 sweeps, one batch of 8
    # against the scan's batch 1.
    short = labels[:8].cpu().numpy()
    jac8 = jacobi(8).render_jacobi(short, sweeps=8)
    scan8 = scan_renderer.render(short)
    phase("jacobi", frames=t, sweeps=JACOBI_SWEEPS, bucket=CHUNK,
          form="phase" if one.generator.phase_form else "plain",
          seconds=jac_s, fps=t / jac_s, scan_seconds=scan_s,
          scan_fps=t / scan_s, seconds_by_sweeps=json.dumps(seconds),
          device_ms_per_sweep=busy, kernels_per_sweep=n_kernels,
          top_ms_launches_per_sweep=top, peak_mem_gib=peak_gib,
          b1_launches=launches["conv3x3_stats"], b1_shapes=sorted(shapes),
          psnr_vs_scan_db_by_sweeps=json.dumps(psnrs),
          frame0_max_diff=int(diff[0].max()),
          frames012_max_diff=int(diff.max()),
          first_diff_frame=first_diff(frames, scan),
          clip8_sweeps8_first_diff=first_diff(jac8, scan8),
          clip8_sweeps8_psnr_db=psnr(jac8, scan8))
    by_path = {"jacobi": launches}

    sweeps = 2
    with RecordB1Shapes() as shapes:
        out, wall, n = run_cli([
            "tts", EN_TEXT, "fadg0", "f", "--data-dir", data,
            "--gan-checkpoint", ckpt, "--out", out_dir, "--pose-device",
            "device", "--decode", "jacobi", "--sweeps", str(sweeps)])
    check_mp4(out, (384, 512))
    full, tail = divmod(out["frames"], CHUNK)
    check(n["conv3x3_stats"] == 18 * (full + bool(tail)) * sweeps
          and n["synthesize_and_smooth"] == 1,
          f"cli_tts_jacobi: launches {n} for {out['frames']} frames")
    check(shapes == {(b, 48, 64, res_ch) for b in (CHUNK, tail) if b},
          f"cli_tts_jacobi: B1 shapes {sorted(shapes)}")
    phase("cli_tts_jacobi", frames=out["frames"], sweeps=sweeps, wall_s=wall,
          stage_seconds=json.dumps(out["stage_seconds"]),
          b1_launches=n["conv3x3_stats"], b1_shapes=sorted(shapes),
          b2_launches=n["synthesize_and_smooth"])
    by_path["cli_tts_jacobi"] = n
    return by_path


FLOPS_PER_FRAME = 395531255808  # the 512x384 generator's convs (bench.py)


def run_bench(argv):
    """``cli.main(["bench", *argv])`` through :func:`run_main`, with every
    ``Text2VideoPipeline.synthesize`` it makes recorded: (its one JSON line,
    wall seconds, launches by kernel, frames of each pipeline run). The line
    must name this card."""
    from text2video_tpu_torch import cli
    from text2video_tpu_torch.pipeline import Text2VideoPipeline

    frames, synthesize = [], Text2VideoPipeline.synthesize

    def recording(self, *args, **kw):
        run = synthesize(self, *args, **kw)
        frames.append(run.num_frames)
        return run

    Text2VideoPipeline.synthesize = recording
    try:
        lines, wall, n = run_main(cli.main, ["bench", *argv])
    finally:
        Text2VideoPipeline.synthesize = synthesize
    check(len(lines) == 1, f"bench {argv} printed {lines}")
    line = json.loads(lines[0])
    card = line["device"]
    check(card["name"] == torch.cuda.get_device_name(0)
          and card["power_limit"].endswith(" W"),
          f"bench {argv}: device {card}")
    check(line["value"] > 0, f"bench {argv}: {line}")
    return line, wall, n, frames


def check_mfu(name: str, mfu, flops_per_s: float) -> None:
    """``mfu`` is in (0, 1] and is ``flops_per_s`` over the H100's dense
    bf16 peak. The bench rounds ``mfu`` to 4 places from the unrounded rate
    and prints the rate to 2, so the two agree to half a unit of the 4th
    place and the rate's rounding (6e-5 together)."""
    check(mfu is not None and 0 < mfu <= 1
          and abs(mfu - flops_per_s / PEAK_BF16) <= 6e-5,
          f"{name}: mfu {mfu} for {flops_per_s:.4g} FLOP/s")


def bench_phases() -> dict:
    """The port's bench, as ``python -m text2video_tpu_torch.cli bench``
    runs it (full size: 512x384, base 64, 9 resblocks, bf16, 256 frames), in
    three modes: ``gen`` (batch 1 and the batch-4 extra), ``jacobi
    --sweeps 3`` and ``e2e``. Each line is checked and B1 counted: 18
    launches a generator call (a warm run and three timed ones at each batch
    in ``gen``; a warm run and three of 3 sweeps x 4 buckets in ``jacobi``;
    a warm run and two of ``e2e``, with B2 once a run). Returns the launches
    by path and the ``gen`` line's batch-1 rate."""
    by_path = {}
    timed_runs = 1 + 3

    line, wall, n, _ = run_bench(["--mode", "gen"])
    check(line["metric"] == "pose2frame_generation_fps_512x384_1chip"
          and line["flops_per_frame"] == FLOPS_PER_FRAME,
          f"bench_gen: {line}")
    check_mfu("bench_gen", line["mfu"], FLOPS_PER_FRAME * line["value"])
    check_mfu("bench_gen batch4", line["batch4"]["mfu"],
              FLOPS_PER_FRAME * line["batch4"]["fps"])
    check_launches("bench_gen", n, 2 * timed_runs * N_FRAMES, 0)
    gen_fps = line["value"]
    by_path["bench_gen"] = n
    phase("bench_gen", wall_s=wall, b1_launches=n["conv3x3_stats"],
          line=json.dumps(line))

    line, wall, n, _ = run_bench(["--mode", "jacobi", "--sweeps",
                                  str(JACOBI_SWEEPS)])
    check(line["metric"]
          == f"pose2frame_jacobi{JACOBI_SWEEPS}_fps_512x384_1chip",
          f"bench_jacobi: {line}")
    check_mfu("bench_jacobi", line["mfu"], FLOPS_PER_FRAME * line["value"])
    check_mfu("bench_jacobi executed", line["mfu_executed"],
              JACOBI_SWEEPS * FLOPS_PER_FRAME * line["value"])
    check_launches("bench_jacobi", n,
                   timed_runs * JACOBI_SWEEPS * N_FRAMES // CHUNK, 0)
    by_path["bench_jacobi"] = n
    phase("bench_jacobi", wall_s=wall, b1_launches=n["conv3x3_stats"],
          line=json.dumps(line))

    line, wall, n, frames = run_bench(["--mode", "e2e"])
    check(line["metric"] == "e2e_text2video_realtime_factor_512x384_1chip"
          and {"pose_synthesis", "rasterize", "render", "mux"}
          <= set(line["stage_seconds"]), f"bench_e2e: {line}")
    check(len(frames) == 3 and len(set(frames)) == 1 and frames[0] > 0,
          f"bench_e2e: pipeline runs of {frames} frames")
    check_launches("bench_e2e", n, sum(frames), len(frames))
    by_path["bench_e2e"] = n
    phase("bench_e2e", wall_s=wall, frames=frames,
          b1_launches=n["conv3x3_stats"],
          b2_launches=n["synthesize_and_smooth"], line=json.dumps(line))
    return by_path, gen_fps


class RecordTrainSteps:
    """While active, every step ``train_gan`` takes is timed and its metrics
    read, through a wrapper around the step the loop builds: ``records``
    holds (seconds, metrics) per step; appending True to ``profile_next``
    runs the next step under the profiler (its ``device_profile`` goes to
    ``profiles``, its seconds are nan)."""

    def __enter__(self):
        from text2video_tpu_torch.train import loop

        self.loop, self.make_step = loop, loop.make_train_step
        self.records, self.profiles, self.profile_next = [], [], []

        def recording_make(cfg, **kw):
            step = self.make_step(cfg, **kw)

            def recorded(state, batch):
                if self.profile_next and self.profile_next.pop():
                    out = []
                    self.profiles.append(device_profile(
                        lambda: out.append(step(state, batch)), 1))
                    (state, metrics), seconds = out[0], float("nan")
                else:
                    (state, metrics), seconds = timed(
                        lambda: step(state, batch))
                self.records.append((seconds, {k: float(v)
                                               for k, v in metrics.items()}))
                return state, metrics

            return recorded

        loop.make_train_step = recording_make
        return self

    def __exit__(self, *exc):
        self.loop.make_train_step = self.make_step


def run_train(rec: RecordTrainSteps, argv, steps: int, ckpt: str):
    """``train-gan`` (``argv``) for ``steps`` more steps under ``rec``: (the
    step the run ended at, this run's (seconds, metrics) records, the lines
    it printed). Every metric must be finite and no inference kernel
    launched."""
    from text2video_tpu_torch import cli
    from text2video_tpu_torch.train import trainer

    del rec.records[:]
    lines, _, n = run_main(cli.main, argv + ["--steps", str(steps)])
    out = json.loads(lines[-1])
    check(n["conv3x3_stats"] == 0 and n["synthesize_and_smooth"] == 0,
          f"train-gan launched an inference kernel: {n}")
    check(len(rec.records) == steps, f"{len(rec.records)} steps recorded")
    for _, metrics in rec.records:
        check(set(metrics) == set(trainer.METRICS)
              and all(np.isfinite(v) for v in metrics.values()),
              f"train-gan metrics not finite: {metrics}")
    check(out["ckpt"] == ckpt, f"train-gan printed {out}")
    return out["steps"], list(rec.records), lines


def state_diff(a, b, path: str = ""):
    """(tensors that differ, the largest |difference|, the path of that
    tensor, tensors) between two nested dicts / lists of tensors and plain
    values of one layout."""
    if isinstance(a, torch.Tensor):
        if torch.equal(a, b):
            return 0, 0.0, "", 1
        return 1, float((a.double() - b.double()).abs().max()), path, 1
    if isinstance(a, dict):
        check(a.keys() == b.keys(), f"state keys differ at {path}")
        parts = [state_diff(a[k], b[k], f"{path}/{k}") for k in a]
    elif isinstance(a, (list, tuple)):
        parts = [state_diff(x, y, f"{path}/{i}")
                 for i, (x, y) in enumerate(zip(a, b))]
    else:
        check(a == b, f"state values differ at {path}: {a} != {b}")
        return 0, 0.0, "", 0
    worst = max(parts, key=lambda p: p[1], default=(0, 0.0, "", 0))
    return (sum(p[0] for p in parts), worst[1], worst[2],
            sum(p[3] for p in parts))


def repeat_phase(tmp: str, train_argv) -> None:
    """Two ``train-gan`` runs with one seed, data and flags (``train_argv``
    without its ``--ckpt``, plus ``--device-data``), 3 steps each from a
    fresh directory, must give bit-equal losses at every step and bit-equal
    weights and Adam moments. Beside them, in turns, two runs with the train
    step's deterministic scope replaced by a null context (PyTorch's
    deterministic mode off: cuDNN picks its algorithms freely and the index
    backwards add by atomics; the reflect pad keeps its ordered backward),
    to show what the scope costs (step 2's wall seconds; step 3 of the first
    run of each kind under the profiler) and whether those runs repeat."""
    from text2video_tpu_torch.checkpoints import STATE_NAME, latest_step_dir
    from text2video_tpu_torch.train import loop, trainer

    steps, scope, runs, grads = 3, trainer.deterministic_algorithms, {}, {}
    with RecordTrainSteps() as rec:
        make_step = loop.make_train_step

        def first_grads_make(cfg, **kw):  # keeps each run's first gradients
            step = make_step(cfg, **kw)

            def stepped(state, batch):
                out = step(state, batch)
                grads.setdefault(name, {
                    f"{net}.{k}": p.grad.cpu()
                    for net, mod in (("G", state.generator),
                                     ("D", state.discriminators))
                    for k, p in mod.named_parameters()})
                return out

            return stepped

        loop.make_train_step = first_grads_make
        try:
            for name in ("off_a", "on_a", "on_b", "off_b"):
                ckpt = os.path.join(tmp, f"repeat_{name}")
                rec.profile_next[:] = ([name.endswith("_a")]
                                       + [False] * (steps - 1))
                if name.startswith("off"):
                    trainer.deterministic_algorithms = contextlib.nullcontext
                try:
                    _, recs, _ = run_train(
                        rec, train_argv + ["--ckpt", ckpt, "--device-data"],
                        steps, ckpt)
                finally:
                    trainer.deterministic_algorithms = scope
                state = torch.load(os.path.join(latest_step_dir(ckpt),
                                                STATE_NAME),
                                   map_location="cpu", weights_only=True)
                runs[name] = dict(metrics=[m for _, m in recs], state=state,
                                  step_s=[s for s, _ in recs[1:-1]],
                                  device=(rec.profiles.pop()[:2]
                                          if name.endswith("_a") else None))
        finally:
            loop.make_train_step = make_step
    on = state_diff(runs["on_a"]["state"], runs["on_b"]["state"])
    off = state_diff(runs["off_a"]["state"], runs["off_b"]["state"])
    on_grads = state_diff(grads["on_a"], grads["on_b"])
    check(runs["on_a"]["metrics"] == runs["on_b"]["metrics"] and on[0] == 0
          and on_grads[0] == 0,
          f"train-gan did not repeat: losses {runs['on_a']['metrics']} vs "
          f"{runs['on_b']['metrics']}; {on[0]} of {on[3]} tensors differ, by "
          f"up to {on[1]} at {on[2]}; first gradients {on_grads}")
    # Where the first step's gradients part without the scope: each tensor's
    # largest difference over its network's largest gradient.
    scale = {net: max(float(g.abs().max()) for k, g in grads["off_a"].items()
                      if k.startswith(net)) for net in ("G.", "D.")}
    apart = sorted(
        ((float((g - grads["off_b"][k]).abs().max()) / scale[k[:2]], k)
         for k, g in grads["off_a"].items()), reverse=True)

    def spread(mode):
        a, b = runs[f"{mode}_a"], runs[f"{mode}_b"]
        return dict(step_s=a["step_s"] + b["step_s"],
                    device_ms=a["device"][0], kernels=a["device"][1])

    phase("train_repeat", hw="512x384", batch=2, clip_len=8, steps=steps,
          losses_equal=True, tensors_equal=f"{on[3]}/{on[3]}",
          without_scope_losses_equal=(runs["off_a"]["metrics"]
                                      == runs["off_b"]["metrics"]),
          without_scope_tensors_differ=f"{off[0]}/{off[3]}",
          without_scope_max_diff=off[1], without_scope_worst=off[2],
          without_scope_first_grads_differ=(
              f"{sum(d > 0 for d, _ in apart)}/{len(apart)}"),
          without_scope_first_grads_most_apart=json.dumps(apart[:4]),
          without_scope_first_step_losses_equal=(
              runs["off_a"]["metrics"][0] == runs["off_b"]["metrics"][0]),
          g_loss_by_step=[m["g_loss"] for m in runs["on_a"]["metrics"]],
          after=json.dumps(spread("on")), before=json.dumps(spread("off")))


def repeat_variants_phase(base, device: str) -> None:
    """The train step's deterministic scope under the configurations the
    ``train-gan`` phases do not reach, each its own backward: VGG's loss
    (``use_vgg``, random filters: max-pool), ``bptt`` (the warp's gather
    into the frames fed back) and a generator with a local enhancer (the
    nearest resize; built by hand, as the trainer builds none). Each runs
    twice from seed 0 for two steps of ``trainer.make_train_step`` on one
    seeded batch of 2 clips of 4 frames at ``base``'s size, and must give
    bit-equal losses and weights."""
    from text2video_tpu_torch.models.generator import CompositeGenerator
    from text2video_tpu_torch.train import trainer

    g = torch.Generator(device=device).manual_seed(0)
    shape = (2, 4, base.height, base.width, 3)
    batch = {
        "labels": torch.rand(shape, device=device, generator=g) * 2 - 1,
        "reals": torch.rand(shape, device=device, generator=g) * 2 - 1,
        "face_centers": torch.full((2, 4, 2), base.height / 2.0,
                                   device=device),
    }

    def run(cfg, local: bool):
        state = trainer.create_trainer_state(cfg, seed=0, device=device)
        if local:
            gen = CompositeGenerator(
                3 * (cfg.n_frames_ctx + cfg.use_prev_frames),
                base_ch=cfg.base_ch, n_blocks=cfg.n_blocks, dtype=cfg.dtype,
                n_local_enhancers=1, fused_resblocks=False)
            gen.reset_parameters(torch.Generator().manual_seed(0))
            state.generator = gen.to(device).train()
            state.g_opt = torch.optim.Adam(gen.parameters(), lr=cfg.lr,
                                           betas=(cfg.beta1, 0.999), eps=1e-8)
        step, losses = trainer.make_train_step(cfg), []
        for _ in range(2):
            (state, metrics), seconds = timed(lambda: step(state, batch))
            losses.append({k: float(v) for k, v in metrics.items()})
        weights = {net: {k: v.detach().cpu() for k, v in
                         getattr(state, net).state_dict().items()}
                   for net in ("generator", "discriminators")}
        return losses, weights, seconds

    out = {}
    for name, cfg, local in (
            ("vgg", dataclasses.replace(base, use_vgg=True), False),
            ("bptt", dataclasses.replace(base, bptt=True), False),
            ("local_enhancer", base, True)):
        (la, wa, _), (lb, wb, s) = run(cfg, local), run(cfg, local)
        diff = state_diff(wa, wb)
        check(la == lb and diff[0] == 0 and all(
            np.isfinite(v) for m in la for v in m.values()),
            f"{name}: train steps did not repeat: losses {la} vs {lb}; "
            f"{diff[0]} of {diff[3]} tensors differ, by up to {diff[1]} at "
            f"{diff[2]}")
        out[name] = dict(tensors_equal=f"{diff[3]}/{diff[3]}",
                         g_loss=[m["g_loss"] for m in la], step2_s=s)
    phase("train_repeat_variants", hw=f"{base.width}x{base.height}", batch=2,
          clip_len=4, steps=2, losses_equal=True, by_config=json.dumps(out))


def train_phases(tmp: str, labels: torch.Tensor):
    """``train-gan`` through ``cli.main`` at full width on a data set written
    from the golden frames (steps, resume, the directory as a renderer
    checkpoint, ``jacobi_quality`` on it, three variants of a step), a tiny
    f32 model's gradients on the card against the CPU's, and one step at
    896x512; then :func:`workflow_phases` on the same data set. Returns the
    launches by path (none in training: it runs plain convs, as in the JAX
    package) and what :func:`mesh_phases` holds its data-parallel run
    against: the ``train-gan`` arguments and the first run's steps."""
    from text2video_tpu_torch.checkpoints import (
        STATE_NAME,
        latest_step_dir,
        load_renderer,
    )
    from text2video_tpu_torch.config import get_profile
    from text2video_tpu_torch.golden import write_training_assets
    from text2video_tpu_torch.ops import fused_resblock
    from text2video_tpu_torch.tools import jacobi_quality
    from text2video_tpu_torch.train import trainer

    batch_size, clip_len = 2, 8
    images, keypoints = write_training_assets(
        os.path.join(tmp, "train"), n_frames=24, canvas=(512, 384))
    ckpt = os.path.join(tmp, "gan")
    base_argv = ["train-gan", "--images", images, "--keypoints", keypoints,
                 "--width", "512", "--height", "384", "--clip-len",
                 str(clip_len), "--batch-size", str(batch_size)]
    argv = base_argv + ["--ckpt", ckpt]

    def train(extra, steps):
        return run_train(steps_rec, argv + extra, steps, ckpt)

    with RecordTrainSteps() as steps_rec:
        profile_next, profiles = steps_rec.profile_next, steps_rec.profiles
        torch.cuda.reset_peak_memory_stats()
        (step_n, recs, _), wall = timed(
            lambda: train(["--device-data"], 3))
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check(step_n == 3, f"train-gan ended at step {step_n}")
        train_ref = dict(argv=base_argv + ["--device-data"],
                         first_metrics=recs[0][1],
                         step_s=[s for s, _ in recs[1:]])
        # G and every discriminator moved away from the seed's init.
        cfg = trainer.TrainConfig(height=384, width=512)
        init = trainer.create_trainer_state(cfg, seed=0)
        saved = torch.load(os.path.join(latest_step_dir(ckpt), STATE_NAME),
                           map_location="cuda", weights_only=True)
        check(saved["step"] == 3, f"saved step {saved['step']}")
        moved = {"generator": 0.0}
        for k, v in init.generator.state_dict().items():
            moved["generator"] += float(
                (v - saved["generator"][k]).abs().sum())
        for k, v in init.discriminators.state_dict().items():
            name = k.split(".")[0]
            moved[name] = moved.get(name, 0.0) + float(
                (v - saved["discriminators"][k]).abs().sum())
        check(set(moved) == {"generator", "image", "face", "temporal",
                             "temporal2"} and all(
            np.isfinite(v) and v > 0 for v in moved.values()),
            f"parameters did not move: {moved}")
        del init, saved
        step_s = [s for s, _ in recs[1:]]
        phase("train_gan", hw="512x384", batch=batch_size, clip_len=clip_len,
              steps=step_n, wall_s=wall, first_step_s=recs[0][0],
              step_s=step_s,
              clip_frames_per_s=batch_size * clip_len / float(
                  np.median(step_s)),
              peak_mem_gib=peak_gib, metrics_last=json.dumps(recs[-1][1]),
              moved_abs_sum=json.dumps(moved), b1_launches=0)

        # A second call resumes; its one step runs under the profiler.
        profile_next.append(True)
        step_n, recs, _ = train(["--device-data"], 1)
        check(step_n == 4, f"resumed run ended at step {step_n}, not 4")
        busy, n_kernels, top = profiles[-1]
        phase("train_gan_resume", steps=step_n, device_ms_per_step=busy,
              kernels_per_step=n_kernels, top_ms_launches_per_step=top)
        variants = {}
        for name, extra in (
                ("grad_accum_2", ["--device-data", "--grad-accum", "2"]),
                ("lambda_adv_0", ["--device-data", "--lambda-adv", "0"]),
                ("host_data", [])):
            torch.cuda.reset_peak_memory_stats()
            step_n, recs, _ = train(extra, 2)
            variants[name] = dict(
                step_s=recs[1][0], g_loss=recs[1][1]["g_loss"],
                d_loss=recs[1][1]["d_loss"],
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        check(step_n == 10, f"the variants ended at step {step_n}, not 10")
        check(variants["lambda_adv_0"]["d_loss"] == 0.0,
              f"lambda_adv=0 gave d_loss {variants['lambda_adv_0']}")
        phase("train_gan_variants", second_step_of_each=json.dumps(variants))
    plain_step_s = float(np.median(step_s))

    # The training directory is a renderer checkpoint: 8 frames through B1.
    renderer = load_renderer(ckpt, get_profile("fadg0"))
    fused_resblock.launches = 0
    frames = renderer.render_from_device_chunks([labels[:CHUNK]], 8)
    n_b1 = fused_resblock.launches
    check(n_b1 == 18 * 8,
          f"trained renderer: B1 launched {n_b1} times for 8 frames")
    check(frames.shape == (8, 384, 512, 3) and frames.std() > 0,
          f"trained renderer frames {frames.shape}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = jacobi_quality.main(["--ckpt", ckpt, "--images", images,
                                  "--keypoints", keypoints, "--clip-len",
                                  "16", "--sweeps", "1,2,3,4"])
    quality = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(rc == 0 and quality["frames"] == 16 and all(
        np.isfinite(v) for v in quality["psnr_vs_scan"].values()),
        f"jacobi_quality: {quality}")
    phase("train_gan_renders", frames=8, b1_launches=n_b1,
          jacobi_quality=json.dumps(quality))
    # A batch row against batch 1 on these few-step weights: four 64-frame
    # clips of the slice as one batch, and each alone.
    rows = labels[:4 * CHUNK].reshape(4, CHUNK, *labels.shape[1:])
    batched = renderer.render_many_device(rows)
    alone = [renderer.render_many_device(rows[i:i + 1])[0] for i in range(4)]
    phase("batch_rows_ckpt", ckpt_step=step_n, rows=4, frames=CHUNK,
          first_diff_frame=[first_diff(a, batched[i])
                            for i, a in enumerate(alone)],
          max_diff=[int(np.abs(a.astype(int) - batched[i].astype(int)).max())
                    for i, a in enumerate(alone)],
          psnr_db=[psnr(a, batched[i]) for i, a in enumerate(alone)])
    del renderer, batched, alone

    # ---- the autograd path on the card against the CPU ----------------------
    tiny = trainer.TrainConfig(height=32, width=32, face_crop=8, base_ch=8,
                               n_blocks=1, d_base_ch=8, use_vgg=False,
                               dtype=torch.float32)
    rng = np.random.RandomState(0)
    host_batch = {
        "labels": rng.rand(2, 5, 32, 32, 3).astype(np.float32) * 2 - 1,
        "reals": rng.rand(2, 5, 32, 32, 3).astype(np.float32) * 2 - 1,
        "face_centers": (rng.rand(2, 5, 2) * 32).astype(np.float32),
    }
    grads = {}
    for dev in ("cuda", "cpu"):
        state = trainer.create_trainer_state(tiny, seed=0, device=dev)
        with torch.no_grad():  # flows of a few pixels, as a trained model's
            state.generator.heads.kernel.mul_(0.1)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host_batch.items()}
        state, metrics = trainer.make_train_step(tiny)(state, batch)
        grads[dev] = (
            {"G." + k: p.grad.cpu()
             for k, p in state.generator.named_parameters()}
            | {"D." + k: p.grad.cpu()
               for k, p in state.discriminators.named_parameters()},
            {k: float(v) for k, v in metrics.items()})
    worst = {}
    for net in ("G.", "D."):
        names = [k for k in grads["cpu"][0] if k.startswith(net)]
        # A bias in front of an instance norm has a zero gradient, computed
        # as float noise: such a tensor is held to a hundredth of the
        # network's largest gradient.
        floor = 1e-2 * max(float(grads["cpu"][0][k].abs().max())
                           for k in names)
        check(floor > 0, f"{net} gradients on the CPU are all zero")
        worst[net] = max(
            float((grads["cuda"][0][k] - grads["cpu"][0][k]).abs().max())
            / max(float(grads["cpu"][0][k].abs().max()), floor)
            for k in names)
    check(max(worst.values()) <= GRAD_TOL,
          f"card vs CPU gradients, relative to each tensor's largest: {worst}")
    phase("train_grad_card", hw="32x32", base_ch=8, n_blocks=1,
          worst_rel_err=json.dumps(worst), tol=GRAD_TOL,
          g_loss_card=grads["cuda"][1]["g_loss"],
          g_loss_cpu=grads["cpu"][1]["g_loss"])
    repeat_phase(tmp, base_argv)
    repeat_variants_phase(trainer.TrainConfig(height=384, width=512), "cuda")

    # ---- one step at 896x512, batch 4 x clip 8, reconstruction only ---------
    big = trainer.TrainConfig(height=512, width=896, lambda_adv=0.0,
                              grad_accum=1)
    check(trainer.safe_grad_accum(big, 4, 8) == 1,
          "safe_grad_accum raised the accumulation at 896x512")
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {
        "labels": torch.rand((4, 8, 512, 896, 3), device="cuda",
                             generator=g) * 2 - 1,
        "reals": torch.rand((4, 8, 512, 896, 3), device="cuda",
                            generator=g) * 2 - 1,
        "face_centers": torch.full((4, 8, 2), 256.0, device="cuda"),
    }
    state = trainer.create_trainer_state(big, seed=0)
    torch.cuda.reset_peak_memory_stats()
    (state, metrics), seconds = timed(
        lambda: trainer.make_train_step(big)(state, batch))
    metrics = {k: float(v) for k, v in metrics.items()}
    finite = all(np.isfinite(v) for v in metrics.values()) and all(
        bool(torch.isfinite(p.grad).all())
        for p in state.generator.parameters())
    phase("train_896", hw="896x512", batch=4, clip_len=8, lambda_adv=0,
          grad_accum=1, finite=finite, seconds=seconds,
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
          metrics=json.dumps(metrics))
    check(finite, f"train step at 896x512 is not finite: {metrics}")
    del state, batch
    torch.cuda.empty_cache()
    by_path = {"train_gan": {"conv3x3_stats": 0, "synthesize_and_smooth": 0}}
    by_path.update(workflow_phases(tmp, images, keypoints, base_argv,
                                   plain_step_s))
    return by_path, train_ref


def unit_to_u8(x: torch.Tensor) -> torch.Tensor:
    """Frames in [-1, 1] back to the uint8 levels they were made from."""
    return torch.round((x.cpu() + 1.0) * 127.5).to(torch.uint8)


AUG_FLAGS = ["--aug-jitter", "1.5", "--aug-drop", "0.05", "--aug-face-drop",
             "0.1", "--aug-scale-crop"]
AUG_KW = dict(jitter_px=1.5, drop_prob=0.05, face_drop_prob=0.1)
EVAL_KEYS = ("psnr_db", "ssim", "mouth_psnr_db", "mouth_ssim")
REALS_TOL = 1e-5  # card against CPU bilinear resize, values in [-1, 1]


def workflow_phases(tmp: str, images: str, keypoints: str, train_argv,
                    plain_step_s: float) -> dict:
    """The rest of the training workflow at full width on the training
    phases' data set: an augmented batch on the card against the CPU from the
    same draws, ``train-gan`` with every ``--aug-*`` (``train_argv`` is the
    plain command without its ``--ckpt``; ``plain_step_s`` the plain
    device-data step of this call), ``eval_gan`` and ``eval_gan_many`` on
    snapshots of its directory, and ``make_synthetic_frames`` feeding a
    dataset. Returns the launches by path."""
    from text2video_tpu_torch.tools import (
        eval_gan,
        eval_gan_many,
        make_synthetic_frames,
    )
    from text2video_tpu_torch.tools.mouth_recipe import snapshot
    from text2video_tpu_torch.train import augment
    from text2video_tpu_torch.train.data import PoseClipDataset

    b, t, canvas = 2, 8, (512, 384)

    # ---- one augmented batch, card against CPU, from the same draws ---------
    ds = PoseClipDataset(images, keypoints, canvas=canvas, clip_len=t,
                         cache_labels=False, split="train")
    reals_u8, centers = ds.flat_reals_centers()
    host = ([torch.from_numpy(x) for x in ds.flat_track_arrays()],
            torch.from_numpy(reals_u8), torch.from_numpy(centers))
    card = ([x.cuda() for x in host[0]], host[1].cuda(), host[2].cuda())
    rng = np.random.RandomState(0)
    idx = torch.from_numpy(np.stack(
        [ds.sample_clip_indices(rng) for _ in range(b)]))
    draws = augment.draw_augment(
        b, t, torch.Generator(device="cuda").manual_seed(0), scale_crop=True,
        **AUG_KW)
    # One frame's face is blanked for certain, and one sample crops the far
    # corner of the enlarged frame.
    draws.face[0] = 0.0
    draws.crop[1] = 0.999
    draws_host = draws.to("cpu")
    scales = augment.scale_crop_scales(544.0 / 512.0 - 1.0)
    by_scale = {}
    for s in scales:
        on_card, off_card = augment.augmented_batch(
            *card, idx.cuda(), draws, canvas, scale=s, **AUG_KW)
        on_host, off_host = augment.augmented_batch(
            *host, idx, draws_host, canvas, scale=s, **AUG_KW)
        # Pixels: the card's x / 127.5 - 1 may round its last bit another way.
        label_diff = int((unit_to_u8(on_card["labels"]).int()
                          - unit_to_u8(on_host["labels"]).int()).abs().max())
        reals_err = float((on_card["reals"].cpu()
                           - on_host["reals"]).abs().max())
        check(on_card["labels"].shape == (b, t, 384, 512, 3)
              and on_card["labels"].device.type == "cuda",
              f"augmented labels {on_card['labels'].shape}")
        check(label_diff == 0,
              f"aug labels at scale {s}: card differs from CPU by "
              f"{label_diff}")
        check(reals_err <= REALS_TOL,
              f"aug reals at scale {s}: card vs CPU {reals_err}")
        check(torch.equal(off_card.cpu(), off_host)
              and torch.equal(on_card["face_centers"].cpu(),
                              on_host["face_centers"]),
              f"aug offsets or centres at scale {s} differ from the CPU's")
        drawn = float((on_host["labels"] > -1.0).float().mean())
        check(drawn > 0.002, f"aug labels at scale {s} are empty ({drawn})")
        busy, n_kernels, _ = device_profile(
            lambda: augment.augmented_batch(
                *card, idx.cuda(), draws, canvas, scale=s, **AUG_KW), 1)
        by_scale[f"{s:.4f}"] = dict(
            device_ms=busy, kernels=n_kernels, reals_err=reals_err,
            offsets=off_host.tolist(), drawn_share=drawn)
    check(by_scale[f"{scales[0]:.4f}"]["offsets"] == [[0.0, 0.0]] * b
          and by_scale[f"{scales[2]:.4f}"]["offsets"][1] == [32.0, 24.0],
          f"crop offsets {by_scale}")
    phase("aug_labels_card", batch=b, clip_len=t, hw="512x384",
          label_diff_vs_cpu=0, reals_tol=REALS_TOL,
          by_scale=json.dumps(by_scale))
    del card, on_card

    # ---- train-gan with every augmentation, its own directory ---------------
    ckpt = os.path.join(tmp, "gan_aug")
    argv = train_argv + ["--ckpt", ckpt, "--device-data", *AUG_FLAGS]
    aug_s, aug_profiles, profile_aug = [], [], []
    make_batch = augment.augmented_batch

    def recorded_batch(*args, **kw):
        if profile_aug and profile_aug.pop():
            out = []
            aug_profiles.append(device_profile(
                lambda: out.append(make_batch(*args, **kw)), 1))
            return out[0]
        out, seconds = timed(lambda: make_batch(*args, **kw))
        aug_s.append(seconds)
        return out

    snaps = [os.path.join(tmp, "snap_a"), os.path.join(tmp, "snap_b")]
    augment.augmented_batch = recorded_batch
    try:
        with RecordTrainSteps() as rec:
            torch.cuda.reset_peak_memory_stats()
            step_n, recs, lines = run_train(rec, argv, 3, ckpt)
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            check(step_n == 3 and snapshot(ckpt, snaps[0]) == 3,
                  f"augmented train-gan ended at step {step_n}")
            check(any("device-resident dataset (augmented)" in ln
                      for ln in lines),
                  f"train-gan did not log the augmented branch: {lines[:3]}")
            # The run resumes its own directory; that step's batch and the
            # step itself run under the profiler.
            profile_aug.append(True)
            rec.profile_next.append(True)
            step_n, _, lines = run_train(rec, argv, 1, ckpt)
            check(step_n == 4 and "resumed from step 3" in lines
                  and snapshot(ckpt, snaps[1]) == 4,
                  f"augmented resume ended at step {step_n}")
            step_busy, step_kernels, _ = rec.profiles[-1]
    finally:
        augment.augmented_batch = make_batch
    check(len(aug_s) == 3 and len(aug_profiles) == 1,
          f"augmented batches recorded: {len(aug_s)}, {len(aug_profiles)}")
    aug_busy, aug_kernels, aug_top = aug_profiles[0]
    step_s = [s for s, _ in recs[1:]]
    phase("train_gan_aug", hw="512x384", batch=b, clip_len=t, steps=step_n,
          flags=" ".join(AUG_FLAGS), first_step_s=recs[0][0],
          train_step_s=step_s, aug_batch_s=aug_s,
          step_with_aug_s=float(np.median(step_s) + np.median(aug_s[1:])),
          plain_device_data_step_s=plain_step_s,
          aug_device_ms=aug_busy, aug_kernels=aug_kernels,
          aug_top_ms_launches=aug_top, train_step_device_ms=step_busy,
          train_step_kernels=step_kernels, peak_mem_gib=peak_gib,
          metrics_last=json.dumps(recs[-1][1]), b1_launches=0,
          b2_launches=0)
    by_path = {"train_gan_aug": {"conv3x3_stats": 0,
                                 "synthesize_and_smooth": 0}}

    # ---- eval_gan and eval_gan_many on the two snapshots --------------------
    clips, clip_len = 2, 16
    data_args = ["--images", images, "--keypoints", keypoints, "--split",
                 "holdout", "--clips", str(clips), "--clip-len",
                 str(clip_len)]

    def evaluate(ckpt_dir):
        lines, wall, n = run_main(eval_gan.main,
                                  ["--ckpt", ckpt_dir, *data_args])
        row = json.loads(lines[-1])
        check(n["conv3x3_stats"] == 18 * clips * clip_len
              and n["synthesize_and_smooth"] == 0,
              f"eval_gan launches {n}")
        check(row["frames"] == clips * clip_len and row["split"] == "holdout"
              and row["mouth_crop_px"] == 96
              and all(np.isfinite(row[k]) for k in EVAL_KEYS),
              f"eval_gan printed {row}")
        return row, wall, n

    row_a, wall, n = evaluate(snaps[0])
    by_path["eval_gan"] = n
    phase("eval_gan", ckpt_step=3, frames=row_a["frames"], wall_s=wall,
          b1_launches=n["conv3x3_stats"], row=json.dumps(row_a))
    prefix = os.path.join(tmp, "eval_")
    lines, wall, n = run_main(
        eval_gan_many.main,
        ["--ckpts", *snaps, "--out-prefix", prefix, *data_args])
    rows = [json.loads(ln) for ln in lines]
    check(n["conv3x3_stats"] == 2 * 18 * clips * clip_len,
          f"eval_gan_many launches {n}")
    check([r.pop("ckpt") for r in rows] == snaps, "eval_gan_many ckpt names")
    for name, row in zip(("snap_a", "snap_b"), rows):
        with open(f"{prefix}{name}_holdout.json") as f:
            check({k: v for k, v in json.load(f).items() if k != "ckpt"}
                  == row, f"eval_gan_many wrote another row for {name}")
    row_b, _, _ = evaluate(snaps[1])  # a fresh renderer on the second
    check(rows[0] == row_a, f"eval_gan_many row 0 {rows[0]} != {row_a}")
    check(rows[1] == row_b,
          f"swapped weights: eval_gan_many row 1 {rows[1]} != a fresh "
          f"eval_gan's {row_b}")
    check(rows[0] != rows[1], f"the two checkpoints score the same: {rows}")
    by_path["eval_gan_many"] = n
    phase("eval_gan_many", ckpt_steps=[3, 4], wall_s=wall,
          b1_launches=n["conv3x3_stats"], rows=json.dumps(rows),
          row0_equals_eval_gan=True, row1_equals_fresh_eval_gan=True)

    # ---- synthetic frames: stage 0 of the mouth recipes (host only) ---------
    n_frames, out_dir = 12, os.path.join(tmp, "synthetic")
    t0 = time.perf_counter()
    lines, _, _ = run_main(make_synthetic_frames.main, [
        "--keypoints", keypoints, "--out", out_dir, "--width", "896",
        "--height", "512", "--source-width", "512", "--source-height", "384",
        "--limit", str(n_frames)])
    seconds = time.perf_counter() - t0
    check(len(os.listdir(out_dir)) == n_frames
          and f"wrote {n_frames} frames" in lines[-1],
          f"make_synthetic_frames: {lines}")
    ds = PoseClipDataset(out_dir, keypoints, canvas=(896, 512),
                         source_canvas=(512, 384), clip_len=8,
                         cache_labels=False)
    labels, reals, _ = ds.sample_clip(np.random.RandomState(0))
    check(ds.num_frames == n_frames and reals.shape == (8, 512, 896, 3)
          and labels.shape == reals.shape and reals.std() > 10
          and labels.std() > 1, f"dataset of synthetic frames: {reals.shape}")
    phase("synthetic_frames", frames=n_frames, hw="896x512",
          seconds_per_frame=seconds / n_frames,
          dataset_frames=ds.num_frames)
    return by_path


# ---- the mouth-selected training recipe, end to end --------------------------

RECIPE_ARGS = ["--width", "512", "--height", "384", "--source-width", "512",
               "--source-height", "384", "--recon-steps", "2", "--segments",
               "3", "--segment-steps", "1", "--eval-clips", "1",
               "--eval-clip-len", "8", "--person", "fadg0", "--clip-text",
               "She had your dark suit", "--pose-device", "device",
               "--timeout", "600"]


def recipe_phase(tmp: str, data: str) -> dict:
    """``[recipe]``: ``tools.mouth_recipe`` at the flagship generator's full
    width (512x384, base 64, 9 resblocks, bf16; batch 2 x clip 8, device
    data) on keypoints from ``golden.write_training_assets(n_frames=40)``:
    the stage-0 frames drawn from them, recon to step 2, three adversarial
    segments of one step, ``eval_gan_many --clips 1 --clip-len 8`` on the
    holdout split, the selection, the winner's train-split ``eval_gan`` and
    its ``tts "She had your dark suit" fadg0`` clip on the golden data
    directory ``data``. The train stages run as the recipe runs them, in
    subprocesses; the others run in this process, their kernel launches
    counted. Gates: each train stage resumes the step the previous one
    reached; the selection is :func:`select_checkpoint`'s on the rows; the
    mp4 holds its frames; B1 runs in the evaluations and the clip, B2 once
    in the clip. Returns the launches by path."""
    import importlib

    from text2video_tpu_torch.golden import write_training_assets
    from text2video_tpu_torch.tools import mouth_recipe

    _, keypoints = write_training_assets(os.path.join(tmp, "recipe_data"),
                                         n_frames=40)
    work = os.path.join(tmp, "recipe")
    counted = {}

    def runner(module, argv, stdout_path, timeout):
        if module == mouth_recipe.CLI and argv[0] == "train-gan":
            return mouth_recipe.run_module(module, argv, stdout_path,
                                           timeout)
        torch.cuda.empty_cache()
        lines, wall, n = run_main(importlib.import_module(module).main, argv)
        with open(stdout_path, "a") as f:
            f.write("".join(line + "\n" for line in lines))
        name = module.rsplit(".", 1)[1]
        counted["clip" if name == "cli" else name] = dict(
            wall_s=wall, launches=n, last=lines[-1] if lines else "")
        return 0

    args = mouth_recipe.parser().parse_args(
        ["--keypoints", keypoints, "--work", work, "--data-dir", data,
         *RECIPE_ARGS])
    summary, wall = timed(lambda: mouth_recipe.run_recipe(args, runner))
    stages = summary["stages"]
    check([st["stage"] for st in stages] == [0, 1, 2, 2, 2, 3, 4, 5],
          f"recipe stages {stages}")
    train = stages[1:5]
    steps = [(st["from_step"], st["step"]) for st in train]
    check(steps == [(0, 2), (2, 3), (3, 4), (4, 5)],
          f"recipe: the train stages went from and to {steps}")
    for k, st in enumerate(train[1:], start=1):
        with open(os.path.join(work, "logs", f"train{k}.log")) as f:
            check(f"resumed from step {st['from_step']}" in f.read(),
                  f"recipe: train stage {k} did not resume its directory")
    rows = summary["rows"]
    check(len(rows) == 4 and all(np.isfinite(r[k]) for r in rows
                                 for k in EVAL_KEYS),
          f"recipe: evaluation rows {rows}")
    pick = mouth_recipe.select_checkpoint(rows)
    check(summary["selected"] == rows[pick]["ckpt"],
          f"recipe selected {summary['selected']}, the rule {pick}")
    clip = json.loads(counted["clip"]["last"])
    check_mp4(clip, (384, 512))
    many, one, tts = (counted[k]["launches"] for k in (
        "eval_gan_many", "eval_gan", "clip"))
    check(many == {"conv3x3_stats": 4 * 18 * 8, "synthesize_and_smooth": 0}
          and one == {"conv3x3_stats": 18 * 8, "synthesize_and_smooth": 0},
          f"recipe evaluations launched {many}, {one}")
    check_launches("recipe clip", tts, clip["frames"], 1)
    phase("recipe", hw="512x384", base_ch=64, n_blocks=9, dtype="bf16",
          batch=2, clip_len=8, wall_s=wall,
          stage_seconds=[round(st["seconds"], 3) for st in stages],
          steps_reached=[st["step"] for st in train],
          train_runs=[len(st["runs"]) for st in train],
          rows=json.dumps([{k: r[k] for k in ("psnr_db", "mouth_psnr_db")}
                           | {"ckpt": os.path.basename(r["ckpt"])}
                           for r in rows]),
          selected=os.path.basename(summary["selected"]),
          train_eval=json.dumps(summary["train_eval"]),
          clip_frames=clip["frames"],
          b1_launches=dict(eval_gan_many=many["conv3x3_stats"],
                           eval_gan=one["conv3x3_stats"],
                           clip=tts["conv3x3_stats"]),
          b2_launches=tts["synthesize_and_smooth"],
          in_process_wall_s={k: v["wall_s"] for k, v in counted.items()})
    return {"recipe_eval_gan_many": many, "recipe_eval_gan": one,
            "recipe_clip": tts}


# ---- the host rasterizer: the golden PNGs, and the card against it -----------


def raster_host_phase() -> None:
    """``[raster_host]``: the port's bit-exact host drawing
    (``rasterize_frame_host``) of the 22 golden frames of
    ``tests/goldens/fadg0_Shehadyour`` (raw and smoothed poses), pixel-equal
    to the PNGs the original pipeline drew, and the card's device labels of
    the same keypoints (``rasterize_batch``, ``device="cuda"``) at
    whole-image SSIM >= 0.96 against it, frame by frame; host ms a frame."""
    import cv2

    from text2video_tpu_torch.io.openpose import load_keypoint_frame
    from text2video_tpu_torch.ops.rasterize import (
        SSIM_MIN,
        rasterize_batch,
        rasterize_frame_host,
        whole_ssim,
    )

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "goldens", "fadg0_Shehadyour")
    kfs, goldens = [], []
    for sub_json, sub_png in (("pose", "png"), ("pose_smooth", "png_smooth")):
        for name in sorted(os.listdir(os.path.join(root, sub_png))):
            stem = os.path.splitext(name)[0]
            kfs.append(load_keypoint_frame(
                os.path.join(root, sub_json, stem + ".json")))
            goldens.append(cv2.imread(os.path.join(root, sub_png, name)))
    size = (512, 384)
    host, seconds = timed(lambda: [rasterize_frame_host(
        k.face, k.pose, k.hand_l, k.hand_r, size) for k in kfs])
    unequal = [i for i, (h, g) in enumerate(zip(host, goldens))
               if not np.array_equal(h, g)]
    check(len(kfs) == 22 and not unequal,
          f"raster_host: frames {unequal} of {len(kfs)} differ from the "
          "golden PNGs")
    card = rasterize_batch(*[np.stack([getattr(k, a) for k in kfs]) for a in
                             ("face", "pose", "hand_l", "hand_r")],
                           size, chunk=len(kfs), device="cuda")
    ssim = [whole_ssim(c, h) for c, h in zip(card, host)]
    check(min(ssim) >= SSIM_MIN,
          f"raster_host: card labels against the host drawing, SSIM {ssim}")
    phase("raster_host", frames=len(kfs), hw="512x384",
          pixel_equal_golden_png=True, host_ms_per_frame=seconds
          / len(kfs) * 1e3, card_ssim_min=min(ssim),
          card_ssim_mean=float(np.mean(ssim)), ssim_bound=SSIM_MIN)


# ---- the mesh: ranks of torch.distributed, two on the one card (gloo) -------

MESH_BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "text2video_tpu")
MESH_WORLD = 2
MESH_TIMEOUT_S = 600.0  # the spawn's deadline; each collective has 300 s
MESH_TRAIN_STEPS = 3
# Step 1 of data-parallel train-gan (two ranks of one clip) against one
# process (one batch of two clips), bf16 compute: each loss within this share
# of the single process's.
MESH_LOSS_RTOL = 1e-2


def _sha(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _counted(fn):
    """(``fn()``, wall seconds, launches by kernel) with the counters at 0."""
    from text2video_tpu_torch.ops import fused_pose, fused_resblock

    fused_resblock.launches = 0
    fused_pose.launches = 0
    out, wall = timed(fn)
    return out, wall, {"conv3x3_stats": fused_resblock.launches,
                       "synthesize_and_smooth": fused_pose.launches}


def serve_rank(mesh, spec: dict) -> dict:
    """The serving paths of one rank of ``mesh`` (sharded over its "data"
    axis, replicated over its "model" axis), each counted: Jacobi over the
    timeline of ``spec["labels"]`` with the renderer checkpoint
    ``spec["ckpt"]``, ``render_many`` of four 64-frame clips (one warm-up
    each), and ``Text2VideoPipeline(mesh=)`` on the skeleton path (its mp4
    under ``spec["pose_out"]``). Global rank 0 saves the frames, labels and
    tracks to ``spec["out"]``. Returns each path's wall, launches and
    digest."""
    from text2video_tpu_torch import pipeline
    from text2video_tpu_torch.checkpoints import load_renderer
    from text2video_tpu_torch.config import PipelineConfig, get_profile
    from text2video_tpu_torch.golden import golden_pose_inputs
    from text2video_tpu_torch.parallel import barrier

    res = {}
    profile = get_profile("fadg0", data_dir=spec["data"])
    labels = np.load(spec["labels"])  # [256, 384, 512, 3] uint8

    def keep(name, **arrays):
        if mesh.is_main:
            np.savez(os.path.join(spec["out"], name), **arrays)

    def jacobi():
        jac = load_renderer(spec["ckpt"], profile, decode_mode="jacobi",
                            jacobi_sweeps=JACOBI_SWEEPS)
        # Warm: one bucket a data index, one sweep.
        jac.render_jacobi_sharded(labels[:CHUNK * mesh.n_data], mesh,
                                  sweeps=1)
        out = _counted(lambda: jac.render_jacobi_sharded(
            labels, mesh, sweeps=JACOBI_SWEEPS))
        del jac
        torch.cuda.empty_cache()
        return out

    # A batch-64 sweep peaks at ~16 GiB a rank: the model ranks of a data
    # index (four ranks on one card) take turns, each turn a data group.
    for turn in range(mesh.n_model):
        if turn == mesh.model_rank:
            frames, wall, n = jacobi()
        barrier(mesh)
    res["jacobi"] = dict(wall_s=wall, launches=n, sha=_sha(frames))
    keep("jacobi.npz", frames=frames)
    del frames

    scan = load_renderer(spec["ckpt"], profile)
    rows = labels[:2 * mesh.n_data * CHUNK].reshape(
        2 * mesh.n_data, CHUNK, *labels.shape[1:])
    scan.render_many(rows[:, :8], mesh=mesh)  # warm: batch 2, 8 steps
    frames, wall, n = _counted(lambda: scan.render_many(rows, mesh=mesh))
    res["render_many"] = dict(wall_s=wall, launches=n, sha=_sha(frames))
    keep("render_many.npz", frames=frames)
    del scan, frames
    torch.cuda.empty_cache()

    gprof, pdict, table, ts = golden_pose_inputs(n_frames=N_FRAMES)
    port_stage = pipeline.PoseStage
    pipeline.PoseStage = (
        lambda p, device="cpu": port_stage(p, pdict, table, device))
    try:
        pipe = pipeline.Text2VideoPipeline(
            PipelineConfig(person=gprof, out_dir=spec["pose_out"]),
            mesh=mesh)
        run, wall, n = _counted(
            lambda: pipe.synthesize(ts, "mesh", keep_arrays=True))
        tracks = pipe.pose_stage.run(ts, mesh=mesh)
    finally:
        pipeline.PoseStage = port_stage
    res["pose_raster"] = dict(
        wall_s=wall, launches=n, frames=run.num_frames,
        files=[os.path.basename(f) for f in run.files],
        stage_seconds=run.stage_seconds, sha=_sha(run.label_maps),
        tracks_sha=_sha(np.concatenate([tracks.face_smooth,
                                        tracks.pose_smooth], axis=1)))
    keep("pose_raster.npz", labels=run.label_maps,
         face=tracks.face_smooth, pose=tracks.pose_smooth)
    return res


def mesh_rank(rank: int, world: int, spec_path: str) -> None:
    """One rank of :func:`mesh_phases` (started by ``parallel.spawn`` with
    JAX and the JAX package unimportable): joins the group of
    ``spec["backend"]`` through a ``file://`` store, runs
    :func:`serve_rank` and ``train-gan`` through the port's mesh APIs, each
    counted, and writes ``rank<r>.json`` (rank 0 also the frames, labels and
    tracks) to ``spec["out"]``."""
    from text2video_tpu_torch import cli
    from text2video_tpu_torch.parallel import make_mesh
    from text2video_tpu_torch.train import loop, trainer

    with open(spec_path) as f:
        spec = json.load(f)
    mesh = make_mesh(device="cuda", backend=spec["backend"],
                     init_method="file://" + spec["store"], rank=rank,
                     world_size=world)
    out = spec["out"]
    res = dict(device=str(mesh.device), backend=mesh.backend,
               **serve_rank(mesh, spec))

    # train-gan through the CLI: the group is up, so it trains over it.
    records, sync_s = [], []
    mean, make = trainer.mean_ordered, loop.make_train_step

    def timed_mean(tensors, m):
        synced, seconds = timed(lambda: mean(tensors, m))
        sync_s.append(seconds)
        return synced

    def recording_make(cfg, **kw):
        step = make(cfg, **kw)

        def recorded(state, batch):
            (state, metrics), seconds = timed(lambda: step(state, batch))
            records.append((seconds, {k: float(v)
                                      for k, v in metrics.items()}))
            return state, metrics

        return recorded

    trainer.mean_ordered, loop.make_train_step = timed_mean, recording_make
    runs = {}
    try:
        for name in ("dp_a", "dp_b"):
            del records[:], sync_s[:]
            (lines, _, n), wall = timed(lambda: run_main(cli.main, spec[
                "train_argv"] + ["--ckpt", os.path.join(spec["train_out"],
                                                        name),
                                 "--steps", str(MESH_TRAIN_STEPS)]))
            runs[name] = dict(wall_s=wall, launches=n,
                              step_s=[s for s, _ in records],
                              sync_s=list(sync_s),
                              metrics=[m for _, m in records],
                              printed=lines[-1] if lines else None)
    finally:
        trainer.mean_ordered, loop.make_train_step = mean, make
    res["train"] = runs
    res["loaded"] = sorted(k for k, v in sys.modules.items() if v is not None
                           and k.split(".")[0] in MESH_BLOCKED)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def torchrun_phase(tmp: str) -> None:
    """``train-gan`` under ``torchrun --nproc-per-node 1`` (a mesh of one
    rank, built from torchrun's environment) and as a plain process, from one
    seed on one tiny data set: the two checkpoints must be bit-equal."""
    import subprocess

    from text2video_tpu_torch.checkpoints import STATE_NAME, latest_step_dir
    from text2video_tpu_torch.golden import write_training_assets

    root = os.path.dirname(os.path.abspath(__file__))
    images, keypoints = write_training_assets(
        os.path.join(tmp, "torchrun_data"), n_frames=24, canvas=(128, 96))
    argv = ["-m", "text2video_tpu_torch.cli", "train-gan", "--images",
            images, "--keypoints", keypoints, "--width", "128", "--height",
            "96", "--source-width", "512", "--source-height", "384",
            "--clip-len", "4", "--base-ch", "8", "--batch-size", "2",
            "--steps", "2", "--device-data"]
    env = dict(os.environ, PYTHONPATH=root)
    procs, states = {}, {}
    t0 = time.perf_counter()
    for name, launcher in (  # both at once: each takes ~30 s to start
            ("plain", []),
            ("torchrun", ["-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "1"])):
        ckpt = os.path.join(tmp, f"torchrun_{name}")
        # A session of its own: torchrun's worker goes with it on a kill.
        procs[name] = (ckpt, subprocess.Popen(
            [sys.executable, *launcher, *argv, "--ckpt", ckpt], cwd=root,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, start_new_session=True))
    try:
        for name, (ckpt, proc) in procs.items():
            _, err = proc.communicate(timeout=300)
            check(proc.returncode == 0,
                  f"train-gan ({name}) failed: {err[-2000:]}")
            states[name] = torch.load(
                os.path.join(latest_step_dir(ckpt), STATE_NAME),
                map_location="cpu", weights_only=True)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    wall = time.perf_counter() - t0
    diff = state_diff(states["plain"], states["torchrun"])
    check(states["plain"]["step"] == 2 and diff[0] == 0,
          f"torchrun's checkpoint differs from the plain run's: {diff}")
    phase("mesh_torchrun", hw="128x96", base_ch=8, batch=2, clip_len=4,
          steps=2, tensors_equal=f"{diff[3]}/{diff[3]}", wall_s=wall)


def mesh_phases(tmp: str, data: str, ckpt: str, labels: np.ndarray,
                train_ref: dict, backends=None) -> dict:
    """The port's mesh on the card: :func:`mesh_rank` in ``MESH_WORLD``
    ranks over gloo on the one card (NCCL refuses two ranks on one device),
    and, where the host has two cards or more, over NCCL across them. Each
    rank's results are held against one process's in this call:
    ``[mesh_jacobi]`` (the slice's 256 frames in 3 sweeps, bit-equal to
    ``render_jacobi``), ``[mesh_render_many]`` (four 64-frame clips, each
    rank's two rows bit-equal to ``render_many`` of those rows),
    ``[mesh_pose_raster]`` (``Text2VideoPipeline(mesh=)``: tracks byte-equal
    to ``smooth_host``, labels pixel-equal to ``rasterize_batch``, the mp4
    written once), ``[mesh_train]`` (``train-gan`` over the ranks twice:
    step 1 against the single process's, the two runs bit-equal, rank 0's
    checkpoint served by one process). ``backends``: [(backend, ranks)],
    by default as above. Returns B1's launches by path and rank."""
    from text2video_tpu_torch.checkpoints import (
        STATE_NAME,
        latest_step_dir,
        load_renderer,
    )
    from text2video_tpu_torch.config import get_profile
    from text2video_tpu_torch.golden import golden_pose_inputs
    from text2video_tpu_torch.ops.interp import (
        plan_pose_track,
        synthesize_host,
    )
    from text2video_tpu_torch.ops.rasterize import rasterize_batch
    from text2video_tpu_torch.ops.smooth import smooth_host
    from text2video_tpu_torch.parallel import spawn

    torch.cuda.empty_cache()  # the ranks share the card with this process
    root = os.path.join(tmp, "mesh")
    os.makedirs(root)
    labels_path = os.path.join(root, "labels.npy")
    np.save(labels_path, labels)
    profile = get_profile("fadg0", data_dir=data)

    # One process's results on the same inputs.
    jac = load_renderer(ckpt, profile, decode_mode="jacobi",
                        jacobi_sweeps=JACOBI_SWEEPS)
    jac.render_jacobi(labels[:CHUNK], sweeps=1)
    jac_ref, jac_s = timed(lambda: jac.render_jacobi(labels,
                                                     sweeps=JACOBI_SWEEPS))
    del jac
    scan = load_renderer(ckpt, profile)
    rows = labels[:2 * MESH_WORLD * CHUNK].reshape(2 * MESH_WORLD, CHUNK,
                                                   *labels.shape[1:])
    many_ref, many_s = timed(lambda: np.concatenate(
        [scan.render_many(rows[i: i + 2]) for i in range(0, len(rows), 2)]))
    del scan
    torch.cuda.empty_cache()
    gprof, pdict, table, ts = golden_pose_inputs(n_frames=N_FRAMES)
    plan = plan_pose_track(ts, pdict, table, gprof)
    face_s, pose_s = smooth_host(*synthesize_host(plan, table),
                                 gprof.smooth_width)
    hands = table.hands[plan.carrier]
    raster_ref = rasterize_batch(face_s, pose_s, hands[:, 0], hands[:, 1],
                                 tuple(gprof.canvas), chunk=CHUNK,
                                 device="cuda")
    single_step_s = float(np.median(train_ref["step_s"]))

    by_path = {}
    if backends is None:
        backends = [("gloo", MESH_WORLD)]
        if torch.cuda.device_count() >= MESH_WORLD:
            backends.append(("nccl", MESH_WORLD))
    for backend, world in backends:
        out = os.path.join(root, backend)
        os.makedirs(out)
        spec = dict(backend=backend, store=os.path.join(out, "store"),
                    out=out, labels=labels_path, ckpt=ckpt, data=data,
                    pose_out=os.path.join(out, "pose"),
                    train_out=os.path.join(out, "train"),
                    train_argv=train_ref["argv"])
        spec_path = os.path.join(out, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        _, spawn_s = timed(lambda: spawn(
            "chip_smoke:mesh_rank", world, (spec_path,),
            timeout_s=MESH_TIMEOUT_S, block=MESH_BLOCKED))
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        check(all(not rk["loaded"] for rk in ranks),
              f"a rank imported JAX or the JAX package: "
              f"{[rk['loaded'] for rk in ranks]}")
        from text2video_tpu_torch.bench import device_info

        cards = sorted({rk["device"] for rk in ranks})
        common = dict(backend=backend, world=world,
                      devices=[rk["device"] for rk in ranks],
                      cards=json.dumps([
                          "{name}, {power_limit}".format(
                              **device_info(torch.device(c))) for c in cards]))

        def held(name, ref):
            """(rank 0's array, max |diff| against ``ref``, first frame that
            differs, whether every rank got the same bits)."""
            got = np.load(os.path.join(out, name + ".npz"))
            key = "frames" if "frames" in got else "labels"
            arr = got[key]
            check(arr.shape == ref.shape, f"{name}: {arr.shape} vs "
                  f"{ref.shape}")
            agree = len({rk[name]["sha"] for rk in ranks}) == 1
            check(agree, f"{name}: the ranks' results differ")
            return (arr, int(np.abs(arr.astype(int) - ref.astype(int)).max()),
                    agree)

        launches = [rk["jacobi"]["launches"]["conv3x3_stats"] for rk in ranks]
        arr, diff, agree = held("jacobi", jac_ref)
        n_buckets = -(-labels.shape[0] // CHUNK) // world
        check(launches == [18 * n_buckets * JACOBI_SWEEPS] * world,
              f"mesh_jacobi: B1 launches by rank {launches}")
        check(diff == 0, f"mesh_jacobi: frames differ from one process's "
              f"by up to {diff}, first at frame {first_diff(arr, jac_ref)}")
        walls = [rk["jacobi"]["wall_s"] for rk in ranks]
        phase("mesh_jacobi", **common, frames=len(jac_ref),
              sweeps=JACOBI_SWEEPS, bucket=CHUNK, bit_equal=diff == 0,
              ranks_agree=agree, wall_s_by_rank=walls,
              single_process_wall_s=jac_s, b1_launches_by_rank=launches)
        for r, n in enumerate(launches):
            by_path[f"mesh_jacobi_{backend}_rank{r}"] = ranks[r]["jacobi"][
                "launches"]

        launches = [rk["render_many"]["launches"]["conv3x3_stats"]
                    for rk in ranks]
        arr, diff, agree = held("render_many", many_ref)
        check(launches == [18 * CHUNK] * world,
              f"mesh_render_many: B1 launches by rank {launches}")
        check(diff == 0, f"mesh_render_many: rows differ from one process's "
              f"render_many by up to {diff}")
        phase("mesh_render_many", **common, rows=len(rows), frames=CHUNK,
              rows_a_rank=len(rows) // world, bit_equal=diff == 0,
              ranks_agree=agree,
              wall_s_by_rank=[rk["render_many"]["wall_s"] for rk in ranks],
              single_process_wall_s=many_s, b1_launches_by_rank=launches)
        for r in range(world):
            by_path[f"mesh_render_many_{backend}_rank{r}"] = ranks[r][
                "render_many"]["launches"]

        pr = [rk["pose_raster"] for rk in ranks]
        got = np.load(os.path.join(out, "pose_raster.npz"))
        tracks_equal = (np.array_equal(got["face"], face_s)
                        and np.array_equal(got["pose"], pose_s))
        labels_equal = np.array_equal(got["labels"], raster_ref)
        mp4s = [f for f in os.listdir(os.path.join(out, "pose", "fadg0"))]
        check(tracks_equal and len({p["tracks_sha"] for p in pr}) == 1,
              "mesh_pose_raster: smoothed tracks differ from smooth_host's")
        check(labels_equal and len({p["sha"] for p in pr}) == 1,
              "mesh_pose_raster: labels differ from rasterize_batch's")
        check([p["files"] for p in pr] == [["mesh.mp4"]] + [[]] * (world - 1)
              and mp4s == ["mesh.mp4"] and mp4_frame_count(
                  os.path.join(out, "pose", "fadg0", "mesh.mp4")) == N_FRAMES,
              f"mesh_pose_raster: files {[p['files'] for p in pr]}, {mp4s}")
        check(all(p["launches"] == {"conv3x3_stats": 0,
                                    "synthesize_and_smooth": 0} for p in pr),
              f"mesh_pose_raster launched {[p['launches'] for p in pr]}")
        phase("mesh_pose_raster", **common, frames=N_FRAMES, hw="512x384",
              tracks_byte_equal=tracks_equal, labels_pixel_equal=labels_equal,
              files_by_rank=[p["files"] for p in pr],
              wall_s_by_rank=[p["wall_s"] for p in pr],
              stage_seconds_rank0=json.dumps(pr[0]["stage_seconds"]),
              b1_b2_launches=0)

        tr = [rk["train"] for rk in ranks]
        for run in ("dp_a", "dp_b"):
            check(all(t[run]["metrics"] == tr[0][run]["metrics"]
                      for t in tr), f"mesh_train {run}: ranks' losses differ")
            check(all(t[run]["launches"]["conv3x3_stats"] == 0 for t in tr),
                  f"mesh_train {run}: an inference kernel launched")
        check(tr[0]["dp_a"]["metrics"] == tr[0]["dp_b"]["metrics"],
              "mesh_train: two runs' losses differ")
        states = [torch.load(os.path.join(latest_step_dir(
            os.path.join(out, "train", run)), STATE_NAME),
            map_location="cpu", weights_only=True) for run in ("dp_a",
                                                               "dp_b")]
        same = state_diff(*states)
        check(states[0]["step"] == MESH_TRAIN_STEPS and same[0] == 0,
              f"mesh_train: the runs' states differ: {same}")
        first = tr[0]["dp_a"]["metrics"][0]
        ref = train_ref["first_metrics"]
        rel = {k: abs(first[k] - ref[k]) / max(abs(ref[k]), 1e-6)
               for k in ref}
        check(max(rel.values()) <= MESH_LOSS_RTOL,
              f"mesh_train: step 1 against one process, relative: {rel}")
        served = load_renderer(os.path.join(out, "train", "dp_a"), profile)
        frames, _, n = _counted(lambda: served.render_from_device_chunks(
            [torch.from_numpy(labels[:8]).cuda()], 8))
        check(n["conv3x3_stats"] == 18 * 8 and frames.std() > 0,
              f"mesh_train: the DP checkpoint served {n}")
        del served
        step_s = [t["dp_b"]["step_s"][1:] for t in tr]
        sync_s = [t["dp_b"]["sync_s"][1:] for t in tr]
        phase("mesh_train", **common, hw="512x384", batch=2, clip_len=8,
              steps=MESH_TRAIN_STEPS, runs_bit_equal=True,
              tensors_equal=f"{same[3]}/{same[3]}",
              step1_rel_diff_vs_single=json.dumps(rel),
              step1_tol=MESH_LOSS_RTOL, step_s_by_rank=step_s,
              sync_s_by_rank=sync_s,
              sync_share=float(np.sum(sync_s) / np.sum(step_s)),
              single_process_step_s=single_step_s,
              ckpt_served_b1_launches=n["conv3x3_stats"],
              spawn_wall_s=spawn_s)
    return by_path


# ---- the mesh's model axis: train-gan on a (data, model) grid -----------------

GRID_WORLD = 4
GRID_MODEL = 2
# Wide conv kernels (4-D, >= 256 output channels) of the train-gan default:
# 21 in G (two downsamples, 18 resblock convs, the first upsample) and 9 in
# the Ds (two in each of the image D's two scales, two in each temporal D,
# one in the face D).
GRID_WIDE_KERNELS = 30


def grid_rank(rank: int, world: int, spec_path: str) -> None:
    """One rank of :func:`mesh_model_phase` (started by ``parallel.spawn``
    with JAX blocked): joins the group through a ``file://`` store, runs
    ``train-gan`` (``spec["argv"]``, with its ``--n-model``) through the
    CLI, then, given ``spec["serve"]``, :func:`serve_rank` on the same
    grid, and writes ``rank<r>.json``: each step's seconds, metrics, the
    gradient sync's and the kernel gather's seconds, kernels gathered; a
    rank's parameter and Adam bytes against the whole model's; the bytes a
    micro-batch gathers; peak memory of the training; B1 and B2 launches;
    the serving paths' walls, launches and digests."""
    import datetime

    from text2video_tpu_torch import cli
    from text2video_tpu_torch.parallel import make_mesh, model_axis
    from text2video_tpu_torch.train import loop, trainer

    with open(spec_path) as f:
        spec = json.load(f)
    # The card the CLI picks for this rank (its rank modulo the cards),
    # current before anything touches CUDA.
    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.distributed.init_process_group(
        spec["backend"], init_method="file://" + spec["store"], rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300))
    records, sizes = [], {}
    mean, make = trainer.mean_ordered, loop.make_train_step
    gather = model_axis._gather_last_axis
    clock = {"sync_s": 0.0, "gather_s": 0.0}

    def timed_into(key, fn):
        def wrapped(*args):
            out, seconds = timed(lambda: fn(*args))
            clock[key] += seconds
            return out
        return wrapped

    def param_bytes(state):
        """(a rank's f32 parameters and two Adam moments, the whole model's,
        bytes of whole kernels a micro-batch gathers in the compute dtype,
        of which the other model ranks send (n - 1) / n)."""
        local = full = gathered = 0
        for net in (state.generator, state.discriminators):
            for m in net.modules():
                for name, p in m.named_parameters(recurse=False):
                    n = p.numel() * p.element_size()
                    shard = getattr(m, "shard", None) if name == "kernel" \
                        else None
                    whole = n if shard is None else (
                        n // (shard[1] - shard[0]) * shard[2])
                    local, full = local + 3 * n, full + 3 * whole
                    if shard is not None:
                        gathered += (whole // p.element_size()
                                     * torch.finfo(m.dtype).bits // 8)
        return dict(local_bytes=local, full_bytes=full,
                    gathered_bytes=gathered)

    def recording_make(cfg, **kw):
        step = make(cfg, **kw)

        def recorded(state, batch):
            if not sizes:
                sizes.update(param_bytes(state))
            clock.update(sync_s=0.0, gather_s=0.0)
            before = model_axis.gathers
            (state, metrics), seconds = timed(lambda: step(state, batch))
            records.append(dict(step_s=seconds, gathered=model_axis.gathers
                                - before, **clock,
                                metrics={k: float(v)
                                         for k, v in metrics.items()}))
            return state, metrics

        return recorded

    trainer.mean_ordered = timed_into("sync_s", mean)
    model_axis._gather_last_axis = timed_into("gather_s", gather)
    loop.make_train_step = recording_make
    try:
        torch.cuda.reset_peak_memory_stats()
        _, wall, n = run_main(cli.main, spec["argv"])
    finally:
        trainer.mean_ordered, loop.make_train_step = mean, make
        model_axis._gather_last_axis = gather
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    served = {}
    if spec.get("serve"):
        # The serving paths on the same grid, in the same ranks, with the
        # training's memory handed back first.
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        mesh = make_mesh(n_data=world // GRID_MODEL, n_model=GRID_MODEL,
                         device="cuda")
        served, serve_s = timed(lambda: serve_rank(mesh, spec["serve"]))
        served["wall_s"] = serve_s
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(dict(
            steps=records, wall_s=wall, launches=n, **sizes, serve=served,
            device=str(torch.device("cuda", torch.cuda.current_device())),
            peak_mem_gib=peak_gib,
            loaded=sorted(k for k, v in sys.modules.items() if v is not None
                          and k.split(".")[0] in MESH_BLOCKED)), f)
    torch.distributed.destroy_process_group()


def run_grid(root: str, backend: str, world: int, argv,
             serve=None) -> list:
    """``train-gan`` (``argv``) in ``world`` :func:`grid_rank` ranks over
    ``backend``, then the serving paths where ``serve`` (a
    :func:`serve_rank` spec) is given: each rank's record."""
    from text2video_tpu_torch.parallel import spawn

    os.makedirs(root)
    spec_path = os.path.join(root, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(dict(backend=backend, store=os.path.join(root, "store"),
                       out=root, argv=argv, serve=serve), f)
    spawn("chip_smoke:grid_rank", world, (spec_path,),
          timeout_s=MESH_TIMEOUT_S, block=MESH_BLOCKED)
    ranks = []
    for r in range(world):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    check(all(not rk["loaded"] for rk in ranks),
          f"a rank imported JAX or the JAX package: "
          f"{[rk['loaded'] for rk in ranks]}")
    return ranks


def mesh_train_refs(tmp: str) -> dict:
    """What ``[mesh_train]`` left for :func:`mesh_model_phase`, by backend:
    its first run's directory and its steps' metrics, the step seconds of
    its second run, and the (2, 1) ranks' serving spec and directory (their
    frames, labels and records)."""
    refs = {}
    for backend in ("gloo", "nccl"):
        out = os.path.join(tmp, "mesh", backend)
        if os.path.exists(os.path.join(out, "rank0.json")):
            with open(os.path.join(out, "rank0.json")) as f:
                train = json.load(f)["train"]
            with open(os.path.join(out, "spec.json")) as f:
                spec = json.load(f)
            refs[backend] = dict(ckpt=os.path.join(out, "train", "dp_a"),
                                 metrics=train["dp_a"]["metrics"],
                                 step_s=train["dp_b"]["step_s"][1:],
                                 serve=spec, serve_out=out)
    return refs


def grid_serve_phase(ranks: list, ref: dict, out: str, backend: str) -> dict:
    """``[mesh_model_serve]``: the serving paths that the (2, 2) ranks ran
    after training (``out``: their directory), held against the (2, 1) ranks
    of ``[mesh_jacobi]``, ``[mesh_render_many]`` and ``[mesh_pose_raster]``
    in this call (``ref["serve_out"]``, themselves bit-equal to one
    process): Jacobi's and ``render_many``'s frames bit-equal, the same
    digest on every rank (so the two model ranks of a data index return the
    same bytes), B1's launches a rank those of a (2, 1) rank, the skeleton
    pipeline's labels and tracks equal and its one mp4 written by global
    rank 0. Returns B1's launches by path and rank."""
    with open(os.path.join(ref["serve_out"], "rank0.json")) as f:
        pair = json.load(f)
    served = [rk["serve"] for rk in ranks]
    fields, by_path = {}, {}
    for path in ("jacobi", "render_many"):
        got = np.load(os.path.join(out, path + ".npz"))["frames"]
        want = np.load(os.path.join(ref["serve_out"], path + ".npz"))["frames"]
        check(got.shape == want.shape, f"mesh_model_serve {path}: "
              f"{got.shape} vs {want.shape}")
        diff = int(np.abs(got.astype(int) - want.astype(int)).max())
        shas = sorted({sv[path]["sha"] for sv in served})
        check(diff == 0 and shas == [pair[path]["sha"]],
              f"mesh_model_serve {path}: differs from the (2, 1) frames by "
              f"up to {diff}; digests {shas}")
        launches = [sv[path]["launches"]["conv3x3_stats"] for sv in served]
        check(launches == [pair[path]["launches"]["conv3x3_stats"]]
              * len(served), f"mesh_model_serve {path}: B1 by rank "
              f"{launches}")
        fields[f"{path}_bit_equal_vs_2x1"] = True
        fields[f"{path}_wall_s_by_rank"] = [sv[path]["wall_s"]
                                            for sv in served]
        fields[f"{path}_b1_launches_by_rank"] = launches
        for r, sv in enumerate(served):
            by_path[f"mesh_model_{path}_{backend}_rank{r}"] = sv[path][
                "launches"]
    pr = [sv["pose_raster"] for sv in served]
    mp4s = sorted(os.listdir(os.path.join(out, "pose", "fadg0")))
    check({p["sha"] for p in pr} == {pair["pose_raster"]["sha"]}
          and {p["tracks_sha"] for p in pr}
          == {pair["pose_raster"]["tracks_sha"]},
          "mesh_model_serve: the skeleton pipeline's labels or tracks differ "
          "from the (2, 1) run's")
    check([p["files"] for p in pr] == [["mesh.mp4"]] + [[]] * (len(pr) - 1)
          and mp4s == ["mesh.mp4"] and mp4_frame_count(
              os.path.join(out, "pose", "fadg0", "mesh.mp4")) == N_FRAMES,
          f"mesh_model_serve: files {[p['files'] for p in pr]}, {mp4s}")
    phase("mesh_model_serve", backend=backend, world=len(served),
          grid=f"{len(served) // GRID_MODEL}x{GRID_MODEL}", frames=N_FRAMES,
          sweeps=JACOBI_SWEEPS, clips=4, **fields,
          pose_raster_equal_vs_2x1=True,
          files_by_rank=[p["files"] for p in pr],
          serve_wall_s_by_rank=[sv["wall_s"] for sv in served])
    return by_path


def mesh_model_phase(tmp: str, train_argv, labels: np.ndarray,
                     refs=None) -> dict:
    """``[mesh_model]``: ``train-gan --n-model 2`` over a 2 x 2 grid of
    ranks at full width (``train_argv``: 512x384, base 64, 9 resblocks,
    bf16, batch 2 x clip 8, device data; 3 steps), held against the same
    run at ``n_model=1`` over two ranks (``refs[backend]``: its directory,
    its steps' metrics and seconds, from ``[mesh_train]``; made here when
    not given): the losses of every step and the whole weights and Adam
    moments of the two checkpoints bit-equal, each wide kernel gathered once
    a micro-batch, and the (2, 2) directory restored in one process and
    served through B1 (on ``labels``' first 8 maps). Where ``refs`` hold
    the (2, 1) ranks' serving (``mesh_train_refs``), the four ranks then
    serve on the grid: :func:`grid_serve_phase`. Four gloo ranks share the
    one card; on a host with four cards or more, four NCCL ranks take one
    each as well. Returns B1's launches by serving path and rank."""
    from text2video_tpu_torch.bench import device_info
    from text2video_tpu_torch.checkpoints import (
        STATE_NAME,
        latest_step_dir,
        load_renderer,
        restore_state,
    )
    from text2video_tpu_torch.config import get_profile
    from text2video_tpu_torch.train import trainer

    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count()
                           >= GRID_WORLD else [])
    refs = dict(refs or {})
    root = os.path.join(tmp, "mesh_model")
    by_path = {}
    for backend in backends:
        out = os.path.join(root, backend)
        if backend not in refs:
            ckpt = os.path.join(out, "ref_ckpt")
            ranks = run_grid(os.path.join(out, "ref"), backend, 2,
                             train_argv + ["--ckpt", ckpt, "--steps",
                                           str(MESH_TRAIN_STEPS)])
            refs[backend] = dict(ckpt=ckpt, metrics=[
                s["metrics"] for s in ranks[0]["steps"]],
                step_s=[s["step_s"] for s in ranks[0]["steps"][1:]])
        ref = refs[backend]
        ckpt = os.path.join(out, "grid_ckpt")
        grid_out = os.path.join(out, "grid")
        serve = None
        if "serve" in ref:
            serve = dict({k: ref["serve"][k] for k in ("labels", "ckpt",
                                                       "data")},
                         out=grid_out, pose_out=os.path.join(grid_out, "pose"))
        torch.cuda.empty_cache()  # the ranks share the card with us
        ranks, wall = timed(lambda: run_grid(
            grid_out, backend, GRID_WORLD,
            train_argv + ["--ckpt", ckpt, "--steps", str(MESH_TRAIN_STEPS),
                          "--n-model", str(GRID_MODEL)], serve))
        metrics = [[s["metrics"] for s in rk["steps"]] for rk in ranks]
        check(all(m == metrics[0] for m in metrics),
              "mesh_model: the ranks' losses differ")
        check(metrics[0] == ref["metrics"],
              f"mesh_model: losses differ from the (2, 1) run's: "
              f"{metrics[0]} vs {ref['metrics']}")
        gathered = [[s["gathered"] for s in rk["steps"]] for rk in ranks]
        check(gathered == [[GRID_WIDE_KERNELS] * MESH_TRAIN_STEPS]
              * GRID_WORLD, f"mesh_model: kernels gathered {gathered}")
        check(all(rk["launches"]["conv3x3_stats"] == 0
                  and rk["launches"]["synthesize_and_smooth"] == 0
                  for rk in ranks), "mesh_model: an inference kernel "
              f"launched: {[rk['launches'] for rk in ranks]}")
        states = [torch.load(os.path.join(latest_step_dir(d), STATE_NAME),
                             map_location="cpu", weights_only=True)
                  for d in (ckpt, ref["ckpt"])]
        same = state_diff(*states)
        check(states[0]["step"] == MESH_TRAIN_STEPS and same[0] == 0,
              f"mesh_model: the (2, 2) and (2, 1) states differ: {same}")
        del states
        # The (2, 2) directory in one process: whole tensors restore into a
        # whole state, and a renderer serves from it through B1.
        whole = restore_state(ckpt, trainer.create_trainer_state(
            trainer.TrainConfig(height=384, width=512)))
        check(whole.step == MESH_TRAIN_STEPS, f"restored {whole.step}")
        del whole
        served = load_renderer(ckpt, get_profile("fadg0"))
        frames, _, n = _counted(lambda: served.render_from_device_chunks(
            [torch.from_numpy(labels[:8]).cuda()], 8))
        check(n["conv3x3_stats"] == 18 * 8 and frames.std() > 0,
              f"mesh_model: the (2, 2) checkpoint served {n}")
        del served
        step_s = [[s["step_s"] for s in rk["steps"][1:]] for rk in ranks]
        sync_s = [[s["sync_s"] for s in rk["steps"][1:]] for rk in ranks]
        gather_s = [[s["gather_s"] for s in rk["steps"][1:]] for rk in ranks]
        cards = sorted({rk["device"] for rk in ranks})
        phase("mesh_model", backend=backend, world=GRID_WORLD,
              grid=f"{GRID_WORLD // GRID_MODEL}x{GRID_MODEL}",
              devices=[rk["device"] for rk in ranks],
              cards=json.dumps(["{name}, {power_limit}".format(
                  **device_info(torch.device(c))) for c in cards]),
              hw="512x384",
              base_ch=64, n_blocks=9, batch=2, clip_len=8,
              steps=MESH_TRAIN_STEPS, losses_bit_equal_vs_2x1=True,
              tensors_equal=f"{same[3]}/{same[3]}",
              kernels_gathered_a_microbatch=GRID_WIDE_KERNELS,
              local_param_adam_bytes_by_rank=[rk["local_bytes"]
                                              for rk in ranks],
              full_param_adam_bytes=ranks[0]["full_bytes"],
              gathered_bytes_a_microbatch=ranks[0]["gathered_bytes"],
              received_bytes_a_microbatch=ranks[0]["gathered_bytes"]
              * (GRID_MODEL - 1) // GRID_MODEL,
              step_s_by_rank=step_s, gather_s_by_rank=gather_s,
              sync_s_by_rank=sync_s,
              sync_share=float(np.sum(sync_s) / np.sum(step_s)),
              gather_share=float(np.sum(gather_s) / np.sum(step_s)),
              step_s_2x1=ref["step_s"],
              peak_mem_gib_by_rank=[rk["peak_mem_gib"] for rk in ranks],
              served_b1_launches=n["conv3x3_stats"], b1_launches=0,
              spawn_wall_s=wall)
        if serve is not None:
            by_path.update(grid_serve_phase(ranks, ref, grid_out, backend))
    return by_path


def dryrun_phase() -> dict:
    """``[dryrun_multichip]``: ``graft_entry.dryrun_multichip(4)``, the
    ranks sharing the card over gloo (one a card over NCCL on a host with
    four): its line, its wall and the ranks' B1 launches (Jacobi at base 8,
    C = 64). Returns the launches by rank."""
    from text2video_tpu_torch import graft_entry

    torch.cuda.empty_cache()
    out, wall = timed(lambda: graft_entry.dryrun_multichip(4))
    ranks = out["ranks"]
    check([(rk["data_rank"], rk["model_rank"]) for rk in ranks]
          == [divmod(r, 2) for r in range(4)], f"dryrun grid: {ranks}")
    check(all(rk["launches"]["conv3x3_stats"] > 0 for rk in ranks),
          f"dryrun_multichip: B1 not launched {[rk['launches'] for rk in ranks]}")
    check(all(rk["g_loss"] == ranks[0]["g_loss"] for rk in ranks),
          "dryrun_multichip: the ranks' losses differ")
    phase("dryrun_multichip", wall_s=wall, line=json.dumps(out["line"]),
          devices=[rk["device"] for rk in ranks],
          backend=ranks[0]["backend"],
          b1_launches_by_rank=[rk["launches"]["conv3x3_stats"]
                               for rk in ranks])
    return {f"dryrun_multichip_rank{r}": rk["launches"]
            for r, rk in enumerate(ranks)}


def entry_phase() -> dict:
    """``[entry]``: one call of ``graft_entry.entry()``'s flagship forward
    (512x384, base 64, 9 resblocks, bf16) on the card, 18 B1 launches
    counted, finite outputs of the expected shapes."""
    from text2video_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    out, wall, n = _counted(lambda: fn(*args))
    frame, flow, mask = out
    check(n["conv3x3_stats"] == 18 and n["synthesize_and_smooth"] == 0,
          f"entry: launches {n}")
    check(tuple(frame.shape) == (1, 384, 512, 3)
          and tuple(flow.shape) == (1, 384, 512, 2)
          and tuple(mask.shape) == (1, 384, 512, 1)
          and all(bool(torch.isfinite(t).all()) for t in out),
          f"entry: outputs {[tuple(t.shape) for t in out]}")
    phase("entry", hw="512x384", base_ch=64, n_blocks=9, dtype="bf16",
          wall_s=wall, b1_launches=n["conv3x3_stats"])
    return {"entry": n}


# The phase forms' ops at 512x384, base 64 (name, input [H, W, C], output
# channels): the stem into down.0, the three decoder upsamples, the heads.
PHASE_OPS = [
    ("stem_down0", (384, 512, 15), 128),
    ("up0", (48, 64, 512), 256),
    ("up1", (96, 128, 256), 128),
    ("up2", (192, 256, 128), 64),
    ("heads", (384, 512, 64), 6),
]
PHASE_TOL = 2e-4  # f32, phase against plain: JAX's tests/test_phase_conv.py


def allclose_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / (PHASE_TOL * (1 + |b|)): within the bound when <= 1."""
    a, b = a.float(), b.float()
    return ((a - b).abs() / (PHASE_TOL * (1 + b.abs()))).max().item()


def phase_op_pair(name: str, c_in: int, c_out: int, dt, dev):
    """(phase form, plain form, input maker) of one op of :data:`PHASE_OPS`
    on seeded lecun weights in ``dt``; both forms return the full-res
    result (the phase form's op emits what the generator emits, and the
    comparison turns it back)."""
    from text2video_tpu_torch.models.layers import Conv, ConvBlock, reflect_pad
    from text2video_tpu_torch.ops import phase_conv as pc

    seed = torch.Generator().manual_seed(3)
    if name == "stem_down0":
        stem = ConvBlock(c_in, 64, kernel=7, dtype=dt)
        down = ConvBlock(64, c_out, stride=2, dtype=dt)
        for m in (stem, down):
            m.conv.reset_parameters(seed)
            m.to(dev)
        return (lambda x: down.from_phase(stem.phase_stem(x)),
                lambda x: down(stem(x)), None)
    if name == "heads":
        conv = Conv(c_in, c_out, kernel=7, dtype=dt)
        conv.reset_parameters(seed)
        conv.to(dev)

        def heads(p):  # as CompositeGenerator.forward runs it
            k7, b7 = conv.weights(pc.build_head_kernel)
            return pc.head_window(p, k7) + b7

        return heads, (lambda f: conv(reflect_pad(f, 3))), pc.space_to_depth2
    block = ConvBlock(c_in, c_out, dtype=dt)
    block.conv.reset_parameters(seed)
    block.to(dev)
    emit = name == "up2"  # the last upsample hands the heads its phase tensor
    return (lambda x: block.upsample2x(x, emit_phase=emit),
            lambda x: block(x.repeat_interleave(2, 1).repeat_interleave(2, 2)),
            None)


def phase_form_phase(dev, card: str) -> None:
    """``[phase_form]``: each phase op of :data:`PHASE_OPS` against the plain
    op it replaces, on the same weights, at batch 1 and 64, in f32 (max
    error, bounded by :data:`PHASE_TOL`) and bf16 (a row's output the same
    at batch 1, 2, 4 and 64); device ms of both forms by CUDA-graph replay
    (bf16 at both batches, f32 at batch 1) and kernels a call (bf16, batch
    1); then one whole generator call at [1,...], [4,...] and [64,...] in
    both forms on one set of weights (``Renderer.create(phase_form=...)``,
    the heads scaled by 0.1): device ms, kernels, a call's peak memory, the
    f32 frame/flow/mask bound and the bf16 error against f32."""
    from text2video_tpu_torch.ops import phase_conv as pc
    from text2video_tpu_torch.render import Renderer

    t_start = time.perf_counter()
    # Inputs drawn on the card: a [64, 384, 512, 64] draw on the host takes
    # seconds.
    gen = torch.Generator(device=dev).manual_seed(5)
    f32, bf16 = torch.float32, torch.bfloat16
    for name, (h, w, c_in), c_out in PHASE_OPS:
        fields = {}
        for b in (1, CHUNK):
            x32 = torch.rand((b, h, w, c_in), generator=gen,
                             device=dev) * 2 - 1
            for dt in (f32, bf16):
                phase_fn, plain_fn, prep = phase_op_pair(name, c_in, c_out,
                                                         dt, dev)
                x = x32.to(dt)
                xp = prep(x) if prep else x
                with torch.inference_mode():
                    y, y0 = phase_fn(xp), plain_fn(x)
                    if y.shape != y0.shape:
                        y = pc.depth_to_space2(y)
                check(y.shape == y0.shape,
                      f"[phase_form] {name}: {tuple(y.shape)} against "
                      f"{tuple(y0.shape)}")
                key = f"b{b}_{str(dt).split('.')[-1]}"
                err = (y.float() - y0.float()).abs().max().item()
                fields[f"{key}_max_err"] = err
                if dt == f32:
                    bound_x = allclose_err(y, y0)
                    check(bound_x <= 1.0,
                          f"[phase_form] {name} batch {b}: f32 phase form "
                          f"off the plain form by {err} ({bound_x} of the "
                          f"bound)")
                del y, y0
                if b == CHUNK and dt == bf16:
                    # A row's output must not depend on its batch (the mesh
                    # holds sharded serving bit-equal to one process).
                    with torch.inference_mode():
                        row0 = phase_fn(xp[:1])
                        same = [torch.equal(phase_fn(xp[:n])[:1], row0)
                                for n in (2, 4, CHUNK)]
                    fields["bf16_row_equal_at_batch_2_4_64"] = same
                    check(all(same), f"[phase_form] {name}: a row's output "
                          f"depends on the batch: {same}")
                if b == 1 or dt == bf16:
                    calls = 20 if b == 1 else 4
                    with torch.inference_mode():
                        fields[f"{key}_ms"] = graph_ms(
                            lambda: phase_fn(xp), calls=calls)
                        fields[f"{key}_plain_ms"] = graph_ms(
                            lambda: plain_fn(x), calls=calls)
                if b == 1 and dt == bf16:
                    with torch.inference_mode():
                        _, fields["b1_bf16_kernels"], fields["b1_bf16_top"] = (
                            device_profile(lambda: phase_fn(xp), 1))
                        (_, fields["b1_bf16_plain_kernels"],
                         fields["b1_bf16_plain_top"]) = device_profile(
                            lambda: plain_fn(x), 1)
                del x, xp
        phase("phase_form", op=name, shape=[h, w, c_in], cout=c_out, **fields)
    torch.cuda.empty_cache()
    renderers = {(dt, pf): Renderer.create(seed=0, dtype=dt, phase_form=pf,
                                           device=dev)
                 for dt in (f32, bf16) for pf in (True, False)}
    for r in renderers.values():
        # Flows of a few pixels, as the parity tests hold them (ROADMAP,
        # known behaviour 5): the lecun heads' ~30 px flows resolve only to
        # ~1e-4 in f32, in either form.
        with torch.no_grad():
            r.generator.heads.kernel.mul_(0.1)
    for b in (1, 4, CHUNK):
        labels = torch.rand((b, 384, 512, 9), generator=gen,
                            device=dev) * 2 - 1
        prev = torch.rand((b, 384, 512, 6), generator=gen,
                          device=dev) * 2 - 1
        has_prev = torch.ones((b,), device=dev)
        has_prev[0] = 0.0  # a first frame: the mask forced open
        args = (labels, prev, has_prev)
        outs, fields = {}, {}
        for (dt, pf), r in renderers.items():
            g = r.generator
            with torch.inference_mode():
                outs[dt, pf] = [o.float() for o in g(*args)]
                if dt == f32:
                    continue
                form = "phase" if pf else "plain"
                # What a call needs above what is held (weights, inputs).
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                g(*args)
                torch.cuda.synchronize()
                fields[f"{form}_call_peak_gib"] = (
                    torch.cuda.max_memory_allocated() - held) / 2**30
                fields[f"{form}_ms"] = graph_ms(
                    lambda: g(*args), calls=20 if b <= 4 else 2,
                    reps=5 if b <= 4 else 3)
                fields[f"{form}_kernels"] = device_profile(
                    lambda: g(*args), 1)[1]
        phase32, plain32 = outs[f32, True], outs[f32, False]
        f32_errs = [(a - c).abs().max().item()
                    for a, c in zip(phase32, plain32)]
        f32_bound = max(allclose_err(a, c) for a, c in zip(phase32, plain32))
        e16 = {pf: (outs[bf16, pf][0] - plain32[0]).abs().mean().item()
               for pf in (True, False)}
        phase("phase_form", generator_batch=b, hw="512x384", base_ch=64,
              n_blocks=9, **fields, f32_err_frame_flow_mask=f32_errs,
              f32_bound_share=f32_bound, bf16_mean_err_phase=e16[True],
              bf16_mean_err_plain=e16[False], card=card)
        check(f32_bound <= 1.0,
              f"[phase_form] generator batch {b}: f32 phase form off the "
              f"plain form by {f32_errs} ({f32_bound} of the bound)")
        check(e16[True] < 3.0 * e16[False] + 1e-3,
              f"[phase_form] generator batch {b}: bf16 phase error "
              f"{e16[True]} against plain {e16[False]}")
        del outs, args, labels, prev
    del renderers
    torch.cuda.empty_cache()
    phase("phase_form", seconds=time.perf_counter() - t_start)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() "
                 "is False)")
    # The plain references run in full f32, not TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    from text2video_tpu_torch import kernels
    from text2video_tpu_torch.frontend import native
    from text2video_tpu_torch.io import wire_native

    # ---- 1. build: the CUDA kernels and, beside them, the frontend's native
    # library and the wire codec (g++), which the CLI and serving phases use
    t0 = time.perf_counter()
    lib_path, log = kernels.build()
    kernels.library()
    kernels_s = time.perf_counter() - t0
    native_lib = native.ensure_built()
    wire_lib = wire_native.ensure_built()
    phase("build", seconds=round(kernels_s, 3),
          native_seconds=round(time.perf_counter() - t0 - kernels_s, 3),
          lib=os.path.relpath(lib_path), native=os.path.relpath(native_lib),
          wire=os.path.relpath(wire_lib), ptxas=json.dumps(ptxas_lines(log)))

    from text2video_tpu_torch.ops import fused_pose, fused_resblock

    # ---- 2. B1 against its plain version -------------------------------------
    gen = torch.Generator().manual_seed(0)
    b1, b1_b64 = {}, {}
    for shape, kscale in B1_SHAPES:
        c = shape[-1]
        x32 = torch.randn(shape, generator=gen).to(dev)
        scale = kscale if kscale else (1.0 / (9 * c)) ** 0.5
        k32 = (torch.randn((3, 3, c, c), generator=gen) * scale).to(dev)
        b = torch.randn((c,), generator=gen).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            # The layers hand the kernel its weights in the compute dtype.
            x, k = x32.to(dt), k32.to(dt)
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
                npx = shape[0] * shape[1] * shape[2]
                esz = x.element_size()
                # x, k and bias read once; y, mean and var written once.
                bound_ms, bound_by = bound(
                    2 * npx * c * esz + 9 * c * c * esz + 4 * c
                    + 2 * 4 * shape[0] * c,
                    2.0 * npx * c * 9 * c,
                    PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32)
                # A call at batch 64 takes milliseconds: fewer in a graph.
                calls = 20 if shape[0] <= 4 else 4
                ms = graph_ms(lambda: fused_resblock.conv3x3_stats(x, k, b),
                              calls=calls)
                plain_ms = graph_ms(
                    lambda: fused_resblock.conv3x3_stats_plain(x, k, b),
                    calls=calls)
                # Yardstick, never called by the port: cuDNN's conv of the
                # same shape, channels-last, zero padding, no statistics.
                xc = x.permute(0, 3, 1, 2)
                wc = k.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                library_ms = graph_ms(lambda: F.conv2d(xc, wc, padding=1),
                                      calls=calls)
                fields.update(ms=ms, plain_ms=plain_ms,
                              library_ms=library_ms, bound_ms=bound_ms,
                              bound_by=bound_by, bound_share=bound_ms / ms)
                if dt == torch.bfloat16 and shape == B1_SHAPES[0][0]:
                    b1 = dict(max_abs_err=errs[0], ms=ms,
                              plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=library_ms)
                    # The wrapper's host time a call, which the frame
                    # loop pays 18 times a frame: 200 calls queued
                    # without a sync (the card keeps up with them).
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(200):
                        fused_resblock.conv3x3_stats(x, k, b)
                    fields["wrapper_host_us"] = (
                        time.perf_counter() - t0) / 200 * 1e6
                    torch.cuda.synchronize()
            if dt == torch.bfloat16 and shape[0] == CHUNK:
                # 128 x 128 tiles over the persistent blocks, one per SM.
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                tiles = npx // 128 * (c // 128)
                b1_b64 = dict(max_abs_err=errs[0], ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=library_ms)
                phase("B1_b64", tiles=tiles, sms=sms, waves=tiles / sms,
                      tflops=2.0 * npx * c * 9 * c / ms / 1e9, **fields)
            else:
                phase("B1", **fields)
            del x, k, y, y0
        del x32, k32

    # ---- 3. B2 against its plain version and the host smoother ---------------
    from text2video_tpu_torch.golden import golden_pose_inputs
    from text2video_tpu_torch.ops.interp import (
        plan_pose_track,
        synthesize_host,
    )
    from text2video_tpu_torch.ops.smooth import smooth_host

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
    b2_ms = graph_ms(lambda: fused_pose.blend_and_smooth(*args, sw))
    b2_plain_ms = graph_ms(
        lambda: fused_pose.blend_and_smooth_plain(*args, sw), calls=2)
    # Bytes: the table rows this plan reads, the plan, the two outputs.
    # Operations: a blend (3 flops) and a 2 sw-tap window (4 sw + 4) per
    # value, far below the bytes' time.
    t_len, width = plan.num_frames, fused_pose.FACE_D + fused_pose.POSE_D
    rows = len(np.union1d(plan.i1, plan.i2))
    b2_bound_ms, b2_bound_by = bound(
        4 * (rows * width + 3 * t_len + t_len * width),
        t_len * width * (7 + 4 * sw), PEAK_F32)
    phase("B2", frames=t_len, table_rows=len(table), rows_read=rows,
          err_vs_plain=b2_err, err_vs_smooth_host=float(host_err), ms=b2_ms,
          plain_ms=b2_plain_ms, bound_ms=b2_bound_ms, bound_by=b2_bound_by)

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
    from text2video_tpu_torch.bench import device_info

    card = device_info(dev)  # as nvidia-smi --query-gpu=name,power.limit
    card = f"{card['name']}, {card['power_limit']}"

    # ---- 5. the serving path, bf16 -----------------------------------------
    import cv2

    from text2video_tpu_torch import pipeline
    from text2video_tpu_torch.ops.rasterize import rasterize_batch

    port_stage = pipeline.PoseStage
    pipeline.PoseStage = (
        lambda prof, device="cpu": port_stage(prof, pdict, table, device))
    # The serving renderer is made as a user makes it: on the card by default.
    renderer = Renderer.create(seed=0, dtype=torch.bfloat16)
    check(renderer.device.type == "cuda", f"renderer on {renderer.device}")
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
            rasterize_batch(*tracks, (512, 384), chunk=8,
                            device="cpu").astype(int)
            - rasterize_batch(*tracks, (512, 384), chunk=8,
                              device=dev).astype(int)).max()
        check(label_diff == 0, f"device labels differ from CPU by {label_diff}")
        # The 512x384 keypoints on a 64x64 canvas: segments past the sample
        # budget take the JAX path's INT32_MIN endpoint (ROADMAP C3).
        small = [rasterize_batch(*tracks, (64, 64), chunk=8, device=d)
                 for d in ("cpu", dev)]
        small_diff = np.abs(small[0].astype(int) - small[1].astype(int)).max()
        check(small_diff == 0 and small[0][:, -1, -1].any(),
              f"64x64 labels: card differs from CPU by {small_diff}")
        phase("raster_small", hw="64x64", frames=8,
              label_diff_vs_cpu=int(small_diff),
              drawn_share=float((small[1] > 0).mean()))
        raster_host_phase()

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
              label_diff_vs_cpu=int(label_diff),
              peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)

        def run_slice(r, name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pipeline.Text2VideoPipeline(cfg, r).synthesize(
                ts, name, audio=audio)
            return out, time.perf_counter() - t0

        wire_phase(renderer, warm.frames, run_slice)

    # Where the device time of a frame goes: warm frames under the profiler
    # (which slows the host, so its wall clock is not the rate).
    labels = torch.from_numpy(warm.label_maps).to(dev)[None]
    busy, n_kernels, top = device_profile(
        lambda: renderer.generate_device(labels[:, :PROFILE_STEPS]),
        PROFILE_STEPS)
    # The same frames through the plain form on the same weights.
    plain_r = Renderer.create(seed=0, dtype=torch.bfloat16, phase_form=False)
    plain_r.time_bucket = CHUNK
    plain_r.generate_device(labels[:, :2])  # its first calls build copies
    busy0, n_kernels0, top0 = device_profile(
        lambda: plain_r.generate_device(labels[:, :PROFILE_STEPS]),
        PROFILE_STEPS)
    del plain_r
    check(renderer.generator.phase_form, "the serving renderer's form")
    phase("profile", frames=PROFILE_STEPS, form="phase",
          device_ms_per_frame=busy, kernels_per_frame=n_kernels,
          top_ms_launches_per_frame=top, plain_device_ms_per_frame=busy0,
          plain_kernels_per_frame=n_kernels0,
          plain_top_ms_launches_per_frame=top0)
    phase_form_phase(dev, card)
    # ---- 6. the user's entry points: the bench (its gen line is the warm
    # generation rate), then the CLI, text (or audio) in, mp4 out -----------
    pipeline.PoseStage = port_stage  # both run unpatched from here on
    by_path = {"slice": launches}
    bench_paths, fps_batch1 = bench_phases()
    by_path.update(bench_paths)
    from text2video_tpu_torch.checkpoints import save_renderer
    from text2video_tpu_torch.golden import write_golden_assets

    with tempfile.TemporaryDirectory() as tmp:
        data = write_golden_assets(os.path.join(tmp, "data"))
        ckpt = os.path.join(tmp, "ckpt")
        save_renderer(renderer, ckpt, height=384)
        by_path.update(cli_phases(tmp, data, ckpt, renderer,
                                  fps_batch1=fps_batch1))
        # ---- 7. Jacobi decoding, 8. training -------------------------------
        by_path.update(jacobi_phases(data, ckpt, os.path.join(tmp, "jacobi"),
                                     renderer, labels[0]))
        del renderer
        torch.cuda.empty_cache()
        train_paths, train_ref = train_phases(tmp, labels[0])
        by_path.update(train_paths)
        by_path.update(recipe_phase(tmp, data))
        # ---- 9. the mesh: data-parallel ranks of torch.distributed, the
        # model axis, the dry run and the flagship forward -----------------
        by_path.update(mesh_phases(tmp, data, ckpt, warm.label_maps,
                                   train_ref))
        by_path.update(mesh_model_phase(tmp, train_ref["argv"],
                                        warm.label_maps,
                                        mesh_train_refs(tmp)))
        by_path.update(dryrun_phase())
        by_path.update(entry_phase())
        torchrun_phase(tmp)
    check(all(by_path[p]["conv3x3_stats"] > 0 for p in by_path
              if not p.startswith("train_gan")),
          f"B1 was not launched on a serving path: {by_path}")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "orbax", "text2video_tpu"))
    check(not loaded, f"JAX or the JAX package was imported: {loaded}")

    # ---- 10. the card, 11. the result ----------------------------------------
    phase("total", seconds=time.perf_counter() - START)
    print(json.dumps({"kernels": [
        {"name": "conv3x3_stats", "route": "cuda",
         "source": "text2video_tpu_torch/csrc/conv3x3_stats.cu",
         "replaces": "text2video_tpu/ops/fused_resblock.py:64",
         "launches": launches["conv3x3_stats"],
         "launches_per_frame": launches["conv3x3_stats"] / N_FRAMES,
         "launches_by_path": {k: v["conv3x3_stats"]
                              for k, v in by_path.items()},
         "batch64": b1_b64, **b1},
        {"name": "synthesize_and_smooth", "route": "cuda",
         "source": "text2video_tpu_torch/csrc/fused_pose.cu",
         "replaces": "text2video_tpu/ops/fused_pose.py:46",
         "launches": launches["synthesize_and_smooth"],
         "launches_per_frame": launches["synthesize_and_smooth"] / N_FRAMES,
         "launches_by_path": {k: v["synthesize_and_smooth"]
                              for k, v in by_path.items()},
         "max_abs_err": b2_err, "ms": b2_ms, "plain_ms": b2_plain_ms,
         "bound_ms": b2_bound_ms, "bound_by": b2_bound_by,
         "library_ms": None},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def mesh_only() -> None:
    """``python3 chip_smoke.py --mesh``: the mesh phases alone, with what
    they are held against made as :func:`main` makes it (the serving
    renderer's checkpoint, the slice's 256 golden label maps, one process's
    first ``train-gan`` steps at full width), ``[mesh_model]`` and
    ``[mesh_torchrun]``. On a host with several cards the phases also run
    over NCCL across two of them, and ``[mesh_model]`` across four
    (``python3 chip_smoke.py --mesh`` on a four-card host)."""
    from text2video_tpu_torch import kernels
    from text2video_tpu_torch.checkpoints import save_renderer
    from text2video_tpu_torch.golden import (
        golden_pose_inputs,
        write_golden_assets,
        write_training_assets,
    )
    from text2video_tpu_torch.ops.interp import (
        plan_pose_track,
        synthesize_host,
    )
    from text2video_tpu_torch.ops.rasterize import rasterize_batch
    from text2video_tpu_torch.ops.smooth import smooth_host
    from text2video_tpu_torch.render import Renderer

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    kernels.library()
    with tempfile.TemporaryDirectory() as tmp:
        data = write_golden_assets(os.path.join(tmp, "data"))
        ckpt = os.path.join(tmp, "ckpt")
        save_renderer(Renderer.create(seed=0), ckpt, height=384)
        prof, pdict, table, ts = golden_pose_inputs(n_frames=N_FRAMES)
        plan = plan_pose_track(ts, pdict, table, prof)
        face, pose = smooth_host(*synthesize_host(plan, table),
                                 prof.smooth_width)
        hands = table.hands[plan.carrier]
        labels = rasterize_batch(face, pose, hands[:, 0], hands[:, 1],
                                 tuple(prof.canvas), chunk=CHUNK,
                                 device="cuda")
        images, keypoints = write_training_assets(
            os.path.join(tmp, "train"), n_frames=24, canvas=(512, 384))
        argv = ["train-gan", "--images", images, "--keypoints", keypoints,
                "--width", "512", "--height", "384", "--clip-len", "8",
                "--batch-size", "2", "--device-data"]
        gan = os.path.join(tmp, "gan")
        with RecordTrainSteps() as rec:
            _, recs, _ = run_train(rec, argv + ["--ckpt", gan], 3, gan)
        mesh_phases(tmp, data, ckpt, labels, dict(
            argv=argv, first_metrics=recs[0][1],
            step_s=[s for s, _ in recs[1:]]))
        mesh_model_phase(tmp, argv, labels, mesh_train_refs(tmp))
        torchrun_phase(tmp)
    phase("total", seconds=time.perf_counter() - START)


def mesh_model_only() -> None:
    """``python3 chip_smoke.py --mesh-model``: ``[mesh_model]`` alone, with
    its (2, 1) reference run made here, over gloo and, on a host with four
    cards, over NCCL one rank a card. It trains only: the grid's serving
    (``[mesh_model_serve]``) is held against ``[mesh_jacobi]``'s ranks, so
    it runs with ``--mesh`` and in the whole smoke."""
    from text2video_tpu_torch import kernels
    from text2video_tpu_torch.golden import write_training_assets

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    kernels.library()
    with tempfile.TemporaryDirectory() as tmp:
        images, keypoints = write_training_assets(
            os.path.join(tmp, "train"), n_frames=24, canvas=(512, 384))
        labels = np.random.RandomState(0).randint(0, 256, (8, 384, 512, 3),
                                                  np.uint8)
        mesh_model_phase(tmp, [
            "train-gan", "--images", images, "--keypoints", keypoints,
            "--width", "512", "--height", "384", "--clip-len", "8",
            "--batch-size", "2", "--device-data"], labels)
    phase("total", seconds=time.perf_counter() - START)


if __name__ == "__main__":
    if sys.argv[1:] == ["--mesh"]:
        mesh_only()
    elif sys.argv[1:] == ["--mesh-model"]:
        mesh_model_only()
    else:
        main()
