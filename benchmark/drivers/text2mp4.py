"""Text-to-mp4 cells: one client, closed loop, each request a phone timeline
and its waveform through ``Text2VideoPipeline.synthesize`` (pose stage on
the device, label maps drawn on the device, the autoregressive scan,
frames streamed over the DCT wire to the muxer) until its mp4 is closed.

Traffic (the workload file): utterance lengths spread evenly over
``frames`` (the same set for every seed, in the seed's order), keys
``gap`` frames apart over the person's symbol inventory, a waveform of the
same length. The person is a seeded key-pose recording of the template
frame, written in the original data layout. A request's files are deleted
when it ends, but for the requests the check samples.

Check, for a seeded sample of the window's first ``among`` requests with the
longest of them, each stage against the reference, from the program's own
output of the stage before (``lib/tap.py``): the pose stage's tracks and
the generator's calls at a seeded sample of steps are kept as the window
runs them.

* ``track_px``: the largest difference, in pixels, between the pose stage's
  tracks (face, body, hands) and the reference's from the same timeline and
  recording (float64 interpolation and smoothing).
* ``label_px``: pixels of the kept steps' label context (the map and the
  two before) that differ from the reference's drawing of the program's own
  tracks. Limit 0.
* ``carry_mismatch``, ``gen_mae``, ``gen_worst``: ``lib/servecheck.py``.
* ``frames_missing``: frames of the request absent from its mp4. Limit 0.
* ``file_luma_off``: the mp4's JPEG samples at the kept steps, decoded by
  libjpeg (luma), against the reference's wire model of the program's own
  frames (``reference/wire.py``): the share of pixels, in %, more than one
  level apart.

The control (``--control 1``) puts the reference's lower precision in each
stage's place: tracks in bfloat16, the generator in float8, the wire's DCT
in TF32; each is read against the reference in the same way.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time
from typing import List, Tuple

import numpy as np
import torch

from benchmark.lib import mp4, servecheck, traffic, weights
from benchmark.lib.limits import compared
from benchmark.lib.tap import GeneratorTap
from benchmark.lib.trace import span
from benchmark.reference import pose, raster, wire
from benchmark.reference.lowp import round_bf16
from benchmark.reference.serve import generator_shapes, reference_generator


@dataclasses.dataclass
class Request:
    frames: int
    keys: List[Tuple[int, str]]
    audio: np.ndarray


def off_share(luma: np.ndarray, model: np.ndarray) -> float:
    """The share, in %, of pixels more than one level from the model (an
    exact inverse DCT and libjpeg's integer one differ by one at most)."""
    return 100.0 * float((np.abs(luma.astype(np.int16) - model) > 1).mean())


def _with_span(name, fn):
    def wrapped(*a, **k):
        with span(name):
            return fn(*a, **k)
    return wrapped


class Cell:
    def __init__(self, ctx):
        from text2video_tpu_torch import pipeline as pipeline_mod
        from text2video_tpu_torch.config import (
            PipelineConfig,
            RenderConfig,
            get_profile,
        )
        from text2video_tpu_torch.frontend.timestamps import Timestamps
        from text2video_tpu_torch.render import Renderer

        self.ctx = ctx
        cfg, wl = ctx.cell.config, ctx.cell.workload
        self.cfg, self.wl = cfg, wl
        self.device = ctx.device
        canvas = tuple(cfg["canvas"])
        symbols = traffic.symbol_inventory(wl["symbols"])
        self.rec = traffic.recording(
            cfg["person"], canvas, wl["recording"]["clips"],
            wl["recording"]["clip_frames"], symbols,
            traffic.rng_for(ctx.seed, "recording"))
        dict_path, kp_dir = traffic.write_recording(self.rec,
                                                    ctx.tmp / "person")
        p = cfg["pose"]
        profile = dataclasses.replace(
            get_profile(cfg["person"]), dict_path=dict_path,
            keypoints_dir=kp_dir, keypoint_layout="clip", canvas=canvas,
            fps=float(cfg["fps"]), motion_width=p["motion_width"],
            transition_width=p["transition_width"],
            min_key_dist=p["min_key_dist"],
            key_gap_inclusive=p["key_gap_inclusive"],
            smooth_width=p["smooth_width"])
        self.params = pose.PoseParams(**p)

        # Requests: every seed the same lengths, each cycle in its own order.
        lengths = traffic.stable_lengths(*wl["frames"], wl["lengths"])
        rng = traffic.rng_for(ctx.seed, "requests")
        order = np.concatenate([rng.permutation(lengths)
                                for _ in range(wl["cycles"])])
        rate = wl["sample_rate"]
        self.requests = [
            Request(int(n), traffic.timeline(int(n), symbols, wl["gap"], rng),
                    traffic.waveform(int(n), cfg["fps"], rate, rng))
            for n in order]
        # The check's requests: the longest of the first ``among`` (which
        # every window completes) and a seeded rest of them.
        pick = traffic.rng_for(ctx.seed, "check")
        first = list(range(wl["check"]["among"]))
        longest = first[int(np.argmax(order[: len(first)]))]
        others = [i for i in first if i != longest]
        self.sample = sorted({longest, *pick.choice(
            others, wl["check"]["requests"] - 1, replace=False).tolist()})
        self.kept, self.files = {}, {}
        steps_rng = traffic.rng_for(ctx.seed, "steps")
        self.steps = {i: servecheck.sample_steps(
            int(order[i]), wl["check"]["steps"], steps_rng)
            for i in self.sample}

        self.state = weights.make(generator_shapes(cfg), ctx.seed, self.device,
                                  cfg["init_scales"])
        renderer = Renderer.create(
            RenderConfig(), base_ch=cfg["base_ch"], n_blocks=cfg["n_blocks"],
            dtype=getattr(torch, cfg["dtype"]), device=self.device,
            phase_form=cfg["phase_form"])
        renderer.generator.load_state_dict(self.state, strict=True)
        renderer.time_bucket = wl["time_bucket"]
        self.out = ctx.tmp / "out"
        self.pipe = pipeline_mod.Text2VideoPipeline(
            PipelineConfig(person=profile, out_dir=str(self.out),
                           pose_device=wl["pose_device"], stream=True),
            renderer=renderer)
        self.Timestamps = Timestamps
        if ctx.fault == "frame_offset":
            gen = renderer.generator
            forward = gen.forward

            def altered(*a, **k):
                frame, flow, mask = forward(*a, **k)
                return frame + 0.1, flow, mask
            gen.forward = altered
        elif ctx.fault == "label_shift":
            draw = pipeline_mod.rasterize_batch

            def shifted(face, pose, *a, **k):
                face, pose = face.copy(), pose.copy()
                face[:, 0::3] += 1.0
                pose[:, 0::3] += 1.0
                return draw(face, pose, *a, **k)
            pipeline_mod.rasterize_batch = shifted
        elif ctx.fault is not None:
            raise ValueError(f"text2mp4 has no fault {ctx.fault!r}")
        self.tap = GeneratorTap(renderer.generator)
        self.pose_tap = {}
        stage = self.pipe.pose_stage
        run_pose = stage.run

        def pose_run(*a, **k):
            result = run_pose(*a, **k)
            if self.tap.armed:
                hands = stage.table.hands[result.plan.carrier]
                self.pose_tap["tracks"] = (result.face_smooth,
                                           result.pose_smooth, hands)
            return result
        stage.run = pose_run
        if ctx.trace:
            self._add_spans(pipeline_mod, renderer)

        # Warm-up: the shortest and the longest utterance, every shape the
        # traffic uses (64-frame chunks, a partial last chunk).
        warm = traffic.rng_for(ctx.seed, "warm")
        for n in (min(lengths), max(lengths)):
            req = Request(n, traffic.timeline(n, symbols, wl["gap"], warm),
                          traffic.waveform(n, cfg["fps"], rate, warm))
            self._synthesize(req, "warm")

    def _add_spans(self, pipeline_mod, renderer) -> None:
        """``bench.*`` spans around the program's layers, for the traced
        run's breakdown."""
        stage = self.pipe.pose_stage
        stage.run = _with_span("pose_stage", stage.run)
        pipeline_mod.rasterize_batch = _with_span(
            "rasterize", pipeline_mod.rasterize_batch)
        for method, label in (("_scan_chunk", "generator_scan"),
                              ("_encode_wire", "wire_encode"),
                              ("_wait_host", "wire_pull")):
            if hasattr(renderer, method):
                setattr(renderer, method,
                        _with_span(label, getattr(renderer, method)))

    def _synthesize(self, req: Request, name: str):
        ts = self.Timestamps(entries=tuple(req.keys))
        with span("synthesize"):
            res = self.pipe.synthesize(ts, name, audio=req.audio,
                                       sample_rate=self.wl["sample_rate"])
        return res

    def unit(self, i: int) -> dict:
        req = self.requests[i % len(self.requests)]
        if i in self.sample:
            self.tap.arm(self.steps[i][1])
        t0 = time.perf_counter()
        res = self._synthesize(req, f"r{i:05d}")
        latency = time.perf_counter() - t0
        if i in self.sample:
            self.kept[i] = (self.tap.disarm(), self.pose_tap.pop("tracks"))
        for path in res.files:
            if i in self.sample and path.endswith(".mp4"):
                self.files[i] = path
            else:
                os.remove(path)
        return {"requests": 1, "frames": res.num_frames,
                "video_s": res.num_frames / self.cfg["fps"],
                "latency_s": latency,
                "mux_s": (res.stage_seconds or {}).get("mux", 0.0)}

    def release(self) -> None:
        self.pipe = self.tap = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _labels(self, tracks) -> torch.Tensor:
        """The reference's drawing of ``tracks`` as the [T, H, W, 9] label
        context in the program's compute dtype: maps t, t-1, t-2 (zeros
        before the start)."""
        face, pose_t, hands = tracks
        lab = raster.draw(face, pose_t, hands[:, 0], hands[:, 1],
                          tuple(self.cfg["canvas"]), self.device)
        lab = lab.float() / 127.5 - 1.0
        zero = torch.zeros_like(lab[:1])
        ctx = [lab] + [torch.cat([zero] * k + [lab[: lab.shape[0] - k]])
                       for k in (1, 2)]
        return torch.cat(ctx, dim=-1).to(getattr(torch, self.cfg["dtype"]))

    @staticmethod
    def _track_px(a, b) -> float:
        if any(x.shape != y.shape for x, y in zip(a, b)):
            return float("inf")
        return max(float(np.abs(np.asarray(x, np.float64) - y).max())
                   for x, y in zip(a, b))

    def _file_luma(self, calls, steps, luma) -> float:
        dtype = getattr(torch, self.cfg["dtype"])
        frames = torch.cat([calls[t][3].to(dtype).float() for t in steps])
        model = wire.wire_luma(frames, self.wl["wire_quality"])
        if luma.shape[0] <= max(steps):
            return float("inf")
        return off_share(luma[steps], model)

    def check(self) -> dict:
        limits = self.wl["check"]["limits"]
        gen = reference_generator(self.cfg, "f32", self.state, self.device)
        dtype = getattr(torch, self.cfg["dtype"])
        errs, carry, label_px, missing = [], 0, 0, 0
        track_px, file_mae = [], []
        for i in self.sample:
            req, kept = self.requests[i], self.kept.get(i)
            if kept is None or i not in self.files:
                missing += req.frames  # the window ended first
                continue
            calls, tracks = kept
            steps = self.steps[i][0]
            track_px.append(self._track_px(
                tracks, pose.tracks(req.keys, self.rec, self.params)))
            ctx = self._labels(tracks)
            label_px += sum(int((calls[t][0][0] != ctx[t]).any(-1).sum())
                            for t in steps)
            carry += servecheck.carry_mismatch(calls, steps, dtype)
            errs += servecheck.step_errors(calls, steps, gen)
            luma = mp4.decoded_luma(self.files.pop(i))
            missing += abs(req.frames - luma.shape[0])
            file_mae.append(self._file_luma(calls, steps, luma))
        out = servecheck.numbers(errs, carry, limits)
        inf = float("inf")
        out.update(compared({
            "track_px": max(track_px, default=inf), "label_px": label_px,
            "frames_missing": missing,
            "file_luma_off": max(file_mae, default=inf)}, limits))
        return out

    def control(self) -> dict:
        """The reference's lower precision in each stage's place, on the
        first sampled request as the program ran it: its tracks in
        bfloat16, its generator step in float8 (from the inputs the program
        fed each kept step), its wire's DCT in TF32 (on the program's
        frames); each against the reference as the check reads it."""
        i = self.sample[0]
        req = self.requests[i]
        self.tap.arm(self.steps[i][1])
        self._synthesize(req, "control")
        calls = self.tap.disarm()
        self.pose_tap.pop("tracks")
        steps = self.steps[i][0]
        low = reference_generator(self.cfg, "fp8", self.state, self.device)
        ref = reference_generator(self.cfg, "f32", self.state, self.device)
        outs = servecheck.reference_outputs(calls, steps, low)
        errs = servecheck.step_errors(calls, steps, ref, outputs=outs)
        limits = self.wl["check"]["limits"]
        out = servecheck.numbers(errs, 0, limits)
        out.pop("carry_mismatch", None)
        dtype = getattr(torch, self.cfg["dtype"])
        frames = torch.cat([calls[t][3].to(dtype).float() for t in steps])
        exact = wire.wire_luma(frames, self.wl["wire_quality"])
        tf32 = wire.wire_luma(frames, self.wl["wire_quality"], tf32=True)
        out.update(compared({
            "track_px": self._track_px(
                pose.tracks(req.keys, self.rec, self.params, round_bf16),
                pose.tracks(req.keys, self.rec, self.params)),
            "file_luma_off": off_share(tf32, exact)}, limits))
        return out
