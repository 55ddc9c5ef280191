"""Batched-serving cells: ``Renderer.render_many_device`` back to back, each
call one batch of utterances scanned together (the generator at batch B a
step) and pulled to the host as uint8 frames.

Traffic (the workload file): a pool of ``pool`` utterances of ``frames``
label maps each, drawn at set-up by the reference's drawing from seeded
keypoint tracks of the person's template; call i takes ``batch`` rows of the
pool in a seeded order.

Check: one seeded call among the window's first two, step by step from the
program's own state (``lib/tap.py``, ``lib/servecheck.py``) at a seeded
sample of its steps, every row: ``carry_mismatch``, ``gen_mae``,
``gen_worst``, and ``delivered_mismatch``, the pixels of the uint8 frames
the call returned at those steps that are not the program's frames
quantized (limit 0).
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from benchmark.lib import servecheck, traffic, weights
from benchmark.lib.limits import compared
from benchmark.lib.tap import GeneratorTap
from benchmark.lib.trace import span
from benchmark.reference.serve import generator_shapes, reference_generator


class Cell:
    def __init__(self, ctx):
        from text2video_tpu_torch.config import RenderConfig
        from text2video_tpu_torch.render import Renderer

        cfg, wl = ctx.cell.config, ctx.cell.workload
        self.cfg, self.wl, self.device = cfg, wl, ctx.device
        canvas = (cfg["width"], cfg["height"])
        self.pool = traffic.label_rows(
            cfg["person"], canvas, wl["pool"], wl["frames"],
            traffic.rng_for(ctx.seed, "labels"), self.device)
        rng = traffic.rng_for(ctx.seed, "calls")
        self.rows = [rng.permutation(wl["pool"])[: wl["batch"]].tolist()
                     for _ in range(wl["calls"])]
        self.sample = int(traffic.rng_for(ctx.seed, "check").integers(2))
        self.steps = servecheck.sample_steps(
            wl["frames"], wl["check"]["steps"],
            traffic.rng_for(ctx.seed, "steps"))
        self.kept = None

        self.state = weights.make(generator_shapes(cfg), ctx.seed, self.device,
                                  cfg["init_scales"])
        self.renderer = Renderer.create(
            RenderConfig(), base_ch=cfg["base_ch"], n_blocks=cfg["n_blocks"],
            dtype=getattr(torch, cfg["dtype"]), device=self.device,
            phase_form=cfg["phase_form"])
        self.renderer.generator.load_state_dict(self.state, strict=True)
        self.renderer.time_bucket = wl["time_bucket"]
        if ctx.fault == "frame_offset":
            gen = self.renderer.generator
            forward = gen.forward

            def altered(*a, **k):
                frame, flow, mask = forward(*a, **k)
                return frame + 0.1, flow, mask
            gen.forward = altered
        elif ctx.fault is not None:
            raise ValueError(f"render_batch has no fault {ctx.fault!r}")
        self.tap = GeneratorTap(self.renderer.generator)
        self._call(self.rows[-1])  # warm-up: the one shape of the traffic

    def _call(self, rows) -> np.ndarray:
        labels = self.pool[rows]
        with span("render_many"):
            return self.renderer.render_many_device(labels)

    def unit(self, i: int) -> dict:
        rows = self.rows[i % len(self.rows)]
        if i == self.sample:
            self.tap.arm(self.steps[1])
        frames = self._call(rows)
        if i == self.sample:
            self.kept = (self.tap.disarm(), frames)
        b, t = frames.shape[:2]
        h, w = self.cfg["height"] // 8, self.cfg["width"] // 8
        return {"calls": 1, "frames": b * t, "b1_shape": [b, h, w, 512]}

    def release(self) -> None:
        self.renderer = self.tap = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        limits = self.wl["check"]["limits"]
        if self.kept is None:
            return servecheck.numbers([], 0, limits)
        calls, delivered = self.kept
        steps, dtype = self.steps[0], getattr(torch, self.cfg["dtype"])
        gen = reference_generator(self.cfg, "f32", self.state, self.device)
        out = servecheck.numbers(
            servecheck.step_errors(calls, steps, gen),
            servecheck.carry_mismatch(calls, steps, dtype), limits)
        bad = 0
        for t in steps:
            want = torch.clamp((calls[t][3].to(dtype).float() + 1.0) * 127.5,
                               0.0, 255.0).to(torch.uint8).cpu().numpy()
            bad += int((delivered[:, t] != want).sum())
        out.update(compared({"delivered_mismatch": bad}, limits))
        return out

    def control(self) -> dict:
        """The float8 reference in the program's generator step, on the
        sampled call's steps as the program fed them."""
        self.tap.arm(self.steps[1])
        self._call(self.rows[self.sample])
        calls = self.tap.disarm()
        low = reference_generator(self.cfg, "fp8", self.state, self.device)
        ref = reference_generator(self.cfg, "f32", self.state, self.device)
        outs = servecheck.reference_outputs(calls, self.steps[0], low)
        out = servecheck.numbers(
            servecheck.step_errors(calls, self.steps[0], ref, outputs=outs),
            0, self.wl["check"]["limits"])
        out.pop("carry_mismatch", None)
        return out
