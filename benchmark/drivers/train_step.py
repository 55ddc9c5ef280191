"""Training cells: the trainer's step (``train.trainer.make_train_step``) back
to back on a data set resident on the device, as ``train-gan --device-data``
runs it: each step moves only an index array and gathers its clips there.

Traffic (the workload file): ``dataset_frames`` frames of one seeded
recording of the person at the configuration's size (label maps drawn by the
reference's drawing, 'real' frames made from them, mouth centres); step s
takes ``batch`` clips of ``clip_len`` consecutive frames, every row another
start, from a stream seeded by (seed, s).

Set-up builds one trainer state with the harness's weights and runs its
first three steps through the same call and feed as the window; those are
the steps the check follows. It records each step's losses, the first
gradient of every leaf as Adam's first moment holds it after step 1
(``exp_avg / (1 - beta1)``), every leaf's change after step 3, and each
step's unroll as the generator ran it (``lib/tap.py``): every frame's
inputs and output. After the window the reference runs the same three steps
from the same weights on the same batches, each frame fed the program's
previous-frame input of that frame (the unroll amplifies rounding, so the
reference follows the program step by step from the program's own state);
the carry it skips is checked by itself. The window's own steps are timed
and not compared: the reference takes no weights that the program made, so
it cannot take up the program's state at a later step; each of them has to
give a finite G loss, or the run is not correct. Numbers, each the worst
case:

* ``carry_mismatch``: frames whose previous-frame input is not, bit for
  bit, the program's two frames before (zeros at a clip's start). Limit 0.
* ``loss1_gap``: step 1's G and D losses against the reference's,
  relative, the worse. Steps 2 and 3 start from weights that Adam moved by
  about the learning rate in every element whatever its gradient's size, so
  round-off that flips a small gradient's sign moves their losses by 1-2%
  in the program and in its float8 control alike: they are printed, not
  compared.
* ``grad_norm_gap`` and ``change_norm_gap``: a leaf's gradient norm and its
  change's norm against the reference's, over the reference's norm of that
  leaf or of the median leaf of its network, whichever is larger. Leaves
  whose reference gradient is under a thousandth of their network's median
  (a conv bias in front of an instance norm: its gradient is round-off, and
  Adam moves it by round-off alone) are left out of both.
"""

from __future__ import annotations

import gc
import math
import sys
from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import traffic, weights
from benchmark.lib.limits import compared
from benchmark.lib.tap import GeneratorTap
from benchmark.lib.trace import span
from benchmark.reference import raster
from benchmark.reference import train as ref_train

CHECK_STEPS = 3
NETS = ("generator", "discriminators")


def _net(name: str) -> str:
    return name.split(".", 1)[0]


def _gaps(prog: Dict[str, float], ref: Dict[str, float],
          keep=None) -> float:
    """max over leaves of |prog - ref| / max(ref, median ref of its net)."""
    worst, where = 0.0, None
    for net in NETS:
        names = [k for k in ref if _net(k) == net and (keep is None or k in keep)]
        if not names:
            continue
        med = float(np.median([ref[k] for k in names]))
        for k in names:
            gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            if gap > worst:
                worst, where = gap, (k, prog[k], ref[k], med)
    print(f"train check: worst leaf {where}", file=sys.stderr)
    return worst


class Cell:
    def __init__(self, ctx):
        from text2video_tpu_torch.train import trainer

        cfg, wl = ctx.cell.config, ctx.cell.workload
        tc = cfg["train"]
        self.cfg, self.wl, self.tc, self.device = cfg, wl, tc, ctx.device
        self.seed = ctx.seed
        h, w = cfg["height"], cfg["width"]
        n = wl["dataset_frames"]
        face0, pose0 = traffic.template(cfg["person"], (w, h))
        face, pose = traffic.motion_tracks(
            face0, pose0, n, traffic.rng_for(ctx.seed, "dataset"), (w, h))
        hands = np.zeros((n, 63))
        self.labels = raster.draw(face, pose, hands, hands, (w, h), self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(ctx.seed % (1 << 63))
        self.reals = traffic.training_frames(self.labels, gen)
        self.centers = torch.as_tensor(traffic.mouth_centers(face),
                                       dtype=torch.float32, device=self.device)

        self.state0 = weights.make(ref_train.shapes(tc, cfg), ctx.seed,
                                   self.device, cfg["init_scales"])
        tcfg = trainer.TrainConfig(
            height=h, width=w, base_ch=cfg["base_ch"], n_blocks=cfg["n_blocks"],
            dtype=getattr(torch, cfg["dtype"]),
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in tc.items()})
        st = trainer.create_trainer_state(tcfg, seed=0, device=self.device)
        st.generator.load_state_dict(ref_train.split(self.state0, "generator"),
                                     strict=True)
        st.discriminators.load_state_dict(
            ref_train.split(self.state0, "discriminators"), strict=True)
        self.st, self.step_fn = st, trainer.make_train_step(tcfg)
        if ctx.fault == "state_unchanged":
            st.g_opt.step = st.d_opt.step = lambda *a, **k: None
        elif ctx.fault == "half_batch":
            step = self.step_fn
            self.step_fn = lambda s, b: step(
                s, {k: v[: v.shape[0] // 2] for k, v in b.items()})
        elif ctx.fault is not None:
            raise ValueError(f"train_step has no fault {ctx.fault!r}")

        # The first steps: the window's call and feed; the check's readings.
        tap = GeneratorTap(st.generator)
        self.losses: List[Dict[str, float]] = []
        self.unrolls = []
        for s in range(CHECK_STEPS):
            tap.arm(range(wl["clip_len"]))  # the forward, not the recompute
            m = self._step(s)
            self.unrolls.append(tap.disarm())
            self.losses.append({k: float(m[k]) for k in ("g_loss", "d_loss")})
            if s == 0:
                self.grad1 = self._first_grads()
        self.change = self._changes()

    def _batch(self, s: int) -> Dict[str, torch.Tensor]:
        wl = self.wl
        rng = traffic.rng_for(self.seed, f"batch{s}")
        starts = rng.choice(wl["dataset_frames"] - wl["clip_len"] + 1,
                            wl["batch"], replace=False)
        idx = torch.as_tensor(starts[:, None] + np.arange(wl["clip_len"]),
                              device=self.device)
        return {"labels": self.labels[idx].float() / 127.5 - 1.0,
                "reals": self.reals[idx].float() / 127.5 - 1.0,
                "face_centers": self.centers[idx]}

    def _step(self, s: int) -> Dict[str, torch.Tensor]:
        with span("train_step"):
            _, metrics = self.step_fn(self.st, self._batch(s))
        return metrics

    def _named(self):
        return ([(f"generator.{k}", p) for k, p in
                 self.st.generator.named_parameters()]
                + [(f"discriminators.{k}", p) for k, p in
                   self.st.discriminators.named_parameters()])

    def _first_grads(self) -> Dict[str, float]:
        beta1 = self.tc["beta1"]
        out = {}
        for name, p in self._named():
            opt = self.st.g_opt if _net(name) == "generator" else self.st.d_opt
            m = opt.state.get(p, {}).get("exp_avg")
            out[name] = (0.0 if m is None else
                         float(m.float().norm()) / (1.0 - beta1))
        return out

    def _changes(self) -> Dict[str, float]:
        return {name: float((p.detach().float() - self.state0[name]).norm())
                for name, p in self._named()}

    def unit(self, i: int) -> dict:
        m = self._step(CHECK_STEPS + i)
        loss = float(m["g_loss"])  # waits for the step, as a loop's log does
        if not math.isfinite(loss):
            raise FloatingPointError(f"step {CHECK_STEPS + i}: g_loss {loss}")
        return {"steps": 1}

    def release(self) -> None:
        self.st = self.step_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, prec: str):
        """(losses, first gradients, changes) of the reference's first
        steps."""
        ref = ref_train.Trainer(self.tc, self.cfg, self.state0, prec,
                                self.device)
        losses, grad1 = [], {}
        for s in range(CHECK_STEPS):
            calls, batch = self.unrolls[s], self._batch(s)
            prev = [calls[t][1] for t in range(len(calls))]
            if any(p.shape[0] != batch["labels"].shape[0] for p in prev):
                prev = None  # an unroll of other rows: the reference's own
            losses.append(ref.step(batch, prev))
            if s == 0:
                grad1 = {k: float(p.grad.norm()) for k, p in ref.named()}
        change = {k: float((p.detach() - self.state0[k]).norm())
                  for k, p in ref.named()}
        return losses, grad1, change

    def _carry(self) -> int:
        bad = 0
        for calls in self.unrolls:
            for t in sorted(calls):
                prev = calls[t][1]
                want = (torch.zeros_like(prev) if t == 0 else torch.cat(
                    [calls[t - 1][3], calls[t - 1][1][..., :-3]], dim=-1))
                rows = prev.shape[0] == self.wl["batch"]
                bad += int(not rows or not torch.equal(prev, want.to(prev.dtype)))
        return bad

    def _numbers(self, prog, ref) -> dict:
        limits = self.wl["check"]["limits"]
        (pl, pg, pc), (rl, rg, rc) = prog, ref
        print(f"train check: losses {pl} against {rl}", file=sys.stderr)
        gaps = [max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in b)
                for a, b in zip(pl, rl)]
        print(f"train check: loss gaps by step {gaps} (step 1 compared)",
              file=sys.stderr)
        keep = set()
        for net in NETS:
            names = [k for k in rg if _net(k) == net]
            med = float(np.median([rg[k] for k in names]))
            keep |= {k for k in names if rg[k] >= 1e-3 * med}
        return compared({
            "carry_mismatch": self._carry(), "loss1_gap": gaps[0],
            "grad_norm_gap": _gaps(pg, rg, keep),
            "change_norm_gap": _gaps(pc, rc, keep)}, limits)

    def check(self) -> dict:
        return self._numbers((self.losses, self.grad1, self.change),
                             self._reference("f32"))

    def control(self) -> dict:
        out = self._numbers(self._reference("fp8"), self._reference("f32"))
        out.pop("carry_mismatch", None)
        return out
