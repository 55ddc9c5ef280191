"""Training, plain: one optimisation step of the pose2frame GAN (vid2vid's
objective as the measured package trains it), float32.

The generator unrolls over the clip, fed its own previous frames detached
and the previous label maps; its losses are LSGAN terms of the image
discriminator (two scales), of one temporal discriminator a stride (stacks
of 3 frames at strides 1 and 2) and of a face discriminator on 96-pixel
mouth crops, all weighted by ``lambda_adv``, plus ``lambda_fm`` x feature
matching on the image discriminator, ``lambda_flow`` x the photometric flow
loss, ``lambda_l1`` x L1 and ``lambda_l1_mouth`` x L1 on the mouth crops.
The discriminators' LSGAN loss sees the detached fakes. Each network has
its own Adam (eps 1e-8 outside the root, bias-corrected); the
discriminators' learning rate is ``lr * d_lr_scale``. Each frame's generator
forward is recomputed in the backward pass (``torch.utils.checkpoint``) to
fit the clip in memory.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference import models as M
from benchmark.reference.lowp import Precision, ieee_f32


def temporal_key(stride: int) -> str:
    return "temporal" if stride == 1 else f"temporal{stride}"


def build(tc: dict, cfg: dict, prec: str, device) -> Tuple[nn.Module,
                                                            nn.ModuleDict]:
    """(generator, discriminators) of the configuration, zero weights."""
    p = Precision(prec)
    with torch.device(device):
        gen = M.CompositeGenerator(15, cfg["base_ch"], cfg["n_downsample"],
                                   cfg["n_blocks"], prec=p)
        d = tc["d_base_ch"]
        discs = nn.ModuleDict({
            "image": M.MultiscaleDiscriminator(6, tc["num_d"], d, p),
            "face": M.MultiscaleDiscriminator(6, 1, d // 2, p)})
        for s in tc["temporal_strides"]:
            discs[temporal_key(s)] = M.MultiscaleDiscriminator(
                3 * tc["temporal_window"], 1, d, p)
    return gen, discs


def shapes(tc: dict, cfg: dict) -> Dict[str, torch.Size]:
    """{name: shape} of "generator.*" and "discriminators.*" leaves."""
    gen, discs = build(tc, cfg, "f32", "meta")
    out = {f"generator.{k}": v.shape for k, v in gen.state_dict().items()}
    out.update({f"discriminators.{k}": v.shape
                for k, v in discs.state_dict().items()})
    return out


def split(state: Dict[str, torch.Tensor], prefix: str) -> Dict:
    return {k[len(prefix) + 1:]: v for k, v in state.items()
            if k.startswith(prefix + ".")}


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _temporal(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    b, t, h, w, c = x.shape
    n = t - (window - 1) * stride
    return torch.cat([x[:, i * stride: i * stride + n] for i in range(window)],
                     dim=-1).reshape(-1, h, w, c * window)


class Trainer:
    """The networks, their optimizers and :meth:`step`."""

    def __init__(self, tc: dict, cfg: dict, state: Dict[str, torch.Tensor],
                 prec: str, device):
        self.tc = tc
        self.gen, self.discs = build(tc, cfg, prec, device)
        self.gen.load_state_dict(split(state, "generator"), strict=True)
        self.discs.load_state_dict(split(state, "discriminators"), strict=True)
        betas = (tc["beta1"], 0.999)
        self.g_opt = torch.optim.Adam(self.gen.parameters(), lr=tc["lr"],
                                      betas=betas, eps=1e-8)
        self.d_opt = torch.optim.Adam(self.discs.parameters(),
                                      lr=tc["lr"] * tc["d_lr_scale"],
                                      betas=betas, eps=1e-8)

    def named(self) -> List[Tuple[str, nn.Parameter]]:
        return ([(f"generator.{k}", v) for k, v in
                 self.gen.named_parameters()]
                + [(f"discriminators.{k}", v) for k, v in
                   self.discs.named_parameters()])

    def _discs(self, labels_f, frames, frames_f, centers_f):
        tc, D = self.tc, self.discs
        d_out = D["image"](torch.cat([labels_f, frames_f], dim=-1))
        t_outs = [D[temporal_key(s)](_temporal(frames, tc["temporal_window"], s))
                  for s in tc["temporal_strides"]
                  if (tc["temporal_window"] - 1) * s + 1 <= frames.shape[1]]
        crop = tc["face_crop"]
        f_out = D["face"](torch.cat([M.face_crop(labels_f, centers_f, crop),
                                     M.face_crop(frames_f, centers_f, crop)],
                                    dim=-1))
        return d_out, t_outs, f_out

    def step(self, batch: Dict[str, torch.Tensor],
             prev_frames=None) -> Dict[str, float]:
        """One step on {"labels", "reals": [B, T, H, W, 3] in [-1, 1],
        "face_centers": [B, T, 2]}; the gradients stay in ``.grad``.
        Returns the losses. ``prev_frames[t]``, where given, is frame t's
        previous-frame input in place of the frames this unroll generated
        (the program's own, to follow it step by step)."""
        tc = self.tc
        with ieee_f32():
            labels, reals = batch["labels"].float(), batch["reals"].float()
            b, t, h, w, _ = labels.shape
            prev_i = torch.zeros((b, h, w, 6), device=labels.device)
            prev_l = torch.zeros((b, h, w, 6), device=labels.device)
            fakes, flows = [], []
            for i in range(t):
                lab = labels[:, i]
                if prev_frames is not None:
                    prev_i = prev_frames[i].float()
                has_prev = torch.full((b,), float(i > 0), device=labels.device)
                frame, flow, _ = checkpoint(
                    self.gen, torch.cat([lab, prev_l], dim=-1), prev_i,
                    has_prev, use_reentrant=False)
                prev_i = torch.cat([frame.detach(), prev_i[..., :-3]], dim=-1)
                prev_l = torch.cat([lab, prev_l[..., :-3]], dim=-1)
                fakes.append(frame)
                flows.append(flow)
            fakes, flows = torch.stack(fakes, 1), torch.stack(flows, 1)
            labels_f, fakes_f, reals_f = _flat(labels), _flat(fakes), _flat(reals)
            centers_f = _flat(batch["face_centers"])
            d_fake, t_fakes, f_fake = self._discs(labels_f, fakes, fakes_f,
                                                  centers_f)
            with torch.no_grad():
                d_real_img = self.discs["image"](
                    torch.cat([labels_f, reals_f], dim=-1))
            g_adv = tc["lambda_adv"] * (
                M.lsgan_g(d_fake)
                + tc["lambda_temp"] * sum(M.lsgan_g(o) for o in t_fakes)
                + tc["lambda_face"] * M.lsgan_g(f_fake))
            g_fm = M.feature_matching(d_real_img, d_fake)
            g_flow = M.flow_loss(_flat(flows[:, 1:]), _flat(reals[:, :-1]),
                                 _flat(reals[:, 1:]))
            crop = tc["face_crop"]
            g_mouth = M.l1(M.face_crop(fakes_f, centers_f, crop),
                           M.face_crop(reals_f, centers_f, crop))
            g_loss = (g_adv + tc["lambda_fm"] * g_fm
                      + tc["lambda_flow"] * g_flow
                      + tc["lambda_l1"] * M.l1(fakes_f, reals_f)
                      + tc["lambda_l1_mouth"] * g_mouth)
            g_params = list(self.gen.parameters())
            grads = torch.autograd.grad(g_loss, g_params, allow_unused=True)
            for p, g in zip(g_params, grads):
                p.grad = torch.zeros_like(p) if g is None else g
            fakes_d = fakes.detach()
            d_fake, t_fakes, f_fake = self._discs(labels_f, fakes_d,
                                                  _flat(fakes_d), centers_f)
            d_real, t_reals, f_real = self._discs(labels_f, reals, reals_f,
                                                  centers_f)
            d_loss = (M.lsgan_d(d_real, d_fake)
                      + sum(M.lsgan_d(r, f) for r, f in zip(t_reals, t_fakes))
                      + M.lsgan_d(f_real, f_fake))
            d_params = list(self.discs.parameters())
            grads = torch.autograd.grad(d_loss, d_params, allow_unused=True)
            for p, g in zip(d_params, grads):
                p.grad = torch.zeros_like(p) if g is None else g
            self.g_opt.step()
            self.d_opt.step()
        return {"g_loss": float(g_loss.detach()),
                "d_loss": float(d_loss.detach())}
