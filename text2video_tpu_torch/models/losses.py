"""Training objectives of the pose2frame GAN (counterpart of
``text2video_tpu/models/losses.py``).

LSGAN terms for the multiscale image, temporal and face discriminators,
discriminator feature matching, the VGG perceptual loss, the flow losses
(the previous real frame warped onto the current one, or a reference flow,
plus smoothness) and L1. Every term is a mean of f32 values; the real side
is detached wherever the JAX function stops its gradient.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from text2video_tpu_torch.ops.warp import flow_tv, flow_warp

DiscOut = Tuple[torch.Tensor, List[torch.Tensor]]  # (logits, features)


def lsgan_d(real: Sequence[DiscOut], fake: Sequence[DiscOut]) -> torch.Tensor:
    """Least-squares D loss: real -> 1, fake -> 0, summed over scales."""
    loss = 0.0
    for (lr, _), (lf, _) in zip(real, fake):
        loss = loss + ((lr.float() - 1.0) ** 2).mean() + (lf.float() ** 2).mean()
    return 0.5 * loss


def lsgan_g(fake: Sequence[DiscOut]) -> torch.Tensor:
    """Least-squares G loss: fake -> 1, summed over scales."""
    loss = 0.0
    for lf, _ in fake:
        loss = loss + ((lf.float() - 1.0) ** 2).mean()
    return 0.5 * loss


def feature_matching(real: Sequence[DiscOut],
                     fake: Sequence[DiscOut]) -> torch.Tensor:
    """L1 between the D features of real and fake, averaged over layers and
    scales; the real features are detached targets."""
    loss, n = 0.0, 0
    for (_, fr), (_, ff) in zip(real, fake):
        for r, f in zip(fr, ff):
            loss = loss + (f.float() - r.detach().float()).abs().mean()
            n += 1
    return loss / max(n, 1)


_VGG_LAYER_W = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)


def perceptual(feats_fake: Sequence[torch.Tensor],
               feats_real: Sequence[torch.Tensor]) -> torch.Tensor:
    """Weighted L1 over VGG feature maps (deep layers weighted highest);
    the real features are detached targets."""
    loss = 0.0
    for w, f, r in zip(_VGG_LAYER_W, feats_fake, feats_real):
        loss = loss + w * (f.float() - r.detach().float()).abs().mean()
    return loss


def flow_loss(flow: torch.Tensor, real_prev: torch.Tensor,
              real_cur: torch.Tensor, tv_weight: float = 0.01) -> torch.Tensor:
    """Photometric flow supervision: the previous *real* frame warped by
    ``flow`` against the current real frame, plus smoothness. The warp is
    one call over all frames."""
    warped = flow_warp(real_prev.float(), flow)
    photo = (warped - real_cur.float()).abs().mean()
    return photo + tv_weight * flow_tv(flow)


def flow_supervised_loss(flow: torch.Tensor, flow_gt: torch.Tensor,
                         tv_weight: float = 0.01) -> torch.Tensor:
    """Flow against a reference field (``train/data.py`` provides Farneback
    flow between the sampled real frames): mean endpoint L1 + smoothness."""
    epe = (flow.float() - flow_gt.float()).abs().mean()
    return epe + tv_weight * flow_tv(flow)


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean |a - b| in f32; ``b`` is a detached target."""
    return (a.float() - b.detach().float()).abs().mean()
