"""Training-time label augmentation on the device (counterpart of
``text2video_tpu/train/augment.py``).

vid2vid trains its pose dataset with random keypoint dropping and noise
(reference: keypoint2img.py:119-123, ``random_drop_prob`` edge dropping;
``remove_face_labels`` blanks the face region) so the generator is robust to
imperfect OpenPose detections at test time. Here the keypoint tracks stay on
the device, are perturbed there every step and the label maps are drawn from
them by ``ops/rasterize.py``: fresh noise each step, and no label image ever
crosses from the host.

Every augmentation is split in two: a pure function of the tracks and the
random draws, and :func:`draw_augment`, which makes the draws from an explicit
``torch.Generator``. The same draws give the same batch on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from text2video_tpu_torch.ops.rasterize import _rasterize_chunk, _round_up

TRACK_POINTS = (70, 25, 21, 21)  # face, pose, left hand, right hand


@dataclasses.dataclass
class AugmentDraws:
    """The random numbers of one augmented batch of M = B*T frames. A field
    is None where its augmentation is off."""

    # Standard normals, one [M, n_pts, 2] per track (face, pose, hands).
    jitter: Optional[Tuple[torch.Tensor, ...]] = None
    # Uniforms in [0, 1), one [M, n_pts, 1] per track.
    drop: Optional[Tuple[torch.Tensor, ...]] = None
    # Uniforms [M, 1]: a frame's whole face is blanked below the threshold.
    face: Optional[torch.Tensor] = None
    # Uniforms [B, 2] (row, column): where each sample's crop starts.
    crop: Optional[torch.Tensor] = None

    def to(self, device) -> "AugmentDraws":
        def move(x):
            if x is None:
                return None
            if isinstance(x, tuple):
                return tuple(v.to(device) for v in x)
            return x.to(device)

        return AugmentDraws(**{f.name: move(getattr(self, f.name))
                               for f in dataclasses.fields(self)})


def draw_augment(
    b: int,
    t: int,
    generator: torch.Generator,
    drop_prob: float = 0.0,
    jitter_px: float = 0.0,
    face_drop_prob: float = 0.0,
    scale_crop: bool = False,
) -> AugmentDraws:
    """The draws of one batch of ``b`` clips of ``t`` frames, made on
    ``generator``'s device, only for the augmentations that are on."""
    m, dev = b * t, generator.device

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    return AugmentDraws(
        jitter=tuple(torch.randn((m, n, 2), generator=generator, device=dev)
                     for n in TRACK_POINTS) if jitter_px > 0.0 else None,
        drop=tuple(uniform(m, n, 1) for n in TRACK_POINTS)
        if drop_prob > 0.0 else None,
        face=uniform(m, 1) if face_drop_prob > 0.0 else None,
        crop=uniform(b, 2) if scale_crop else None,
    )


def augment_tracks(
    face: torch.Tensor,
    pose: torch.Tensor,
    hand_l: torch.Tensor,
    hand_r: torch.Tensor,
    draws: AugmentDraws,
    drop_prob: float = 0.0,
    jitter_px: float = 0.0,
    face_drop_prob: float = 0.0,
):
    """Perturb keypoint tracks ([M,210]/[M,75]/[M,63]/[M,63] x,y,conf
    triples) for one batch of frames with the given draws.

    * jitter_px: Gaussian x/y noise added to every confident point;
    * drop_prob: per-point confidence zeroing (an edge with a dropped
      endpoint is not drawn: the reference's random edge drop);
    * face_drop_prob: per-frame whole-face blanking (remove_face_labels).
    """
    out = []
    for i, (x, n_pts) in enumerate(zip((face, pose, hand_l, hand_r),
                                       TRACK_POINTS)):
        pts = x.reshape(x.shape[0], n_pts, 3)
        xy, conf = pts[..., :2], pts[..., 2:]
        if jitter_px > 0.0:
            xy = xy + (jitter_px * draws.jitter[i]) * (conf > 0.0)
        if drop_prob > 0.0:
            conf = conf * (draws.drop[i] >= drop_prob).to(conf.dtype)
        out.append(torch.cat([xy, conf], dim=-1).reshape(x.shape))
    face, pose, hand_l, hand_r = out
    if face_drop_prob > 0.0:
        keep = (draws.face >= face_drop_prob).to(face.dtype)  # [M, 1]
        pts = face.reshape(face.shape[0], 70, 3)
        # keep == 0 zeroes the confidence of every face point of the frame.
        face = torch.cat([pts[..., :2], pts[..., 2:] * keep[:, None, :]],
                         dim=-1).reshape(face.shape)
    return face, pose, hand_l, hand_r


# ---- random scaleHeight + aligned crop (reference README.md:169-171:
# --resize_or_crop randomScaleHeight_and_scaledCrop --loadSize 544
# --fineSize 512: every training step sees a randomly up-scaled then randomly
# cropped view of the real frame, with the label keypoints transformed by the
# same affine so the pair stays registered). ---------------------------------

def scale_crop_scales(scale_max: float) -> tuple:
    """The discrete scale set standing in for the reference's continuous
    [1, loadSize/fineSize] draw: identity, half and full zoom."""
    return (1.0, 1.0 + scale_max / 2.0, 1.0 + scale_max)


def _affine(s: float) -> Tuple[float, float]:
    """(scale, shift) of the enlargement by ``s``, rounded as f32 arithmetic
    rounds them: bilinear resizing with half-pixel centres puts source ``p``
    at ``p * s + (s - 1) / 2``."""
    s32 = np.float32(s)
    return float(s32), float((s32 - np.float32(1.0)) / np.float32(2.0))


def scale_crop_transform_track(track: torch.Tensor, n_pts: int, s: float,
                               off: torch.Tensor, h: int, w: int):
    """Affine-transform one keypoint track array [M, n_pts*3] by scale ``s``
    and per-frame crop offset ``off`` [M, 1, 2] (x, y); points leaving the
    canvas get their confidence zeroed (an edge with an off-canvas endpoint
    is not drawn, as the reference's crop never draws outside the window)."""
    scale, shift = _affine(s)
    pts = track.reshape(track.shape[0], n_pts, 3)
    xy, conf = pts[..., :2], pts[..., 2:]
    xy2 = xy * scale + shift - off
    inside = ((xy2[..., 0] >= 0.0) & (xy2[..., 0] <= w - 1.0)
              & (xy2[..., 1] >= 0.0) & (xy2[..., 1] <= h - 1.0))[..., None]
    return torch.cat([xy2, conf * inside], dim=-1).reshape(track.shape)


def scale_crop_centers(centers: torch.Tensor, s: float, off: torch.Tensor):
    """Face centres [B, T, 2] under the same affine; ``off`` [B, 2]."""
    scale, shift = _affine(s)
    return centers * scale + shift - off[:, None, :]


def scale_crop_reals(reals: torch.Tensor, u: torch.Tensor, s: float):
    """Resize the real clips [B, T, H, W, 3] (float) to
    ``(round(H*s), round(W*s))`` and crop each sample back to (H, W) at
    ``floor(u * (enlarged - size + 1))``, ``u`` [B, 2] uniform draws (row,
    column). Returns (the crops, the offsets [B, 2] float (x, y))."""
    b, t, h, w, c = reals.shape
    hi, wi = round(h * s), round(w * s)
    if (hi, wi) == (h, w):
        return reals, torch.zeros((b, 2), dtype=torch.float32,
                                  device=reals.device)
    # Nothing is reduced, so no antialiasing: plain half-pixel bilinear.
    rs = F.interpolate(reals.reshape(b * t, h, w, c).permute(0, 3, 1, 2),
                       size=(hi, wi), mode="bilinear", align_corners=False)
    rs = rs.reshape(b, t, c, hi, wi)
    oy = torch.floor(u[:, 0] * (hi - h + 1)).to(torch.int64)
    ox = torch.floor(u[:, 1] * (wi - w + 1)).to(torch.int64)
    # Per-sample windows by index, so the offsets never leave the device.
    rows = oy[:, None] + torch.arange(h, device=reals.device)  # [B, h]
    cols = ox[:, None] + torch.arange(w, device=reals.device)  # [B, w]
    rs = torch.gather(rs, 3, rows[:, None, None, :, None].expand(
        b, t, c, h, wi))
    rs = torch.gather(rs, 4, cols[:, None, None, None, :].expand(
        b, t, c, h, w))
    off = torch.stack([ox, oy], dim=-1).to(torch.float32)
    return rs.permute(0, 1, 3, 4, 2).contiguous(), off


def augmented_batch(
    tracks: Sequence[torch.Tensor],
    reals_all: torch.Tensor,
    centers_all: torch.Tensor,
    idx: torch.Tensor,
    draws: AugmentDraws,
    canvas: Tuple[int, int],
    drop_prob: float = 0.0,
    jitter_px: float = 0.0,
    face_drop_prob: float = 0.0,
    scale: Optional[float] = None,
):
    """One training batch from the device-resident dataset: gather the frames
    ``idx`` [B, T] of ``tracks`` (face [N,210], pose [N,75], hands [N,63]),
    ``reals_all`` [N, H, W, 3] uint8 and ``centers_all`` [N, 2], perturb the
    tracks, with ``scale`` zoom and crop reals, tracks and centres by one
    affine, and draw the label maps from the perturbed tracks.

    Returns ({"labels", "reals" [B,T,H,W,3] in [-1, 1], "face_centers"
    [B,T,2]}, the crop offsets [B, 2] (x, y)). Runs without a graph."""
    w, h = canvas
    b, t = idx.shape
    with torch.no_grad():
        flat = idx.reshape(-1)
        f, p, l, r = augment_tracks(
            *(x[flat] for x in tracks), draws, drop_prob=drop_prob,
            jitter_px=jitter_px, face_drop_prob=face_drop_prob)
        reals = reals_all[idx].float() / 127.5 - 1.0
        centers = centers_all[idx]
        off = torch.zeros((b, 2), dtype=torch.float32, device=idx.device)
        if scale is not None:
            reals, off = scale_crop_reals(reals, draws.crop, scale)
            off_flat = off.repeat_interleave(t, dim=0)[:, None, :]
            f, p, l, r = (
                scale_crop_transform_track(x, n, scale, off_flat, h, w)
                for x, n in zip((f, p, l, r), TRACK_POINTS))
            centers = scale_crop_centers(centers, scale, off)
        labels_u8 = _rasterize_chunk(
            f, p, l, r, width=w, height=h,
            n_samples=_round_up(max(w, h), 128))
        labels = (labels_u8.float() / 127.5 - 1.0).reshape(b, t, h, w, 3)
    return {"labels": labels, "reals": reals, "face_centers": centers}, off
