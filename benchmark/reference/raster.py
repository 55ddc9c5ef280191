"""OpenPose skeleton drawing, plain (a frozen copy of the measured
package's device drawing, which its tests hold against the reference's
bit-exact host drawing).

Every drawn primitive is a 2-point segment sampled like the original
``interpPoints``; per drawing group the samples are scatter-counted into a
grid, dilated into the brush footprint, and blended into the canvas by the
per-pixel count rule; the hand-centre circles overwrite last. Counts and
blends are integer-valued in float32, so the drawing is exact on any device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


POSE_EDGES: List[Tuple[int, int]] = [
    (0, 1), (1, 8),          # trunk
    (1, 2), (2, 3), (3, 4),  # right arm
    (1, 5), (5, 6), (6, 7),  # left arm
    (8, 9), (8, 12),         # hips
]
POSE_EDGE_COLORS: List[Tuple[int, int, int]] = [
    (153, 0, 51), (153, 0, 0),
    (153, 51, 0), (153, 102, 0), (153, 153, 0),
    (102, 153, 0), (51, 153, 0), (0, 153, 0),
    (0, 153, 51), (0, 153, 102),
]

HAND_CHAINS: List[List[int]] = [
    [0, 1, 2, 3, 4],
    [0, 5, 6, 7, 8],
    [0, 9, 10, 11, 12],
    [0, 13, 14, 15, 16],
    [0, 17, 18, 19, 20],
]
HAND_CHAIN_COLORS: List[Tuple[int, int, int]] = [
    (204, 0, 0), (163, 204, 0), (0, 204, 82), (0, 82, 204), (163, 0, 204),
]

FACE_GROUPS: List[List[List[int]]] = [
    [list(range(0, 17))],                        # jaw
    [list(range(17, 22))],                       # left eyebrow
    [list(range(22, 27))],                       # right eyebrow
    [list(range(27, 31)), list(range(31, 36))],  # nose
    [[36, 37, 38, 39], [39, 40, 41, 36]],        # left eye
    [[42, 43, 44, 45], [45, 46, 47, 42]],        # right eye
    [list(range(48, 55)), [54, 55, 56, 57, 58, 59, 48]],  # outer mouth
    [list(range(60, 65)), [64, 65, 66, 67, 60]],          # inner mouth
]

FACE_CONF_THRESH = 0.1
POSE_CONF_THRESH = 0.01
HAND_CONF_THRESH = 0.01
POSE_BW = 3
FACE_BW = 2
CIRCLE_RADIUS = 8
HAND_CENTER_POINT = 9
CIRCLE_COLORS = ((0, 255, 0), (255, 0, 0))  # left green, right blue (BGR)


def face_subedges() -> List[Tuple[int, int]]:
    """All 63 face point-pairs in reference drawing order."""
    pairs = []
    for group in FACE_GROUPS:
        for edge in group:
            for i in range(0, max(1, len(edge) - 1)):
                pairs.append((edge[i], edge[i + 1]))
    return pairs



FACE_SUBEDGES = face_subedges()



def _disk_offsets(bw: int) -> np.ndarray:
    offs = [(i, j) for i in range(-bw * 2, bw * 2)
            for j in range(-bw * 2, bw * 2) if i * i + j * j < 4 * bw * bw]
    return np.asarray(offs, dtype=np.int64)


def _circle_offsets(radius: int) -> np.ndarray:
    offs = [(i, j) for i in range(-radius, radius + 1)
            for j in range(-radius, radius + 1) if i * i + j * j <= radius * radius]
    return np.asarray(offs, dtype=np.int64)


def _validate_device(face, pose, hand_l, hand_r):
    """Keypoint validation, batched: face [B, 70, 3] etc. -> (x, y) arrays
    with invalid points zeroed."""
    pose_xy = pose[..., :2] * (pose[..., 2] > POSE_CONF_THRESH)[..., None]

    face_valid = torch.zeros(face.shape[:-1], dtype=torch.bool,
                             device=face.device)
    for group in FACE_GROUPS:
        for edge in group:
            ok = (face[..., edge, 2] > FACE_CONF_THRESH).all(dim=-1)
            face_valid[..., edge] |= ok[..., None]
    face_xy = face[..., :2] * face_valid[..., None]

    def hand_xy(hand):
        valid = torch.zeros(hand.shape[:-1], dtype=torch.bool,
                            device=hand.device)
        for chain in HAND_CHAINS:
            ok = (hand[..., chain, 2] > HAND_CONF_THRESH).all(dim=-1)
            valid[..., chain] |= ok[..., None]
        return hand[..., :2] * valid[..., None]

    return face_xy, pose_xy, hand_xy(hand_l), hand_xy(hand_r)


def _segment_samples(p0, p1, valid, n_samples: int):
    """Sampled integer pixels of a batch of segments, reproducing the
    reference's major-axis linspace of int(span) points.

    p0, p1: [..., 2] f32 (x, y). Returns (xi, yi, keep [..., n_samples],
    n [...])."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    swap = (x0 - x1).abs() < (y0 - y1).abs()
    M0 = torch.where(swap, y0, x0)
    m0 = torch.where(swap, x0, y0)
    M1 = torch.where(swap, y1, x1)
    m1 = torch.where(swap, x1, y1)
    rev = M0 > M1
    M0, M1 = torch.where(rev, M1, M0), torch.where(rev, M0, M1)
    m0, m1 = torch.where(rev, m1, m0), torch.where(rev, m0, m1)
    n = torch.floor(M1 - M0).to(torch.int32)

    kk = torch.arange(n_samples, dtype=torch.float32, device=p0.device)
    kk = kk.expand(*M0.shape, n_samples)
    denom = torch.clamp(n[..., None] - 1, min=1).to(torch.float32)
    frac = kk / denom
    span = (M1 - M0)[..., None]
    posM = M0[..., None] + frac * span
    slope = torch.where(span == 0.0, torch.zeros_like(span),
                        (m1 - m0)[..., None] / span)
    posm = m0[..., None] + (posM - M0[..., None]) * slope

    keep = ((kk < n[..., None].to(torch.float32)) & valid[..., None]
            & (n[..., None] >= 1))
    Mi = torch.trunc(posM).to(torch.int64)
    mi = torch.trunc(posm).to(torch.int64)
    xi = torch.where(swap[..., None], mi, Mi)
    yi = torch.where(swap[..., None], Mi, mi)
    return xi, yi, keep, n


def _scatter_count(xi, yi, keep, h: int, w: int):
    """[B, N] sample coords -> [B, h, w] f32 counts (duplicates sum). Dropped
    samples land in one extra slot past the canvas, sliced off after."""
    b = xi.shape[0]
    flat = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
    flat = torch.where(keep, flat, torch.full_like(flat, h * w))
    grid = torch.zeros((b, h * w + 1), dtype=torch.float32, device=xi.device)
    grid.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.float32))
    return grid[:, : h * w].reshape(b, h, w)


INT32_MIN = -(2**31)


def _wrap_i32(x):
    """int64 values as the JAX path's int32 arithmetic leaves them: wrapped
    into [-2^31, 2^31)."""
    return torch.remainder(x - INT32_MIN, 2**32) + INT32_MIN


def _scatter_point_count(xi, yi, keep, offsets, h: int, w: int):
    """Stamp an offset pattern ([K, 2] (dy, dx)) around points [B, N], with
    canvas clipping. The point + offset sums wrap as int32 sums do: an
    endpoint filled with INT32_MIN (see :func:`_rasterize_chunk`) lands on
    the canvas edges exactly as in the JAX path."""
    yy = torch.clamp(_wrap_i32(yi[..., None] + offsets[:, 0]), 0, h - 1)
    xx = torch.clamp(_wrap_i32(xi[..., None] + offsets[:, 1]), 0, w - 1)
    kk = keep[..., None].expand(yy.shape)
    b = xi.shape[0]
    return _scatter_count(xx.reshape(b, -1), yy.reshape(b, -1),
                          kk.reshape(b, -1), h, w)


def _dilate_box(grid, bw: int):
    """Brush stamp counts: the sum over a (2bw)^2 box at offsets [-bw, bw),
    hence the asymmetric padding (bw-1 before, bw after) — the all-ones conv
    of the JAX path, taken as two separable window sums (exact for these
    small integer counts, and no TF32 on any device)."""
    k = 2 * bw
    padded = F.pad(grid, (bw - 1, bw, bw - 1, bw))
    return padded.unfold(1, k, 1).sum(-1).unfold(2, k, 1).sum(-1)


def _blend(canvas, count, color):
    """Per-pixel form of n sequential (v + c) // 2 averages: an empty pixel
    takes the color, a drawn one moves toward it by 2^-n. Updates
    ``canvas`` in place, touching only the covered pixels."""
    flat = canvas.view(-1, 3)
    cnt = count.reshape(-1)
    idx = torch.nonzero(cnt > 0.0).squeeze(1)
    v = flat[idx]
    inv = torch.exp2(-torch.clamp(cnt[idx], max=8.0))[:, None]
    mixed = torch.floor(v * inv + color * (1.0 - inv))
    empty = (v == 0.0).all(dim=-1, keepdim=True)
    flat[idx] = torch.where(empty, color.expand_as(v), mixed)
    return canvas


def _overwrite_disk(canvas, cx, cy, color, offsets, h: int, w: int):
    count = _scatter_point_count(cx[:, None], cy[:, None],
                                 torch.ones_like(cx, dtype=torch.bool)[:, None],
                                 offsets, h, w)
    color = torch.tensor(color, dtype=torch.float32, device=canvas.device)
    return torch.where((count > 0)[..., None], color, canvas)


def _draw_groups():
    """Static drawing plan (source, a[k], b[k], color, bw, endpoints,
    short): 10 pose edges, 5 finger chains per hand, then all face
    sub-edges in one white group — the reference's drawing order, with
    same-color segments merged (exact under the count rule of _blend).
    Sources: 0 pose, 1 left hand, 2 right hand, 3 face."""
    groups = []
    for (a, b), c in zip(POSE_EDGES, POSE_EDGE_COLORS):
        groups.append((0, [a], [b], c, POSE_BW, True, False))
    for s in (1, 2):
        for fi, chain in enumerate(HAND_CHAINS):
            groups.append((s, chain[:-1], chain[1:], HAND_CHAIN_COLORS[fi],
                           POSE_BW, True, True))
    groups.append((3, [a for a, _ in FACE_SUBEDGES],
                   [b for _, b in FACE_SUBEDGES], (255, 255, 255), FACE_BW,
                   False, True))
    return groups


_DRAW_GROUPS = _draw_groups()


def _rasterize_chunk(face, pose, hand_l, hand_r, width: int, height: int,
                     n_samples: int):
    """face [B, 210], pose [B, 75], hand_* [B, 63] f32 -> [B, H, W, 3]
    uint8."""
    b = face.shape[0]
    h, w = height, width
    dev = face.device
    face_xy, pose_xy, hl_xy, hr_xy = _validate_device(
        face.reshape(b, 70, 3), pose.reshape(b, 25, 3),
        hand_l.reshape(b, 21, 3), hand_r.reshape(b, 21, 3))
    sources = (pose_xy, hl_xy, hr_xy, face_xy)
    # Face and hand sub-edges span a small part of the canvas.
    n_short = max(n_samples // 4, 128)
    disk3 = torch.as_tensor(_disk_offsets(POSE_BW), device=dev)
    canvas = torch.zeros((b, h, w, 3), dtype=torch.float32, device=dev)

    for src, aa, bb, color, bw, has_ep, short in _DRAW_GROUPS:
        pts = sources[src]
        p0 = pts[:, aa]  # [B, k, 2]
        p1 = pts[:, bb]
        valid = (p0[..., 0] != 0.0) & (p1[..., 0] != 0.0)
        xi, yi, keep, n = _segment_samples(
            p0, p1, valid, n_short if short else n_samples)
        grid = _scatter_count(xi.reshape(b, -1), yi.reshape(b, -1),
                              keep.reshape(b, -1), h, w)
        colorb = torch.tensor(color, dtype=torch.float32, device=dev)
        canvas = _blend(canvas, _dilate_box(grid, bw), colorb)
        if has_ep:
            # Endpoint disks at sample 0 and sample n-1 of each segment. A
            # segment longer than the sample budget (keypoints drawn on a
            # canvas smaller than their span) has no sample n-1: the JAX
            # path's take_along_axis fills it with INT32_MIN, and so does
            # this one.
            last = torch.clamp(n - 1, min=0).to(torch.int64)[..., None]
            inside = last < xi.shape[-1]
            idx = torch.clamp(last, max=xi.shape[-1] - 1)

            def endpoint(v):
                end = torch.where(inside, torch.gather(v, -1, idx),
                                  torch.full_like(idx, INT32_MIN))
                return torch.cat([v[..., :1], end], dim=-1)

            ex, ey = endpoint(xi), endpoint(yi)
            ek = keep.any(dim=-1, keepdim=True).expand(ex.shape)
            cnt = _scatter_point_count(ex.reshape(b, -1), ey.reshape(b, -1),
                                       ek.reshape(b, -1), disk3, h, w)
            canvas = _blend(canvas, cnt, colorb)

    circle = torch.as_tensor(_circle_offsets(CIRCLE_RADIUS), device=dev)
    for hand_xy, color in zip((hl_xy, hr_xy), CIRCLE_COLORS):
        cx = torch.trunc(hand_xy[:, HAND_CENTER_POINT, 0]).to(torch.int64)
        cy = torch.trunc(hand_xy[:, HAND_CENTER_POINT, 1]).to(torch.int64)
        canvas = _overwrite_disk(canvas, cx, cy, color, circle, h, w)
    return torch.clamp(canvas, 0.0, 255.0).to(torch.uint8)


def draw(face, pose, hand_l, hand_r, size: Tuple[int, int], device,
         chunk: int = 64) -> torch.Tensor:
    """Tracks (face [T, 210], pose [T, 75], hands [T, 63], any float) ->
    [T, h, w, 3] uint8 label maps on ``device``, ``size`` = (w, h)."""
    w, h = size
    n_samples = -(-max(w, h) // 128) * 128

    def put(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

    face, pose, hand_l, hand_r = map(put, (face, pose, hand_l, hand_r))
    return torch.cat([
        _rasterize_chunk(face[lo: lo + chunk], pose[lo: lo + chunk],
                         hand_l[lo: lo + chunk], hand_r[lo: lo + chunk],
                         width=w, height=h, n_samples=n_samples)
        for lo in range(0, face.shape[0], chunk)])
