"""OpenPose skeleton rasterization on the device (counterpart of the batched
device renderer in ``text2video_tpu/ops/rasterize.py``).

Every drawn primitive is a 2-point segment sampled like the reference's
``interpPoints``. Per drawing group the samples are scatter-counted into an
``[B, H, W]`` grid, dilated into the (2*bw)^2 brush footprint with an
all-ones conv, and blended into the canvas by the per-pixel count rule; the
hand-centre circles overwrite last. Counts and blends are integer-valued in
f32, so the result equals the JAX device path exactly.
``rasterize_batch_sharded`` splits an utterance's frames over a mesh.

Beside it, the bit-exact host drawing (``rasterize_frame_host``; numpy and
``cv2.circle``): the reference's sequential vector stamps, half-intensity
fringes, uint8 wraparound and the corner circles of a handless person, pixel
for pixel. It never runs on the serving path; it is the independent
reference the device drawing is held against (SSIM >= 0.96, as the JAX
package holds its own).

The topology constants and the host drawing are copied from the JAX module,
which cannot be imported without JAX.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from text2video_tpu_torch import device as devices
from text2video_tpu_torch.parallel.mesh import gather_rows, shard_rows

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


def hand_subedges() -> List[Tuple[int, int, int]]:
    """(finger, a, b) point-pairs for one hand in drawing order."""
    out = []
    for fi, chain in enumerate(HAND_CHAINS):
        for j in range(len(chain) - 1):
            out.append((fi, chain[j], chain[j + 1]))
    return out


FACE_SUBEDGES = face_subedges()
HAND_SUBEDGES = hand_subedges()


# ---- keypoint validation and the bit-exact host drawing (numpy) -------------


def validate_pose(pts: np.ndarray) -> np.ndarray:
    """[25,3] -> [25,2]: zero out low-confidence points."""
    out = np.zeros((pts.shape[0], 2))
    valid = pts[:, 2] > POSE_CONF_THRESH
    out[valid] = pts[valid, :2]
    return out


def validate_face(pts: np.ndarray) -> np.ndarray:
    """[70,3] -> [70,2]: a point survives if any containing face edge has
    all confidences above threshold."""
    out = np.zeros((70, 2))
    for group in FACE_GROUPS:
        for edge in group:
            idx = np.asarray(edge)
            if (pts[idx, 2] > FACE_CONF_THRESH).all():
                out[idx] = pts[idx, :2]
    return out


def validate_hand(pts: np.ndarray) -> np.ndarray:
    """[21,3] -> [21,2]: whole finger chains pass or fail together."""
    out = np.zeros((21, 2))
    for chain in HAND_CHAINS:
        idx = np.asarray(chain)
        if (pts[idx, 2] > HAND_CONF_THRESH).all():
            out[idx] = pts[idx, :2]
    return out


def _sample_segment(x: np.ndarray, y: np.ndarray):
    """Sampled integer pixels of a 2-point segment, reference semantics."""
    swapped = abs(x[0] - x[1]) < abs(y[0] - y[1])
    if swapped:
        x, y = y, x
    if x[0] > x[-1]:
        x = x[::-1].copy()
        y = y[::-1].copy()
    n = int(x[-1] - x[0])
    if n <= 0:
        return None, None
    xs = np.linspace(x[0], x[-1], n)
    if n == 1:
        ys = np.asarray([y[0]], dtype=float)
    else:
        a = (y[1] - y[0]) / (x[1] - x[0])
        b = y[0] - a * x[0]
        ys = a * xs + b
    xi, yi = xs.astype(int), ys.astype(int)
    if swapped:
        return yi, xi
    return xi, yi


def _vector_stamp(im: np.ndarray, yy: np.ndarray, xx: np.ndarray, color):
    """The reference's vectorized setColor: all-empty -> assign; else every
    target pixel averages with the color (uint8 floor)."""
    if (im[yy, xx] == 0).all():
        im[yy, xx, 0], im[yy, xx, 1], im[yy, xx, 2] = (color[0], color[1],
                                                       color[2])
    else:
        for c in range(3):
            im[yy, xx, c] = ((im[yy, xx, c].astype(float) + color[c])
                             / 2).astype(np.uint8)


def _draw_thick(im, xs, ys, bw, color, endpoints: bool):
    if xs is None or xs.size == 0:
        return
    h, w = im.shape[:2]
    for i in range(-bw, bw):
        for j in range(-bw, bw):
            yy = np.maximum(0, np.minimum(h - 1, ys + i))
            xx = np.maximum(0, np.minimum(w - 1, xs + j))
            _vector_stamp(im, yy, xx, color)
    if endpoints:
        for i in range(-bw * 2, bw * 2):
            for j in range(-bw * 2, bw * 2):
                if i * i + j * j < 4 * bw * bw:
                    yy = np.maximum(
                        0, np.minimum(h - 1, np.array([ys[0], ys[-1]]) + i))
                    xx = np.maximum(
                        0, np.minimum(w - 1, np.array([xs[0], xs[-1]]) + j))
                    _vector_stamp(im, yy, xx, color)


def _draw_circle(im: np.ndarray, cx: int, cy: int, radius: int, color):
    """Filled circle by overwrite (the reference uses cv2.circle)."""
    import cv2

    cv2.circle(im, (cx, cy), radius, color, -1)


def rasterize_person_host(
    pose_pts: np.ndarray,
    face_pts: np.ndarray,
    hand_l_pts: np.ndarray,
    hand_r_pts: np.ndarray,
    size: Tuple[int, int],
) -> np.ndarray:
    """One person's [25,3]/[70,3]/[21,3]x2 keypoints -> [h,w,3] uint8."""
    w, h = size
    im = np.zeros((h, w, 3), np.uint8)
    pose = validate_pose(pose_pts)
    face = validate_face(face_pts)
    hands = [validate_hand(hand_l_pts), validate_hand(hand_r_pts)]

    for edge, color in zip(POSE_EDGES, POSE_EDGE_COLORS):
        x = pose[list(edge), 0]
        y = pose[list(edge), 1]
        if 0 in x:
            continue
        xs, ys = _sample_segment(x, y)
        _draw_thick(im, xs, ys, POSE_BW, color, endpoints=True)

    for hand in hands:
        for fi, a, b in HAND_SUBEDGES:
            x = hand[[a, b], 0]
            y = hand[[a, b], 1]
            if 0 in x:
                continue
            xs, ys = _sample_segment(x, y)
            _draw_thick(im, xs, ys, POSE_BW, HAND_CHAIN_COLORS[fi],
                        endpoints=True)

    for a, b in FACE_SUBEDGES:
        x = face[[a, b], 0]
        y = face[[a, b], 1]
        if 0 in x:
            continue
        xs, ys = _sample_segment(x, y)
        _draw_thick(im, xs, ys, FACE_BW, (255, 255, 255), endpoints=False)

    for hand, color in zip(hands, CIRCLE_COLORS):
        _draw_circle(im, int(hand[HAND_CENTER_POINT, 0]),
                     int(hand[HAND_CENTER_POINT, 1]), CIRCLE_RADIUS, color)
    return im


def rasterize_frame_host(
    face_track: np.ndarray,
    pose_track: np.ndarray,
    hand_l: np.ndarray,
    hand_r: np.ndarray,
    size: Tuple[int, int],
) -> np.ndarray:
    """Track vectors (face [210], pose [75], hands [63]) -> [h,w,3] uint8.

    Accumulates with uint8 wraparound like the reference's multi-person
    ``pose_img +=`` (keypoint2img.py:89); with one person it is a copy.
    """
    img = np.zeros((size[1], size[0], 3), np.uint8)
    img += rasterize_person_host(
        pose_track.reshape(25, 3),
        face_track.reshape(70, 3),
        hand_l.reshape(21, 3),
        hand_r.reshape(21, 3),
        size,
    )
    return img


SSIM_MIN = 0.96  # the device drawing's bound against the host drawing


def whole_ssim(a: np.ndarray, b: np.ndarray) -> float:
    """Whole-image SSIM (one window: the image) of two uint8 frames, the
    JAX package's measure of the device drawing against the host drawing
    (``tests/test_rasterize.py``)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    mu_a, mu_b = a.mean(), b.mean()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    return float(((2 * mu_a * mu_b + c1) * (2 * cov + c2))
                 / ((mu_a ** 2 + mu_b ** 2 + c1) * (a.var() + b.var() + c2)))


# ---- the device drawing ------------------------------------------------------


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


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def rasterize_batch(face, pose, hand_l, hand_r, size: Tuple[int, int],
                    chunk: int = 64, to_host: bool = True, device=None):
    """Tracks (face [T, 210], pose [T, 75], hands [T, 63]; numpy or tensors)
    -> [T, h, w, 3] uint8 numpy frames, drawn on ``device`` (the card
    unless the caller names another) in chunks of ``chunk`` frames (the
    last padded with zeros).

    ``to_host=False`` returns the list of per-chunk device tensors instead,
    the last still padded to ``chunk`` frames, for an on-device consumer
    (the renderer)."""
    device = devices.resolve(device)
    w, h = size
    t_len = face.shape[0]
    n_samples = _round_up(max(w, h), 128)

    def put(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

    face, pose, hand_l, hand_r = map(put, (face, pose, hand_l, hand_r))
    outs = []
    for lo in range(0, t_len, chunk):
        hi = min(t_len, lo + chunk)
        pad = chunk - (hi - lo)

        def sl(x):
            return F.pad(x[lo:hi], (0, 0, 0, pad))

        outs.append(_rasterize_chunk(sl(face), sl(pose), sl(hand_l),
                                     sl(hand_r), width=w, height=h,
                                     n_samples=n_samples))
    if not to_host:
        return outs
    return np.concatenate([o.cpu().numpy() for o in outs], axis=0)[:t_len]


def rasterize_batch_sharded(face, pose, hand_l, hand_r, size: Tuple[int, int],
                            mesh) -> np.ndarray:
    """Frame-parallel rasterization over the mesh's "data" axis: the
    utterance's frames, padded to a multiple of the axis, split into one
    block a rank; each rank draws its block on its device with
    ``_rasterize_chunk`` and the blocks are gathered. Frames are
    independent, so no halo is needed and the labels are pixel-equal to
    :func:`rasterize_batch`'s. Every rank calls with the same tracks and gets
    the whole [T, h, w, 3] uint8 numpy result."""
    w, h = size
    t_len = face.shape[0]

    def block(x):
        x = torch.as_tensor(np.asarray(x, dtype=np.float32))
        return shard_rows(x, mesh).to(mesh.device)

    img = _rasterize_chunk(*map(block, (face, pose, hand_l, hand_r)),
                           width=w, height=h,
                           n_samples=_round_up(max(w, h), 128))
    return gather_rows(img, mesh, t_len).cpu().numpy()
