"""Temporal smoothing with mouth re-pinning, on the host (counterpart of
``smooth_host`` in ``text2video_tpu/ops/smooth.py``; the port's device path
is the fused op in ``ops/fused_pose.py``; the mesh's is
``smooth_recursive_sharded``).

The reference smooths face (210-dim) and pose (75-dim) tracks with an
asymmetric inverse-distance window ``s in range(-smooth_width, smooth_width)``
(note: excludes +smooth_width) weighted ``1/(|s|+1)``, then *re-pins the
mouth*: the original (un-smoothed) mouth points 48-67 are shifted by the
difference of smoothed vs original mouth centers (average of points 48-59)
and pasted over the smoothed face, so lip articulation is not blurred
(reference: interp_landmarks_motion_phoneme_VidTIMIT_smooth.py:230-258,
mouth_center/mouth_shift at :104-114).

Crucial quirk: the reference mutates its frame list *in place* while
iterating (:257-258), so neighbors at negative offsets contribute their
already-smoothed, mouth-re-pinned values — the filter is recursive (IIR),
not a plain convolution. ``smooth_host`` is the bit-exact float64
sequential loop; ``smooth_recursive_sharded`` is byte-equal to it with the
time axis sharded over a mesh. ``smooth_fir_host`` / ``smooth_fir_sharded``
are the non-recursive variant, the second with a halo exchange.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from text2video_tpu_torch.parallel.mesh import (
    gather_rows,
    halo_rows,
    shard_rows,
)

MOUTH_CENTER_LO, MOUTH_CENTER_HI = 48, 60  # points averaged for the center
MOUTH_LO, MOUTH_HI = 48, 68  # points shifted & re-pinned


def smooth_host(
    face: np.ndarray, pose: np.ndarray, smooth_width: int = 4
) -> Tuple[np.ndarray, np.ndarray]:
    """(face [T,210], pose [T,75]) float64 -> smoothed copies, bit-exact.

    ``wf``/``wp`` play the role of the reference's in-place-mutated
    ``jsonlist``: rows before the current index already hold smoothed
    values when the window reads them.
    """
    T = face.shape[0]
    wf = face.copy()
    wp = pose.copy()
    _smooth_span(wf, wp, 0, T, T, smooth_width)
    return wf, wp


def _smooth_span(wf: np.ndarray, wp: np.ndarray, lo: int, hi: int,
                 t_valid: int, smooth_width: int) -> None:
    """``smooth_host``'s recursion over rows ``lo .. hi - 1`` of ``wf`` /
    ``wp``, in place; the window reads rows ``0 .. t_valid - 1`` only."""
    for idx in range(lo, hi):
        sum_fc = np.zeros((1, 210), dtype=np.float64)
        sum_ps = np.zeros((1, 75), dtype=np.float64)
        sum_w = 0.0
        for s in range(-smooth_width, smooth_width):
            sidx = s + idx
            if 0 <= sidx < t_valid:
                wt = 1.0 / (abs(s) + 1.0)
                sum_fc += wf[sidx] * wt
                sum_ps += wp[sidx] * wt
                sum_w += wt
        ave_fc = sum_fc / sum_w
        ave_ps = sum_ps / sum_w

        orig_fc = wf[idx].copy()
        c_t = np.average(
            ave_fc.reshape(70, 3)[MOUTH_CENTER_LO:MOUTH_CENTER_HI, :], axis=0
        )
        c_s = np.average(
            orig_fc.reshape(70, 3)[MOUTH_CENTER_LO:MOUTH_CENTER_HI, :], axis=0
        )
        off = c_t - c_s
        for i in range(MOUTH_LO, MOUTH_HI):
            orig_fc[i * 3] = orig_fc[i * 3] + off[0]
            orig_fc[i * 3 + 1] = orig_fc[i * 3 + 1] + off[1]
        ave_fc[0, MOUTH_LO * 3 : MOUTH_HI * 3] = orig_fc[
            MOUTH_LO * 3 : MOUTH_HI * 3
        ]
        wf[idx] = ave_fc[0]
        wp[idx] = ave_ps[0]


def smooth_recursive_sharded(face, pose, mesh, smooth_width: int = 4,
                             t_valid: Optional[int] = None,
                             warmup: int = 128
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """The exact recursive smoothing with the time axis sharded over the
    mesh's "data" axis: byte-equal to ``smooth_host`` on every valid frame,
    with no communication but the final ``all_gather``.

    The recursion's feedback is a contraction (the error dynamics form an
    AR(4) system whose companion matrix has spectral radius ~0.67), so each
    rank re-derives its carry by starting the recursion ``warmup`` frames
    before its block from a zero history: the start's error decays as
    0.67^k, and after 128 frames it lies far below half an ulp of a float64
    coordinate, so every rounded intermediate equals the sequential pass.
    A rank whose warm-up reaches frame 0 runs the true recursion. Each rank
    runs ``smooth_host``'s own loop (``_smooth_span``), so the order of
    operations is the same by construction.

    face [T, 210], pose [T, 75]; T must divide by the data axis. ``t_valid``:
    the utterance's length when the tail is padding. Every rank gets the
    whole float64 result; rows past ``t_valid`` keep their input."""
    n = mesh.n_data
    T = face.shape[0]
    if T % n != 0:
        raise ValueError(f"T={T} must divide over {n} shards")
    tl = T // n
    t_valid = T if t_valid is None else t_valid
    start = mesh.rank * tl
    lo = max(start - warmup, 0)
    wf = np.array(face, dtype=np.float64)
    wp = np.array(pose, dtype=np.float64)
    wf[:lo] = 0.0  # the zero history before the warm-up
    wp[:lo] = 0.0
    _smooth_span(wf, wp, lo, min(start + tl, t_valid), t_valid, smooth_width)
    out = [gather_rows(torch.from_numpy(x[start: start + tl]), mesh).numpy()
           for x in (wf, wp)]
    return out[0], out[1]


def smooth_fir_host(
    face: np.ndarray, pose: np.ndarray, smooth_width: int = 4
) -> Tuple[np.ndarray, np.ndarray]:
    """Non-recursive (FIR) variant: the window always reads ORIGINAL
    neighbor values. This is what the reference's loop would compute
    without its mutate-while-iterating quirk; it admits exact temporal
    sharding (see smooth_fir_sharded) because no cross-frame dependency
    chain exists. Mouth re-pin semantics are identical."""
    T = face.shape[0]
    out_f = np.empty_like(face)
    out_p = np.empty_like(pose)
    for idx in range(T):
        sum_fc = np.zeros(210, dtype=np.float64)
        sum_ps = np.zeros(75, dtype=np.float64)
        sum_w = 0.0
        for s in range(-smooth_width, smooth_width):
            sidx = s + idx
            if 0 <= sidx < T:
                wt = 1.0 / (abs(s) + 1.0)
                sum_fc += face[sidx] * wt
                sum_ps += pose[sidx] * wt
                sum_w += wt
        ave_fc = sum_fc / sum_w
        ave_ps = sum_ps / sum_w
        orig = face[idx]
        c_t = ave_fc.reshape(70, 3)[MOUTH_CENTER_LO:MOUTH_CENTER_HI].mean(0)
        c_s = orig.reshape(70, 3)[MOUTH_CENTER_LO:MOUTH_CENTER_HI].mean(0)
        off = c_t - c_s
        ave3 = ave_fc.reshape(70, 3).copy()
        ave3[MOUTH_LO:MOUTH_HI, 0] = orig.reshape(70, 3)[MOUTH_LO:MOUTH_HI, 0] + off[0]
        ave3[MOUTH_LO:MOUTH_HI, 1] = orig.reshape(70, 3)[MOUTH_LO:MOUTH_HI, 1] + off[1]
        ave3[MOUTH_LO:MOUTH_HI, 2] = orig.reshape(70, 3)[MOUTH_LO:MOUTH_HI, 2]
        out_f[idx] = ave3.reshape(-1)
        out_p[idx] = ave_ps
    return out_f, out_p


def smooth_fir_sharded(face, pose, mesh, smooth_width: int = 4,
                       t_valid: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """FIR smoothing (``smooth_fir_host``) in float32 with the time axis
    sharded over the mesh's "data" axis: each rank smooths its frame block on
    its device after a +-``smooth_width`` halo from its neighbours
    (``parallel.mesh.halo_rows``).

    face [T, 210], pose [T, 75]; T must divide by the data axis, and a block
    must be at least ``smooth_width`` frames. ``t_valid``: the utterance's
    length when the tail is padding (frames from ``t_valid`` on are out of
    every window, so padding never bleeds into real frames). Every rank gets
    the whole result, float32 numpy."""
    sw = smooth_width
    n = mesh.n_data
    T = face.shape[0]
    if T % n != 0:
        raise ValueError(f"T={T} must divide over {n} shards")
    tl = T // n
    if tl < sw:
        raise ValueError(f"per-shard block {tl} < halo width {sw}; pad T to "
                         f"at least {n * sw}")
    t_valid = T if t_valid is None else t_valid
    dev = mesh.device

    def block_with_halo(x):
        blk = shard_rows(torch.as_tensor(np.asarray(x, np.float32)),
                         mesh).to(dev)
        prev, nxt = halo_rows(blk, mesh, sw, sw)
        return blk, torch.cat([prev, blk, nxt])

    face_blk, face_ext = block_with_halo(face)
    _, pose_ext = block_with_halo(pose)
    t_global = mesh.rank * tl + torch.arange(tl, device=dev)
    offsets = torch.arange(-sw, sw, device=dev)
    t_win = t_global[:, None] + offsets[None, :]
    valid = ((t_win >= 0) & (t_win < t_valid)).float()
    w = (1.0 / (offsets.abs() + 1.0))[None, :] * valid  # [tl, 2sw]
    rows = torch.arange(tl, device=dev)[:, None] + sw + offsets[None, :]
    sum_w = w.sum(dim=1, keepdim=True)
    sum_w = torch.where(sum_w > 0, sum_w, torch.ones_like(sum_w))
    ave_f = torch.einsum("ts,tsd->td", w, face_ext[rows]) / sum_w
    ave_p = torch.einsum("ts,tsd->td", w, pose_ext[rows]) / sum_w
    # Mouth re-pin, as the sequential paths do.
    a3 = ave_f.reshape(tl, 70, 3).clone()
    o3 = face_blk.reshape(tl, 70, 3)
    c_t = a3[:, MOUTH_CENTER_LO:MOUTH_CENTER_HI].mean(dim=1)
    c_s = o3[:, MOUTH_CENTER_LO:MOUTH_CENTER_HI].mean(dim=1)
    off = c_t - c_s
    off[:, 2] = 0.0
    a3[:, MOUTH_LO:MOUTH_HI] = o3[:, MOUTH_LO:MOUTH_HI] + off[:, None, :]
    return (gather_rows(a3.reshape(tl, -1), mesh).cpu().numpy(),
            gather_rows(ave_p, mesh).cpu().numpy())
