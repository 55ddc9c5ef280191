"""Fused pose synthesis: table gather + blend + recursive smoothing + mouth
re-pin in one launch.

Counterpart of ``text2video_tpu/ops/fused_pose.py``. The kernel
(``csrc/fused_pose.cu``) keeps the JAX kernel's numerical contract — pass 1
blends ``f1 * (1 - w2) + f2 * w2`` for every frame, pass 2 smooths in place
over ``s in [-sw, sw)`` with weight ``1/(|s|+1)`` (rows behind the cursor
already smoothed) and re-pins mouth points [48, 68) of the unsmoothed row by
the change of the mean of points [48, 60) in x and y. The TPU layout
artefacts (128-row T padding, 256/128 lane padding) are gone.

Dispatch: CPU tensors take :func:`blend_and_smooth_plain`; CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from text2video_tpu_torch import device as devices
from text2video_tpu_torch import kernels
from text2video_tpu_torch.ops.smooth import (
    MOUTH_CENTER_HI,
    MOUTH_CENTER_LO,
    MOUTH_HI,
    MOUTH_LO,
)

FACE_D, POSE_D = 210, 75
MAX_SMOOTH_WIDTH = 8  # the kernel is built for widths 1..8

# Kernel launches since import; chip_smoke.py reads and resets it.
launches = 0


def blend_and_smooth_plain(
    tabf: torch.Tensor,
    tabp: torch.Tensor,
    i1: torch.Tensor,
    i2: torch.Tensor,
    w2: torch.Tensor,
    smooth_width: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`blend_and_smooth`, on any device:
    a vectorised blend, then one step per frame."""
    w = w2[:, None]
    tab = torch.cat([tabf, tabp], dim=1)
    rows = tab[i1.long()] * (1.0 - w) + tab[i2.long()] * w  # [T, 285]
    t_len = rows.shape[0]
    sw = smooth_width
    s = torch.arange(-sw, sw, device=rows.device, dtype=torch.float32)
    weights = 1.0 / (s.abs() + 1.0)
    clo, chi = MOUTH_CENTER_LO * 3, MOUTH_CENTER_HI * 3
    mlo, mhi = MOUTH_LO * 3, MOUTH_HI * 3
    n_c = MOUTH_CENTER_HI - MOUTH_CENTER_LO
    xy_only = (torch.arange(3, device=rows.device) < 2).float()  # x, y
    for t in range(t_len):
        lo, hi = max(t - sw, 0), min(t + sw, t_len)
        wts = weights[lo - t + sw: hi - t + sw]
        inv = 1.0 / wts.sum().clamp(min=1e-20)
        ave = (rows[lo:hi] * wts[:, None]).sum(dim=0) * inv
        cur = rows[t]
        off = (
            ave[clo:chi].view(-1, 3).sum(dim=0) / n_c
            - cur[clo:chi].view(-1, 3).sum(dim=0) / n_c
        ) * xy_only  # confidences are not shifted
        ave[mlo:mhi] = (cur[mlo:mhi].view(-1, 3) + off).view(-1)
        rows[t] = ave
    return rows[:, :FACE_D].contiguous(), rows[:, FACE_D:].contiguous()


def blend_and_smooth(
    tabf: torch.Tensor,
    tabp: torch.Tensor,
    i1: torch.Tensor,
    i2: torch.Tensor,
    w2: torch.Tensor,
    smooth_width: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """tabf [N, 210], tabp [N, 75] f32; i1, i2 [T] int32 table rows; w2 [T]
    f32 -> smoothed (face [T, 210], pose [T, 75]) f32 on the same device."""
    if tabf.device.type == "cpu":
        return blend_and_smooth_plain(tabf, tabp, i1, i2, w2, smooth_width)
    if tabf.device.type != "cuda":
        raise ValueError(f"blend_and_smooth: unsupported device {tabf.device}")
    n = tabf.shape[0]
    t_len = i1.shape[0]
    if tuple(tabf.shape) != (n, FACE_D) or tuple(tabp.shape) != (n, POSE_D):
        raise ValueError(f"blend_and_smooth: bad table shapes "
                         f"{tuple(tabf.shape)} {tuple(tabp.shape)}")
    if t_len < 1 or tuple(i2.shape) != (t_len,) or tuple(w2.shape) != (t_len,):
        raise ValueError("blend_and_smooth: i1, i2, w2 must be [T], T >= 1")
    if not 1 <= smooth_width <= MAX_SMOOTH_WIDTH:
        raise ValueError(f"blend_and_smooth: the kernel takes smooth widths "
                         f"1..{MAX_SMOOTH_WIDTH}, got {smooth_width}")
    args = (tabf, tabp, i1, i2, w2)
    dtypes = (torch.float32,) * 2 + (torch.int32,) * 2 + (torch.float32,)
    for a, dt in zip(args, dtypes):
        if a.device != tabf.device or a.dtype != dt or not a.is_contiguous():
            raise ValueError("blend_and_smooth: inputs must be contiguous, "
                             "on one device, f32 tables/weights, int32 rows")
    outf = torch.empty((t_len, FACE_D), dtype=torch.float32, device=tabf.device)
    outp = torch.empty((t_len, POSE_D), dtype=torch.float32, device=tabf.device)
    lib = kernels.library()
    with torch.cuda.device(tabf.device):
        rc = lib.t2v_synthesize_and_smooth(
            *(a.data_ptr() for a in args), outf.data_ptr(), outp.data_ptr(),
            t_len, smooth_width, torch.cuda.current_stream().cuda_stream,
        )
    kernels.check_launch(rc, "synthesize_and_smooth")
    global launches
    launches += 1
    return outf, outp


def synthesize_and_smooth(
    plan, table, smooth_width: int = 4, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PosePlan + KeypointTable -> smoothed (face [T, 210], pose [T, 75])
    f32 tensors on ``device``, the card unless the caller names another
    (same contract as ``synthesize_and_smooth_pallas`` in
    ``text2video_tpu/ops/fused_pose.py``)."""
    device = devices.resolve(device)
    n = len(table)
    for rows in (plan.i1, plan.i2):
        if rows.size and (rows.min() < 0 or rows.max() >= n):
            raise IndexError(f"pose plan row out of range [0, {n})")

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return blend_and_smooth(
        put(table.face, torch.float32),
        put(table.pose, torch.float32),
        put(plan.i1, torch.int32),
        put(plan.i2, torch.int32),
        put(plan.w2, torch.float32),
        smooth_width,
    )
