"""Temporal smoothing with mouth re-pinning, on the host (counterpart of
``smooth_host`` in ``text2video_tpu/ops/smooth.py``; the port's device path
is the fused op in ``ops/fused_pose.py``).

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
sequential loop.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

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
    for idx in range(T):
        sum_fc = np.zeros((1, 210), dtype=np.float64)
        sum_ps = np.zeros((1, 75), dtype=np.float64)
        sum_w = 0.0
        for s in range(-smooth_width, smooth_width):
            sidx = s + idx
            if 0 <= sidx < T:
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
    return wf, wp
