"""Pose synthesis, plain: a phone timeline -> per-frame keypoint tracks.

The original script (``interp_landmarks_motion_phoneme_VidTIMIT_smooth.py``)
walks the timeline's key pairs, copies the moving key-pose sequences of the
recording near each key and blends them linearly between keys, holds the
first key pose before the first key, then smooths the tracks with an
inverse-distance window over ``[-width, width)`` that reads its own
already-smoothed earlier rows (the original mutates its list in place), and
pastes the unsmoothed mouth, shifted to the smoothed mouth centre, back over
it. Everything here is float64 NumPy, in the original's order of
operations.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

Key = Tuple[str, int]


@dataclasses.dataclass
class Recording:
    """A person's key-pose recording: row i is frame ``keys[i]`` (clip,
    index); ``dictionary`` maps a symbol to its key frame."""

    keys: List[Key]
    face: np.ndarray   # [N, 210]
    pose: np.ndarray   # [N, 75]
    hands: np.ndarray  # [N, 2, 63]
    dictionary: Dict[str, Key]

    def row_nearest(self, key: Key) -> int:
        """The row of (clip, frame), else of the clip's nearest frame (the
        earlier one on a tie)."""
        index = {k: i for i, k in enumerate(self.keys)}
        if key in index:
            return index[key]
        frames = sorted(f for c, f in self.keys if c == key[0])
        i = bisect.bisect_left(frames, key[1])
        if i == 0:
            near = frames[0]
        elif i >= len(frames):
            near = frames[-1]
        else:
            lo, hi = frames[i - 1], frames[i]
            near = lo if key[1] - lo <= hi - key[1] else hi
        return index[(key[0], near)]


@dataclasses.dataclass(frozen=True)
class PoseParams:
    motion_width: int
    transition_width: int
    min_key_dist: int
    key_gap_inclusive: bool
    smooth_width: int


def key_pairs(ts: Sequence[Tuple[int, str]], p: PoseParams):
    """The original's walk: take (ts[i], ts[i+1]) when their gap passes the
    threshold, else skip the middle key; the last pair is always taken."""
    pairs, n, i = [], len(ts), 0
    while i < n - 1:
        (d1, s1), (d2, s2) = ts[i], ts[i + 1]
        gap = d2 - d1
        ok = gap >= p.min_key_dist if p.key_gap_inclusive else gap > p.min_key_dist
        if ok:
            i += 1
        elif i == n - 2:
            i += 2
        else:
            d2, s2 = ts[i + 2]
            i += 2
        pairs.append((d1, s1, d2, s2))
    return pairs


def tracks(ts: Sequence[Tuple[int, str]], rec: Recording, p: PoseParams,
           rnd=None):
    """(face [T, 210], pose [T, 75], hands [T, 2, 63]) smoothed tracks of
    the timeline, T = last key frame + 1. Hands are the recording's at each
    frame's carrier row (the row whose JSON the original writes the frame
    into), never blended. ``rnd`` (the control) rounds the blend's inputs
    and every array the blend and the smoothing make to a lower
    precision."""
    rnd = rnd or (lambda a: a)
    n = ts[-1][0] + 1
    mw, tw = p.motion_width, p.transition_width
    first = rec.row_nearest(rec.dictionary[ts[0][1]])
    i1 = np.full(n, first)
    i2 = np.full(n, first)
    w2 = np.zeros(n)
    carrier = np.full(n, first)
    for d1, s1, d2, s2 in key_pairs(ts, p):
        (c1, k1), (c2, k2) = rec.dictionary[s1], rec.dictionary[s2]
        gap = d2 - d1
        if gap - 1 < 2 * mw + tw:
            for t in range(d1, d2 + 1):
                i1[t] = rec.row_nearest((c1, k1 + t - d1))
                i2[t] = rec.row_nearest((c2, k2 + t - d2))
                w2[t] = float(t - d1) / float(gap)
                carrier[t] = first
        else:
            for t in range(d1, d1 + mw + 1):
                i1[t] = i2[t] = carrier[t] = rec.row_nearest((c1, k1 + t - d1))
                w2[t] = 0.0
            for t in range(d2, d2 - mw - 1, -1):
                i1[t] = i2[t] = carrier[t] = rec.row_nearest((c2, k2 + t - d2))
                w2[t] = 0.0
            ja = rec.row_nearest((c1, k1 + mw))
            jb = rec.row_nearest((c2, k2 - mw))
            span = (d2 - mw) - (d1 + mw)
            for t in range(d1 + mw + 1, d2 - mw):
                i1[t], i2[t], carrier[t] = ja, jb, ja
                w2[t] = float(t - (d1 + mw)) / float(span)
    wb = rnd(w2[:, None])
    face_t, pose_t = rnd(rec.face), rnd(rec.pose)
    face = rnd(rnd(face_t[i1] * (1.0 - wb)) + rnd(face_t[i2] * wb))
    pose = rnd(rnd(pose_t[i1] * (1.0 - wb)) + rnd(pose_t[i2] * wb))
    face, pose = smooth(face, pose, p.smooth_width, rnd)
    return face, pose, rec.hands[carrier]


def smooth(face: np.ndarray, pose: np.ndarray, width: int, rnd=None):
    """The original's in-place smoothing with the mouth pasted back."""
    rnd = rnd or (lambda a: a)
    face, pose = face.copy(), pose.copy()
    t_len = face.shape[0]
    for t in range(t_len):
        sf = np.zeros(210)
        sp = np.zeros(75)
        sw = 0.0
        for s in range(-width, width):
            j = t + s
            if 0 <= j < t_len:
                wt = 1.0 / (abs(s) + 1.0)
                sf += face[j] * wt
                sp += pose[j] * wt
                sw += wt
        avg_f, avg_p = sf / sw, sp / sw
        orig = face[t].reshape(70, 3)
        off = (avg_f.reshape(70, 3)[48:60].mean(axis=0)
               - orig[48:60].mean(axis=0))
        mouth = orig[48:68].copy()
        mouth[:, :2] += off[:2]
        avg_f = avg_f.reshape(70, 3)
        avg_f[48:68] = mouth
        face[t] = rnd(avg_f.reshape(-1))
        pose[t] = rnd(avg_p)
    return face, pose
