"""Key-pose insertion and interpolation as a vectorized table gather
(counterpart of ``text2video_tpu/ops/interp.py``: the host planner and
the float64 host blend; the port's device blend is fused into
``ops/fused_pose.py``).

The reference walks timestamp pairs and, per output frame, re-opens two
keypoint JSON files and blends 285 floats in Python (reference:
interp_landmarks_motion_phoneme_VidTIMIT_smooth.py:120-209 and
interp_landmarks_motion.py:148-225). Here the data-dependent control flow
(key skipping, short vs long segments) runs once on the host and produces a
*plan* — per-frame gather rows and blend weights — and the per-frame math
is one vectorized blend: ``out = w1 * table[i1] + w2 * table[i2]`` over the
whole utterance.

Algorithm parity notes (all reference cites into
...VidTIMIT_smooth.py unless said otherwise):

* Key-pair walk (:120-144): take (ts[i], ts[i+1]) when the frame gap passes
  the threshold (``>= min_key_dist`` English :127; ``> min_key_dist``
  Chinese, interp_landmarks_motion.py:154), else skip the middle key and
  take (ts[i], ts[i+2]); the final pair is always taken.
* Short segment (gap-1 < 2*motion_width + transition_width, :150-173):
  every frame blends the two *moving* key sequences — frame n uses key1's
  clip at offset (n - didx1) and key2's clip at offset (n - didx2), with
  linear weights across the whole interval.
* Long segment (:176-201): copy motion_width+1 real frames forward from
  key1 and backward from key2; blend the fixed frames key1+motion_width and
  key2-motion_width across the middle.
* Pre-roll (:81-88): frames [0, first key frame) hold the first key pose
  verbatim. The tail-hold loop (:206-209) is dead code — ``range(last+1,
  last)`` is empty — so the utterance ends exactly at the last key frame.
* Carrier semantics: blended frames are written into a deep copy of the
  *first* key frame's JSON whose hands/meta are never updated (:117-118);
  long-segment middles carry key1+motion_width's JSON (:198); copies carry
  their own JSON. The plan tracks the carrier row so emission is
  byte-faithful.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from text2video_tpu_torch.config import PersonProfile
from text2video_tpu_torch.frontend.timestamps import Timestamps
from text2video_tpu_torch.io.dicts import KeypointTable, PoseDictionary


@dataclasses.dataclass
class PosePlan:
    """Per-output-frame gather rows and blend weights.

    Arrays all have length T = last key frame + 1.
      i1, i2:    int32 rows into the keypoint table.
      w2:        float64 blend weight of i2 (w1 = 1 - w2).
      carrier:   int32 row whose raw JSON carries the non-blended fields.
      verbatim:  frames written as a byte-faithful copy of the carrier JSON
                 (pre-roll + long-segment motion ramps).
    """

    i1: np.ndarray
    i2: np.ndarray
    w2: np.ndarray
    carrier: np.ndarray
    verbatim: np.ndarray

    @property
    def num_frames(self) -> int:
        return self.i1.shape[0]


def _walk_key_pairs(
    ts: Timestamps, profile: PersonProfile
) -> List[Tuple[int, str, int, str]]:
    """Reproduce the reference's while-loop over timestamp pairs."""
    pairs: List[Tuple[int, str, int, str]] = []
    n = len(ts)
    idx = 0
    while idx < n - 1:
        d1, s1 = ts[idx]
        d2, s2 = ts[idx + 1]
        gap = d2 - d1
        ok = gap >= profile.min_key_dist if profile.key_gap_inclusive else (
            gap > profile.min_key_dist
        )
        if ok:
            idx += 1
        elif idx == n - 2:
            idx += 2
        else:
            d2, s2 = ts[idx + 2]
            idx += 2
        pairs.append((d1, s1, d2, s2))
    return pairs


def plan_pose_track(
    ts: Timestamps,
    pdict: PoseDictionary,
    table: KeypointTable,
    profile: PersonProfile,
) -> PosePlan:
    # Symbols missing from the pose dictionary (OOV pinyin, exotic
    # phonemes) are dropped with a warning — the reference KeyErrors.
    unknown = sorted({s for _, s in ts if s not in pdict})
    if unknown:
        import warnings

        warnings.warn(
            f"dropping {len(unknown)} timestamp symbols not in the pose "
            f"dictionary: {unknown[:8]}"
        )
        kept = tuple((f, s) for f, s in ts if s in pdict)
        if not kept:
            raise KeyError(
                f"no timestamp symbol found in the pose dictionary "
                f"(first unknowns: {unknown[:8]})"
            )
        ts = Timestamps(entries=kept)

    first_didx = ts.first_frame
    last_didx = ts.last_frame
    num_frames = last_didx + 1

    mw = profile.motion_width
    tw = profile.transition_width

    first_key = pdict.lookup(ts[0][1])
    first_row = table.row_nearest(first_key)

    # Default every frame to a verbatim hold of the first key pose so that
    # degenerate inputs (e.g. a single timestamp entry, which crashes the
    # reference) produce a sane still rather than garbage gathers.
    i1 = np.full(num_frames, first_row, dtype=np.int32)
    i2 = np.full(num_frames, first_row, dtype=np.int32)
    w2 = np.zeros(num_frames, dtype=np.float64)
    carrier = np.full(num_frames, first_row, dtype=np.int32)
    verbatim = np.ones(num_frames, dtype=bool)
    # The blended-frame carrier is the first key frame's JSON, deep-copied
    # once and reused for every short-segment frame (:117-118).
    template_row = first_row

    # Pre-roll hold.
    for t in range(0, first_didx):
        i1[t] = i2[t] = carrier[t] = first_row
        w2[t] = 0.0
        verbatim[t] = True

    for d1, s1, d2, s2 in _walk_key_pairs(ts, profile):
        clip1, k1 = pdict.lookup(s1)
        clip2, k2 = pdict.lookup(s2)
        gap = d2 - d1
        if gap <= 0:
            raise ValueError(
                f"non-increasing key frames {d1} -> {d2} for symbols "
                f"{s1!r} -> {s2!r}; the reference divides by zero here"
            )
        inter_frame_num = gap - 1
        if inter_frame_num < 2 * mw + tw:
            # Short: cross-fade the two moving key sequences.
            for n in range(d1, d2 + 1):
                i1[n] = table.row_nearest((clip1, k1 + n - d1))
                i2[n] = table.row_nearest((clip2, k2 + n - d2))
                w2[n] = float(n - d1) / float(gap)
                carrier[n] = template_row
                verbatim[n] = False
        else:
            # Long: motion ramps copied verbatim, linear blend in between.
            for n in range(d1, d1 + mw + 1):
                row = table.row_nearest((clip1, k1 + n - d1))
                i1[n] = i2[n] = carrier[n] = row
                w2[n] = 0.0
                verbatim[n] = True
            for n in range(d2, d2 - mw - 1, -1):
                row = table.row_nearest((clip2, k2 + n - d2))
                i1[n] = i2[n] = carrier[n] = row
                w2[n] = 0.0
                verbatim[n] = True
            ja = table.row_nearest((clip1, k1 + mw))
            jb = table.row_nearest((clip2, k2 - mw))
            intv = (d2 - mw) - (d1 + mw)
            for n in range(d1 + mw + 1, d2 - mw):
                i1[n] = ja
                i2[n] = jb
                w2[n] = float(n - (d1 + mw)) / float(intv)
                carrier[n] = ja
                verbatim[n] = False

    return PosePlan(i1=i1, i2=i2, w2=w2, carrier=carrier, verbatim=verbatim)


def synthesize_host(
    plan: PosePlan, table: KeypointTable
) -> Tuple[np.ndarray, np.ndarray]:
    """Bit-exact float64 blend: (face [T,210], pose [T,75]).

    Matches the reference arithmetic ``x1*w1 + x2*w2`` in float64 exactly,
    so emitted JSON floats are byte-identical.
    """
    w2 = plan.w2[:, None]
    w1 = 1.0 - w2
    face = table.face[plan.i1] * w1 + table.face[plan.i2] * w2
    pose = table.pose[plan.i1] * w1 + table.pose[plan.i2] * w2
    return face, pose

