"""Phoneme/pinyin-pose dictionaries and the preloaded keypoint table
(counterpart of ``text2video_tpu/io/dicts.py``).

The reference re-opens and JSON-parses the same keypoint files once per
output frame inside its interpolation loop (reference:
interp_landmarks_motion_phoneme_VidTIMIT_smooth.py:151-173 — its hottest
CPU loop). Here the whole key-pose recording is loaded once into dense
``[N, 285]`` arrays; dictionary lookup plus moving-sequence offsets become a
vectorized table *gather*, and the per-frame blend is one vectorized
step over the utterance (see ``ops/interp.py``).

Two dictionary formats (reference: §2.4 of SURVEY.md):
  * English, 3-column "PHONEME clip frame" (e.g. ``AA0 sa1 038``) —
    *phoneme_data/VidTIMIT/fadg0.txt; keypoint files are
    ``{clip}_{frame:03d}_keypoints.json``.
  * Chinese, 2-column "pinyin frame" (e.g. ``ba 50``) — dict_henan.txt;
    keypoint files are ``{frame:05d}_keypoints.json`` (one long recording).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Any, Dict, List, Tuple

import numpy as np

from text2video_tpu_torch.io import openpose
from text2video_tpu_torch.io.openpose import FACE_DIM, HAND_DIM, POSE_DIM

# A key-pose is addressed by (clip, frame). Flat (Chinese) layouts use
# clip = "" throughout.
Key = Tuple[str, int]


@dataclasses.dataclass(frozen=True)
class PoseDictionary:
    """symbol -> (clip, key frame index) mapping."""

    entries: Dict[str, Key]
    layout: str  # "clip" | "flat"

    @classmethod
    def load(cls, path: str, layout: str) -> "PoseDictionary":
        entries: Dict[str, Key] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if layout == "clip":
                    if len(parts) != 3:
                        raise ValueError(f"bad 3-column dict line: {line!r}")
                    entries[parts[0]] = (parts[1], int(parts[2]))
                else:
                    if len(parts) != 2:
                        raise ValueError(f"bad 2-column dict line: {line!r}")
                    entries[parts[0]] = ("", int(parts[1]))
        return cls(entries=entries, layout=layout)

    def __contains__(self, sym: str) -> bool:
        return sym in self.entries

    def lookup(self, sym: str) -> Key:
        if sym not in self.entries:
            raise KeyError(
                f"symbol {sym!r} not in pose dictionary "
                f"({len(self.entries)} entries)"
            )
        return self.entries[sym]


_CLIP_RE = re.compile(r"^(?P<clip>.+)_(?P<frame>\d{3})_keypoints\.json$")
_FLAT_RE = re.compile(r"^(?P<frame>\d{5})_keypoints\.json$")


class KeypointTable:
    """All key-pose keypoint frames of one person, as dense arrays.

    Attributes:
      face: [N, 210] float64 — face tracks.
      pose: [N, 75] float64 — body tracks.
      hands: [N, 2, 63] float64 — zeros where source hands were empty.
      has_hands: [N] bool.
      raws: list of N raw dicts (carriers for byte-faithful JSON emission).
    """

    def __init__(
        self,
        face: np.ndarray,
        pose: np.ndarray,
        hands: np.ndarray,
        has_hands: np.ndarray,
        raws: List[Dict[str, Any]],
        index: Dict[Key, int],
    ):
        self.face = face
        self.pose = pose
        self.hands = hands
        self.has_hands = has_hands
        self.raws = raws
        self._index = index

    def __len__(self) -> int:
        return self.face.shape[0]

    @classmethod
    def load_dir(cls, keypoints_dir: str, layout: str) -> "KeypointTable":
        pattern = os.path.join(keypoints_dir, "*_keypoints.json")
        paths = sorted(glob.glob(pattern))
        if not paths:
            raise FileNotFoundError(f"no keypoint JSONs under {keypoints_dir}")
        face = np.zeros((len(paths), FACE_DIM), dtype=np.float64)
        pose = np.zeros((len(paths), POSE_DIM), dtype=np.float64)
        hands = np.zeros((len(paths), 2, HAND_DIM), dtype=np.float64)
        has_hands = np.zeros(len(paths), dtype=bool)
        raws: List[Dict[str, Any]] = []
        index: Dict[Key, int] = {}
        rx = _CLIP_RE if layout == "clip" else _FLAT_RE
        for row, path in enumerate(paths):
            name = os.path.basename(path)
            m = rx.match(name)
            if not m:
                raise ValueError(f"unexpected keypoint filename {name!r}")
            key: Key = (
                (m.group("clip"), int(m.group("frame")))
                if layout == "clip"
                else ("", int(m.group("frame")))
            )
            kf = openpose.load_keypoint_frame(path)
            face[row] = kf.face
            pose[row] = kf.pose
            hands[row, 0] = kf.hand_l
            hands[row, 1] = kf.hand_r
            has_hands[row] = kf.has_hands
            raws.append(kf.raw)
            index[key] = row
        return cls(face, pose, hands, has_hands, raws, index)

    def row_nearest(self, key: Key) -> int:
        """Row for (clip, frame), falling back to the clip's nearest
        existing frame. The shipped Chinese keypoint folders are sparse
        (e.g. xuesong: 2,978 files over a 0..4500 index range) — the
        reference crashes with FileNotFoundError when the interpolation
        window lands in a gap; clamping to the nearest captured frame
        keeps every dictionary entry usable. Exact hits stay exact."""
        if key in self._index:
            return self._index[key]
        clip, frame = key
        frames = self._clip_frames().get(clip)
        if not frames:
            raise KeyError(f"no keypoint frames for clip {clip!r}")
        import bisect

        i = bisect.bisect_left(frames, frame)
        if i == 0:
            near = frames[0]
        elif i >= len(frames):
            near = frames[-1]
        else:
            lo, hi = frames[i - 1], frames[i]
            near = lo if frame - lo <= hi - frame else hi
        return self._index[(clip, near)]

    def _clip_frames(self) -> Dict[str, List[int]]:
        cache = getattr(self, "_clip_frames_cache", None)
        if cache is None:
            cache = {}
            for (clip, frame) in self._index:
                cache.setdefault(clip, []).append(frame)
            for v in cache.values():
                v.sort()
            self._clip_frames_cache = cache
        return cache

