"""OpenPose keypoint-JSON codec (counterpart of
``text2video_tpu/io/openpose.py``).

The reference consumes and emits OpenPose 1.3 JSON files of the form
``{"version": 1.3, "people": [{"person_id": [-1], "pose_keypoints_2d": [75
floats], "face_keypoints_2d": [210 floats], "hand_left_keypoints_2d": [63
floats or empty], ...}]}`` (reference:
*phoneme_data/VidTIMIT/fadg0/keypoints_fadg0/*.json and keypoint2img.py:70-90).

This codec is byte-faithful on round trip: non-track fields (person_id,
hands, 3d arrays, version) are carried through verbatim, and values that were
ints in the source stay ints, so a verbatim re-emit is bit-identical to
``json.dump`` of the original and a blended re-emit differs only in the
blended tracks — matching the reference's behavior of mutating only
``face_keypoints_2d`` / ``pose_keypoints_2d`` inside a deep-copied carrier
dict (reference: interp_landmarks_motion.py:78-89).
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Dict, Optional, Sequence

import numpy as np

POSE_POINTS = 25  # OpenPose BODY_25
FACE_POINTS = 70
HAND_POINTS = 21
POSE_DIM = POSE_POINTS * 3  # 75
FACE_DIM = FACE_POINTS * 3  # 210
HAND_DIM = HAND_POINTS * 3  # 63


@dataclasses.dataclass
class KeypointFrame:
    """One frame's keypoints as dense arrays plus its raw carrier dict.

    ``raw`` preserves every field of the source JSON so re-emission is
    byte-faithful; ``pose``/``face``/hands are float64 views for compute.
    """

    pose: np.ndarray  # [75]
    face: np.ndarray  # [210]
    hand_l: np.ndarray  # [63] (zeros if absent in source)
    hand_r: np.ndarray  # [63]
    has_hands: bool
    raw: Dict[str, Any]


def load_keypoint_json(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def frame_from_raw(raw: Dict[str, Any]) -> KeypointFrame:
    person = raw["people"][0]
    pose = np.asarray(person["pose_keypoints_2d"], dtype=np.float64).reshape(-1)
    face = np.asarray(person["face_keypoints_2d"], dtype=np.float64).reshape(-1)
    hl = person.get("hand_left_keypoints_2d") or []
    hr = person.get("hand_right_keypoints_2d") or []
    has_hands = len(hl) == HAND_DIM
    hand_l = (
        np.asarray(hl, dtype=np.float64)
        if has_hands
        else np.zeros(HAND_DIM, dtype=np.float64)
    )
    hand_r = (
        np.asarray(hr, dtype=np.float64)
        if len(hr) == HAND_DIM
        else np.zeros(HAND_DIM, dtype=np.float64)
    )
    if pose.shape[0] != POSE_DIM or face.shape[0] != FACE_DIM:
        raise ValueError(
            f"malformed keypoint JSON: pose={pose.shape} face={face.shape}"
        )
    return KeypointFrame(
        pose=pose, face=face, hand_l=hand_l, hand_r=hand_r,
        has_hands=has_hands, raw=raw,
    )


def load_keypoint_frame(path: str) -> KeypointFrame:
    return frame_from_raw(load_keypoint_json(path))


def raw_with_tracks(
    carrier: Dict[str, Any],
    face: Optional[Sequence] = None,
    pose: Optional[Sequence] = None,
    nested: bool = False,
) -> Dict[str, Any]:
    """Deep-copy ``carrier`` and replace its face/pose tracks.

    ``nested=True`` reproduces the reference's smoothing-output quirk where
    a ``(1, N)`` ndarray ``.tolist()`` produces a single-element nested list
    (reference: ...VidTIMIT_smooth.py:257-258 writes ``ave_fc.tolist()`` of a
    (1,210) array). Downstream consumers reshape through it transparently.
    """
    out = copy.deepcopy(carrier)
    person = out["people"][0]
    if face is not None:
        vals = [float(v) for v in face]
        person["face_keypoints_2d"] = [vals] if nested else vals
    if pose is not None:
        vals = [float(v) for v in pose]
        person["pose_keypoints_2d"] = [vals] if nested else vals
    return out


def dumps_keypoint_json(raw: Dict[str, Any]) -> str:
    """The same formatting as the reference's ``json.dump``."""
    return json.dumps(raw)
