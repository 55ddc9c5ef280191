"""Pose inputs built from the committed golden OpenPose frames.

The reference data set (dictionaries, keypoint folders, timestamp files) is
not part of the repository, so the slice's smoke run and the parity tests
start from the 87 fadg0 frames under ``tests/goldens/fadg0_Shehadyour/pose``:
a :class:`KeypointTable` of those frames (flat keys ``("", i)``), a small
:class:`PoseDictionary` of a dozen ARPAbet symbols, and seeded
:class:`Timestamps`. ``plan_pose_track`` consumes them unchanged.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from text2video_tpu_torch.config import PersonProfile, get_profile
from text2video_tpu_torch.frontend.timestamps import Timestamps
from text2video_tpu_torch.io.dicts import KeypointTable, PoseDictionary
from text2video_tpu_torch.io.openpose import frame_from_raw, load_keypoint_json

GOLDEN_POSE_DIR = (
    Path(__file__).resolve().parent.parent
    / "tests" / "goldens" / "fadg0_Shehadyour" / "pose"
)
SYMBOLS = ("AA", "AE", "AH", "B", "D", "EH", "IY", "M", "OW", "S", "T", "UW")


def golden_table() -> KeypointTable:
    """KeypointTable of the golden frames, row i keyed ``("", i)``."""
    paths = sorted(GOLDEN_POSE_DIR.glob("*.json"))
    if not paths:
        raise FileNotFoundError(f"no golden pose frames under {GOLDEN_POSE_DIR}")
    frames = [frame_from_raw(load_keypoint_json(str(p))) for p in paths]
    return KeypointTable(
        face=np.stack([f.face for f in frames]),
        pose=np.stack([f.pose for f in frames]),
        hands=np.stack([np.stack([f.hand_l, f.hand_r]) for f in frames]),
        has_hands=np.asarray([f.has_hands for f in frames]),
        raws=[f.raw for f in frames],
        index={("", i): i for i in range(len(frames))},
    )


def golden_dictionary(table: KeypointTable, seed: int = 0) -> PoseDictionary:
    """Each symbol maps to a distinct seeded key frame of ``table``."""
    rng = np.random.RandomState(seed)
    rows = rng.choice(len(table), size=len(SYMBOLS), replace=False)
    return PoseDictionary(
        entries={s: ("", int(r)) for s, r in zip(SYMBOLS, rows)},
        layout="flat",
    )


def golden_timestamps(n_frames: int, seed: int = 0) -> Timestamps:
    """Seeded (frame, symbol) keys 2-8 frames apart; the last key is frame
    ``n_frames - 1``, so the planned utterance has exactly ``n_frames``."""
    if n_frames < 2:
        raise ValueError("golden_timestamps needs n_frames >= 2")
    rng = np.random.RandomState(seed)
    entries = []
    frame = int(rng.randint(0, 4))
    while frame < n_frames - 1:
        entries.append((frame, SYMBOLS[rng.randint(len(SYMBOLS))]))
        frame += int(rng.randint(2, 9))
    entries.append((n_frames - 1, SYMBOLS[rng.randint(len(SYMBOLS))]))
    return Timestamps(entries=tuple(entries))


def golden_pose_inputs(
    n_frames: int = 256, seed: int = 0
) -> Tuple[PersonProfile, PoseDictionary, KeypointTable, Timestamps]:
    """(fadg0 profile, dictionary, table, timestamps) for an utterance of
    ``n_frames`` frames (256 is ~10 s at 25 fps)."""
    table = golden_table()
    return (
        get_profile("fadg0"),
        golden_dictionary(table, seed),
        table,
        golden_timestamps(n_frames, seed),
    )
