"""Pose inputs built from the committed golden OpenPose frames.

The reference data set (dictionaries, keypoint folders, timestamp files) is
not part of the repository, so the smoke run and the parity tests start
from the committed golden frames: the 87 fadg0 frames under
``tests/goldens/fadg0_Shehadyour/pose`` and the 62 henan frames under
``tests/goldens/henan_111/pose``.

* :func:`golden_pose_inputs`: a :class:`KeypointTable` of the fadg0 frames
  (flat keys ``("", i)``), a small :class:`PoseDictionary` of a dozen
  ARPAbet symbols, and seeded :class:`Timestamps`, for ``plan_pose_track``.
* :func:`write_golden_assets`: a data directory laid out like the
  reference's, so ``get_profile(name, data_dir=root)`` and the CLI's
  ``--data-dir`` find dictionaries and keypoint folders for fadg0 and henan
  that cover every symbol the frontends can emit.
* :func:`write_training_assets`: paired real-frame images and keypoint
  JSONs for ``train/data.py::PoseClipDataset``, the images drawn from the
  keypoints.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Tuple

import numpy as np

from text2video_tpu_torch.config import (
    PACKAGED_DATA_DIR,
    PersonProfile,
    get_profile,
)
from text2video_tpu_torch.frontend.align_english import (
    ARPABET_BASE,
    add_default_stress,
)
from text2video_tpu_torch.frontend.timestamps import Timestamps
from text2video_tpu_torch.io.dicts import KeypointTable, PoseDictionary
from text2video_tpu_torch.io.openpose import frame_from_raw, load_keypoint_json

GOLDEN_DIR = Path(__file__).resolve().parent.parent / "tests" / "goldens"
GOLDEN_POSE_DIR = GOLDEN_DIR / "fadg0_Shehadyour" / "pose"
GOLDEN_HENAN_POSE_DIR = GOLDEN_DIR / "henan_111" / "pose"
SYMBOLS = ("AA", "AE", "AH", "B", "D", "EH", "IY", "M", "OW", "S", "T", "UW")


def golden_table() -> KeypointTable:
    """KeypointTable of the golden frames, row i keyed ``("", i)``."""
    paths = _golden_frames(GOLDEN_POSE_DIR)
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


def _english_symbols() -> list:
    """Every symbol the English aligner can emit: the ARPAbet consonants,
    each vowel with stress 0, 1 and 2, and ``sp``."""
    out = ["sp"]
    for p in ARPABET_BASE:
        if add_default_stress([p])[0] == p:  # a consonant
            out.append(p)
        else:
            out.extend(p + s for s in "012")
    return out


def _pinyin_syllables() -> list:
    """Every toneless syllable of the packaged pinyin table."""
    with open(PACKAGED_DATA_DIR / "pinyin_table.tsv", encoding="utf-8") as f:
        return sorted({ln.rstrip("\n").split("\t")[1] for ln in f
                       if ln.count("\t") == 1})


def _golden_frames(src: Path) -> list:
    paths = sorted(src.glob("*.json"))
    if not paths:
        raise FileNotFoundError(f"no golden pose frames under {src}")
    return paths


def write_golden_assets(root: str, seed: int = 0) -> str:
    """Write a data directory laid out like the reference's under ``root``
    and return ``root``:

    * fadg0 (clip layout): ``*phoneme_data/VidTIMIT/fadg0.txt`` and
      ``*phoneme_data/VidTIMIT/fadg0/keypoints_fadg0/golden_<fff>_keypoints
      .json``, every English symbol mapped to a seeded golden frame;
    * henan (flat layout): ``dict_henan.txt`` and
      ``*pinyin_data/henan/keypoints_henan/<fffff>_keypoints.json``, every
      toneless syllable of the pinyin table mapped to a seeded frame;
    * an empty pronouncing dictionary ``aligner/english/dict``, so every
      word goes through the G2P.
    """
    rng = np.random.RandomState(seed)
    fadg0 = get_profile("fadg0", data_dir=root)
    henan = get_profile("henan", data_dir=root)

    frames = _golden_frames(GOLDEN_POSE_DIR)
    os.makedirs(fadg0.keypoints_dir, exist_ok=True)
    for i, src in enumerate(frames):
        shutil.copyfile(src, os.path.join(
            fadg0.keypoints_dir, f"golden_{i:03d}_keypoints.json"))
    symbols = _english_symbols()
    rows = rng.randint(0, len(frames), size=len(symbols))
    with open(fadg0.dict_path, "w") as f:
        f.writelines(f"{s} golden {r:03d}\n" for s, r in zip(symbols, rows))

    frames = _golden_frames(GOLDEN_HENAN_POSE_DIR)
    os.makedirs(henan.keypoints_dir, exist_ok=True)
    for i, src in enumerate(frames):
        shutil.copyfile(src, os.path.join(
            henan.keypoints_dir, f"{i:05d}_keypoints.json"))
    syllables = _pinyin_syllables()
    rows = rng.randint(0, len(frames), size=len(syllables))
    with open(henan.dict_path, "w", encoding="utf-8") as f:
        f.writelines(f"{s} {r}\n" for s, r in zip(syllables, rows))

    dict_dir = os.path.join(root, "aligner", "english")
    os.makedirs(dict_dir, exist_ok=True)
    open(os.path.join(dict_dir, "dict"), "w").close()
    return root


def write_training_assets(root: str, n_frames: int = 40,
                          canvas: Tuple[int, int] = (512, 384)
                          ) -> Tuple[str, str]:
    """Write a GAN training set under ``root`` and return ``(images_dir,
    keypoints_dir)``: two runs of ``n_frames`` golden fadg0 pose frames each
    (``run0`` the first frames in order, ``run1`` the last ones reversed, so
    a holdout split has a run to hold out), as ``<run>_<frame>.jpg`` and
    ``<run>_<frame>_keypoints.json``. The JSONs are the golden files
    (annotated on fadg0's 512x384 canvas: pass that as the dataset's
    ``source_canvas``); each image is a deterministic drawing of its
    keypoints at ``canvas`` (w, h): a shaded background, the face outline
    filled, eyes, and the mouth, which moves with the pose."""
    import cv2

    paths = _golden_frames(GOLDEN_POSE_DIR)
    if not 2 <= n_frames <= len(paths):
        raise ValueError(f"n_frames {n_frames} outside 2..{len(paths)}")
    images_dir = os.path.join(root, "images")
    keypoints_dir = os.path.join(root, "keypoints")
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(keypoints_dir, exist_ok=True)
    w, h = canvas
    src_w, src_h = get_profile("fadg0").canvas
    yy, xx = np.mgrid[0:h, 0:w]
    background = np.stack([96 + 64 * xx / w, 112 + 48 * yy / h,
                           128 + 0 * xx], axis=-1).astype(np.uint8)
    runs = {"run0": paths[:n_frames], "run1": paths[::-1][:n_frames]}
    for run, members in runs.items():
        for i, src in enumerate(members):
            shutil.copyfile(src, os.path.join(
                keypoints_dir, f"{run}_{i:03d}_keypoints.json"))
            face = frame_from_raw(load_keypoint_json(str(src))).face
            pts = face.reshape(70, 3)[:, :2] * (w / src_w, h / src_h)
            pts = np.round(pts).astype(np.int32)
            img = background.copy()
            cv2.fillConvexPoly(img, cv2.convexHull(pts[:27]), (120, 150, 210))
            for eye in (pts[36:42], pts[42:48]):
                cv2.fillConvexPoly(img, cv2.convexHull(eye), (250, 250, 250))
            cv2.fillPoly(img, [pts[48:60]], (60, 50, 170))
            cv2.fillPoly(img, [pts[60:68]], (20, 20, 40))
            cv2.imwrite(os.path.join(images_dir, f"{run}_{i:03d}.jpg"), img)
    return images_dir, keypoints_dir
