"""The benchmark's inputs, made from a seed: keypoint tracks, a person's
key-pose recording and its dictionary, phone timelines, waveforms, label
maps and training frames. Every cell's traffic is one of these generators
driven by the numbers in its workload file.

Tracks start from a person's template frame (``benchmark/data``, one
OpenPose frame of the person) scaled to the working canvas, and move it with
a few seeded low-frequency motions: the head drifts, the jaw and lips open
and close at speech-like rates, the shoulders sway. Nothing here calls the
measured program.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import raster
from benchmark.reference.pose import Recording

DATA = Path(__file__).resolve().parent.parent / "data"
HEAD_POSE_POINTS = (0, 15, 16, 17, 18)  # nose, eyes, ears (BODY_25)


def template(person: str, canvas: Tuple[int, int]):
    """(face [70, 3], pose [25, 3]) of the person's template frame, scaled
    from its own canvas to ``canvas`` (w, h)."""
    d = json.loads((DATA / f"{person}_keypoints.json").read_text())
    sx, sy = canvas[0] / d["canvas"][0], canvas[1] / d["canvas"][1]
    scale = np.array([sx, sy, 1.0])
    face = np.array(d["face"], np.float64).reshape(70, 3) * scale
    pose = np.array(d["pose"], np.float64).reshape(25, 3) * scale
    return face, pose


def motion_tracks(face0: np.ndarray, pose0: np.ndarray, n: int,
                  rng: np.random.Generator, canvas: Tuple[int, int]):
    """(face [n, 210], pose [n, 75]) float64: the template moved by seeded
    head drift, mouth opening and body sway, frame by frame at 25 fps."""
    t = np.arange(n)[:, None] / 25.0
    w = canvas[0]

    def wave(amp, lo_hz, hi_hz, k=2):
        out = np.zeros((n, 1))
        for _ in range(k):
            f = rng.uniform(lo_hz, hi_hz)
            out += amp / k * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
        return out

    head = np.concatenate([wave(0.012 * w, 0.1, 0.6),
                           wave(0.008 * w, 0.1, 0.6)], axis=1)   # [n, 2]
    jaw_h = face0[8, 1] - face0[27, 1]                           # chin - nose top
    mouth = np.clip(0.5 + wave(0.5, 2.0, 5.0, 3), 0.0, 1.0)[:, 0] * 0.12 * jaw_h
    sway = np.concatenate([wave(0.006 * w, 0.05, 0.3),
                           wave(0.003 * w, 0.05, 0.3)], axis=1)

    face = np.repeat(face0[None], n, axis=0)
    face[:, :, :2] += head[:, None, :]
    lower = np.zeros(70)
    lower[5:12] = 0.5                  # lower jaw
    lower[[55, 56, 57, 58, 59]] = 1.0  # outer lower lip
    lower[[65, 66, 67]] = 1.0          # inner lower lip
    face[:, :, 1] += mouth[:, None] * lower[None, :]
    pose = np.repeat(pose0[None], n, axis=0)
    valid = pose0[:, 2] > 0
    body = np.where(valid, 1.0, 0.0)
    pose[:, :, :2] += sway[:, None, :] * body[None, :, None]
    for j in HEAD_POSE_POINTS:
        if valid[j]:
            pose[:, j, :2] += head - sway
    return face.reshape(n, 210), pose.reshape(n, 75)


def recording(person: str, canvas: Tuple[int, int], clips: int,
              clip_frames: int, symbols: Sequence[str],
              rng: np.random.Generator) -> Recording:
    """A key-pose recording of ``clips`` clips of ``clip_frames`` frames and
    a dictionary mapping each symbol to a seeded (clip, frame)."""
    face0, pose0 = template(person, canvas)
    keys, faces, poses = [], [], []
    for c in range(clips):
        f, p = motion_tracks(face0, pose0, clip_frames, rng, canvas)
        keys += [(f"c{c:02d}", i) for i in range(clip_frames)]
        faces.append(f)
        poses.append(p)
    dictionary = {s: (f"c{int(rng.integers(clips)):02d}",
                      int(rng.integers(clip_frames))) for s in symbols}
    face, pose = np.concatenate(faces), np.concatenate(poses)
    return Recording(keys=keys, face=face, pose=pose,
                     hands=np.zeros((face.shape[0], 2, 63)),
                     dictionary=dictionary)


def write_recording(rec: Recording, root: Path) -> Tuple[str, str]:
    """The recording in the original data layout: a 3-column dictionary
    ("SYMBOL clip frame") and ``{clip}_{frame:03d}_keypoints.json`` OpenPose
    files. Returns (dictionary path, keypoint directory)."""
    kp = root / "keypoints"
    kp.mkdir(parents=True, exist_ok=True)
    for (clip, i), face, pose in zip(rec.keys, rec.face, rec.pose):
        person = {"person_id": -1, "pose_keypoints_2d": pose.tolist(),
                  "face_keypoints_2d": face.tolist(),
                  "hand_left_keypoints_2d": [], "hand_right_keypoints_2d": []}
        (kp / f"{clip}_{i:03d}_keypoints.json").write_text(
            json.dumps({"version": 1.3, "people": [person]}))
    dict_path = root / "dictionary.txt"
    dict_path.write_text("".join(f"{s} {c} {i:03d}\n"
                                 for s, (c, i) in rec.dictionary.items()))
    return str(dict_path), str(kp)


def timeline(n_frames: int, symbols: Sequence[str], gap: Sequence[int],
             rng: np.random.Generator) -> List[Tuple[int, str]]:
    """Seeded (frame, symbol) keys ``gap[0]..gap[1]`` frames apart whose last
    key is frame ``n_frames - 1``: an utterance of ``n_frames`` frames."""
    entries = []
    frame = int(rng.integers(0, 4))
    while frame < n_frames - 1:
        entries.append((frame, symbols[int(rng.integers(len(symbols)))]))
        frame += int(rng.integers(gap[0], gap[1] + 1))
    entries.append((n_frames - 1, symbols[int(rng.integers(len(symbols)))]))
    return entries


def waveform(n_frames: int, fps: float, rate: int,
             rng: np.random.Generator) -> np.ndarray:
    """A speech-length float32 waveform: voiced harmonics under a syllabic
    envelope, plus a little noise."""
    t = np.arange(int(round(n_frames / fps * rate))) / rate
    f0 = rng.uniform(110.0, 220.0)
    voiced = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3.0, 5.0) * t)
    noise = rng.standard_normal(t.shape[0]) * 0.02
    return (0.2 * env * voiced + noise).astype(np.float32)


def label_rows(person: str, canvas: Tuple[int, int], rows: int, frames: int,
               rng: np.random.Generator, device) -> torch.Tensor:
    """[rows, frames, h, w, 3] uint8 skeleton label maps on ``device``:
    each row one utterance of moving keypoints, drawn by the reference's
    drawing."""
    face0, pose0 = template(person, canvas)
    out = []
    for _ in range(rows):
        face, pose = motion_tracks(face0, pose0, frames, rng, canvas)
        hands = np.zeros((frames, 63))
        out.append(raster.draw(face, pose, hands, hands, canvas, device))
    return torch.stack(out)


def mouth_centers(face: np.ndarray) -> np.ndarray:
    """[T, 210] -> [T, 2]: the mean of points 48-59 (the original's mouth
    centre)."""
    return face.reshape(-1, 70, 3)[:, 48:60, :2].mean(axis=1)


def training_frames(labels: torch.Tensor, gen: torch.Generator
                    ) -> torch.Tensor:
    """[N, h, w, 3] uint8 'real' frames for label maps [N, h, w, 3]: a
    seeded low-frequency colour field with the skeleton blurred into it."""
    n, h, w, _ = labels.shape
    dev = labels.device
    field = torch.randn((1, 3, h // 64 + 1, w // 64 + 1), generator=gen,
                        device=dev)
    field = torch.nn.functional.interpolate(field, size=(h, w),
                                            mode="bilinear")
    drift = torch.randn((n, 3, 1, 1), generator=gen, device=dev) * 0.1
    lab = labels.permute(0, 3, 1, 2).float()
    blur = torch.nn.functional.avg_pool2d(lab, 5, 1, 2)
    img = 128.0 + 40.0 * (field + drift) + 0.5 * (blur - 64.0)
    return img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def stable_lengths(lo: int, hi: int, count: int) -> List[int]:
    """``count`` utterance lengths spread evenly over [lo, hi]: every seed
    gets the same set, in its own order."""
    return [int(round(v)) for v in np.linspace(lo, hi, count)]


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent NumPy stream per (seed, purpose); ``seed`` may be any
    non-negative integer."""
    return np.random.default_rng([seed, sum(map(ord, stream)), len(stream)])


def symbol_inventory(spec: Dict) -> List[str]:
    """The symbols of a person's dictionary from a workload's ``symbols``
    entry: consonants as they are, vowels with stress 0, 1 and 2, extras."""
    out = list(spec.get("extra", []))
    out += list(spec.get("consonants", []))
    out += [v + s for v in spec.get("vowels", []) for s in "012"]
    return out
