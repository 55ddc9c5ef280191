"""Objective GAN evaluation: PSNR/SSIM of generated against ground-truth
frames (counterpart of ``tools/eval_gan.py``).

The reference's only quality evidence is a user study. This tool gives a
reproducible proxy: render clips from pose labels with the trained generator
and compare them to the real frames.

``--split holdout`` (the default) evaluates on the deterministic held-out
partition (``train/data.py::_split_runs``, the split that ``train-gan --split
train`` reserves), so the numbers are for frames the model never saw. SSIM is
the standard 11x11 Gaussian *windowed* SSIM (Wang et al. 2004), not a single
global-moment formula (global moments inflate scores by ignoring local
structure).

Beside the whole-frame numbers it reports mouth-crop PSNR/SSIM: a square
region around the label keypoints' mouth centre (the same points 48-59
average that drives the re-pin in ``ops/smooth.py``), the stand-in for a
lip-sync user study: whole-frame SSIM barely weights the one region the
pipeline exists to get right.

    python -m text2video_tpu_torch.tools.eval_gan --ckpt checkpoints/fadg0 \\
        --images .../images_fadg0 --keypoints .../keypoints_fadg0 \\
        [--split holdout|train|all] [--clips 4] [--clip-len 16] [--device cpu]

Prints one JSON line ``{"psnr_db", "ssim", "mouth_psnr_db", "mouth_ssim",
"mouth_crop_px", "split", "clips", "frames"}``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np


def windowed_ssim(a: np.ndarray, b: np.ndarray) -> float:
    """Mean local SSIM over 11x11 Gaussian windows (sigma 1.5), averaged
    over channels: the standard formulation. a, b: [H, W, C] uint8."""
    import cv2

    a = a.astype(np.float64)
    b = b.astype(np.float64)
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2

    def blur(x):
        return cv2.GaussianBlur(x, (11, 11), 1.5)

    mu_a, mu_b = blur(a), blur(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = blur(a * a) - mu_aa
    var_b = blur(b * b) - mu_bb
    cov = blur(a * b) - mu_ab
    ssim_map = ((2 * mu_ab + c1) * (2 * cov + c2)) / (
        (mu_aa + mu_bb + c1) * (var_a + var_b + c2))
    return float(ssim_map.mean())


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0**2 / max(mse, 1e-9)))


def mouth_side(height: int) -> int:
    """Mouth crop side: a quarter of the canvas height (about the lip region
    plus jaw context at every trained shape), even for clean halving."""
    return max(32, (height // 4) & ~1)


def mouth_crop(img: np.ndarray, center: np.ndarray, side: int) -> np.ndarray:
    """The ``side``-pixel square of ``img`` [H, W, C] around ``center``
    (x, y), moved inside the frame where it would stick out."""
    half = side // 2
    cx = int(np.clip(round(center[0]), half, img.shape[1] - half))
    cy = int(np.clip(round(center[1]), half, img.shape[0] - half))
    return img[cy - half: cy + half, cx - half: cx + half]


def evaluate(renderer, dataset, clips: int, height: int, split: str) -> Dict:
    """Render ``clips`` clips of ``dataset`` (the same ones on every call:
    a fixed seed) with ``renderer`` and score them against the real frames:
    the tool's JSON row."""
    side = mouth_side(height)
    rng = np.random.RandomState(7)
    psnrs, ssims, mpsnrs, mssims = [], [], [], []
    for _ in range(clips):
        labels, reals, centers = dataset.sample_clip(rng)
        fakes = renderer.render(labels)
        # Centres are annotated on the label canvas, which is the evaluation
        # canvas here; scaled in case the renderer worked at another size.
        sy = fakes.shape[1] / labels.shape[1]
        sx = fakes.shape[2] / labels.shape[2]
        for t in range(labels.shape[0]):
            psnrs.append(psnr(fakes[t], reals[t]))
            ssims.append(windowed_ssim(fakes[t], reals[t]))
            c = centers[t] * np.array([sx, sy])
            mf = mouth_crop(fakes[t], c, side)
            mr = mouth_crop(reals[t], c, side)
            mpsnrs.append(psnr(mf, mr))
            mssims.append(windowed_ssim(mf, mr))
    return {
        "psnr_db": round(float(np.mean(psnrs)), 2),
        "ssim": round(float(np.mean(ssims)), 4),
        "mouth_psnr_db": round(float(np.mean(mpsnrs)), 2),
        "mouth_ssim": round(float(np.mean(mssims)), 4),
        "mouth_crop_px": side,
        "split": split,
        "clips": clips,
        "frames": len(psnrs),
    }


def add_arguments(p: argparse.ArgumentParser) -> None:
    """The arguments every evaluation tool shares (all but the checkpoint)."""
    p.add_argument("--images", required=True)
    p.add_argument("--keypoints", required=True)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--source-width", type=int, default=None,
                   help="resolution the keypoints were annotated at "
                   "(e.g. 1280x720 for a 896x512 eval)")
    p.add_argument("--source-height", type=int, default=None)
    p.add_argument("--split", choices=["holdout", "train", "all"],
                   default="holdout")
    p.add_argument("--holdout-fraction", type=float, default=0.1)
    p.add_argument("--clips", type=int, default=4)
    p.add_argument("--clip-len", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                   "plain versions)")


def load(args, ckpt: str):
    """(renderer of ``ckpt``, evaluation dataset) for parsed ``args``."""
    from text2video_tpu_torch.checkpoints import load_renderer
    from text2video_tpu_torch.config import PersonProfile
    from text2video_tpu_torch.train.data import PoseClipDataset

    dataset = PoseClipDataset(
        images_dir=args.images,
        keypoints_dir=args.keypoints,
        canvas=(args.width, args.height),
        source_canvas=((args.source_width, args.source_height)
                       if args.source_width else None),
        clip_len=args.clip_len,
        cache_labels=False,
        split=args.split,
        holdout_fraction=args.holdout_fraction,
        device=args.device,
    )
    profile = PersonProfile(
        name="eval", language="en", canvas=(args.width, args.height),
        dict_path="", keypoints_dir="", keypoint_layout="clip",
    )
    renderer = load_renderer(ckpt, profile, device=args.device)
    renderer.time_bucket = args.clip_len
    return renderer, dataset


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m text2video_tpu_torch.tools.eval_gan")
    p.add_argument("--ckpt", required=True)
    add_arguments(p)
    args = p.parse_args(argv)
    renderer, dataset = load(args, args.ckpt)
    print(json.dumps(evaluate(renderer, dataset, args.clips, args.height,
                              args.split)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
