"""Jacobi-vs-scan decoding fidelity of a checkpoint (counterpart of
``tools/jacobi_quality.py``).

What users of ``--decode jacobi --sweeps k`` get: PSNR between the exact
sequential scan and k-sweep Jacobi decoding of one held-out clip's label
maps, per k, and each decoding's PSNR against the real frames.

    python -m text2video_tpu_torch.tools.jacobi_quality --ckpt DIR \\
        --images .../images_fadg0 --keypoints .../keypoints_fadg0 \\
        [--sweeps 1,2,3,4] [--clip-len 32] [--device cpu]

Prints one JSON line ``{"psnr_vs_scan": {k: dB}, "psnr_vs_real": {k: dB},
"scan_vs_real_psnr": dB, "split": ..., "frames": N}``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Sequence

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0**2 / max(mse, 1e-12)))


def jacobi_quality(renderer, labels: np.ndarray, reals: np.ndarray,
                   sweeps: Sequence[int]) -> Dict:
    """``renderer``'s scan against its Jacobi decoding at each sweep count,
    on one clip: labels and reals [T, H, W, 3] uint8 at the renderer's
    working size."""
    scan = renderer.render(labels)
    vs_scan, vs_real = {}, {}
    for k in sweeps:
        jac = renderer.render_jacobi(labels, sweeps=k)
        vs_scan[str(k)] = round(psnr(scan, jac), 2)
        vs_real[str(k)] = round(psnr(jac, reals), 2)
    # How far the exact scan itself is from the real frames: Jacobi's error
    # matters only relative to the model's.
    return {"psnr_vs_scan": vs_scan, "psnr_vs_real": vs_real,
            "scan_vs_real_psnr": round(psnr(scan, reals), 2),
            "frames": int(labels.shape[0])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m text2video_tpu_torch.tools.jacobi_quality")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--keypoints", required=True)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--source-width", type=int, default=None,
                   help="resolution the keypoints were annotated at")
    p.add_argument("--source-height", type=int, default=None)
    p.add_argument("--split", choices=["holdout", "train", "all"],
                   default="holdout")
    p.add_argument("--sweeps", default="1,2,3,4")
    p.add_argument("--clip-len", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                   "plain versions)")
    args = p.parse_args(argv)

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
        max_t_step=1,
        cache_labels=False,
        split=args.split,
        device=args.device,
    )
    profile = PersonProfile(
        name="eval", language="en", canvas=(args.width, args.height),
        dict_path="", keypoints_dir="", keypoint_layout="clip",
    )
    renderer = load_renderer(args.ckpt, profile, device=args.device)
    renderer.time_bucket = args.clip_len
    labels, reals, _ = dataset.sample_clip(np.random.RandomState(7))
    out = jacobi_quality(renderer, labels, reals,
                         [int(s) for s in args.sweeps.split(",") if s])
    out["split"] = args.split
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
