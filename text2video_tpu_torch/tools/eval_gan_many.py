"""Evaluate several checkpoints of the same architecture in one process
(counterpart of ``tools/eval_gan_many.py``).

``eval_gan`` per checkpoint builds the renderer and stages the dataset again
each run; for selecting a checkpoint step that multiplies. Here the renderer
is built once and only the generator's weights are swapped between
checkpoints: the same metrics, the same split and the same clips, one JSON
line per checkpoint.

    python -m text2video_tpu_torch.tools.eval_gan_many --ckpts a b c \\
        --out-prefix out/eval_ --images ... --keypoints ... --width 896 \\
        --height 512 --source-width 1280 --source-height 720 --split holdout
"""

from __future__ import annotations

import argparse
import json
import os

from text2video_tpu_torch.tools import eval_gan


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m text2video_tpu_torch.tools.eval_gan_many")
    p.add_argument("--ckpts", nargs="+", required=True)
    p.add_argument("--out-prefix", default="")
    eval_gan.add_arguments(p)
    args = p.parse_args(argv)

    from text2video_tpu_torch.checkpoints import restore_generator_state

    renderer, dataset = eval_gan.load(args, args.ckpts[0])
    for i, ckpt in enumerate(args.ckpts):
        if i:  # the renderer was built from the first
            # In place: the layers' cached low-precision copies follow the
            # parameters' versions.
            renderer.generator.load_state_dict(
                restore_generator_state(ckpt), strict=True)
        row = {"ckpt": ckpt, **eval_gan.evaluate(
            renderer, dataset, args.clips, args.height, args.split)}
        print(json.dumps(row), flush=True)
        if args.out_prefix:
            name = os.path.basename(ckpt.rstrip("/"))
            with open(f"{args.out_prefix}{name}_{args.split}.json", "w") as f:
                json.dump(row, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
