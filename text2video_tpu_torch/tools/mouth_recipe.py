"""The mouth-selected training recipe, end to end (counterpart of
``tools/train_xuesong_mouth_r5.sh``, ``tools/train_henan_mouth_r5.sh`` and
``tools/henan_r5_continue.sh``).

Runs the scripts' stages through the port's own entry points, each guarded
by its output so that a rerun resumes where the last run stopped and redoes
what its arguments change (the evaluations and the clip keep the arguments
that made them beside them, in ``*.argv.json``):

0. ``tools.make_synthetic_frames``: avatar frames drawn from the keypoints;
1. recon: ``cli train-gan --lambda-adv 0 --lr 5e-4 --l1-mouth 5 ...`` to
   ``--recon-steps``, then a snapshot of the newest step;
2. adversarial: ``--segments`` segments of ``--segment-steps`` steps
   (``--lambda-adv 0.5 --d-lr-scale 0.25 --lr 1e-4``), a snapshot after
   each (``config.json`` copied, the step's files hard-linked: a step
   directory is never written again);
3. ``tools.eval_gan_many`` over the recon and every snapshot on the
   holdout split, one JSON line a checkpoint;
4. :func:`select_checkpoint`: the best mouth PSNR among the checkpoints
   whose whole-frame PSNR is at most 0.3 dB below the recon's, written as
   ``select.json`` in the shape of ``artifacts/bench/henan_r5_select.json``;
5. the winner's train-split ``tools.eval_gan``, and a clip through ``cli
   tts`` (``tts-chinese`` for a Mandarin person) with ``--gan-checkpoint``.

Every stage is a subprocess of ``python -m`` (the train stages must be:
``train-gan``'s stall watchdog ends a stalled process with ``os._exit(3)``).
A train stage that exits 3 runs again. Unlike the scripts, which passed the
whole relative ``--steps`` again on a resume (henan's recon overshot 1200 to
1500), a train stage passes only the steps still owed: its target minus the
newest step in the training directory.

    python -m text2video_tpu_torch.tools.mouth_recipe --keypoints KP \\
        --work runs/xuesong --person xuesong --clip-text 中国海油今天上午发布消息

Prints one JSON line: each stage's seconds and the step it reached, the
evaluation rows, the selection and the clip's files.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shlex
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional

from text2video_tpu_torch import checkpoints

REPO_ROOT = str(Path(__file__).resolve().parents[2])
CLI = "text2video_tpu_torch.cli"
STALL_EXIT = 3  # train/loop.py::_StallWatchdog.EXIT_CODE
MAX_DROP_DB = 0.3
MAX_FRAMES = 2600  # the frames drawn in stage 0 and trained on

# The scripts' train-gan flags: every train stage, recon, adversarial.
TRAIN_FLAGS = ["--device-data", "--batch-size", "2", "--clip-len", "8",
               "--max-frames", str(MAX_FRAMES), "--l1-mouth", "5",
               "--stall-timeout", "1200"]
RECON_FLAGS = ["--lambda-adv", "0", "--lr", "5e-4", "--sample-every", "300"]
ADV_FLAGS = ["--lambda-adv", "0.5", "--d-lr-scale", "0.25", "--lr", "1e-4",
             "--sample-every", "200"]

# runner(module, argv, stdout_path, timeout_s) -> exit code: runs
# ``python -m module argv``, its standard output appended to stdout_path.
Runner = Callable[[str, List[str], str, Optional[float]], int]


def run_module(module: str, argv: List[str], stdout_path: str,
               timeout: Optional[float] = None) -> int:
    """``python -m module *argv`` in a process of its own (a session of its
    own: a kill takes its children), standard output appended to
    ``stdout_path`` and standard error to ``stdout_path + ".err"``; killed
    and raising past ``timeout`` seconds. Returns its exit code."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    with open(stdout_path, "a") as out, open(stdout_path + ".err", "a") as err:
        err.write(f"$ python -m {module} {shlex.join(argv)}\n")
        err.flush()
        proc = subprocess.Popen([sys.executable, "-m", module, *argv],
                                stdout=out, stderr=err, env=env,
                                start_new_session=True)
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"python -m {module} passed its deadline of "
                               f"{timeout} s") from None
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()


def select_checkpoint(rows: List[dict], baseline: int = 0,
                      max_drop_db: float = MAX_DROP_DB) -> int:
    """Index of the row to ship: among the rows whose whole-frame
    ``psnr_db`` is at most ``max_drop_db`` below ``rows[baseline]``'s, the
    highest ``mouth_psnr_db``, the first on a tie (the rule of
    ``tools/train_xuesong_mouth_r5.sh`` and ``tools/henan_r5_continue.sh``)."""
    floor = rows[baseline]["psnr_db"] - max_drop_db
    best = None
    for i, row in enumerate(rows):
        if row["psnr_db"] < floor:
            continue
        if best is None or row["mouth_psnr_db"] > rows[best]["mouth_psnr_db"]:
            best = i
    return best


def latest_step(ckpt_dir: str) -> int:
    """The newest finished step of a training directory, 0 without one."""
    step_dir = checkpoints.latest_step_dir(ckpt_dir)
    return 0 if step_dir is None else int(
        os.path.basename(step_dir).split("_")[1])


def snapshot(train_dir: str, dst: str) -> int:
    """The newest step directory of ``train_dir`` with its ``config.json``,
    as a training directory ``dst`` of its own: the step's files are hard
    links, ``config.json`` (which every save rewrites) a copy. ``dst``
    appears whole or not at all. Returns the step."""
    step_dir = checkpoints.latest_step_dir(train_dir)
    if step_dir is None:
        raise FileNotFoundError(f"no step directory in {train_dir}")
    tmp = dst + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.copytree(step_dir, os.path.join(tmp, os.path.basename(step_dir)),
                    copy_function=os.link)
    shutil.copyfile(os.path.join(train_dir, checkpoints.CONFIG_NAME),
                    os.path.join(tmp, checkpoints.CONFIG_NAME))
    os.rename(tmp, dst)
    return latest_step(dst)


def train_to(runner: Runner, argv: List[str], ckpt: str, target: int,
             stdout_path: str, timeout: Optional[float] = None) -> dict:
    """Run ``train-gan`` (``argv``, without ``--ckpt`` and ``--steps``) on
    ``ckpt`` until its newest step is ``target``: each run asks for the
    steps still owed, and a run that exits :data:`STALL_EXIT` runs again.
    Returns the step it started from, the step reached and the runs."""
    start = latest_step(ckpt)
    runs = []
    while (done := latest_step(ckpt)) < target:
        owed = target - done
        rc = runner(CLI, ["train-gan", *argv, "--ckpt", ckpt, "--steps",
                          str(owed)], stdout_path, timeout)
        runs.append(dict(steps=owed, rc=rc))
        if rc == STALL_EXIT:
            continue
        if rc != 0:
            raise RuntimeError(f"train-gan exited {rc}; see {stdout_path}")
        if latest_step(ckpt) != target:
            raise RuntimeError(
                f"train-gan ran {owed} steps from step {done} of {ckpt} and "
                f"left step {latest_step(ckpt)}, not {target}")
    return dict(from_step=start, step=latest_step(ckpt), runs=runs)


def _rows(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.startswith("{")]


def _made_by(out: str, argv: List[str]) -> bool:
    """Whether ``out`` exists and was made by a run of ``argv`` (the
    arguments :func:`_record` kept beside it)."""
    try:
        with open(out + ".argv.json") as f:
            return os.path.exists(out) and json.load(f) == argv
    except FileNotFoundError:
        return False


def _record(out: str, argv: List[str]) -> None:
    with open(out + ".argv.json", "w") as f:
        json.dump(argv, f)


def _remove(out: str) -> None:
    """Delete the file or directory ``out`` and its record, where they
    exist."""
    for path in (out + ".argv.json", out):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)


def run_recipe(args, runner: Runner = run_module) -> dict:
    """Stages 0-5 for parsed ``args`` (see :func:`main`), each skipped when
    its output exists and was made from what the stage is given now: a
    snapshot must hold the step asked for, the evaluations and the clip
    must have been made with the arguments of this run (the snapshots, the
    selected checkpoint, the text), the selection from these rows. Returns
    the summary :func:`main` prints."""
    work = os.path.abspath(args.work)
    keypoints = os.path.abspath(args.keypoints)
    frames = os.path.join(work, "frames")
    train = os.path.join(work, "train")
    logs = os.path.join(work, "logs")
    os.makedirs(logs, exist_ok=True)
    timeout = args.timeout or None
    canvas = ["--width", str(args.width), "--height", str(args.height),
              "--source-width", str(args.source_width), "--source-height",
              str(args.source_height)]
    data = ["--images", frames, "--keypoints", keypoints, *canvas,
            "--device", args.device]
    stages = []

    def stage(name, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args) or {}
        stages.append(dict(stage=name, seconds=time.perf_counter() - t0,
                           **out))
        return out

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} exited {rc}; see {logs}")

    # ---- 0: avatar frames from the keypoints ---------------------------------
    def make_frames():
        n = min(len(glob.glob(os.path.join(keypoints, "*_keypoints.json"))),
                MAX_FRAMES)
        if len(glob.glob(os.path.join(frames, "*.jpg"))) >= n > 0:
            return dict(skipped=True, frames=n)
        check(runner("text2video_tpu_torch.tools.make_synthetic_frames",
                     ["--keypoints", keypoints, "--out", frames,
                      *canvas, "--limit", str(MAX_FRAMES)],
                     os.path.join(logs, "frames.log"), timeout),
              "make_synthetic_frames")
        return dict(frames=n)

    stage(0, make_frames)

    # ---- 1 and 2: recon, then adversarial segments, a snapshot each ------------
    train_argv = ["--images", frames, "--keypoints", keypoints, *canvas,
                  "--base-ch", str(args.base_ch), *TRAIN_FLAGS, "--device",
                  args.device]
    snaps = [os.path.join(work, "train_recon")]
    targets = [args.recon_steps]
    flags = [RECON_FLAGS]
    for k in range(1, args.segments + 1):
        targets.append(args.recon_steps + k * args.segment_steps)
        snaps.append(os.path.join(work, f"train_adv{targets[-1]}"))
        flags.append(ADV_FLAGS)

    def segment(k, snap, target, extra):
        if os.path.isdir(snap):
            if latest_step(snap) != target:
                raise RuntimeError(
                    f"{snap} holds step {latest_step(snap)}, not {target}: "
                    f"{work} was made with other step counts")
            return dict(skipped=True, step=target)
        out = train_to(runner, train_argv + extra, train, target,
                       os.path.join(logs, f"train{k}.log"), timeout)
        if snapshot(train, snap) != target:
            raise RuntimeError(f"snapshot {snap} is not step {target}")
        return out

    for k, seg in enumerate(zip(snaps, targets, flags)):
        stage(1 if k == 0 else 2, segment, k, *seg)

    # ---- 3: every candidate on the holdout split ------------------------------
    evals = os.path.join(work, "evals_holdout.jsonl")
    select_path = os.path.join(work, "select.json")
    train_eval = os.path.join(work, "eval_selected_train.json")
    clip_dir = os.path.join(work, "clip")
    eval_args = ["--clips", str(args.eval_clips), "--clip-len",
                 str(args.eval_clip_len)]

    def evaluate():
        cmd = ["--ckpts", *snaps, *data, "--split", "holdout", *eval_args]
        if _made_by(evals, cmd):
            return dict(skipped=True)
        _remove(evals)
        check(runner("text2video_tpu_torch.tools.eval_gan_many", cmd, evals,
                     timeout), "eval_gan_many")
        if [r["ckpt"] for r in _rows(evals)] != snaps:
            raise RuntimeError(f"eval_gan_many wrote {evals} without a row "
                               "for every checkpoint")
        _record(evals, cmd)

    stage(3, evaluate)
    rows = _rows(evals)

    # ---- 4: the mouth-metric selection ----------------------------------------
    def select():
        if os.path.exists(select_path):
            with open(select_path) as f:
                if json.load(f)["rows"] == rows:
                    return dict(skipped=True)
        pick = select_checkpoint(rows, baseline=0, max_drop_db=MAX_DROP_DB)
        with open(select_path + ".tmp", "w") as f:
            json.dump({"selected": rows[pick]["ckpt"], "rows": rows}, f)
        os.rename(select_path + ".tmp", select_path)

    stage(4, select)
    with open(select_path) as f:
        selected = json.load(f)["selected"]

    # ---- 5: the winner on the train split, and a clip from it ------------------
    def finish():
        out = {}
        cmd = ["--ckpt", selected, *data, "--split", "train", *eval_args]
        if _made_by(train_eval, cmd):
            out["eval_skipped"] = True
        else:
            _remove(train_eval)
            check(runner("text2video_tpu_torch.tools.eval_gan", cmd,
                         train_eval, timeout), "eval_gan")
            _record(train_eval, cmd)
        from text2video_tpu_torch.config import get_profile

        zh = get_profile(args.person, args.data_dir).language == "zh"
        clip = ["tts-chinese" if zh else "tts", args.clip_text, args.person,
                "--out", clip_dir, "--gan-checkpoint", selected,
                "--pose-device", args.pose_device, "--device", args.device]
        if args.data_dir:
            clip += ["--data-dir", args.data_dir]
        if args.aligner_model:
            clip += ["--aligner-model", args.aligner_model]
        if args.tts_pool:
            clip += ["--tts-pool", *args.tts_pool]
        if _made_by(clip_dir, clip):
            out["clip_skipped"] = True
            return out
        _remove(clip_dir)
        check(runner(CLI, clip, os.path.join(logs, "clip.log"), timeout),
              "the clip")
        _record(clip_dir, clip)
        return out

    stage(5, finish)
    return dict(stages=stages, rows=rows, selected=selected,
                train_eval=_rows(train_eval)[-1],
                clip=sorted(glob.glob(os.path.join(clip_dir, args.person,
                                                   "*"))))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m text2video_tpu_torch.tools.mouth_recipe",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--keypoints", required=True,
                   help="OpenPose JSON directory of the person")
    p.add_argument("--work", required=True,
                   help="directory of every stage's output; a rerun resumes "
                   "from it")
    p.add_argument("--width", type=int, default=896)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--source-width", type=int, default=1280,
                   help="the canvas the keypoints were annotated on")
    p.add_argument("--source-height", type=int, default=720)
    p.add_argument("--base-ch", type=int, default=64)
    p.add_argument("--recon-steps", type=int, default=1200)
    p.add_argument("--segments", type=int, default=3)
    p.add_argument("--segment-steps", type=int, default=200)
    p.add_argument("--eval-clips", type=int, default=4)
    p.add_argument("--eval-clip-len", type=int, default=16)
    p.add_argument("--person", default="xuesong",
                   help="the clip's person (tts-chinese for a zh profile)")
    p.add_argument("--clip-text", default="中国海油今天上午发布消息")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--aligner-model", default=None)
    p.add_argument("--tts-pool", nargs="+", default=None,
                   metavar="WAV_OR_TEXT")
    p.add_argument("--pose-device", choices=["host", "device"],
                   default="host")
    p.add_argument("--device", default="cuda",
                   help="torch device of every stage (default cuda)")
    p.add_argument("--timeout", type=float, default=0.0,
                   help="seconds each subprocess may take (0: no limit)")
    return p


def main(argv=None) -> int:
    summary = run_recipe(parser().parse_args(argv))
    print(json.dumps(summary, ensure_ascii=False))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
