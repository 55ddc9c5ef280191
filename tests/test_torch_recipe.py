"""The port's mouth-selected training recipe
(``text2video_tpu_torch/tools/mouth_recipe.py``): its selection rule against
the two committed selections, its stage flags against the text of the JAX
package's recipe scripts, the resume of a stalled train stage with the steps
still owed, its snapshots, and the whole chain on the CPU in a subprocess of
its own at a tiny size."""

import json
import os
import re
import shlex
import subprocess
import sys

import cv2
import pytest

from text2video_tpu_torch.tools import mouth_recipe as mr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN_TIMEOUT_S = 300.0  # the whole chain's subprocess
STAGE_TIMEOUT_S = 240.0  # each of its own subprocesses


def _artifact(name):
    with open(os.path.join(ROOT, "artifacts", "bench", name)) as f:
        return json.load(f)


def test_select_checkpoint_reproduces_xuesong_selection():
    """Rows keyed by candidate: the recon baseline first."""
    sel = _artifact("xuesong_r5_select.json")
    names = list(sel["rows"])
    assert names[0] == "xuesong_512_recon"
    pick = mr.select_checkpoint(list(sel["rows"].values()), baseline=0,
                                max_drop_db=0.3)
    assert names[pick] == sel["selected"] == "xuesong_512_adv1800"


def test_select_checkpoint_reproduces_henan_selection():
    """A list of rows with their ``ckpt``, as ``eval_gan_many`` prints."""
    sel = _artifact("henan_r5_select.json")
    pick = mr.select_checkpoint(sel["rows"], baseline=0, max_drop_db=0.3)
    assert sel["rows"][pick]["ckpt"] == sel["selected"]


def test_select_checkpoint_skips_regressions_and_keeps_first_tie():
    rows = [dict(psnr_db=30.0, mouth_psnr_db=20.0),
            dict(psnr_db=29.6, mouth_psnr_db=25.0),   # 0.4 dB down: out
            dict(psnr_db=29.7, mouth_psnr_db=21.0),   # exactly 0.3 down: in
            dict(psnr_db=31.0, mouth_psnr_db=21.0)]   # a tie: the first wins
    assert mr.select_checkpoint(rows) == 2


def _flags(tokens):
    """{flag: value or True} of a train-gan argument list."""
    out, i = {}, 0
    while i < len(tokens):
        if i + 1 < len(tokens) and not tokens[i + 1].startswith("--"):
            out[tokens[i]] = tokens[i + 1]
            i += 2
        else:
            out[tokens[i]] = True
            i += 1
    return out


PATH_FLAGS = ("--images", "--keypoints", "--ckpt", "--width", "--height",
              "--source-width", "--source-height")


@pytest.mark.parametrize("script", ["train_xuesong_mouth_r5.sh",
                                    "train_henan_mouth_r5.sh"])
def test_stage_flags_equal_the_scripts(script):
    """``TRAIN_FLAGS``, ``RECON_FLAGS`` and ``ADV_FLAGS`` equal the flags of
    the script's train stages; the recipe's defaults are xuesong's canvas,
    steps and segments; the selection's 0.3 dB is the scripts'."""
    with open(os.path.join(ROOT, "tools", script)) as f:
        text = f.read()
    train = _flags(shlex.split(
        re.search(r"train_args=\((.*?)\)", text, re.S).group(1)))
    recon, adv = (_flags(shlex.split(m.replace("\\\n", " "))) for m in
                  re.findall(r'train-gan "\$\{train_args\[@\]\}" \\\n(.*?)>>',
                             text, re.S))
    assert {k: v for k, v in train.items() if k not in PATH_FLAGS} == \
        _flags(mr.TRAIN_FLAGS)
    assert {k: v for k, v in recon.items() if k != "--steps"} == \
        _flags(mr.RECON_FLAGS)
    assert {k: v for k, v in adv.items() if k != "--steps"} == \
        _flags(mr.ADV_FLAGS)
    assert 'r["psnr_db"] < base["psnr_db"] - 0.3' in text
    assert mr.MAX_DROP_DB == 0.3
    d = mr.parser().parse_args(["--keypoints", "k", "--work", "w"])
    segs = [int(s) for s in re.search(r"for seg in ([\d ]+);",
                                      text).group(1).split()]
    assert (d.recon_steps, d.segment_steps) == (int(recon["--steps"]),
                                                int(adv["--steps"]))
    assert segs == [d.recon_steps + k * d.segment_steps
                    for k in range(1, d.segments + 1)]
    assert (d.width, d.height, mr.MAX_FRAMES) == (
        int(train["--width"]), int(train["--height"]),
        int(train["--max-frames"]))
    if "xuesong" in script:
        assert (d.source_width, d.source_height) == (
            int(train["--source-width"]), int(train["--source-height"]))
        assert d.person == "xuesong" and d.clip_text in text


def _write_step(ckpt, step):
    d = os.path.join(ckpt, f"step_{step:08d}")
    os.makedirs(d)
    with open(os.path.join(d, "state.pt"), "w") as f:
        f.write(str(step))
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump({"step_written": step}, f)


def test_stalled_train_stage_reruns_with_the_steps_owed(tmp_path):
    """A run that stalls (exit 3) after one of its three steps: the stage
    runs again asking for the two still owed, and ends at the target."""
    ckpt = str(tmp_path / "train")
    _write_step(ckpt, 2)
    calls = []

    def runner(module, argv, stdout_path, timeout):
        assert module == mr.CLI and argv[0] == "train-gan"
        assert timeout == 9.0
        owed = int(argv[argv.index("--steps") + 1])
        calls.append(owed)
        done = mr.latest_step(ckpt)
        if len(calls) == 1:
            _write_step(ckpt, done + 1)
            return mr.STALL_EXIT
        _write_step(ckpt, done + owed)
        return 0

    out = mr.train_to(runner, ["--lr", "1e-4"], ckpt, 5,
                      str(tmp_path / "log"), 9.0)
    assert calls == [3, 2]
    assert out == dict(from_step=2, step=5, runs=[dict(steps=3, rc=3),
                                                   dict(steps=2, rc=0)])


def test_train_stage_short_of_its_target_raises(tmp_path):
    """A run that exits 0 short of the target (a trainer that started over
    instead of resuming) is an error, not a silent rerun."""
    ckpt = str(tmp_path / "train")
    _write_step(ckpt, 4)

    def runner(module, argv, stdout_path, timeout):
        _write_step(ckpt, int(argv[argv.index("--steps") + 1]))
        return 0

    with pytest.raises(RuntimeError, match="not 6"):
        mr.train_to(runner, [], ckpt, 6, str(tmp_path / "log"))


def test_snapshot_links_the_step_and_copies_the_config(tmp_path):
    train = str(tmp_path / "train")
    for step in (3, 4):
        _write_step(train, step)
    snap = str(tmp_path / "snap")
    assert mr.snapshot(train, snap) == 4
    src = os.path.join(train, "step_00000004", "state.pt")
    dst = os.path.join(snap, "step_00000004", "state.pt")
    assert os.path.samefile(src, dst)
    assert not os.path.samefile(os.path.join(train, "config.json"),
                                os.path.join(snap, "config.json"))
    assert sorted(os.listdir(snap)) == ["config.json", "step_00000004"]
    assert not os.path.exists(snap + ".tmp")


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The whole chain as a user runs it, ``python -m ...mouth_recipe
    --device cpu``: base 8 at 64x48, one step a stage, two adversarial
    segments, a deadline on the chain and on each of its subprocesses."""
    from text2video_tpu_torch.golden import (
        write_golden_assets,
        write_training_assets,
    )

    root = tmp_path_factory.mktemp("recipe")
    _, keypoints = write_training_assets(str(root / "data"), 12, (64, 48))
    golden = write_golden_assets(str(root / "golden"))
    work = str(root / "work")
    argv = ["--keypoints", keypoints, "--work", work, "--width", "64",
            "--height", "48", "--source-width", "512", "--source-height",
            "384", "--base-ch", "8", "--recon-steps", "1", "--segments", "2",
            "--segment-steps", "1", "--eval-clips", "1", "--eval-clip-len",
            "8", "--person", "fadg0", "--clip-text",
            "She had your dark suit", "--data-dir", golden, "--device",
            "cpu", "--timeout", str(STAGE_TIMEOUT_S)]
    # One thread a process: the tiny model gains nothing from more, and in a
    # parallel test run the other workers hold the cores (at eight threads a
    # process the chain ran 2-6x slower there).
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "text2video_tpu_torch.tools.mouth_recipe",
         *argv], cwd=str(root), env=env, capture_output=True, text=True,
        timeout=CHAIN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(summary=json.loads(proc.stdout.strip().splitlines()[-1]),
                work=work, argv=argv)


def test_chain_runs_every_stage_in_order_and_resumes_each_step(chain):
    s = chain["summary"]
    assert [st["stage"] for st in s["stages"]] == [0, 1, 2, 2, 3, 4, 5]
    assert s["stages"][0]["frames"] == 24
    train = s["stages"][1:4]
    assert [(st["from_step"], st["step"]) for st in train] == [
        (0, 1), (1, 2), (2, 3)]
    assert all(st["runs"] == [dict(steps=1, rc=0)] for st in train)
    work = chain["work"]
    with open(os.path.join(work, "logs", "train1.log")) as f:
        assert "resumed from step 1" in f.read()
    snaps = [os.path.join(work, n)
             for n in ("train_recon", "train_adv2", "train_adv3")]
    assert [mr.latest_step(p) for p in snaps] == [1, 2, 3]


def test_chain_selection_eval_and_clip(chain):
    s = chain["summary"]
    rows = s["rows"]
    snaps = [os.path.join(chain["work"], n)
             for n in ("train_recon", "train_adv2", "train_adv3")]
    assert [r["ckpt"] for r in rows] == snaps
    assert all(r["split"] == "holdout" and r["frames"] == 8 for r in rows)
    assert s["selected"] == rows[mr.select_checkpoint(rows)]["ckpt"]
    with open(os.path.join(chain["work"], "select.json")) as f:
        assert json.load(f) == {"selected": s["selected"], "rows": rows}
    assert s["train_eval"]["split"] == "train"
    mp4 = [f for f in s["clip"] if f.endswith(".mp4")]
    assert [os.path.basename(f) for f in mp4] == ["Shehadyour.mp4"]
    cap = cv2.VideoCapture(mp4[0])
    # The model's 48 rows, rounded to 64 as the JAX loader rounds its
    # load_size (Renderer.target_hw); fadg0's 4:3 canvas at that height.
    assert cap.read()[1].shape == (64, 64, 3)
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) > 10
    cap.release()


def test_chain_rerun_skips_every_stage(chain, capsys):
    """Every stage's output exists: a rerun calls no subprocess."""
    def runner(*args):
        raise AssertionError(f"a stage ran again: {args}")

    s = mr.run_recipe(mr.parser().parse_args(chain["argv"]), runner)
    assert all(st.get("skipped") or st.get("clip_skipped")
               for st in s["stages"])
    assert s["selected"] == chain["summary"]["selected"]


class FakeStages:
    """A runner that stands in for every stage's subprocess: frames as empty
    files, a train step as a step directory, an evaluation row whose mouth
    PSNR is the checkpoint's step (so the newest snapshot wins), a clip named
    after the checkpoint it was made from. Records each call."""

    def __init__(self, root):
        self.keypoints = os.path.join(root, "keypoints")
        os.makedirs(self.keypoints)
        for i in range(4):
            open(os.path.join(self.keypoints, f"{i:04d}_keypoints.json"),
                 "w").close()
        self.calls = []

    def __call__(self, module, argv, stdout_path, timeout):
        name = argv[0] if module == mr.CLI else module.rsplit(".", 1)[1]
        self.calls.append(name)

        def arg(flag):
            return argv[argv.index(flag) + 1]

        if name == "make_synthetic_frames":
            os.makedirs(arg("--out"))
            for i in range(4):
                open(os.path.join(arg("--out"), f"{i:04d}.jpg"), "w").close()
        elif name == "train-gan":
            ckpt = arg("--ckpt")
            _write_step(ckpt, mr.latest_step(ckpt) + int(arg("--steps")))
        elif name in ("eval_gan_many", "eval_gan"):
            ckpts = (argv[1:argv.index("--images")] if name == "eval_gan_many"
                     else [arg("--ckpt")])
            with open(stdout_path, "a") as f:
                for c in ckpts:
                    f.write(json.dumps(dict(
                        ckpt=c, psnr_db=20.0, split=arg("--split"),
                        mouth_psnr_db=float(mr.latest_step(c)))) + "\n")
        else:  # the clip
            out = os.path.join(arg("--out"), argv[2])
            os.makedirs(out)
            name = os.path.basename(arg("--gan-checkpoint"))
            open(os.path.join(out, f"{name}_{argv[1]}.mp4"), "w").close()
        return 0

    def run(self, work, *extra):
        self.calls = []
        return mr.run_recipe(mr.parser().parse_args(
            ["--keypoints", self.keypoints, "--work", work, "--recon-steps",
             "1", "--segment-steps", "1", "--person", "fadg0", "--clip-text",
             "a", "--device", "cpu", *extra]), self)


def test_rerun_with_another_segment_redoes_what_follows(tmp_path):
    """A rerun with one more segment trains only that segment, scores every
    snapshot again, selects from the new rows, and evaluates and draws the
    clip of the new selection; the old clip is gone. A rerun with the same
    arguments runs nothing; another clip text redoes the clip alone; other
    recon steps than the work directory holds raise."""
    fake = FakeStages(str(tmp_path))
    work = str(tmp_path / "work")
    first = fake.run(work, "--segments", "2")
    assert fake.calls == ["make_synthetic_frames", "train-gan", "train-gan",
                          "train-gan", "eval_gan_many", "eval_gan", "tts"]
    assert first["selected"] == os.path.join(work, "train_adv3")

    s = fake.run(work, "--segments", "3")
    assert fake.calls == ["train-gan", "eval_gan_many", "eval_gan", "tts"]
    snaps = [os.path.join(work, n) for n in
             ("train_recon", "train_adv2", "train_adv3", "train_adv4")]
    assert [r["ckpt"] for r in s["rows"]] == snaps
    assert s["selected"] == snaps[-1]
    with open(os.path.join(work, "select.json")) as f:
        assert json.load(f) == {"selected": snaps[-1], "rows": s["rows"]}
    assert s["train_eval"]["ckpt"] == snaps[-1]
    assert [os.path.basename(c) for c in s["clip"]] == ["train_adv4_a.mp4"]

    fake.run(work, "--segments", "3")
    assert fake.calls == []
    s = fake.run(work, "--segments", "3", "--clip-text", "b")
    assert fake.calls == ["tts"]
    assert [os.path.basename(c) for c in s["clip"]] == ["train_adv4_b.mp4"]
    with pytest.raises(RuntimeError, match="other step counts"):
        fake.run(work, "--segments", "3", "--recon-steps", "2")
