"""The port's entry points against the JAX package's: ``run_tts``,
``run_audio`` and ``run_tts_chinese`` on a data directory written by
``golden.write_golden_assets`` (exact timestamps and label maps), batched
serving at B=2 with the same f32 weights (uint8 +-1 over a short rollout,
random weights make longer ones chaotic), the CLI, ``emit_intermediates``'
pose JSONs, and the checkpoint round trip."""

import json
import os

import numpy as np
import pytest
import torch

from text2video_tpu import config as jconfig
from text2video_tpu_torch import config as tconfig
from text2video_tpu_torch import pipeline as tpipe
from text2video_tpu_torch.config import PACKAGED_DATA_DIR
from text2video_tpu_torch.convert import params_from_flax
from text2video_tpu_torch.frontend.audio import save_wav
from text2video_tpu_torch.golden import write_golden_assets
from text2video_tpu_torch.render import Renderer

torch.set_num_threads(1)

SR = 16000
EN_TEXT = "Do they make it"
EN_TEXT2 = "She had your dark suit"
ZH_TEXT = "你好"
N_CMP = 6  # frames compared between the two renderers


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_golden_assets(str(tmp_path_factory.mktemp("golden")))


@pytest.fixture
def jnative(monkeypatch):
    """The JAX package's native binding on the port's library (no build
    into ``native/build``)."""
    from text2video_tpu.frontend import native as jn

    from text2video_tpu_torch.frontend import native as tn

    path = tn.ensure_built()
    monkeypatch.setattr(jn, "ensure_built", lambda: path)
    monkeypatch.setattr(jn, "_lib", None)
    return jn


def _aligners(jnative, data_dir):
    from text2video_tpu.frontend.align_english import EnglishAligner as JaxAl

    from text2video_tpu_torch.frontend.align_english import EnglishAligner

    model = str(PACKAGED_DATA_DIR / "english_fadg0.am")
    pdict = os.path.join(data_dir, "aligner", "english", "dict")
    return EnglishAligner.load(model, pdict), JaxAl.load(model, pdict)


def _tiny_renderers(load_size=64, max_frames=N_CMP):
    """(JAX, port) f32 renderers with the same seeded weights, heads x0.1
    (see test_torch_generator.py), working at ``load_size`` rows."""
    import jax
    import jax.numpy as jnp

    from text2video_tpu.models.generator import CompositeGenerator
    from text2video_tpu.render import Renderer as JaxRenderer

    gen = CompositeGenerator(base_ch=8, n_blocks=1, dtype=jnp.float32)
    params = jax.jit(gen.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 9)),
                               jnp.zeros((1, 64, 64, 6)), jnp.ones((1,)))
    params = jax.tree_util.tree_map(np.array, params)
    params["params"]["heads"]["kernel"] *= 0.1
    kw = dict(load_size=load_size, max_frames=max_frames)
    jr = JaxRenderer(generator=gen, params=params,
                     config=jconfig.RenderConfig(**kw), time_bucket=4)
    tr = Renderer.create(config=tconfig.RenderConfig(**kw), base_ch=8,
                         n_blocks=1, dtype=torch.float32, device="cpu")
    tr.generator.load_state_dict(params_from_flax(params), strict=True)
    tr.time_bucket = 4
    return jr, tr


def _pipelines(tmp_path, data_dir, person, aligners=(None, None),
               renderers=(None, None), **cfg):
    from text2video_tpu.pipeline import Text2VideoPipeline as JaxPipeline

    tal, jal = aligners
    jr, tr = renderers
    cfg.setdefault("frame_chunk", 8)  # rasterize 8 frames a chunk, not 64
    port = tpipe.Text2VideoPipeline(
        tconfig.PipelineConfig(person=tconfig.get_profile(person, data_dir),
                               out_dir=str(tmp_path / "torch"), **cfg),
        renderer=tr, aligner=tal, device="cpu")
    ref = JaxPipeline(
        jconfig.PipelineConfig(person=jconfig.get_profile(person, data_dir),
                               out_dir=str(tmp_path / "jax"), **cfg),
        renderer=jr, aligner=jal)
    return port, ref


def _same_run(out, ref):
    assert out.name == ref.name and out.num_frames == ref.num_frames
    assert out.timestamps.entries == ref.timestamps.entries
    assert out.label_maps.shape == ref.label_maps.shape
    np.testing.assert_array_equal(out.label_maps, ref.label_maps)


@pytest.mark.parametrize("entry", ["run_tts", "run_audio", "run_tts_chinese"])
def test_entry_point_matches_jax(jnative, tmp_path, data_dir, entry):
    from text2video_tpu_torch.frontend.tts import FormantTTS

    if entry == "run_tts_chinese":
        port, ref = _pipelines(tmp_path, data_dir, "henan")
        assert port.mandarin_aligner is not None
        out = port.run_tts_chinese(ZH_TEXT, keep_arrays=True)
        want = ref.run_tts_chinese(ZH_TEXT, keep_arrays=True)
    else:
        port, ref = _pipelines(tmp_path, data_dir, "fadg0",
                               _aligners(jnative, data_dir))
        if entry == "run_tts":
            out = port.run_tts(EN_TEXT, keep_arrays=True)
            want = ref.run_tts(EN_TEXT, keep_arrays=True)
        else:
            wav = str(tmp_path / "in.wav")
            save_wav(wav, FormantTTS().synthesize(EN_TEXT, SR), SR)
            out = port.run_audio(EN_TEXT, wav, keep_arrays=True)
            want = ref.run_audio(EN_TEXT, wav, keep_arrays=True)
    _same_run(out, want)
    assert {"align", "pose_synthesis", "rasterize", "mux"} <= set(
        out.stage_seconds)
    assert [os.path.basename(f) for f in out.files] == \
        [os.path.basename(f) for f in want.files]


def test_run_audio_batch_matches_jax(jnative, tmp_path, data_dir):
    from text2video_tpu_torch.frontend.tts import FormantTTS

    items = []
    for i, text in enumerate((EN_TEXT, EN_TEXT2)):
        wav = str(tmp_path / f"u{i}.wav")
        save_wav(wav, FormantTTS().synthesize(text, SR), SR)
        items.append((text, wav))
    port, ref = _pipelines(tmp_path, data_dir, "fadg0",
                           _aligners(jnative, data_dir), _tiny_renderers())
    outs = port.run_audio_batch(items, keep_arrays=True)
    wants = ref.run_audio_batch(items, keep_arrays=True)
    assert len(outs) == 2 and outs[0].num_frames != outs[1].num_frames
    for out, want in zip(outs, wants):
        _same_run(out, want)
        assert out.frames.shape == want.frames.shape == (N_CMP, 64, 64, 3)
        assert np.abs(out.frames.astype(int)
                      - want.frames.astype(int)).max() <= 1
        assert out.frames.std() > 1.0
    assert set(outs[0].stage_seconds) == {"frontend", "rasterize",
                                          "batch_pad", "render", "mux"}


def test_render_many_device_matches_jax():
    import jax.numpy as jnp

    jr, tr = _tiny_renderers(load_size=None, max_frames=1200)
    labels = np.random.RandomState(3).randint(0, 256, (2, N_CMP, 32, 48, 3),
                                              np.uint8)
    ref = jr.render_many_device(jnp.asarray(labels))
    out = tr.render_many_device(torch.from_numpy(labels))
    assert out.shape == ref.shape == (2, N_CMP, 32, 48, 3)
    assert out.dtype == np.uint8
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(tr.render_many(labels), out)
    # Batch row i is the batch-1 render of utterance i (up to the CPU
    # convolutions' rounding, which depends on the batch size).
    single = tr.render_many(labels[1:])
    assert np.abs(single.astype(int) - out[1:].astype(int)).max() <= 1


def _tiny_checkpoint(path, seed=0):
    from text2video_tpu_torch.checkpoints import save_renderer

    renderer = Renderer.create(seed=seed, base_ch=8, n_blocks=1,
                               dtype=torch.float32, device="cpu")
    save_renderer(renderer, str(path), height=64)
    return renderer


def test_checkpoint_round_trip(tmp_path):
    from text2video_tpu_torch.checkpoints import load_renderer

    src = _tiny_checkpoint(tmp_path / "ckpt", seed=5)
    meta = json.loads((tmp_path / "ckpt" / "config.json").read_text())
    assert meta == {"base_ch": 8, "n_blocks": 1, "height": 64}
    r = load_renderer(str(tmp_path / "ckpt"), tconfig.get_profile("henan"),
                      device="cpu")
    assert r.config.load_size == 64 and r.generator.dtype == torch.bfloat16
    assert r.target_hw(1080, 1920) == (64, 128)
    a, b = src.generator.state_dict(), r.generator.state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    rj = load_renderer(str(tmp_path / "ckpt"), tconfig.get_profile("henan"),
                       decode_mode="jacobi", jacobi_sweeps=5, device="cpu")
    assert (rj.config.decode_mode, rj.config.jacobi_sweeps) == ("jacobi", 5)
    with pytest.raises(ValueError, match="decode_mode"):
        load_renderer(str(tmp_path / "ckpt"), tconfig.get_profile("henan"),
                      decode_mode="parallel", device="cpu")


def _cli_json(capsys, argv):
    from text2video_tpu_torch import cli

    capsys.readouterr()
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("command,text,person,hw", [
    ("tts", EN_TEXT, "fadg0", (64, 64)),
    ("tts-chinese", ZH_TEXT, "henan", (64, 128)),
])
def test_cli_with_checkpoint_on_cpu(capsys, tmp_path, data_dir, command, text,
                                    person, hw):
    import cv2

    from text2video_tpu_torch.frontend.textnorm import derive_file_name

    _tiny_checkpoint(tmp_path / "ckpt")
    out = _cli_json(capsys, [
        command, text, person, "f", "--data-dir", data_dir,
        "--gan-checkpoint", str(tmp_path / "ckpt"), "--device", "cpu",
        "--pose-device", "device", "--out", str(tmp_path / "out")])
    name = derive_file_name(text)
    assert out["name"] == name and out["frames"] > 10
    base = tmp_path / "out" / person / name
    assert out["files"] == [str(base) + ext for ext in (".mp4", ".wav", ".avi")]
    assert all(os.path.getsize(f) > 0 for f in out["files"])
    assert {"tts", "align", "render", "mux"} <= set(out["stage_seconds"])
    cap = cv2.VideoCapture(out["files"][0])
    ok, first = cap.read()
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    assert ok and first.shape[:2] == hw and n == out["frames"]


@pytest.mark.parametrize("command,text,person", [
    ("tts", EN_TEXT, "fadg0"), ("audio", EN_TEXT, "fadg0")])
def test_cli_jacobi_decode_on_cpu(capsys, tmp_path, data_dir, command, text,
                                  person):
    """``--decode jacobi --sweeps k``: the generator runs ``time_bucket``
    frames a call, k times over the timeline, and the mp4 holds the frames
    the run reports; the scan's run of the same text has as many."""
    import cv2

    from text2video_tpu_torch.models.generator import CompositeGenerator

    _tiny_checkpoint(tmp_path / "ckpt")
    argv = [command, text, person, "--data-dir", data_dir, "--gan-checkpoint",
            str(tmp_path / "ckpt"), "--device", "cpu"]
    if command == "audio":
        from text2video_tpu_torch.frontend.tts import FormantTTS

        wav = str(tmp_path / "u.wav")
        save_wav(wav, FormantTTS().synthesize(text, SR), SR)
        argv += ["--wav", wav]
    scan = _cli_json(capsys, argv + ["--out", str(tmp_path / "scan")])
    batches = []
    forward = CompositeGenerator.forward

    def counting(self, labels, prev_imgs, has_prev):
        batches.append(labels.shape[0])
        return forward(self, labels, prev_imgs, has_prev)

    CompositeGenerator.forward = counting
    try:
        out = _cli_json(capsys, argv + ["--decode", "jacobi", "--sweeps", "2",
                                        "--out", str(tmp_path / "jacobi")])
    finally:
        CompositeGenerator.forward = forward
    t = out["frames"]
    assert t == scan["frames"] and t < 64
    assert batches == [t, t]  # one bucket holds the clip: two sweeps
    cap = cv2.VideoCapture(out["files"][0])
    frames = []
    ok, img = cap.read()
    while ok:
        frames.append(img)
        ok, img = cap.read()
    cap.release()
    assert len(frames) == t and frames[0].shape[:2] == (64, 64)
    assert np.stack(frames).std() > 1.0


@pytest.mark.parametrize("pose_device", ["host", "device"])
def test_cli_audio_batch_on_cpu(capsys, tmp_path, data_dir, pose_device):
    """``audio-batch`` with a checkpoint: one run per pair, and the device
    pose path (``--pose-device``, which only the port's command takes) gives
    the host path's frame counts."""
    from text2video_tpu_torch.frontend.tts import FormantTTS

    _tiny_checkpoint(tmp_path / "ckpt")
    pairs = []
    for i, text in enumerate((EN_TEXT, EN_TEXT2)):
        wav = str(tmp_path / f"u{i}.wav")
        save_wav(wav, FormantTTS().synthesize(text, SR), SR)
        pairs += [text, wav]
    runs = _cli_json(capsys, [
        "audio-batch", "fadg0", "--data-dir", data_dir, "--gan-checkpoint",
        str(tmp_path / "ckpt"), "--device", "cpu", "--pose-device",
        pose_device, "--out", str(tmp_path / "out"), *pairs])
    assert [r["frames"] for r in runs] == [40, 57]
    for r in runs:
        assert r["files"][0].endswith(".mp4")
        assert all(os.path.getsize(f) > 0 for f in r["files"])
        assert "batch_pad" in r["stage_seconds"]


def test_cli_without_checkpoint_matches_jax_cli(jnative, capsys, tmp_path,
                                                data_dir):
    """Skeleton passthrough: the same printed run and the same file bytes
    as the JAX package's CLI."""
    from text2video_tpu import cli as jcli

    out = _cli_json(capsys, ["tts", EN_TEXT, "fadg0", "--data-dir", data_dir,
                             "--device", "cpu", "--out",
                             str(tmp_path / "torch")])
    capsys.readouterr()
    assert jcli.main(["tts", EN_TEXT, "fadg0", "--data-dir", data_dir,
                      "--out", str(tmp_path / "jax")]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["name"], out["frames"]) == (ref["name"], ref["frames"])
    for a, b in zip(out["files"], ref["files"], strict=True):
        assert a.replace("torch", "jax") == b
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)


def test_emit_intermediates_writes_jax_pose_jsons(jnative, tmp_path, data_dir):
    from text2video_tpu.pose_stage import PoseStage as JaxPoseStage

    tal, _ = _aligners(jnative, data_dir)
    _, tr = _tiny_renderers()
    cfg = tconfig.PipelineConfig(person=tconfig.get_profile("fadg0", data_dir),
                                 out_dir=str(tmp_path), emit_intermediates=True)
    run = tpipe.Text2VideoPipeline(cfg, renderer=tr, aligner=tal).run_tts(
        EN_TEXT)
    inter = tmp_path / "fadg0" / (run.name + "_intermediates")
    stage = JaxPoseStage(jconfig.get_profile("fadg0", data_dir))
    from text2video_tpu.frontend.timestamps import Timestamps

    res = stage.run(Timestamps(entries=run.timestamps.entries), device=False)
    stage.write_jsons(res, str(tmp_path / "ref" / "pose"),
                      str(tmp_path / "ref" / "pose_smooth"))
    for sub in ("pose", "pose_smooth"):
        names = sorted(os.listdir(inter / sub))
        assert names == sorted(os.listdir(tmp_path / "ref" / sub))
        assert len(names) == res.num_frames > N_CMP
        for n in names:
            assert (inter / sub / n).read_bytes() == \
                (tmp_path / "ref" / sub / n).read_bytes(), n
    assert len(os.listdir(inter / "labels")) == res.num_frames
    assert (inter / "timestamps.txt").read_text().splitlines()[0] == \
        "%d %s" % run.timestamps.entries[0]


def test_packaged_mandarin_model_that_fails_to_load_raises(monkeypatch,
                                                           data_dir):
    """A zh pipeline loads the packaged Mandarin model; a load failure (a
    failed native build, a bad file) raises instead of falling back to the
    energy segmenter."""
    def fail(path):
        raise RuntimeError(f"cannot load {path}")

    monkeypatch.setattr(tpipe.MandarinAligner, "load", staticmethod(fail))
    cfg = tconfig.PipelineConfig(person=tconfig.get_profile("henan", data_dir))
    with pytest.raises(RuntimeError, match="mandarin_henan.am"):
        tpipe.Text2VideoPipeline(cfg, device="cpu")
