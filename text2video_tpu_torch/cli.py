"""Command-line interface of the port (counterpart of
``text2video_tpu/cli.py``): the reference's three shell entry points + tools.

Mirrors (reference):
  * ``text2video_tts.sh "<text>" <person> <f|m>``      -> ``tts``
  * ``text2video_audio.sh "<text>" <person>``          -> ``audio``
  * ``text2video_tts_chinese.sh "<text>" <person> f``  -> ``tts-chinese``
plus ``audio-batch`` (many utterances as one generator batch), ``train-gan``,
the frontend tools ``train-aligner``, ``train-aligner-zh``, ``build-dict``
and ``build-dict-zh``, and ``bench`` (``bench.py`` of this package, the
counterpart of the root ``bench.py``). The commands take the JAX CLI's
arguments, plus ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions), and ``audio-batch`` also takes ``--pose-device``.
``train-gan`` is data-parallel when several processes run it
(``torchrun --nproc-per-node N -m text2video_tpu_torch.cli train-gan ...``:
the mesh comes from torchrun's environment, each rank on its own card); its
``--n-model`` above 1 raises (the mesh's model axis is not ported).
``--gan-checkpoint`` takes the port's checkpoint formats
(``checkpoints.py``): a renderer checkpoint or ``train-gan``'s directory.

Usage: ``python -m text2video_tpu_torch.cli <command> ...``. The video
commands print one JSON object: the run's name, frame count, files and
per-stage seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("text")
    p.add_argument("person")
    p.add_argument(
        "--out", default="./output", help="output directory root"
    )
    p.add_argument(
        "--data-dir",
        default=None,
        help="asset root laid out like the reference repo (default: "
        "$T2V_DATA_DIR or ./reference; golden.write_golden_assets writes "
        "one from the committed golden frames)",
    )
    p.add_argument(
        "--aligner-model",
        default=None,
        help="acoustic model path (.am). Default: <out>/aligner/<person>.am, "
        "else the packaged english_<person>.am",
    )
    p.add_argument(
        "--gan-checkpoint",
        default=None,
        help="checkpoint dir of a pose2frame GAN in the port's format "
        "(config.json + generator.pt, checkpoints.py); without it the "
        "output video shows the skeleton label maps",
    )
    p.add_argument("--no-smooth", action="store_true")
    p.add_argument(
        "--decode",
        choices=["scan", "jacobi"],
        default="scan",
        help="GAN decoding: 'scan' = exact sequential autoregression; "
        "'jacobi' = batched fixed-point sweeps over the whole timeline "
        "(approximate; --sweeps)",
    )
    p.add_argument(
        "--sweeps",
        type=int,
        default=3,
        help="Jacobi sweep count: more sweeps come closer to the scan",
    )
    p.add_argument(
        "--emit-intermediates",
        action="store_true",
        help="write pose JSONs / label JPEGs / timestamp files like the "
        "reference's dataset directories",
    )
    _add_pose_device(p)
    _add_device(p)


def _add_pose_device(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--pose-device",
        choices=["host", "device"],
        default="host",
        help="where the pose stage smooths: the bit-exact float64 host "
        "path or the fused device op (kernel B2 on a card)",
    )


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device of every stage after the frontend (default "
        "cuda; cpu runs the kernels' plain versions)",
    )


def _build_pipeline(args, need_aligner: bool, mandarin_aligner=None):
    from text2video_tpu_torch.config import PipelineConfig, get_profile
    from text2video_tpu_torch.pipeline import Text2VideoPipeline

    profile = get_profile(args.person, data_dir=args.data_dir)
    config = PipelineConfig(
        person=profile,
        out_dir=args.out,
        smooth=not args.no_smooth,
        emit_intermediates=args.emit_intermediates,
        pose_device=getattr(args, "pose_device", "host"),
    )
    aligner = None
    if need_aligner:
        aligner = _load_or_train_aligner(args, profile)
    renderer = None
    if args.gan_checkpoint:
        from text2video_tpu_torch.checkpoints import load_renderer

        renderer = load_renderer(
            args.gan_checkpoint,
            profile,
            decode_mode=getattr(args, "decode", "scan"),
            jacobi_sweeps=getattr(args, "sweeps", 3),
            device=args.device,
        )
    return Text2VideoPipeline(
        config,
        renderer=renderer,
        aligner=aligner,
        mandarin_aligner=mandarin_aligner,
        device=args.device,
    )


def _dict_path(args) -> str:
    from text2video_tpu_torch.config import DATA_DIR

    return os.path.join(args.data_dir or DATA_DIR, "aligner/english/dict")


def _load_or_train_aligner(args, profile):
    from text2video_tpu_torch.config import PACKAGED_DATA_DIR
    from text2video_tpu_torch.frontend.align_english import EnglishAligner

    model_path = args.aligner_model or os.path.join(
        args.out, "aligner", f"{profile.name}.am"
    )
    if os.path.exists(model_path):
        return EnglishAligner.load(model_path, _dict_path(args), profile.fps)
    # Packaged speaker-dependent model (same pattern as the Mandarin
    # lookup, pipeline.py::_default_mandarin_aligner).
    for name in (f"english_{profile.name}.am", "english.am"):
        packaged = os.path.join(PACKAGED_DATA_DIR, name)
        if args.aligner_model is None and os.path.exists(packaged):
            return EnglishAligner.load(
                packaged, _dict_path(args), profile.fps
            )
    raise SystemExit(
        f"no acoustic model at {model_path}; train one first:\n"
        f"  python -m text2video_tpu_torch.cli train-aligner --out "
        f"{model_path} wav1 'transcript 1' [wav2 'transcript 2' ...]"
    )


def _concat_tts_from_pool(args, aligner=None, mandarin=None):
    """--tts-pool wav 'transcript' ... -> ConcatTTS (real-voice unit
    selection; frontend/tts_concat.py), or None without a pool."""
    pool = getattr(args, "tts_pool", None)
    if not pool:
        return None
    if len(pool) % 2 != 0:
        raise SystemExit("--tts-pool takes wav1 'transcript 1' wav2 ...")
    from text2video_tpu_torch.frontend.audio import load_wav_for_alignment
    from text2video_tpu_torch.frontend.tts_concat import ConcatTTS

    utts = [
        (load_wav_for_alignment(pool[i]), pool[i + 1])
        for i in range(0, len(pool), 2)
    ]
    if mandarin is not None:
        return ConcatTTS.build_mandarin(utts, mandarin)
    return ConcatTTS.build_english(utts, aligner)


def _run_json(run) -> dict:
    return {"name": run.name, "frames": run.num_frames, "files": run.files,
            "stage_seconds": run.stage_seconds}


def cmd_tts(args) -> int:
    pipe = _build_pipeline(args, need_aligner=True)
    pipe.tts = _concat_tts_from_pool(args, aligner=pipe.aligner) or pipe.tts
    run = pipe.run_tts(args.text, args.sex)
    print(json.dumps(_run_json(run)))
    return 0


def cmd_audio(args) -> int:
    pipe = _build_pipeline(args, need_aligner=True)
    wav = args.wav
    if wav is None:
        from text2video_tpu_torch.config import DATA_DIR
        from text2video_tpu_torch.frontend.textnorm import derive_file_name

        wav = os.path.join(
            args.data_dir or DATA_DIR,
            "input_audio_real",
            args.person,
            derive_file_name(args.text) + ".wav",
        )
    run = pipe.run_audio(args.text, wav)
    print(json.dumps(_run_json(run)))
    return 0


def cmd_audio_batch(args) -> int:
    """Batched serving: many (text, wav) pairs as one generator batch."""
    if len(args.pairs) % 2 != 0:
        raise SystemExit("pairs must be 'text 1' wav1 'text 2' wav2 ...")
    pipe = _build_pipeline(args, need_aligner=True)
    items = [
        (args.pairs[i], args.pairs[i + 1])
        for i in range(0, len(args.pairs), 2)
    ]
    results = pipe.run_audio_batch(items)
    print(json.dumps([_run_json(r) for r in results]))
    return 0


def cmd_tts_chinese(args) -> int:
    mandarin = None
    if args.aligner_model and os.path.exists(args.aligner_model):
        from text2video_tpu_torch.frontend.align_mandarin import (
            MandarinAligner,
        )

        mandarin = MandarinAligner.load(args.aligner_model)
    pipe = _build_pipeline(args, need_aligner=False, mandarin_aligner=mandarin)
    pipe.tts = (
        _concat_tts_from_pool(args, mandarin=pipe.mandarin_aligner)
        or pipe.tts
    )
    run = pipe.run_tts_chinese(args.text, args.sex)
    print(json.dumps(_run_json(run)))
    return 0


def cmd_train_aligner(args) -> int:
    from text2video_tpu_torch.frontend.align_english import (
        PronouncingDict,
        train_acoustic_model,
    )
    from text2video_tpu_torch.frontend.audio import load_wav_for_alignment

    if len(args.pairs) % 2 != 0:
        raise SystemExit("pairs must be wav1 'transcript 1' wav2 ...")
    pdict = PronouncingDict.load(_dict_path(args))
    utts = [
        (load_wav_for_alignment(args.pairs[i]), args.pairs[i + 1])
        for i in range(0, len(args.pairs), 2)
    ]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    train_acoustic_model(
        utts,
        pdict,
        iterations=args.iterations,
        target_mixes=args.mixes,
        save_path=args.out,
    )
    print(json.dumps({"model": args.out, "utterances": len(utts)}))
    return 0


def cmd_train_aligner_zh(args) -> int:
    """Train Mandarin initial/final acoustic models.

    Data sources (combinable):
      * positional pairs: wav1 '<hanzi or pinyin stream 1>' wav2 ...
      * --corpus AUDIO_DIR:TIMESTAMP_DIR — every wav in AUDIO_DIR whose
        stem has a '<frame> <pinyin>' file in TIMESTAMP_DIR (the
        reference's input_audio/ + input_timestamp/ layout).
    """
    from text2video_tpu_torch.frontend import native
    from text2video_tpu_torch.frontend.align_mandarin import (
        expand_walk_stream,
        train_mandarin_model,
    )
    from text2video_tpu_torch.frontend.audio import load_wav_for_alignment

    if len(args.pairs) % 2 != 0:
        raise SystemExit("pairs must be wav1 'text 1' wav2 ...")
    utts = []
    for i in range(0, len(args.pairs), 2):
        samples = load_wav_for_alignment(args.pairs[i])
        text = args.pairs[i + 1]
        # Hanzi text converts through the walk; a space-separated ASCII
        # string is taken as a literal pinyin stream.
        if text.isascii():
            stream = text.split()
        else:
            stream = expand_walk_stream(text)
        utts.append((samples, stream))
    excluded = set(args.exclude or [])
    for corpus in args.corpus or []:
        audio_dir, ts_dir = corpus.split(":", 1)
        for fn in sorted(os.listdir(ts_dir)):
            if not fn.endswith(".txt") or fn[:-4] in excluded:
                continue
            wav = os.path.join(audio_dir, fn[:-4] + ".wav")
            if not os.path.exists(wav):
                continue
            with open(os.path.join(ts_dir, fn)) as f:
                lines = [ln.split() for ln in f]
            stream = [p[1] for p in lines if len(p) == 2]
            if len(stream) < 2:
                continue
            utts.append((load_wav_for_alignment(wav), stream))
    if not utts:
        raise SystemExit("no training utterances")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    train_mandarin_model(
        utts,
        iterations=args.iterations,
        target_mixes=args.mixes,
        save_path=args.out,
        feat_kind=native.FEAT_PLP if args.features == "plp"
        else native.FEAT_MFCC,
    )
    print(json.dumps({"model": args.out, "utterances": len(utts)}))
    return 0


def cmd_train_gan(args) -> int:
    import torch
    import torch.distributed as dist

    from text2video_tpu_torch.parallel.mesh import local_device
    from text2video_tpu_torch.train.data import PoseClipDataset
    from text2video_tpu_torch.train.loop import distributed, train_gan
    from text2video_tpu_torch.train.trainer import TrainConfig

    # One of several processes: this rank's card, for the data set too.
    device = local_device(args.device) if distributed() else args.device

    # VGG policy: real weights turn the perceptual term on; otherwise it is
    # off unless --random-vgg opts into the random-filter prior.
    vgg_params = None
    use_vgg = bool(args.vgg_weights) or args.random_vgg
    if args.vgg_weights:
        from text2video_tpu_torch.models.vgg import load_params

        vgg_params = load_params(args.vgg_weights)
    cfg = TrainConfig(
        height=args.height,
        width=args.width,
        base_ch=args.base_ch,
        use_vgg=use_vgg,
        lambda_l1=args.l1,
        lambda_l1_mouth=args.l1_mouth,
        aug_jitter_px=args.aug_jitter,
        aug_drop_prob=args.aug_drop,
        aug_face_drop_prob=args.aug_face_drop,
        aug_scale_crop=args.aug_scale_crop,
        flow_supervision=args.flow,
        d_lr_scale=args.d_lr_scale,
        lambda_adv=args.lambda_adv,
        lr=args.lr,
        grad_accum=args.grad_accum,
        dtype=torch.bfloat16,
    )
    augmenting = (args.aug_jitter > 0 or args.aug_drop > 0
                  or args.aug_face_drop > 0 or args.aug_scale_crop)
    dataset = PoseClipDataset(
        images_dir=args.images,
        keypoints_dir=args.keypoints,
        canvas=(args.width, args.height),
        source_canvas=(args.source_width or args.width,
                       args.source_height or args.height),
        clip_len=args.clip_len,
        # Augmented device-data training draws its labels on the device
        # every step: no label cache is made.
        cache_labels=not (augmenting and args.device_data),
        max_frames=args.max_frames,
        split=args.split,
        holdout_fraction=args.holdout_fraction,
        device=device,
    )
    state = train_gan(
        dataset,
        cfg,
        steps=args.steps,
        batch_size=args.batch_size,
        ckpt_dir=args.ckpt,
        n_model=args.n_model,
        device_data=args.device_data,
        sample_every=args.sample_every,
        stall_timeout=args.stall_timeout,
        vgg_params=vgg_params,
        device=device,
    )
    # A rank outside the mesh returns None; only rank 0 reports.
    if state is not None and (not dist.is_initialized()
                              or dist.get_rank() == 0):
        print(json.dumps({"steps": int(state.step), "ckpt": args.ckpt}))
    return 0


def cmd_build_dict(args) -> int:
    from text2video_tpu_torch.dictbuild import (
        build_phoneme_dict,
        collect_instances,
        write_phoneme_dict,
    )
    from text2video_tpu_torch.frontend.align_english import EnglishAligner
    from text2video_tpu_torch.frontend.audio import load_wav_for_alignment

    if len(args.triples) % 3 != 0:
        raise SystemExit("triples must be clip1 wav1 'transcript 1' ...")
    aligner = EnglishAligner.load(args.aligner_model, _dict_path(args))
    clips = [
        (
            args.triples[i],
            load_wav_for_alignment(args.triples[i + 1]),
            args.triples[i + 2],
        )
        for i in range(0, len(args.triples), 3)
    ]
    instances = collect_instances(clips, aligner, video_fps=args.fps)
    entries = build_phoneme_dict(instances)
    write_phoneme_dict(entries, args.out)
    print(json.dumps({"dict": args.out, "symbols": len(entries)}))
    return 0


def cmd_build_dict_zh(args) -> int:
    """Build a 2-col pinyin-pose dictionary from one long recording of
    the prompt list (the reference handcrafts dict_{person}.txt from such
    a recording, README.md:117-156; here the Mandarin forced aligner
    times each syllable automatically)."""
    from text2video_tpu_torch.dictbuild import (
        build_pinyin_dict,
        load_prompts,
        prompt_coverage,
        write_pinyin_dict,
    )
    from text2video_tpu_torch.frontend.align_mandarin import (
        MandarinAligner,
        expand_walk_stream,
    )
    from text2video_tpu_torch.frontend.audio import load_wav_for_alignment
    from text2video_tpu_torch.frontend.timestamps import Timestamps

    aligner = MandarinAligner.load(args.aligner_model)
    samples = load_wav_for_alignment(args.wav)
    if args.transcript.isascii():
        stream = args.transcript.split()
    else:
        stream = expand_walk_stream(args.transcript)
    spans = aligner.align_stream(samples, stream)
    ts = Timestamps(
        entries=tuple(
            (int((s.start + (s.end - s.start) / 2) * args.fps + 0.5),
             s.syllable)
            for s in spans
        )
    )
    entries = build_pinyin_dict(ts, max_frame=args.max_frame or None)
    write_pinyin_dict(entries, args.out)
    info = {"dict": args.out, "symbols": len(entries)}
    if args.prompts:
        missing = prompt_coverage(load_prompts(args.prompts), entries)
        info["missing_prompts"] = len(missing)
    print(json.dumps(info))
    return 0


def cmd_bench(args) -> int:
    from text2video_tpu_torch import bench

    return bench.run(args)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="text2video_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("tts", help="English text -> TTS audio -> video")
    _add_common(p)
    p.add_argument("sex", nargs="?", default="f", choices=["f", "m"])
    p.add_argument("--tts-pool", nargs="+", default=None,
                   metavar="WAV_OR_TEXT",
                   help="wav1 'transcript 1' ... -> real-voice "
                   "unit-selection TTS from these recordings "
                   "(frontend/tts_concat.py)")
    p.set_defaults(fn=cmd_tts)

    p = sub.add_parser("audio", help="English text + real audio -> video")
    _add_common(p)
    p.add_argument("--wav", default=None, help="recorded wav path")
    p.set_defaults(fn=cmd_audio)

    p = sub.add_parser(
        "audio-batch", help="many (text, wav) pairs -> one generator batch"
    )
    p.add_argument("person")
    p.add_argument("--out", default="./output")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--aligner-model", default=None)
    p.add_argument("--gan-checkpoint", default=None)
    p.add_argument("--no-smooth", action="store_true")
    p.add_argument("--emit-intermediates", action="store_true")
    _add_pose_device(p)
    _add_device(p)
    p.add_argument("pairs", nargs="+", help="'text 1' wav1 'text 2' wav2 ...")
    p.set_defaults(fn=cmd_audio_batch)

    p = sub.add_parser("tts-chinese", help="Mandarin text -> video")
    _add_common(p)
    p.add_argument("sex", nargs="?", default="f", choices=["f", "m"])
    p.add_argument("--tts-pool", nargs="+", default=None,
                   metavar="WAV_OR_TEXT",
                   help="wav1 'transcript 1' ... -> real-voice "
                   "unit-selection TTS from these recordings "
                   "(frontend/tts_concat.py)")
    p.set_defaults(fn=cmd_tts_chinese)

    p = sub.add_parser("train-aligner", help="train acoustic models")
    p.add_argument("--out", required=True, help="output model path (.am)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--iterations", type=int, default=12)
    p.add_argument("--mixes", type=int, default=4)
    p.add_argument("pairs", nargs="+", help="wav1 'transcript 1' wav2 ...")
    p.set_defaults(fn=cmd_train_aligner)

    p = sub.add_parser(
        "train-aligner-zh", help="train Mandarin acoustic models"
    )
    p.add_argument("--out", required=True, help="output model path (.am)")
    p.add_argument("--iterations", type=int, default=14)
    p.add_argument("--mixes", type=int, default=8)
    p.add_argument("--features", choices=["plp", "mfcc"], default="plp")
    p.add_argument(
        "--corpus",
        action="append",
        help="AUDIO_DIR:TIMESTAMP_DIR pair in the reference layout",
    )
    p.add_argument(
        "--exclude",
        action="append",
        help="corpus stem to drop (stale/mismatched txt-wav pairs "
        "poison flat-start training)",
    )
    p.add_argument(
        "pairs", nargs="*",
        help="wav1 '<hanzi or pinyin stream 1>' wav2 ...",
    )
    p.set_defaults(fn=cmd_train_aligner_zh)

    p = sub.add_parser(
        "build-dict", help="build a phoneme-pose dictionary from recordings"
    )
    p.add_argument("--out", required=True, help="output dict path")
    p.add_argument("--aligner-model", required=True)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--fps", type=float, default=25.0)
    p.add_argument(
        "triples", nargs="+", help="clip1 wav1 'transcript 1' clip2 ..."
    )
    p.set_defaults(fn=cmd_build_dict)

    p = sub.add_parser(
        "build-dict-zh",
        help="build a pinyin-pose dictionary from one prompt recording",
    )
    p.add_argument("--out", required=True, help="output dict path")
    p.add_argument("--aligner-model", required=True,
                   help="Mandarin .am (train-aligner-zh)")
    p.add_argument("--wav", required=True, help="the prompt recording")
    p.add_argument("--transcript", required=True,
                   help="hanzi text or space-separated pinyin stream read "
                   "in the recording")
    p.add_argument("--fps", type=float, default=25.0,
                   help="video frame rate of the recording")
    p.add_argument("--max-frame", type=int, default=0)
    p.add_argument("--prompts", default=None,
                   help="prompt list to check coverage against "
                   "(e.g. prompts/all_pinyin.txt)")
    p.set_defaults(fn=cmd_build_dict_zh)

    p = sub.add_parser("train-gan", help="train the pose2frame GAN")
    p.add_argument("--images", required=True, help="real frame dir")
    p.add_argument("--keypoints", required=True, help="OpenPose JSON dir")
    p.add_argument("--ckpt", required=True, help="checkpoint dir")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--source-width", type=int, default=None)
    p.add_argument("--source-height", type=int, default=None)
    p.add_argument("--clip-len", type=int, default=12)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--base-ch", type=int, default=64)
    p.add_argument("--vgg-weights", default=None,
                   help="VGG19 .npz (models/vgg.load_params); supplying "
                   "real weights turns the perceptual term on")
    p.add_argument("--random-vgg", action="store_true",
                   help="run the VGG term with fixed-seed random filters. "
                   "Off by default")
    p.add_argument("--no-vgg", action="store_true",
                   help=argparse.SUPPRESS)  # legacy: VGG is off by default
    p.add_argument("--l1", type=float, default=10.0,
                   help="L1(fake, real) weight. 0 = vid2vid-faithful (use "
                   "with --vgg-weights)")
    p.add_argument("--l1-mouth", type=float, default=0.0,
                   help="extra L1 on the 96px mouth crop: anchors lip "
                   "fidelity through the adversarial phase")
    p.add_argument("--split", choices=["train", "all"], default="train",
                   help="'train' (default) reserves a deterministic "
                   "held-out tail for honest evaluation "
                   "(tools/eval_gan.py --split holdout); 'all' trains "
                   "on every frame")
    p.add_argument("--holdout-fraction", type=float, default=0.1)
    p.add_argument("--sample-every", type=int, default=0,
                   help="write a [real|fake|label] snapshot strip every N steps")
    p.add_argument("--device-data", action="store_true",
                   help="keep the whole dataset on the device; a step then "
                   "moves only a [B,T] index array")
    p.add_argument("--aug-jitter", type=float, default=0.0,
                   help="keypoint jitter sigma in px (label augmentation; "
                   "every --aug-* needs --device-data and is ignored "
                   "without it)")
    p.add_argument("--aug-drop", type=float, default=0.0,
                   help="per-keypoint drop probability (augmentation)")
    p.add_argument("--aug-face-drop", type=float, default=0.0,
                   help="per-frame whole-face drop probability")
    p.add_argument("--aug-scale-crop", action="store_true",
                   help="random scaleHeight + aligned crop of reals AND "
                   "keypoints each step")
    p.add_argument("--flow", choices=["photometric", "reference"],
                   default="photometric",
                   help="flow loss: self-supervised warp or Farneback "
                   "reference fields (host data path)")
    p.add_argument("--d-lr-scale", type=float, default=1.0,
                   help="discriminator lr multiplier (slow D for "
                   "small-data stability)")
    p.add_argument("--lambda-adv", type=float, default=1.0,
                   help="adversarial weight; 0 = pure reconstruction "
                   "pretrain (no discriminators applied or updated)")
    p.add_argument("--lr", type=float, default=2e-4,
                   help="Adam learning rate (recon pretrain tolerates "
                   "higher, e.g. 5e-4)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batches per step (averaged gradients == "
                   "full batch; cuts peak activation memory)")
    p.add_argument("--stall-timeout", type=float, default=0.0,
                   help="exit(3) when no step completes for this many "
                        "seconds; auto-resume on rerun")
    p.add_argument("--max-frames", type=int, default=None,
                   help="cap total paired frames (device-data datasets "
                   "must fit the device's memory)")
    p.add_argument("--n-model", type=int, default=1,
                   help="model-axis size of the mesh; only 1 is ported "
                   "(the data axis spans the processes torchrun starts)")
    _add_device(p)
    p.set_defaults(fn=cmd_train_gan)

    p = sub.add_parser("bench", help="run the benchmark (one JSON line)")
    from text2video_tpu_torch.bench import add_arguments

    add_arguments(p)
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    # Small hosts: unbounded BLAS/OpenMP pools oversubscribe the host-side
    # frontend math. Set before numpy or torch load (main imports them).
    os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
