"""End-to-end pipeline: text or audio in, talking-head video out
(counterpart of ``text2video_tpu/pipeline.py``).

  text --(TTS | wav file)--> waveform
       --(forced alignment | pinyin timestamping)--> Timestamps
       --(PoseStage: dictionary gather + interpolation + smoothing)--> tracks
       --(rasterize_batch)--> label maps
       --(Renderer: autoregressive pose2frame GAN)--> frames
       --(mux)--> video files

The frontend (TTS, alignment) runs on the host; every later stage runs on
the pipeline's device. Same stage order and StageTimer names as the JAX
package: ``pose_synthesis`` -> ``rasterize`` -> ``render`` -> ``mux``. With
a renderer, label chunks stay on the device between the rasterizer and the
generator; streaming sends each chunk to a muxer thread as it finishes, as
DCT coefficients that the muxer turns into JPEGs with the native codec
(``RenderConfig.wire_format="dct"``, the default) or as YUV420 planes.
The entry points add the frontend's host seconds (``tts``, ``align``) to
the run's ``stage_seconds``. Each stage is also a span of the program's
recorder (``utils/profiling.py``), under the request's root span.
``run_audio_batch`` renders many utterances as one batch.

With a mesh (``parallel.make_mesh``; every rank builds the pipeline and calls
it with the same arguments), the pose stage smooths one utterance with its
time axis sharded (``smooth_recursive_sharded``, byte-equal to the host
path), the skeleton path rasterizes it frame-parallel
(``rasterize_batch_sharded``), and ``run_audio_batch`` shards the utterance
batch of the render (``Renderer.render_many_device``). Each of these shards
over the mesh's "data" axis and replicates over its "model" axis, as the JAX
package's mesh paths do. The frontend runs on every rank (cheap and
deterministic); only global rank 0 writes files.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

import torch
import torch.nn.functional as F

from text2video_tpu_torch import device as devices
from text2video_tpu_torch.config import (
    PACKAGED_DATA_DIR,
    PersonProfile,
    PipelineConfig,
)
from text2video_tpu_torch.frontend.align_english import EnglishAligner
from text2video_tpu_torch.frontend.align_mandarin import MandarinAligner
from text2video_tpu_torch.frontend.audio import (
    ALIGN_SAMPLE_RATE,
    load_wav_for_alignment,
)
from text2video_tpu_torch.frontend.textnorm import derive_file_name
from text2video_tpu_torch.frontend.timestamp_zh import (
    AsrBackend,
    timestamp_chinese,
)
from text2video_tpu_torch.frontend.timestamps import (
    Timestamps,
    format_timestamp_lines,
    format_word_lines,
)
from text2video_tpu_torch.frontend.tts import FormantTTS, TTSBackend
from text2video_tpu_torch.io.video import StreamingMuxer, mux
from text2video_tpu_torch.ops.rasterize import (
    rasterize_batch,
    rasterize_batch_sharded,
)
from text2video_tpu_torch.pose_stage import PoseStage
from text2video_tpu_torch.render import Renderer
from text2video_tpu_torch.utils import profiling
from text2video_tpu_torch.utils.logging import get_logger
from text2video_tpu_torch.utils.profiling import StageTimer


@dataclasses.dataclass
class RunResult:
    name: str
    num_frames: int
    files: List[str]            # muxed outputs
    timestamps: Timestamps
    label_maps: Optional[np.ndarray] = None   # [T, H, W, 3] uint8
    frames: Optional[np.ndarray] = None       # [T, H, W, 3] uint8
    stage_seconds: Optional[dict] = None      # per-stage wall clock


def _scale_tracks(arr: np.ndarray, sx: float, sy: float) -> np.ndarray:
    """Scale the x/y columns of an (x, y, conf)-triple track array [..., 3k]."""
    shape = arr.shape
    flat = arr.reshape(shape[:-1] + (shape[-1] // 3, 3))
    flat = flat * np.asarray([sx, sy, 1.0], np.float32)
    return flat.reshape(shape)


def _default_mandarin_aligner(person: str = "") -> Optional[MandarinAligner]:
    """The packaged Mandarin acoustic model (speaker-dependent
    ``mandarin_<person>.am`` when shipped, else the joint model), or None
    when neither is packaged. A packaged model that fails to load (a
    failed native build, a corrupt file) raises."""
    for name in (f"mandarin_{person}.am", "mandarin.am"):
        path = PACKAGED_DATA_DIR / name
        if path.exists():
            return MandarinAligner.load(str(path))
    return None


class Text2VideoPipeline:
    def __init__(
        self,
        config: PipelineConfig,
        renderer: Optional[Renderer] = None,
        aligner: Optional[EnglishAligner] = None,
        tts: Optional[TTSBackend] = None,
        asr: Optional[AsrBackend] = None,
        mandarin_aligner: Optional[MandarinAligner] = None,
        device=None,
        mesh=None,
    ):
        """Every stage after the frontend runs on the renderer's device;
        without a renderer, on the mesh's device or ``device`` (the card
        unless the caller names another). A zh profile without an ``asr`` or
        ``mandarin_aligner`` loads the packaged Mandarin model, so forced
        alignment, not the energy segmenter, times the Chinese path by
        default. ``mesh``: see the module's docstring; the render of one
        utterance is not sharded (its scan is sequential over time), as in
        the JAX package."""
        self.config = config
        self.profile: PersonProfile = config.person
        self.renderer = renderer
        self.mesh = mesh
        if renderer is not None:
            self.device = renderer.device
        elif mesh is not None:
            self.device = mesh.device
        else:
            self.device = devices.resolve(device)
        self.pose_stage = PoseStage(self.profile, device=self.device)
        self.aligner = aligner
        self.tts = tts
        self.asr = asr
        if (mandarin_aligner is None and asr is None
                and self.profile.language == "zh"):
            mandarin_aligner = _default_mandarin_aligner(self.profile.name)
        self.mandarin_aligner = mandarin_aligner

    @property
    def writes(self) -> bool:
        """Whether this process writes the run's files: always without a
        mesh, on global rank 0 with one."""
        return self.mesh is None or self.mesh.is_main

    def _render_tracks(self, result):
        """The tracks to draw for a pose result (the smoothed pass when
        smoothing is on) and the canvas to draw them on: the GAN's working
        resolution, the tracks scaled to it, as the training labels are
        drawn."""
        face = result.face_smooth if self.config.smooth else result.face
        pose = result.pose_smooth if self.config.smooth else result.pose
        hands = self.pose_stage.table.hands[result.plan.carrier]
        canvas = tuple(self.profile.canvas)
        if self.renderer is not None:
            w_c, h_c = canvas
            h2, w2 = self.renderer.target_hw(h_c, w_c)
            if (w2, h2) != canvas:
                sx, sy = w2 / w_c, h2 / h_c
                face = _scale_tracks(face, sx, sy)
                pose = _scale_tracks(pose, sx, sy)
                hands = _scale_tracks(hands, sx, sy)
                canvas = (w2, h2)
        return face, pose, hands, canvas

    def synthesize(
        self,
        ts: Timestamps,
        name: str,
        audio: Optional[np.ndarray] = None,
        sample_rate: int = ALIGN_SAMPLE_RATE,
        keep_arrays: bool = False,
    ) -> RunResult:
        """One utterance's timeline to its video files. The call is the
        request ``name`` and the span ``synthesize``
        (``utils/profiling.py``)."""
        with profiling.request(name), profiling.span("synthesize"):
            return self._synthesize(ts, name, audio, sample_rate, keep_arrays)

    def _synthesize(self, ts, name, audio, sample_rate, keep_arrays):
        cfg = self.config
        timer = StageTimer()
        with timer.stage("pose_synthesis"):
            result = self.pose_stage.run(
                ts, device=cfg.pose_device == "device", mesh=self.mesh)

        face, pose, hands, raster_canvas = self._render_tracks(result)
        need_host_labels = (self.renderer is None or cfg.emit_intermediates
                            or keep_arrays)
        t_frames = face.shape[0]
        out_dir = os.path.join(cfg.out_dir, self.profile.name)
        os.makedirs(out_dir, exist_ok=True)
        base = os.path.join(out_dir, name)

        labels = None
        frames = None
        on_card = self.device.type == "cuda"
        if self.renderer is not None:
            w2, h2 = raster_canvas
            # The stage's seconds are the drawing's enqueue; its span's
            # device_ms is its extent on the card.
            with timer.stage("rasterize", device=on_card):
                chunks = rasterize_batch(
                    face, pose, hands[:, 0], hands[:, 1], raster_canvas,
                    chunk=self.renderer.time_bucket, to_host=False,
                    device=self.device,
                )
            if cfg.stream and not need_host_labels:
                # A rank that writes nothing renders all the same.
                muxer = StreamingMuxer(
                    base, w2, h2, fps=self.profile.fps,
                    sample_rate=sample_rate, audio=audio,
                    wire_quality=self.renderer.config.wire_quality,
                ) if self.writes else None
                n_done = 0
                with timer.stage("render"):
                    if self.renderer.config.wire_format == "dct":
                        # The wire's coefficients go straight to the muxer's
                        # native codec: no pixel planes on the host.
                        for coeffs, _ in self.renderer.render_stream_coeffs(
                            chunks, t_frames, timer=timer
                        ):
                            n_done += coeffs[0].shape[0]
                            if muxer is not None:
                                muxer.add_coeffs(*coeffs)
                    else:
                        for y, u, v in self.renderer.render_stream_yuv(
                            chunks, t_frames, timer=timer
                        ):
                            n_done += y.shape[0]
                            if muxer is not None:
                                muxer.add_yuv(y, u, v)
                with timer.stage("mux"):
                    files = muxer.close() if muxer is not None else []
                t_frames = muxer.n_frames if muxer is not None else n_done
            else:
                with timer.stage("render"):
                    frames = self.renderer.render_from_device_chunks(
                        chunks, t_frames)
                if need_host_labels:
                    labels = np.concatenate(
                        [c.cpu().numpy() for c in chunks], axis=0)[:t_frames]
        else:
            with timer.stage("rasterize", device=on_card):
                if self.mesh is not None:
                    labels = rasterize_batch_sharded(
                        face, pose, hands[:, 0], hands[:, 1], raster_canvas,
                        self.mesh)
                else:
                    labels = rasterize_batch(
                        face, pose, hands[:, 0], hands[:, 1], raster_canvas,
                        chunk=cfg.frame_chunk, device=self.device,
                    )
            frames = labels  # skeleton passthrough (no trained GAN)

        if frames is not None:
            files = []
            if self.writes:
                with timer.stage("mux"):
                    files = mux(frames, audio, base, fps=self.profile.fps,
                                sample_rate=sample_rate)
            t_frames = frames.shape[0]

        if cfg.emit_intermediates and self.writes:
            self._emit_intermediates(out_dir, name, result, labels, ts)

        stage_seconds = timer.totals()
        get_logger().log(
            "pipeline_run",
            person=self.profile.name,
            name=name,
            frames=int(t_frames),
            **{f"s_{k}": round(v, 4) for k, v in stage_seconds.items()},
        )
        return RunResult(
            name=name,
            num_frames=t_frames,
            files=files,
            timestamps=ts,
            label_maps=labels if keep_arrays else None,
            frames=frames if keep_arrays else None,
            stage_seconds=stage_seconds,
        )

    def _emit_intermediates(self, out_dir, name, pose_result, labels, ts):
        import cv2  # noqa: PLC0415

        inter = os.path.join(out_dir, name + "_intermediates")
        self.pose_stage.write_jsons(
            pose_result,
            os.path.join(inter, "pose"),
            os.path.join(inter, "pose_smooth"),
        )
        img_dir = os.path.join(inter, "labels")
        os.makedirs(img_dir, exist_ok=True)
        for t in range(labels.shape[0]):
            cv2.imwrite(
                os.path.join(img_dir, "%05d.jpg" % t),
                cv2.cvtColor(labels[t], cv2.COLOR_RGB2BGR),
            )
        with open(os.path.join(inter, "timestamps.txt"), "w") as f:
            f.write(format_timestamp_lines(ts))

    # ---- entry points mirroring the three shell scripts -------------------

    def run_audio(self, text: str, wav_path: str,
                  keep_arrays: bool = False) -> RunResult:
        """English, real recorded audio (reference: text2video_audio.sh)."""
        if self.aligner is None:
            raise RuntimeError(
                "run_audio needs an EnglishAligner (train one with "
                "train_acoustic_model or pass model/dict paths to the CLI)"
            )
        timer = StageTimer()
        with timer.stage("align"):
            samples = load_wav_for_alignment(wav_path)
            res = self.aligner.align(samples, text)
        name = derive_file_name(text)
        run = self.synthesize(res.phones, name, audio=samples,
                              keep_arrays=keep_arrays)
        run.stage_seconds = {**timer.totals(), **run.stage_seconds}
        if self.config.emit_intermediates and self.writes:
            out_dir = os.path.join(self.config.out_dir, self.profile.name)
            inter = os.path.join(out_dir, name + "_intermediates")
            os.makedirs(inter, exist_ok=True)
            with open(os.path.join(inter, "words.txt"), "w") as f:
                f.write(format_word_lines(res.words))
        return run

    def run_tts(self, text: str, sex: str = "f",
                keep_arrays: bool = False) -> RunResult:
        """English, synthesized audio (reference: text2video_tts.sh)."""
        tts = self.tts or FormantTTS()
        timer = StageTimer()
        with timer.stage("tts"):
            samples = tts.synthesize(text, ALIGN_SAMPLE_RATE)
        if self.aligner is None:
            raise RuntimeError("run_tts needs an EnglishAligner")
        with timer.stage("align"):
            res = self.aligner.align(samples, text)
        run = self.synthesize(res.phones, derive_file_name(text),
                              audio=samples, keep_arrays=keep_arrays)
        run.stage_seconds = {**timer.totals(), **run.stage_seconds}
        return run

    def run_audio_batch(self, items, mesh=None, keep_arrays: bool = False
                        ) -> List[RunResult]:
        """Batched serving: many (text, wav_path) pairs rendered as ONE
        generator batch. Alignment, pose and rasterization run per
        utterance; the autoregressive GAN pass pads every utterance's
        labels (on the device) to the longest and scans them together, each
        generator step at batch len(items). With ``mesh`` (default: the
        pipeline's), the batch axis shards over its "data" axis and
        replicates over its "model" axis: each rank scans its data index's
        len(items) / n rows, which must divide; global rank 0 writes the
        files. Returns a RunResult per item, in input order. The call is
        one request, its id the items' file names joined by ``+``, under
        the span ``audio_batch``."""
        mesh = self.mesh if mesh is None else mesh
        if self.aligner is None:
            raise RuntimeError("run_audio_batch needs an EnglishAligner")
        items = list(items)
        rid = "+".join(derive_file_name(text) for text, _ in items)
        with profiling.request(rid), profiling.span("audio_batch"):
            return self._run_audio_batch(items, mesh, keep_arrays)

    def _run_audio_batch(self, items, mesh, keep_arrays):
        cfg = self.config
        timer = StageTimer()
        on_device = self.renderer is not None
        prepped = []
        for text, wav_path in items:
            with timer.stage("frontend"):
                samples = load_wav_for_alignment(wav_path)
                res = self.aligner.align(samples, text)
                pose_res = self.pose_stage.run(
                    res.phones, device=cfg.pose_device == "device")
            face, pose, hands, canvas = self._render_tracks(pose_res)
            with timer.stage("rasterize",
                             device=self.device.type == "cuda"):
                # With a renderer, labels stay on the device: concatenated,
                # padded and stacked there.
                labels = rasterize_batch(
                    face, pose, hands[:, 0], hands[:, 1], canvas,
                    chunk=cfg.frame_chunk, to_host=not on_device,
                    device=self.device,
                )
                if on_device:
                    labels = torch.cat(labels, dim=0)[: face.shape[0]]
            prepped.append((text, samples, res.phones, labels))

        t_max = max(p[3].shape[0] for p in prepped)
        with timer.stage("batch_pad"):
            if on_device:
                batch = torch.stack([
                    F.pad(lab, (0, 0, 0, 0, 0, 0, 0, t_max - lab.shape[0]))
                    for *_, lab in prepped
                ])
            else:
                h, w = prepped[0][3].shape[1:3]
                batch = np.zeros((len(prepped), t_max, h, w, 3), np.uint8)
                for i, (*_, labels) in enumerate(prepped):
                    batch[i, : labels.shape[0]] = labels

        with timer.stage("render"):
            frames_b = (self.renderer.render_many_device(batch, mesh=mesh)
                        if on_device else batch)

        out_dir = os.path.join(cfg.out_dir, self.profile.name)
        os.makedirs(out_dir, exist_ok=True)
        results = []
        for i, (text, samples, ts, labels) in enumerate(prepped):
            name = derive_file_name(text)
            t = labels.shape[0]
            frames = frames_b[i, :t]
            files = []
            if mesh is None or mesh.is_main:
                with timer.stage("mux"):
                    files = mux(frames, samples, os.path.join(out_dir, name),
                                fps=self.profile.fps,
                                sample_rate=ALIGN_SAMPLE_RATE)
            host_labels = (labels.cpu().numpy() if on_device else labels)
            results.append(RunResult(
                name=name, num_frames=t, files=files, timestamps=ts,
                label_maps=host_labels if keep_arrays else None,
                frames=frames if keep_arrays else None,
            ))
        stage_seconds = timer.totals()
        for r in results:
            r.stage_seconds = stage_seconds
        return results

    def run_tts_chinese(self, text: str, sex: str = "f",
                        keep_arrays: bool = False) -> RunResult:
        """Mandarin (reference: text2video_tts_chinese.sh)."""
        tts = self.tts or FormantTTS()
        timer = StageTimer()
        with timer.stage("tts"):
            samples = tts.synthesize(text, ALIGN_SAMPLE_RATE)
        with timer.stage("align"):
            ts = timestamp_chinese(
                text, samples, ALIGN_SAMPLE_RATE, asr=self.asr,
                fps=self.profile.timestamp_fps,
                aligner=self.mandarin_aligner,
            )
        run = self.synthesize(ts, derive_file_name(text, strip_spaces=True),
                              audio=samples, keep_arrays=keep_arrays)
        run.stage_seconds = {**timer.totals(), **run.stage_seconds}
        return run
