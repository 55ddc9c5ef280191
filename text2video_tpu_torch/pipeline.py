"""End-to-end pipeline tail: timestamps -> video (counterpart of
``text2video_tpu/pipeline.py::Text2VideoPipeline.synthesize``).

Same stage order and StageTimer names as the JAX package:
``pose_synthesis`` -> ``rasterize`` -> ``render`` -> ``mux``. With a
renderer, label chunks stay on the device between the rasterizer and the
generator; streaming sends YUV420 chunks to a muxer thread as they finish.

Not ported yet: the frontends (``run_audio``, ``run_tts``,
``run_tts_chinese``), ``run_audio_batch``, the mesh paths, the CLI and
``emit_intermediates``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from text2video_tpu_torch import device as devices
from text2video_tpu_torch.config import PersonProfile, PipelineConfig
from text2video_tpu_torch.frontend.audio import ALIGN_SAMPLE_RATE
from text2video_tpu_torch.frontend.timestamps import Timestamps
from text2video_tpu_torch.io.video import StreamingMuxer, mux
from text2video_tpu_torch.ops.rasterize import rasterize_batch
from text2video_tpu_torch.pose_stage import PoseStage
from text2video_tpu_torch.render import Renderer
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


class Text2VideoPipeline:
    def __init__(self, config: PipelineConfig,
                 renderer: Optional[Renderer] = None, device=None):
        """Every stage runs on the renderer's device; without a renderer,
        on ``device`` (the card unless the caller names another)."""
        if config.emit_intermediates:
            raise ValueError("emit_intermediates is not ported yet")
        self.config = config
        self.profile: PersonProfile = config.person
        self.renderer = renderer
        self.device = (renderer.device if renderer is not None
                       else devices.resolve(device))
        self.pose_stage = PoseStage(self.profile, device=self.device)

    def synthesize(
        self,
        ts: Timestamps,
        name: str,
        audio: Optional[np.ndarray] = None,
        sample_rate: int = ALIGN_SAMPLE_RATE,
        keep_arrays: bool = False,
    ) -> RunResult:
        cfg = self.config
        timer = StageTimer()
        with timer.stage("pose_synthesis"):
            result = self.pose_stage.run(
                ts, device=cfg.pose_device == "device")

        # The smoothed tracks feed the rasterizer when smoothing is on.
        face = result.face_smooth if cfg.smooth else result.face
        pose = result.pose_smooth if cfg.smooth else result.pose
        hands = self.pose_stage.table.hands[result.plan.carrier]
        need_host_labels = self.renderer is None or keep_arrays
        t_frames = face.shape[0]
        out_dir = os.path.join(cfg.out_dir, self.profile.name)
        os.makedirs(out_dir, exist_ok=True)
        base = os.path.join(out_dir, name)

        labels = None
        frames = None
        if self.renderer is not None:
            # Draw at the GAN's working resolution from scaled tracks, as
            # the training labels are drawn.
            w_c, h_c = self.profile.canvas
            h2, w2 = self.renderer.target_hw(h_c, w_c)
            raster_canvas = (w2, h2)
            if raster_canvas != tuple(self.profile.canvas):
                sx, sy = w2 / w_c, h2 / h_c
                face = _scale_tracks(face, sx, sy)
                pose = _scale_tracks(pose, sx, sy)
                hands = _scale_tracks(hands, sx, sy)
            with timer.stage("rasterize"):
                chunks = rasterize_batch(
                    face, pose, hands[:, 0], hands[:, 1], raster_canvas,
                    chunk=self.renderer.time_bucket, to_host=False,
                    device=self.device,
                )
            if cfg.stream and not need_host_labels:
                muxer = StreamingMuxer(
                    base, w2, h2, fps=self.profile.fps,
                    sample_rate=sample_rate, audio=audio,
                )
                with timer.stage("render"):
                    for y, u, v in self.renderer.render_stream_yuv(
                        chunks, t_frames, timer=timer
                    ):
                        muxer.add_yuv(y, u, v)
                with timer.stage("mux"):
                    files = muxer.close()
                t_frames = muxer.n_frames
            else:
                with timer.stage("render"):
                    frames = self.renderer.render_from_device_chunks(
                        chunks, t_frames)
                if need_host_labels:
                    labels = np.concatenate(
                        [c.cpu().numpy() for c in chunks], axis=0)[:t_frames]
        else:
            with timer.stage("rasterize"):
                labels = rasterize_batch(
                    face, pose, hands[:, 0], hands[:, 1], self.profile.canvas,
                    chunk=cfg.frame_chunk, device=self.device,
                )
            frames = labels  # skeleton passthrough (no trained GAN)

        if frames is not None:
            with timer.stage("mux"):
                files = mux(frames, audio, base, fps=self.profile.fps,
                            sample_rate=sample_rate)
            t_frames = frames.shape[0]

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
