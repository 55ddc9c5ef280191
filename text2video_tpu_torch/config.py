"""Typed configuration for the pipeline (counterpart of
``text2video_tpu/config.py``: the same classes, fields and defaults).

The reference keys all behavior off ``sys.argv`` positional args plus
hardcoded per-person branches (reference: tts_request.py:29-41,
interp_landmarks_motion.py:55-68, align_english.py:34). Here a single
:class:`PersonProfile` captures everything that varied per person, and
:class:`PipelineConfig` everything that varied per entry point.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional, Tuple

# Default asset root. Point T2V_DATA_DIR at a directory laid out like the
# reference repo's data folders to reuse its dictionaries/keypoints; the
# default is a ``reference`` folder in the working directory.
DATA_DIR = os.environ.get("T2V_DATA_DIR", "reference")

# The packaged frontend data (pinyin tables, acoustic models ``*.am``) is
# read by path from the JAX package's data folder: a read of data files,
# not an import, and no second copy of the binary models.
PACKAGED_DATA_DIR = (
    Path(__file__).resolve().parent.parent / "text2video_tpu" / "data")


@dataclasses.dataclass(frozen=True)
class PersonProfile:
    """Everything the pipeline needs to know about one target identity."""

    name: str
    language: str  # "en" (phoneme dictionary) | "zh" (pinyin dictionary)

    # Canvas the key poses were captured on, (width, height).
    # reference: interp_landmarks_motion_phoneme_VidTIMIT_smooth.py:78-79
    # (fadg0 512x384); interp_landmarks_motion.py:63-68 (xuesong 1280x720,
    # henan 1920x1080).
    canvas: Tuple[int, int]

    # Dictionary file. English format: "PHONEME clip frame" 3-column
    # (reference: *phoneme_data/VidTIMIT/fadg0.txt); Chinese format:
    # "pinyin frame" 2-column (reference: dict_henan.txt).
    dict_path: str
    # Directory of OpenPose keypoint JSONs for the key-pose recording.
    keypoints_dir: str
    # "clip": files are f"{clip}_{frame:03d}_keypoints.json" (English);
    # "flat": files are f"{frame:05d}_keypoints.json" (Chinese).
    keypoint_layout: str

    # Output/alignment frame rates. reference: align_english.py:34 (25 fps
    # English), pinyin_timestamping.py:24 (30 fps Chinese timestamping).
    fps: float = 25.0
    timestamp_fps: float = 30.0

    # Pose-synthesis constants (reference: ...VidTIMIT_smooth.py:70-75 and
    # interp_landmarks_motion.py:56-61).
    motion_width: int = 3
    transition_width: int = 5
    min_key_dist: int = 4
    # English path requires gap >= min_key_dist (...VidTIMIT_smooth.py:127);
    # Chinese path requires gap > min_key_dist (interp_landmarks_motion.py:154)
    # with min_key_dist=3 — the same effective threshold expressed two ways.
    key_gap_inclusive: bool = True
    smooth_width: int = 4

    # TTS voice id, mirroring the per-person/gender table at
    # tts_request.py:29-41.
    voice_female: str = "4100"
    voice_male: str = "4106"

    def voice(self, sex: str) -> str:
        return self.voice_female if sex == "f" else self.voice_male


def _profiles(data_dir: str):
    return {
        "fadg0": PersonProfile(
            name="fadg0",
            language="en",
            canvas=(512, 384),
            dict_path=os.path.join(data_dir, "*phoneme_data/VidTIMIT/fadg0.txt"),
            keypoints_dir=os.path.join(
                data_dir, "*phoneme_data/VidTIMIT/fadg0/keypoints_fadg0"
            ),
            keypoint_layout="clip",
            fps=25.0,
        ),
        "henan": PersonProfile(
            name="henan",
            language="zh",
            canvas=(1920, 1080),
            dict_path=os.path.join(data_dir, "dict_henan.txt"),
            keypoints_dir=os.path.join(data_dir, "*pinyin_data/henan/keypoints_henan"),
            keypoint_layout="flat",
            fps=25.0,
            min_key_dist=3,
            key_gap_inclusive=False,
            voice_female="100",
            voice_male="100",
        ),
        "xuesong": PersonProfile(
            name="xuesong",
            language="zh",
            canvas=(1280, 720),
            dict_path=os.path.join(data_dir, "dict_xuesong.txt"),
            keypoints_dir=os.path.join(
                data_dir, "*pinyin_data/xuesong/keypoints_xuesong"
            ),
            keypoint_layout="flat",
            fps=25.0,
            min_key_dist=3,
            key_gap_inclusive=False,
            voice_female="3",
            voice_male="3",
        ),
    }


def get_profile(name: str, data_dir: Optional[str] = None) -> PersonProfile:
    """Look up a built-in person profile (fadg0 / henan / xuesong)."""
    profiles = _profiles(data_dir or DATA_DIR)
    if name not in profiles:
        raise KeyError(
            f"unknown person {name!r}; known: {sorted(profiles)}. "
            "Construct a PersonProfile directly for a new identity."
        )
    return profiles[name]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """pose2frame GAN inference settings.

    Mirrors the reference vid2vid test invocation
    (text2video_audio.sh:42): --loadSize 512 --how_many 1200
    --no_first_img --dataset_mode pose --input_nc 3.
    """

    # Resize label maps so height == load_size before the GAN (the
    # reference's --resize_or_crop scaleHeight --loadSize 512,
    # text2video_audio.sh:42). None = render at the canvas resolution
    # (matches a canvas-native trained model, e.g. fadg0 at 512x384).
    load_size: Optional[int] = None
    max_frames: int = 1200
    n_frames_ctx: int = 3  # generator conditions on this many label maps
    use_prev_frames: int = 2  # autoregressive context frames
    checkpoint_dir: Optional[str] = None
    dtype: str = "bfloat16"
    # Decoding strategy: "scan" is the exact sequential recurrence,
    # "jacobi" ``jacobi_sweeps`` batched whole-timeline sweeps.
    decode_mode: str = "scan"
    jacobi_sweeps: int = 3
    # Wire format of the streaming paths (render_stream_yuv /
    # render_stream_coeffs): "dct" sends zigzag-truncated quantized 8x8-DCT
    # coefficients (ops/dct.py), which the muxer assembles into JPEGs
    # without decoding them; "yuv420" sends the uint8 planes. The
    # coefficients are bit-packed with a per-block 2-bit AC shift when
    # wire_packed (ops/dct.py::pack_plane_shift).
    wire_format: str = "dct"
    wire_quality: int = 75
    wire_k_luma: int = 12
    wire_k_chroma: int = 6
    wire_packed: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Run-level configuration for one text->video invocation."""

    person: PersonProfile
    out_dir: str = "./output"
    emit_intermediates: bool = False  # write pose JSONs / skeleton JPEGs
    smooth: bool = True  # temporal smoothing + mouth re-pin pass
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    # Device batch size for rasterization / GAN inference frame chunks.
    frame_chunk: int = 64
    # Stream frames off device chunk by chunk (in RenderConfig.wire_format),
    # muxed incrementally on a worker thread (overlaps encode with compute). Falls back to the
    # materialized-RGB path when arrays are requested.
    stream: bool = True
    # Where the pose stage's smoothing runs: "host" is the bit-exact float64
    # loop, "device" the fused gather + blend + smoothing kernel
    # (ops/fused_pose.py) on the pipeline's device.
    pose_device: str = "host"
