"""Waveform I/O and resampling (counterpart of
``text2video_tpu/frontend/audio.py``; replaces the reference's sox
dependency).

The reference shells out to ``sox`` to resample input audio to 16 kHz /
16-bit before alignment (reference: aligner/align_english.py:217). Here
reading/resampling is in-process: scipy wav I/O + polyphase resampling.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

ALIGN_SAMPLE_RATE = 16000


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (mono float32 in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if data.dtype == np.int16:
        samples = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        samples = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        samples = (data.astype(np.float32) - 128.0) / 128.0
    else:
        samples = data.astype(np.float32)
    return samples, int(sr)


def save_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    clipped = np.clip(samples, -1.0, 1.0)
    wavfile.write(path, sample_rate, (clipped * 32767.0).astype(np.int16))


def resample(samples: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return samples
    g = math.gcd(sr, target_sr)
    return resample_poly(samples, target_sr // g, sr // g).astype(np.float32)


def load_wav_for_alignment(path: str) -> np.ndarray:
    """wav file -> mono float32 at 16 kHz (the aligner's input contract)."""
    samples, sr = load_wav(path)
    return resample(samples, sr, ALIGN_SAMPLE_RATE)
