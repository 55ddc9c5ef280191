"""Waveform output (counterpart of ``text2video_tpu/frontend/audio.py``:
the sample rate of the aligner's audio and ``save_wav``)."""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile

ALIGN_SAMPLE_RATE = 16000


def save_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    clipped = np.clip(samples, -1.0, 1.0)
    wavfile.write(path, sample_rate, (clipped * 32767.0).astype(np.int16))
