"""ASR-timed pinyin / word timestamping (the Chinese and word paths;
counterpart of ``text2video_tpu/frontend/timestamp_zh.py``).

Replaces the reference's vosk-driven scripts (reference:
pinyin_timestamping.py, phoneme_timestamping.py): an ASR backend yields
word intervals; the text's pinyin syllables are distributed over each
recognized word's interval; digits are spelled out syllable-per-digit.

Behavioral contract (all cites pinyin_timestamping.py):
  * fps = 30 (:24); frame = int(t * fps + 0.5) (:106).
  * Each recognized word's interval [st, et] is split uniformly with
    step = (et - st) / (n_syllables + 1); syllable idx lands at
    st + step * (idx + 1) (:98-106).
  * The *text's* syllable stream (not the ASR transcription) supplies the
    emitted symbols; numeric tokens emit one digit-pinyin per slot via
    the digit map (:50-60, :112-133).
  * Word variant (phoneme_timestamping.py:92-107): one line per word at
    the interval midpoint.

ASR backends: vosk is not in this environment; ``EnergySegmenter``
provides a self-contained fallback that segments speech by energy and
splits it into the expected number of word intervals. A vosk-API-shaped
backend can be plugged in unchanged (``recognize() -> [WordInterval]``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Protocol, Sequence

import numpy as np

from text2video_tpu_torch.frontend.pinyin import to_pinyin
from text2video_tpu_torch.frontend.timestamps import Timestamps

FPS_ZH = 30.0

# reference: pinyin_timestamping.py:50-60
DIGIT_PINYIN = {
    "1": "yi", "2": "er", "3": "san", "4": "si", "5": "wu",
    "6": "liu", "7": "qi", "8": "ba", "9": "jiu", "0": "ling",
}


def digits_to_pinyin(token: str) -> str:
    """Replace every digit in ``token`` with its pinyin."""
    for d, py in DIGIT_PINYIN.items():
        token = token.replace(d, py)
    return token


@dataclasses.dataclass(frozen=True)
class WordInterval:
    word: str
    start: float
    end: float


class AsrBackend(Protocol):
    def recognize(
        self, samples: np.ndarray, sample_rate: int
    ) -> List[WordInterval]: ...


class EnergySegmenter:
    """Fallback ASR: energy-based VAD split into word-count intervals.

    Finds the speech region by smoothed energy, then divides it into the
    expected number of equal word intervals. No transcription — the text
    supplies the symbols anyway (as in the reference, which only takes
    *timing* from vosk when text is given).
    """

    def __init__(self, n_words: int, win_s: float = 0.02, thresh: float = 0.05):
        self.n_words = n_words
        self.win_s = win_s
        self.thresh = thresh

    def recognize(
        self, samples: np.ndarray, sample_rate: int
    ) -> List[WordInterval]:
        win = max(int(self.win_s * sample_rate), 1)
        n = len(samples) // win
        if n == 0 or self.n_words == 0:
            return []
        e = (samples[: n * win].reshape(n, win) ** 2).mean(axis=1)
        active = e > self.thresh * (e.max() + 1e-12)
        idx = np.nonzero(active)[0]
        if len(idx) == 0:
            t0, t1 = 0.0, len(samples) / sample_rate
        else:
            t0 = idx[0] * self.win_s
            t1 = (idx[-1] + 1) * self.win_s
        step = (t1 - t0) / self.n_words
        return [
            WordInterval(word="", start=t0 + i * step, end=t0 + (i + 1) * step)
            for i in range(self.n_words)
        ]


class VoskAsr:
    """vosk (Kaldi) ASR adapter with the reference's usage pattern
    (pinyin_timestamping.py:68-91). Gated: raises a clear error when the
    vosk package / model directory is unavailable in the environment."""

    def __init__(self, model_dir: str = "model"):
        try:
            from vosk import KaldiRecognizer, Model  # noqa: PLC0415
        except ImportError as e:
            raise RuntimeError(
                "vosk is not installed; use EnergySegmenter or another "
                "AsrBackend"
            ) from e
        self._model = Model(model_dir)
        self._KaldiRecognizer = KaldiRecognizer

    def recognize(
        self, samples: np.ndarray, sample_rate: int
    ) -> List[WordInterval]:
        import json  # noqa: PLC0415

        rec = self._KaldiRecognizer(self._model, sample_rate)
        rec.SetWords(True)
        pcm = (np.clip(samples, -1, 1) * 32767.0).astype("<i2").tobytes()
        rec.AcceptWaveform(pcm)
        res = json.loads(rec.FinalResult())
        return [
            WordInterval(
                word=item["word"], start=item["start"], end=item["end"]
            )
            for item in res.get("result", [])
        ]


def pinyin_timestamps(
    text: str,
    intervals: Sequence[WordInterval],
    fps: float = FPS_ZH,
    pinyin_fn: Callable[[str], List[str]] = to_pinyin,
) -> Timestamps:
    """Distribute the text's pinyin stream over ASR word intervals.

    Reproduces the reference walk exactly (pinyin_timestamping.py:95-133):
    the symbol cursor advances once per emitted line; a numeric text token
    emits one digit per slot until its digits are exhausted.
    """
    py_input = pinyin_fn(text)
    out = []
    i = 0  # cursor into py_input
    j = 0  # digit cursor within a numeric token
    for item in intervals:
        syls = pinyin_fn(item.word) if item.word else ["x"]
        nc = len(syls)
        step = (item.end - item.start) / (nc + 1)
        for idx in range(nc):
            if i > len(py_input) - 1:
                break
            frame = int((item.start + step * (idx + 1)) * fps + 0.5)
            tok = py_input[i]
            if tok.isnumeric():
                if j < len(tok):
                    out.append((frame, digits_to_pinyin(tok[j])))
                    j += 1
                else:
                    j = 0
                    i += 1
            else:
                out.append((frame, tok))
                i += 1
    if not out:
        raise ValueError("no timestamps produced (empty text or intervals)")
    return Timestamps(entries=tuple(out))


def word_timestamps(
    words: Sequence[str],
    intervals: Sequence[WordInterval],
    fps: float = FPS_ZH,
) -> Timestamps:
    """Word-midpoint variant (reference: phoneme_timestamping.py:92-107)."""
    out = []
    for w, item in zip(words, intervals):
        mid = item.start + (item.end - item.start) / 2
        out.append((int(mid * fps + 0.5), w))
    if not out:
        raise ValueError("no timestamps produced")
    return Timestamps(entries=tuple(out))


def timestamp_chinese(
    text: str,
    samples: np.ndarray,
    sample_rate: int,
    asr: Optional[AsrBackend] = None,
    fps: float = FPS_ZH,
    aligner=None,
) -> Timestamps:
    """Full Chinese path: word/syllable intervals -> pinyin timestamps.

    Punctuation strips before conversion, as the reference does before
    lazy_pinyin (pinyin_timestamping.py:20-35). Timing backends, best
    first:
      * ``aligner`` (frontend.align_mandarin.MandarinAligner) — forced
        alignment of the known pinyin stream; each emitted line gets its
        own aligned interval, so the uniform-split walk degenerates to
        true per-syllable midpoints.
      * ``asr`` — any AsrBackend (vosk adapter), the reference's method.
      * default — EnergySegmenter fallback.
    """
    from text2video_tpu_torch.frontend.textnorm import strip_punct

    stripped = strip_punct(text, strip_spaces=False, ascii_too=True)
    if aligner is not None:
        # Each aligned span corresponds 1:1 with an emitted symbol of
        # the expanded walk stream (digits already one-per-slot), so
        # emit span midpoints directly. Feeding the spans through
        # pinyin_timestamps would be wrong for numeric tokens: the
        # reference walk burns one extra interval to advance past an
        # exhausted digit token (pinyin_timestamping.py:112-133) but
        # the aligner produces exactly one span per emitted symbol.
        spans = aligner.align_text(samples, stripped, sample_rate)
        out = [
            (
                int((s.start + (s.end - s.start) / 2) * fps + 0.5),
                s.syllable,
            )
            for s in spans
        ]
        if not out:
            raise ValueError("no timestamps produced (empty text)")
        return Timestamps(entries=tuple(out))
    if asr is None:
        asr = EnergySegmenter(n_words=max(len(to_pinyin(stripped)), 1))
    intervals = asr.recognize(samples, sample_rate)
    return pinyin_timestamps(stripped, intervals, fps=fps)
