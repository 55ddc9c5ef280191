"""TTS frontends: text -> waveform (counterpart of
``text2video_tpu/frontend/tts.py``).

Replaces the reference's Baidu-TTS HTTP client (reference: tts_request.py —
POST to tts.baidu.com/text2audio with per-person/gender voice ids, mp3
download, pydub mp3->wav). Backends:

  * :class:`HttpTTS` — same wire contract (voice id table comes from the
    PersonProfile, mirroring tts_request.py:29-41). Requires network
    egress; raises a clear error without it.
  * :class:`FormantTTS` — self-contained fallback: a tiny rule-driven
    formant synthesizer producing an intelligible-timing (not
    natural-sounding) waveform so the full pipeline runs hermetically.
    Phone durations/voicing drive the pose timing downstream, which is
    what the video path actually consumes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol

import numpy as np

from text2video_tpu_torch.config import PersonProfile
from text2video_tpu_torch.frontend import native
from text2video_tpu_torch.frontend.align_english import (
    PronouncingDict,
    strip_stress,
    transcript_words,
)


class TTSBackend(Protocol):
    def synthesize(self, text: str, sample_rate: int) -> np.ndarray: ...


class HttpTTS:
    """HTTP TTS client with the reference's voice-selection contract."""

    URL = "http://tts.baidu.com/text2audio"

    def __init__(self, profile: PersonProfile, sex: str = "f"):
        self.voice = profile.voice(sex)
        self.language = profile.language

    def synthesize(self, text: str, sample_rate: int) -> np.ndarray:
        try:
            import requests  # noqa: PLC0415
        except ImportError as e:
            raise RuntimeError("requests not available") from e
        params = {
            "tex": text,
            "lan": "zh" if self.language == "zh" else "en",
            "per": self.voice,
            "cuid": "text2video-tpu",
            "ctp": 1,
            "ie": "UTF-8",
            # Request wav (aue=6) instead of the reference's mp3 — no
            # decoder dependency (the reference needed pydub/ffmpeg,
            # tts_request.py:54-55).
            "aue": 6,
        }
        resp = requests.post(self.URL, data=params, timeout=30)
        resp.raise_for_status()
        if resp.headers.get("Content-Type", "").startswith("audio"):
            import io  # noqa: PLC0415

            from text2video_tpu_torch.frontend.audio import (  # noqa: PLC0415
                resample,
            )
            from scipy.io import wavfile  # noqa: PLC0415

            sr, data = wavfile.read(io.BytesIO(resp.content))
            if data.ndim == 2:
                data = data.mean(axis=1)
            samples = data.astype(np.float32)
            if data.dtype == np.int16:
                samples /= 32768.0
            return resample(samples, int(sr), sample_rate)
        raise RuntimeError(f"TTS error response: {resp.text[:200]}")


# ---- self-contained formant synthesizer ----------------------------------

# Source-filter synthesis (Klatt-style cascade, simplified): a glottal
# pulse train with a falling f0 contour excites three time-varying
# second-order resonators whose centre frequencies glide between
# per-phone (F1, F2, F3) targets — coarticulated transitions instead of
# the reference-free "two gated sines per phone" placeholder this
# replaces. Monophthongs have one target; diphthongs a start and an end
# target. Values are classic Peterson–Barney-style averages (Hz).
_VOWEL_FORMANTS = {
    "AA": [(730, 1090, 2440)],
    "AE": [(660, 1720, 2410)],
    "AH": [(640, 1190, 2390)],
    "AO": [(570, 840, 2410)],
    "AW": [(730, 1090, 2440), (440, 1020, 2240)],
    "AY": [(730, 1090, 2440), (390, 1990, 2550)],
    "EH": [(530, 1840, 2480)],
    "ER": [(490, 1350, 1690)],
    "EY": [(480, 1900, 2500), (330, 2100, 2700)],
    "IH": [(390, 1990, 2550)],
    "IY": [(270, 2290, 3010)],
    "OW": [(570, 840, 2410), (330, 890, 2300)],
    "OY": [(570, 840, 2410), (390, 1990, 2550)],
    "UH": [(440, 1020, 2240)],
    "UW": [(300, 870, 2240)],
}
# Voiced sonorants rendered through the same resonator cascade.
_SONORANT_FORMANTS = {
    "M": [(250, 1000, 2200)],
    "N": [(250, 1450, 2300)],
    "NG": [(250, 1300, 2100)],
    "L": [(360, 1300, 2700)],
    "R": [(310, 1060, 1380)],  # the low F3 that cues /r/
    "W": [(300, 610, 2200)],
    "Y": [(270, 2290, 3010)],
}
_FRICATIVES = {"S", "SH", "F", "TH", "HH", "Z", "ZH", "V", "DH", "CH", "JH"}
_VOICED_FRICATIVES = {"Z", "ZH", "V", "DH", "JH"}
# Fricative noise band (low, high) in Hz — sibilants hiss high, labials low.
_FRIC_BAND = {
    "S": (4000, 7600), "Z": (4000, 7600),
    "SH": (2000, 6000), "ZH": (2000, 6000),
    "CH": (2000, 6000), "JH": (2000, 6000),
    "F": (1000, 7000), "V": (1000, 7000),
    "TH": (1200, 7000), "DH": (1200, 7000),
    "HH": (400, 6500),
}
_PLOSIVES = {"P", "T", "K", "B", "D", "G"}
_VOICED_PLOSIVES = {"B", "D", "G"}
# Burst noise band by place of articulation.
_PLOSIVE_BAND = {
    "P": (400, 2000), "B": (400, 2000),
    "T": (2500, 7000), "D": (2500, 7000),
    "K": (1500, 4000), "G": (1500, 4000),
}
_NASALS_LIQUIDS = set(_SONORANT_FORMANTS)

_DUR = {
    "vowel": 0.13, "diphthong": 0.17, "sonorant": 0.08,
    "fricative": 0.09, "plosive": 0.07, "other": 0.08,
}

# Mandarin initial/final units -> the synthesizer's ARPABET-ish classes
# (frontend/align_mandarin.py decomposition). Finals become vowel(+coda)
# formant sequences; initials map onto the closest consonant class.
_ZH_INITIAL_PHONES = {
    "b": ["B"], "p": ["P"], "m": ["M"], "f": ["F"], "d": ["D"],
    "t": ["T"], "n": ["N"], "l": ["L"], "g": ["G"], "k": ["K"],
    "h": ["HH"], "j": ["JH"], "q": ["CH"], "x": ["SH"], "zh": ["JH"],
    "ch": ["CH"], "sh": ["SH"], "r": ["ZH"], "z": ["D", "Z"],
    "c": ["T", "S"],
}
_ZH_FINAL_PHONES = {
    "a": ["AA"], "o": ["AO"], "e": ["AH"], "i": ["IY"], "u": ["UW"],
    "v": ["UW"], "ih": ["ER"], "ai": ["AY"], "ei": ["EY"], "ao": ["AW"],
    "ou": ["OW"], "an": ["AA", "N"], "en": ["AH", "N"],
    "ang": ["AA", "NG"], "eng": ["AH", "NG"], "ong": ["UH", "NG"],
    "er": ["ER"], "ia": ["IY", "AA"], "ie": ["IY", "EH"],
    "iao": ["IY", "AW"], "iou": ["IY", "OW"], "ian": ["IY", "EH", "N"],
    "in": ["IH", "N"], "iang": ["IY", "AA", "NG"], "ing": ["IH", "NG"],
    "iong": ["IY", "UH", "NG"], "ua": ["UW", "AA"], "uo": ["UW", "AO"],
    "uai": ["UW", "AY"], "uei": ["UW", "EY"], "uan": ["UW", "AA", "N"],
    "uen": ["UW", "AH", "N"], "uang": ["UW", "AA", "NG"],
    "ueng": ["UW", "AH", "NG"], "ve": ["UW", "EH"],
    "van": ["UW", "AE", "N"], "vn": ["UW", "N"],
}


@dataclasses.dataclass
class FormantTTS:
    """Rule-based formant synthesis from dictionary pronunciations."""

    pdict: Optional[PronouncingDict] = None
    f0: float = 120.0
    pause_s: float = 0.12

    def _phones(self, word: str) -> List[str]:
        if self.pdict is not None:
            return [strip_stress(p) for p in self.pdict.lookup(word)]
        return native.g2p(word)

    def synthesize(self, text: str, sample_rate: int) -> np.ndarray:
        rng = np.random.RandomState(0)
        words = transcript_words(text)
        pause_s = self.pause_s
        if words:
            units = [self._phones(w) for w in words]
        else:
            # Chinese text: per-syllable initial/final formant synthesis
            # (frontend/align_mandarin decomposition), short inter-
            # syllable gaps — articulated per syllable, not one generic
            # vowel for everything.
            from text2video_tpu_torch.frontend.align_mandarin import (  # noqa: PLC0415
                expand_walk_stream,
                pinyin_to_phones,
            )

            units = []
            for tok in expand_walk_stream(text):
                parts = pinyin_to_phones(tok)
                if parts is None:
                    units.append(["AH"])
                    continue
                phones: List[str] = []
                for p in parts:
                    phones.extend(
                        _ZH_INITIAL_PHONES.get(p)
                        or _ZH_FINAL_PHONES.get(p, ["AH"])
                    )
                units.append(phones)
            pause_s = 0.04
        segs: List[dict] = [_silence(0.1)]
        for phones in units:
            for ph in phones:
                segs.extend(_phone_segments(ph))
            segs.append(_silence(pause_s))
        segs.append(_silence(0.1))
        return _render(segs, sample_rate, self.f0, rng)


# Each segment: {dur, targets: [(F1,F2,F3), ...] or None, voiced: float,
# noise: float, band: (lo, hi) or None}. Rendering interpolates formant
# targets across segment boundaries, so consonant transitions inherit the
# neighbouring vowels' glides (coarticulation).


def _silence(dur: float) -> dict:
    return {"dur": dur, "targets": None, "voiced": 0.0, "noise": 0.0,
            "band": None}


def _phone_segments(ph: str) -> List[dict]:
    if ph in _VOWEL_FORMANTS:
        targets = _VOWEL_FORMANTS[ph]
        dur = _DUR["diphthong"] if len(targets) > 1 else _DUR["vowel"]
        return [{"dur": dur, "targets": targets, "voiced": 1.0,
                 "noise": 0.0, "band": None}]
    if ph in _SONORANT_FORMANTS:
        return [{"dur": _DUR["sonorant"],
                 "targets": _SONORANT_FORMANTS[ph], "voiced": 0.6,
                 "noise": 0.0, "band": None}]
    if ph in _PLOSIVES:
        band = _PLOSIVE_BAND[ph]
        voiced = ph in _VOICED_PLOSIVES
        return [
            # Closure (voiced plosives keep a low murmur), then the burst
            # (+ aspiration for the unvoiced set: longer noise tail).
            {"dur": 0.035, "targets": None,
             "voiced": 0.15 if voiced else 0.0, "noise": 0.0,
             "band": None},
            {"dur": 0.02 if voiced else 0.045, "targets": None,
             "voiced": 0.0, "noise": 0.8, "band": band},
        ]
    if ph in _FRICATIVES:
        return [{"dur": _DUR["fricative"], "targets": None,
                 "voiced": 0.3 if ph in _VOICED_FRICATIVES else 0.0,
                 "noise": 0.55, "band": _FRIC_BAND[ph]}]
    return [{"dur": _DUR["other"], "targets": [(500, 1500, 2500)],
             "voiced": 0.5, "noise": 0.0, "band": None}]


def _resonator_coeffs(f: np.ndarray, bw: float, sr: int):
    """Klatt-style two-pole resonator (b0 chosen for unity DC gain)."""
    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * np.clip(f, 50.0, 0.48 * sr) / sr
    a1 = -2 * r * np.cos(theta)
    a2 = r * r
    b0 = 1 + a1 + a2
    return b0, a1, a2


def _render(
    segs: List[dict], sr: int, f0_base: float, rng: np.random.RandomState
) -> np.ndarray:
    from scipy.signal import butter, lfilter  # noqa: PLC0415

    ns = [max(int(s["dur"] * sr), 1) for s in segs]
    total = int(np.sum(ns))
    bounds = np.concatenate([[0], np.cumsum(ns)])

    # Per-sample voiced/noise amplitude envelopes with 8 ms ramps.
    voiced_amp = np.zeros(total, np.float32)
    noise_amp = np.zeros(total, np.float32)
    ramp = max(int(0.008 * sr), 1)
    up = 0.5 * (1 - np.cos(np.pi * np.arange(ramp) / ramp))
    for s, lo, hi in zip(segs, bounds[:-1], bounds[1:]):
        for arr, amp in ((voiced_amp, s["voiced"]), (noise_amp, s["noise"])):
            if amp <= 0.0:
                continue
            arr[lo:hi] = amp
            e = min(ramp, hi - lo)
            arr[lo : lo + e] *= up[:e]
            arr[hi - e : hi] *= up[:e][::-1]

    # Formant tracks: hold knots at 30%/70% of each voiced segment,
    # linear interpolation everywhere else (glides through consonants).
    knot_t: List[float] = []
    knot_f: List[tuple] = []
    for s, lo, hi in zip(segs, bounds[:-1], bounds[1:]):
        targets = s["targets"]
        if not targets:
            continue
        if len(targets) == 1:
            knot_t += [lo + 0.3 * (hi - lo), lo + 0.7 * (hi - lo)]
            knot_f += [targets[0], targets[0]]
        else:  # diphthong: start and end targets
            knot_t += [lo + 0.2 * (hi - lo), lo + 0.8 * (hi - lo)]
            knot_f += [targets[0], targets[-1]]
    if not knot_t:
        wave = noise_amp * rng.randn(total).astype(np.float32) * 0.3
        peak = np.abs(wave).max()
        return (wave / peak * 0.7).astype(np.float32) if peak > 0 else wave
    knot_t_arr = np.asarray(knot_t)
    knot_f_arr = np.asarray(knot_f, np.float64)  # [K, 3]

    # Glottal source: pulse train with declination + jitter, integrated
    # to a -12 dB/oct spectrum, gated by the voicing envelope.
    tline = np.arange(total) / total
    f0 = f0_base * (1.06 - 0.28 * tline)
    f0 = f0 * (1.0 + 0.015 * rng.randn(total).astype(np.float64).cumsum()
               / np.sqrt(np.arange(1, total + 1)))
    phase = np.cumsum(f0 / sr)
    pulses = np.zeros(total, np.float64)
    pulses[1:] = np.floor(phase[1:]) != np.floor(phase[:-1])
    source = lfilter([1.0], [1.0, -0.94], pulses)
    source = lfilter([1.0, -1.0], [1.0, -0.999], source)  # remove DC drift
    source *= voiced_amp

    # Time-varying cascade of three resonators, updated every 5 ms.
    hop = max(int(0.005 * sr), 1)
    out_v = np.zeros(total, np.float64)
    zis = [np.zeros(2) for _ in range(3)]
    bws = (90.0, 110.0, 170.0)
    for lo in range(0, total, hop):
        hi = min(total, lo + hop)
        mid = 0.5 * (lo + hi)
        f123 = [
            np.interp(mid, knot_t_arr, knot_f_arr[:, i]) for i in range(3)
        ]
        x = source[lo:hi]
        for i, (f, bw) in enumerate(zip(f123, bws)):
            b0, a1, a2 = _resonator_coeffs(np.asarray(f), bw, sr)
            x, zis[i] = lfilter(
                [float(b0)], [1.0, float(a1), float(a2)], x, zi=zis[i]
            )
        out_v[lo:hi] = x

    # Frication/burst noise: white noise band-passed per segment band.
    out_n = np.zeros(total, np.float64)
    white = rng.randn(total)
    nyq = sr / 2.0
    band_cache = {}
    for s, lo, hi in zip(segs, bounds[:-1], bounds[1:]):
        if s["noise"] <= 0.0 or s["band"] is None:
            continue
        band = s["band"]
        if band not in band_cache:
            lo_f = min(band[0] / nyq, 0.95)
            hi_f = min(band[1] / nyq, 0.98)
            band_cache[band] = butter(2, [lo_f, hi_f], btype="band")
        b, a = band_cache[band]
        pad = min(lo, 64)
        seg_noise = lfilter(b, a, white[lo - pad : hi])[pad:]
        out_n[lo:hi] = seg_noise

    wave = out_v * 6.0 + out_n * noise_amp
    peak = np.abs(wave).max()
    return (
        (wave / peak * 0.7).astype(np.float32)
        if peak > 0
        else wave.astype(np.float32)
    )
