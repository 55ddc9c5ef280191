"""English forced alignment: audio + transcript -> phoneme/word timings
(counterpart of ``text2video_tpu/frontend/align_english.py``).

Replaces the reference's P2FA/HTK pipeline (reference:
aligner/align_english.py — sox resample, english2phoneme OOV G2P, HCopy
PLP features, HVite forced alignment, HTK-time output conversion) with the
native toolchain in native/align/ plus this frontend.

Output contract (bit-compatible with the reference's files):
  * phones: lines ``<frame> <PHONE>`` where
    ``frame = int(0.5 * (start_s + end_s) * fps)`` at fps=25
    (reference: align_english.py:148 and :34) and the phone symbols carry
    the dictionary's stress digits plus ``sp`` pauses.
  * words: lines ``<start_s> <end_s> <word>`` with pauses written as
    ``SIL`` (reference: align_english.py:163-169).
  * Times in seconds are frame-boundary times with the reference's
    +12.5 ms half-window offset: ``t = 0.010 * frame + 0.0125``
    (equivalent to its ``(htk_units/1000 + 125)/10000``,
    align_english.py:145-146).

Acoustic models are stress-free monophones (+ sil/sp); dictionary
pronunciations keep their stress digits in the *emitted* symbols while
alignment runs on the stripped symbols. The reference's models were
stripped from its mirror, so models here are trained with
:func:`train_acoustic_model` (flat start -> Viterbi re-estimation ->
mixture splitting) from any (wav, transcript) recordings.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from text2video_tpu_torch.frontend import native
from text2video_tpu_torch.frontend.audio import (
    ALIGN_SAMPLE_RATE,
    load_wav_for_alignment,
)
from text2video_tpu_torch.frontend.timestamps import Timestamps, WordSpan

FRAME_SHIFT_S = 0.010
TIME_OFFSET_S = 0.0125  # half the 25 ms analysis window

_VOWEL_RE = re.compile(r"^(AA|AE|AH|AO|AW|AY|EH|ER|EY|IH|IY|OW|OY|UH|UW)")


def strip_stress(phone: str) -> str:
    return phone.rstrip("0123456789")


def add_default_stress(phones: Sequence[str]) -> List[str]:
    """G2P output -> dictionary-style symbols: vowels get stress ``1``
    (the reference applied the same convention to english2phoneme output,
    align_english.py:36-116, with AX -> AH0)."""
    return [p + "1" if _VOWEL_RE.match(p) else p for p in phones]


class PronouncingDict:
    """CMU-format pronouncing dictionary (``WORD  PH1 PH2 ...``).

    Loads the reference's 127k-entry dict asset when present
    (aligner/english/dict); ``lookup`` falls back to the native G2P rule
    engine for OOV words.
    """

    def __init__(self, entries: Dict[str, List[List[str]]]):
        self.entries = entries

    @classmethod
    def load(cls, path: str) -> "PronouncingDict":
        entries: Dict[str, List[List[str]]] = {}
        with open(path, "r", errors="replace") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                word = parts[0]
                # Alternate pronunciations "WORD(2)" join the variant list.
                if "(" in word:
                    word = word[: word.index("(")]
                entries.setdefault(word.upper(), []).append(parts[1:])
        return cls(entries)

    def lookup(self, word: str) -> List[str]:
        """First (primary) pronunciation."""
        return self.lookup_variants(word)[0]

    def lookup_variants(self, word: str) -> List[List[str]]:
        """All pronunciations; the aligner lets Viterbi pick the best
        (the reference's HVite does the same with its HTK dictionary)."""
        word = word.upper()
        if word in self.entries:
            return self.entries[word]
        return [add_default_stress(native.g2p(word))]


def transcript_words(text: str) -> List[str]:
    """Split a transcript into alignable words: numbers spelled out (the
    reference's saynum.c role), punctuation stripped, apostrophes kept."""
    from text2video_tpu_torch.frontend.textnorm import spell_numbers

    words = []
    for tok in spell_numbers(text).split():
        w = re.sub(r"[^A-Za-z']+", "", tok)
        if w:
            words.append(w)
    return words


@dataclasses.dataclass
class AlignmentResult:
    phones: Timestamps          # "<frame> <PHONE>" pairs, fps-converted
    words: List[WordSpan]       # start/end seconds + word (SIL for pauses)
    phone_times: List[Tuple[str, float, float]]  # symbol, start_s, end_s


class EnglishAligner:
    def __init__(
        self,
        model: native.AcousticModel,
        pdict: PronouncingDict,
        fps: float = 25.0,
    ):
        self.model = model
        self.pdict = pdict
        self.fps = fps

    @classmethod
    def load(
        cls, model_path: str, dict_path: str, fps: float = 25.0
    ) -> "EnglishAligner":
        return cls(
            native.AcousticModel.load(model_path),
            PronouncingDict.load(dict_path),
            fps,
        )

    # ------------------------------------------------------------------

    def _segments(self, words: Sequence[str]):
        """Expand words to the decoding lattice: sil W1 sp W2 sp ... sil.

        Mirrors the reference's MLF convention of optional ``sp`` between
        words and ``sil`` at the edges (align_english.py:118-128). Each
        word segment carries every dictionary pronunciation as a parallel
        variant. Returns (segments, emit_symbols, word_of_segment) where
        segments feed native.align_variants, emit_symbols[(seg, var, pos)]
        is the stressed output symbol, and word_of_segment maps segment
        index to word index (-1 for sil/sp).
        """
        segments: List[Tuple[List[List[int]], bool]] = []
        symbols: Dict[Tuple[int, int, int], str] = {}
        word_of: List[int] = []

        def pid(model_sym: str) -> int:
            i = self.model.phone_id(model_sym)
            if i < 0:
                raise KeyError(
                    f"model has no phone {model_sym!r} "
                    f"(phones: {self.model.phones[:10]}...)"
                )
            return i

        def push(variants: List[List[str]], skippable: bool, widx: int):
            seg = len(segments)
            id_variants = []
            for v, phones in enumerate(variants):
                id_variants.append([pid(strip_stress(p)) for p in phones])
                for k, p in enumerate(phones):
                    symbols[(seg, v, k)] = p
            segments.append((id_variants, skippable))
            word_of.append(widx)

        push([["sil"]], False, -1)
        for i, w in enumerate(words):
            push(self.pdict.lookup_variants(w), False, i)
            if i + 1 < len(words):
                push([["sp"]], True, -1)
        push([["sil"]], False, -1)
        return segments, symbols, word_of

    def align(
        self, samples: np.ndarray, text: str, sample_rate: int = ALIGN_SAMPLE_RATE
    ) -> AlignmentResult:
        words = transcript_words(text)
        if not words:
            raise ValueError("empty transcript")
        feats = native.extract_features(
            samples, sample_rate, self.model.feat_kind
        )
        segments, symbols, word_of = self._segments(words)
        records, _ = native.align_variants(self.model, feats, segments)

        def t_of(frame: int) -> float:
            return FRAME_SHIFT_S * frame + TIME_OFFSET_S

        phone_times: List[Tuple[str, float, float]] = []
        frames: List[Tuple[int, str]] = []
        for seg, var, pos, _pid, start, end in records:
            if start == end:
                continue
            sym = symbols[(seg, var, pos)]
            out_sym = "sp" if sym == "sil" else sym
            st, en = t_of(start), t_of(end)
            phone_times.append((out_sym, st, en))
            frames.append((int(0.5 * (st + en) * self.fps), out_sym))

        # Word spans: first/last emitted phone of each word segment;
        # sil/sp become SIL entries (reference: align_english.py:163-169).
        spans: List[WordSpan] = []
        cur_seg = None
        for seg, var, pos, _pid, start, end in records:
            if start == end:
                continue
            if seg != cur_seg:
                w = word_of[seg]
                spans.append(
                    WordSpan(
                        start=t_of(start),
                        end=t_of(end),
                        word="SIL" if w < 0 else words[w],
                    )
                )
                cur_seg = seg
            else:
                spans[-1] = dataclasses.replace(spans[-1], end=t_of(end))

        return AlignmentResult(
            phones=Timestamps(entries=tuple(frames)),
            words=spans,
            phone_times=phone_times,
        )

    def align_file(self, wav_path: str, text: str) -> AlignmentResult:
        return self.align(load_wav_for_alignment(wav_path), text)

    def align_states(
        self,
        samples: np.ndarray,
        text: str,
        sample_rate: int = ALIGN_SAMPLE_RATE,
        fps: float = 30.0,
    ) -> Timestamps:
        """State-level variant (reference: align_english_states.py — HVite
        -f per-state alignment at fps=30): each phone is emitted at the
        midpoint of its *middle* emitting state's occupancy (HTK state s3
        of 5 == our state index 1 of 3; single-state sp emits at its only
        state, the reference's sp_s2)."""
        words = transcript_words(text)
        if not words:
            raise ValueError("empty transcript")
        feats = native.extract_features(
            samples, sample_rate, self.model.feat_kind
        )
        segments, symbols, _ = self._segments(words)
        _pid, state, seg, pos = native.align_frame_states(
            self.model, feats, segments
        )

        frames = []
        t = 0
        t_max = len(state)
        while t < t_max:
            # Walk one (segment, phone_pos) run.
            s0, p0 = seg[t], pos[t]
            j = t
            mid_lo = mid_hi = None
            n_states = 0
            while j < t_max and seg[j] == s0 and pos[j] == p0:
                n_states = max(n_states, state[j] + 1)
                j += 1
            target_state = 1 if n_states >= 3 else 0
            for k in range(t, j):
                if state[k] == target_state:
                    if mid_lo is None:
                        mid_lo = k
                    mid_hi = k + 1
            if mid_lo is not None:
                st = FRAME_SHIFT_S * mid_lo + TIME_OFFSET_S
                en = FRAME_SHIFT_S * mid_hi + TIME_OFFSET_S
                # The chosen variant is whatever the best path used; map
                # back through any variant that has this phone position.
                sym = None
                for v in range(len(segments[s0][0])):
                    sym = symbols.get((s0, v, p0), sym)
                out_sym = "sp" if sym == "sil" else sym
                frames.append((int(0.5 * (st + en) * fps), out_sym))
            t = j
        return Timestamps(entries=tuple(frames))


# ---- acoustic model training -------------------------------------------

ARPABET_BASE = [
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH", "EH", "ER",
    "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG", "OW",
    "OY", "P", "R", "S", "SH", "T", "TH", "UH", "UW", "V", "W", "Y", "Z",
    "ZH",
]


def load_word_spans(
    words_path: str,
    phones_path: Optional[str] = None,
    fps: float = 25.0,
) -> List[Tuple[float, float, object]]:
    """Reference words/phones timestamp files -> train_acoustic_model
    word_spans supervision.

    words file: "<start_s> <end_s> <word_or_SIL>" rows
    (align_english.py:163-169 emits these). When the matching phones
    file ("<frame> <PHONE>" at ``fps``) exists, each word's phone
    sequence is carved out by midpoint-in-span, pinning the
    pronunciation variant the reference chose."""
    wrows = [
        tuple(l.split()) for l in open(words_path) if len(l.split()) == 3
    ]
    prows: List[Tuple[int, str]] = []
    if phones_path is not None and os.path.exists(phones_path):
        prows = [
            (int(a), b)
            for a, b in (l.split() for l in open(phones_path))
            if b != "sp"
        ]
    out: List[Tuple[float, float, object]] = []
    for s, e, w in wrows:
        s, e = float(s), float(e)
        if w == "SIL":
            # Short inter-word pauses are the *sp* model's training data
            # (the reference's MLF puts sp between words and emits it in
            # the phones output when occupied; long silences are sil).
            # Without this, sp never sees supervised frames and Viterbi
            # learns to skip pauses the reference keeps.
            out.append((s, e, ("sp",) if (e - s) < 0.2 else "SIL"))
            continue
        phs = [p for f, p in prows if s <= f / fps < e]
        out.append((s, e, tuple(phs) if phs else w))
    return out


def train_acoustic_model(
    utterances: Sequence[Tuple[np.ndarray, str]],
    pdict: PronouncingDict,
    sample_rate: int = ALIGN_SAMPLE_RATE,
    iterations: int = 8,
    target_mixes: int = 4,
    save_path: Optional[str] = None,
    feat_kind: int = native.FEAT_MFCC,
    word_spans: Optional[Sequence
                         [Optional[Sequence[Tuple[float, float, str]]]]] = None,
) -> native.AcousticModel:
    """Flat-start Viterbi training of stress-free monophone models.

    utterances: (mono float PCM, transcript) pairs. Replaces the
    reference's dependency on pre-trained P2FA models (stripped from its
    mirror) — any per-person dictionary recording can bootstrap a usable
    aligner.

    word_spans (optional, parallel to utterances): per-utterance
    ``[(start_s, end_s, word_or_SIL), ...]`` segmentation — e.g. the
    reference's ``input_timestamp/{person}/words/*.txt`` files. A
    supervised utterance accumulates per word SEGMENT (features cut at
    the given boundaries, Viterbi within each word), so the trained
    models adopt the supervision's word-boundary convention — the
    classic bootstrap-from-labeled-segmentation recipe (the reference's
    corpus-trained P2FA models are stripped from its mirror; their
    word-level outputs ARE shipped, and this recovers their
    segmentation convention from them). Within-word phone boundaries
    stay model-derived. Entries of None train unsupervised.
    """
    model = native.AcousticModel.create(
        ["sil", "sp"] + ARPABET_BASE, feat_kind=feat_kind
    )
    trainer = native.Trainer(model)

    def word_ids(w: str) -> List[int]:
        return [model.phone_id(strip_stress(ph)) for ph in pdict.lookup(w)]

    prepped = []  # list of [(feats, ids, skip), ...] segments
    for i, (samples, text) in enumerate(utterances):
        feats = native.extract_features(samples, sample_rate, feat_kind)
        spans = word_spans[i] if word_spans is not None else None
        if spans:
            segs = []
            for start, end, w in spans:
                lo = max(int(round(start * 100.0)), 0)  # 10 ms frames
                hi = min(int(round(end * 100.0)), feats.shape[0])
                n = hi - lo
                if n < 3:  # a 3-state HMM needs >= 3 frames
                    continue
                if isinstance(w, (list, tuple)):
                    # Explicit phone sequence (e.g. carved from the
                    # reference's phones/*.txt by word span) — pins the
                    # pronunciation VARIANT the supervision used, which
                    # dictionary-first lookup cannot.
                    ids = [model.phone_id(strip_stress(p)) for p in w]
                    if len(ids) > n:
                        continue
                elif w == "SIL":
                    ids = [model.phone_id("sil")]
                else:
                    ids = word_ids(w)
                    if len(ids) > n:
                        continue  # span too short for the pron
                segs.append((feats[lo:hi], ids, [False] * len(ids)))
            prepped.append(segs)
        else:
            ids: List[int] = [model.phone_id("sil")]
            skip: List[bool] = [False]
            words = transcript_words(text)
            for j, w in enumerate(words):
                wi = word_ids(w)
                ids.extend(wi)
                skip.extend([False] * len(wi))
                if j + 1 < len(words):
                    ids.append(model.phone_id("sp"))
                    skip.append(True)
            ids.append(model.phone_id("sil"))
            skip.append(False)
            prepped.append([(feats, ids, skip)])
        trainer.accumulate_global(feats)
    trainer.finalize_flat_start()

    for it in range(iterations):
        for segs in prepped:
            for feats, ids, skip in segs:
                trainer.accumulate(feats, ids, skip, uniform=(it == 0))
        trainer.update()
        # Split mixtures halfway through once single-Gaussian models settle.
        if it == iterations // 2 and target_mixes > 1:
            trainer.mixup(target_mixes)

    if save_path is not None:
        model.save(save_path)
    return model
