"""Timestamp records: the contract between audio frontends and pose synthesis
(counterpart of ``text2video_tpu/frontend/timestamps.py``).

A timestamp file is lines of ``"<frame> <symbol>"`` where frame is an output
video frame index and symbol is an ARPABET phoneme (English; reference:
align_english.py:178-183) or a pinyin syllable (Chinese; reference:
pinyin_timestamping.py:127-136). Word-level files are
``"<start> <end> <word>"`` in seconds (align_english.py:163-169).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Timestamps:
    """Ordered (frame, symbol) pairs for one utterance."""

    entries: Tuple[Tuple[int, str], ...]

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __iter__(self):
        return iter(self.entries)

    @property
    def first_frame(self) -> int:
        return self.entries[0][0]

    @property
    def last_frame(self) -> int:
        return self.entries[-1][0]


def parse_timestamp_lines(lines: Iterable[str]) -> Timestamps:
    entries: List[Tuple[int, str]] = []
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        if len(parts) != 2:
            raise ValueError(f"bad timestamp line: {line!r}")
        entries.append((int(parts[0]), parts[1]))
    if not entries:
        raise ValueError("empty timestamp input")
    return Timestamps(entries=tuple(entries))


def load_timestamp_file(path: str) -> Timestamps:
    with open(path, encoding="utf-8") as f:
        return parse_timestamp_lines(f)


def format_timestamp_lines(ts: Timestamps) -> str:
    return "".join(f"{frame} {sym}\n" for frame, sym in ts)


@dataclasses.dataclass(frozen=True)
class WordSpan:
    start: float
    end: float
    word: str


def format_word_lines(spans: Sequence[WordSpan]) -> str:
    return "".join(f"{s.start} {s.end} {s.word}\n" for s in spans)
