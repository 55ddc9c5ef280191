"""Hanzi -> pinyin conversion (lazy_pinyin-equivalent, self-contained;
counterpart of ``text2video_tpu/frontend/pinyin.py``).

The reference uses pypinyin's ``lazy_pinyin`` (reference:
pinyin_timestamping.py:42) to turn input text into toneless pinyin
syllables. pypinyin is not in this environment, so this module reads its
own Unihan-kMandarin-derived data (``pinyin_table.tsv`` under
``config.PACKAGED_DATA_DIR``, 41k+ characters — full CJK coverage) plus a
phrase table (``pinyin_phrases.tsv``) for polyphone disambiguation
(了/地/得/长...), regenerated by tools/make_pinyin_table.py.

:func:`to_pinyin` reproduces lazy_pinyin's grouping behavior: each hanzi
becomes one toneless syllable token (``ü`` written ``v``, matching
dict_henan.txt's lv/lve inventory), phrases take their phrase reading via
greedy longest-match segmentation, consecutive non-hanzi characters
(ASCII words, digit runs) group into one token, and unknown hanzi pass
through as themselves.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from text2video_tpu_torch.config import PACKAGED_DATA_DIR

_DATA_DIR = str(PACKAGED_DATA_DIR)

_TABLE: Optional[Dict[str, str]] = None
_PHRASES: Optional[Dict[str, List[str]]] = None
_MAX_PHRASE = 1


def _ensure_loaded() -> None:
    global _TABLE, _PHRASES, _MAX_PHRASE
    if _TABLE is not None:
        return
    _TABLE = {}
    _PHRASES = {}
    table = os.path.join(_DATA_DIR, "pinyin_table.tsv")
    with open(table, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 2 and len(parts[0]) == 1:
                _TABLE[parts[0]] = parts[1]
    phrases = os.path.join(_DATA_DIR, "pinyin_phrases.tsv")
    if os.path.exists(phrases):
        with open(phrases, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) == 2:
                    syls = parts[1].split()
                    if len(syls) == len(parts[0]):
                        _PHRASES[parts[0]] = syls
                        _MAX_PHRASE = max(_MAX_PHRASE, len(parts[0]))


def _is_hanzi(ch: str) -> bool:
    return (
        "一" <= ch <= "鿿"      # CJK Unified
        or "㐀" <= ch <= "䶿"   # Extension A
        or ch == "〇"               # 〇
    )


def load_table(path: str) -> None:
    """Extend/override the character table from a TSV of
    ``<char>\t<pinyin>``."""
    _ensure_loaded()
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 2 and len(parts[0]) == 1:
                _TABLE[parts[0]] = parts[1]


def load_phrases(path: str) -> None:
    """Extend/override the phrase table from a TSV of
    ``<phrase>\t<syl1 syl2 ...>``."""
    global _MAX_PHRASE
    _ensure_loaded()
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 2:
                syls = parts[1].split()
                if len(syls) == len(parts[0]):
                    _PHRASES[parts[0]] = syls
                    _MAX_PHRASE = max(_MAX_PHRASE, len(parts[0]))


def add_entries(entries: Dict[str, str]) -> None:
    _ensure_loaded()
    _TABLE.update(entries)


def to_pinyin(text: str) -> List[str]:
    """lazy_pinyin-equivalent token stream.

    Hanzi -> one toneless syllable each (phrase readings win over
    per-char readings, greedy longest match); consecutive non-hanzi
    characters group into one token (so a digit run like "2024" is one
    numeric token, matching pinyin_timestamping.py:112's ``isnumeric``
    handling); unknown hanzi pass through unchanged.
    """
    _ensure_loaded()
    out: List[str] = []
    buf = ""
    i = 0
    n = len(text)
    while i < n:
        ch = text[i]
        if not _is_hanzi(ch):
            buf += ch
            i += 1
            continue
        if buf:
            out.append(buf)
            buf = ""
        matched = False
        for ln in range(min(_MAX_PHRASE, n - i), 1, -1):
            cand = text[i : i + ln]
            syls = _PHRASES.get(cand)
            if syls is not None:
                out.extend(syls)
                i += ln
                matched = True
                break
        if not matched:
            out.append(_TABLE.get(ch, ch))
            i += 1
    if buf:
        out.append(buf)
    return out
