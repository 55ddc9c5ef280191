"""Text normalization and run-name derivation (counterpart of
``text2video_tpu/frontend/textnorm.py``).

The reference derives the per-run file stem by removing spaces and CJK
punctuation and truncating to 10 chars (reference: tts_request.py:15-19,
align_english.py:27-31, interp_landmarks_motion_phoneme_VidTIMIT_smooth.py:
22-25). The CJK punctuation set mirrors ``zhon.hanzi.punctuation`` (that
package is not available here); ASCII punctuation mirrors the inline
``punctuations`` string (pinyin_timestamping.py:17).
"""

from __future__ import annotations

import re

# CJK full-width/ideographic punctuation (zhon.hanzi.punctuation equivalent).
CJK_PUNCT = (
    "＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣､、〃《》「」"
    "『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘’‛“”„‟…‧﹏"
    "！？｡。"
)

ASCII_PUNCT = "!()-[]{};:'\"\\,<>./?@#$%^&*_~"

_CJK_RE = re.compile("[%s]+" % re.escape(CJK_PUNCT))


def strip_punct(text: str, strip_spaces: bool = True, ascii_too: bool = False) -> str:
    """Remove (optionally) spaces, CJK punctuation, and ASCII punctuation."""
    if strip_spaces:
        text = text.replace(" ", "")
    text = _CJK_RE.sub("", text)
    if ascii_too:
        text = "".join(c for c in text if c not in ASCII_PUNCT)
    return text


def derive_file_name(text: str, strip_spaces: bool = True) -> str:
    """First 10 chars of the punctuation-stripped input — the run stem used
    for audio/timestamp/output artifact names throughout the pipeline."""
    return strip_punct(text, strip_spaces=strip_spaces)[:10]


_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand")]


def number_to_words(n: int) -> str:
    """Integer -> English words (the role of english2phoneme's saynum.c:
    numbers in transcripts become alignable words)."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        return _TENS[tens] + ("" if rest == 0 else " " + _ONES[rest])
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        out = _ONES[hundreds] + " hundred"
        return out if rest == 0 else out + " " + number_to_words(rest)
    for scale, word in _SCALES:
        if n >= scale:
            major, rest = divmod(n, scale)
            out = number_to_words(major) + " " + word
            return out if rest == 0 else out + " " + number_to_words(rest)
    return _ONES[0]


_DIGIT_RUN_RE = re.compile(r"\d+")


def spell_numbers(text: str) -> str:
    """Replace digit runs with English words (19-digit cap; longer runs
    are spelled digit by digit)."""

    def sub(m: "re.Match[str]") -> str:
        s = m.group(0)
        if len(s) > 19:
            return " ".join(_ONES[int(c)] for c in s)
        return number_to_words(int(s))

    return _DIGIT_RUN_RE.sub(sub, text)


def clean_transcript_words(text: str) -> list:
    """Word list for forced alignment, mirroring the aligner's transcript
    cleanup (reference: align_english.py:36-50): selected ASCII punctuation
    becomes spaces, trailing '-' and leading ' are dropped."""
    for pun in [",", ".", ":", ";", "!", "?", '"', "(", ")", "--", "---"]:
        text = text.replace(pun, " ")
    words = []
    for wrd in text.split():
        if wrd and wrd[-1] == "-":
            wrd = wrd[:-1]
        if wrd and wrd[0] == "'":
            wrd = wrd[1:]
        if wrd:
            words.append(wrd)
    return words
