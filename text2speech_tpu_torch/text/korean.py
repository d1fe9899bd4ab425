# coding: utf-8
"""Korean text normalization and jamo tokenization.

Behavior-equivalent rebuild of ``reference/text/korean.py`` (340 LoC):
  * :func:`normalize` — the full cleaning pipeline (dates, hanja, dictionary
    substitution, English word readings, uppercase letter names, quote
    splitting, Sino-/native-Korean number expansion).
  * :func:`tokenize` — normalize then decompose to conjoining jamo + EOS.
  * :func:`number_to_korean` — digit-group expansion with 만/억/조/경/해 units,
    native-Korean counters (한/두/세/…, 열/스물/서른/…), floats ("쩜"), and
    +/- signs (플러스/마이너스).

Substitution dictionaries (etc/english word readings) live as data in
``data/korean_dicts.json`` (extracted from ``reference/text/ko_dictionary.py``).

The reference splits quoted text into sentences with NLTK's punkt model
(``korean.py:209-219``); punkt data is unavailable offline, so an equivalent
regex splitter is used (identical output for single-sentence quotes, which is
all the reference corpus exercises).
"""

from __future__ import annotations

import json
import os
import re
from functools import lru_cache

from .hangul import hangul_to_jamo, jamo_to_hangul_text
from .symbols import EOS, char_to_id

__all__ = [
    "normalize",
    "tokenize",
    "number_to_korean",
    "jamo_to_korean",
]

_DATA_PATH = os.path.join(os.path.dirname(__file__), "data", "korean_dicts.json")


@lru_cache(maxsize=1)
def _dicts() -> dict:
    with open(_DATA_PATH, encoding="utf-8") as f:
        return json.load(f)


def etc_dictionary() -> dict:
    return _dicts()["etc"]


def english_dictionary() -> dict:
    return _dicts()["english"]


# --- digit / unit tables (linguistic facts; reference korean.py:91-253) ---

DIGIT_TO_KOR = dict(zip("0123456789", "영일이삼사오육칠팔구"))

UNIT_READINGS_MULTI = {  # multi-char measurement units, applied first
    "%": "퍼센트",
    "cm": "센치미터",
    "mm": "밀리미터",
    "km": "킬로미터",
    "kg": "킬로그람",
}
UNIT_READINGS_SINGLE = {"m": "미터"}

UPPER_TO_KOR = dict(
    zip(
        "ABCDEFGHIJKLMNOPQRSTUVWXYZ",
        [
            "에이", "비", "씨", "디", "이", "에프", "지", "에이치", "아이",
            "제이", "케이", "엘", "엠", "엔", "오", "피", "큐", "알", "에스",
            "티", "유", "브이", "더블유", "엑스", "와이", "지",
        ],
    )
)

SINO_DIGITS = [""] + list("일이삼사오육칠팔구")          # 1..9
NATIVE_DIGITS = [""] + ["한", "두", "세", "네", "다섯", "여섯", "일곱", "여덟", "아홉"]
SMALL_UNITS = [""] + list("십백천")                      # 10^1..10^3 within a group
BIG_UNITS = [""] + list("만억조경해")                    # 10^4 group units

# Native-Korean tens readings; insertion order matters (regex alternation is
# tried in this order at each position, mirroring the reference's dict-order
# '|'.join at korean.py:308-311).
NATIVE_TENS = {
    "십": "열",
    "두십": "스물",
    "세십": "서른",
    "네십": "마흔",
    "다섯십": "쉰",
    "여섯십": "예순",
    "일곱십": "일흔",
    "여덟십": "여든",
    "아홉십": "아흔",
}

COUNTERS = (
    "시|명|가지|살|마리|포기|송이|수|톨|통|점|개|벌|척|채|다발|그루|자루|줄|"
    "켤레|그릇|잔|마디|상자|사람|곡|병|판"
)

_NUMBER_RE = r"([+-]?\d[\d,]*)[\.]?\d*"
_QUOTE_RE = re.compile("""([`"'＂“‘])(.+?)([`"'＂”’])""")
_DATE_DAY_RE = re.compile(r"\(\d+일\)")
# Parenthesized CJK/hanja annotations, e.g. (猪突) — same ranges as korean.py:168.
_HANJA_PAREN_RE = re.compile(
    r"\([⺀-⺙⺛-⻳⼀-⿕々〇〡-〩〸-〺〻㐀-䶵一-鿃豈-鶴侮-頻並-龎]+\)"
)
# Sentence-boundary model replacing nltk punkt (reference korean.py:211-216):
# a run of terminal punctuation (plus any closing quotes/brackets) followed by
# whitespace ends a sentence — unless the preceding token is a single-letter
# initial ("J.") or a common Latin abbreviation, punkt's main refinements
# that matter for quoted spans.
_SENT_BOUNDARY_RE = re.compile(r"[.!?…]+[\"'”’)\]]*(?=\s)")
# Case-sensitive: lowercase "no."/"st." are ordinary sentence-final words,
# not abbreviations; single-letter initials match either case via [A-Za-z].
_NO_SPLIT_TAIL_RE = re.compile(
    r"\b(?:[A-Za-z]|Mr|Mrs|Ms|Dr|Prof|St|Jr|Sr|vs|etc|No|Vol|Fig|approx"
    r"|e\.g|i\.e)\.$"
)


def _sub_from_dict(text: str, table: dict) -> str:
    if not any(k in text for k in table):
        return text
    pattern = re.compile("|".join(re.escape(k) for k in table))
    return pattern.sub(lambda m: table[m.group()], text)


def _expand_english_words(text: str) -> str:
    table = english_dictionary()
    return re.sub(
        r"[A-Za-z]+", lambda m: table.get(m.group(), m.group()), text
    )


def _expand_upper_acronyms(text: str) -> str:
    def reading(m: re.Match) -> str:
        word = m.group()
        if word.isupper():
            return "".join(UPPER_TO_KOR[c] for c in word)
        return word

    return re.sub(r"[a-zA-Z]+", reading, text)


def _split_sentences(text: str) -> list[str]:
    """Offline replacement for nltk.sent_tokenize (reference korean.py:211-216):
    terminal punctuation ends a sentence, abbreviation-aware, terminal marks
    kept with their sentence."""
    sents: list[str] = []
    start = 0
    for m in _SENT_BOUNDARY_RE.finditer(text):
        head = text[start : m.end()]
        if _NO_SPLIT_TAIL_RE.search(head.rstrip("\"'”’)]")):
            continue
        sents.append(head.strip())
        start = m.end()
    tail = text[start:].strip()
    if tail:
        sents.append(tail)
    return [s for s in sents if s]


def _normalize_quotes(text: str) -> str:
    def requote(m: re.Match) -> str:
        inner = m.group(2)
        return " ".join("'{}'".format(s) for s in _split_sentences(inner))

    return _QUOTE_RE.sub(requote, text)


def number_to_korean(num_str: str, unit: str = "", is_count: bool = False) -> str:
    """Expand one numeric literal into its Korean reading.

    Sino-Korean by default ("3600" -> "삼천육백"); native-Korean digit words when
    ``is_count`` (counter follows: "2마리" -> "두마리", tens contracted via
    :data:`NATIVE_TENS`).  Floats read the integer part then "쩜" + digit names.
    Mirrors ``number_to_korean`` at ``reference/text/korean.py:256-325``
    including its quirks (leading 일/한 elision even across group units).
    """
    raw = num_str.replace(",", "")
    value = float(raw) if "." in raw else int(raw)
    if value == 0:
        return "영"

    parts = raw.split(".")
    if len(parts) > 2:
        raise ValueError("malformed number: %r" % num_str)
    int_str = parts[0]
    frac_str = parts[1] if len(parts) == 2 else None
    if is_count and frac_str is not None:
        raise ValueError("counter with fractional count: %r" % num_str)

    negative = int_str.startswith("-")
    positive = int_str.startswith("+")
    digits = str(abs(int(int_str)))
    n = len(digits)

    words = ""
    group: list[str] = []
    for pos, ch in enumerate(digits, start=1):
        d = int(ch)
        rank = n - pos  # power of ten of this digit
        if d != 0:
            group += (NATIVE_DIGITS if is_count else SINO_DIGITS)[d]
            group += SMALL_UNITS[rank % 4]
        if rank % 4 == 0 and group:
            words += "".join(group)
            group = []
            words += BIG_UNITS[rank // 4]

    if is_count:
        if words.startswith("한") and len(words) > 1:
            words = words[1:]
        if any(k in words for k in NATIVE_TENS):
            words = re.sub(
                "|".join(NATIVE_TENS.keys()),
                lambda m: NATIVE_TENS[m.group()],
                words,
            )
    elif words.startswith("일") and len(words) > 1:
        words = words[1:]

    if frac_str is not None:
        words += "쩜 "
        words += re.sub(r"\d", lambda m: DIGIT_TO_KOR[m.group()], frac_str)

    if positive:
        words = "플러스 " + words
    elif negative:
        words = "마이너스 " + words

    return words + unit


def normalize_number(text: str) -> str:
    text = _sub_from_dict(text, UNIT_READINGS_MULTI)
    text = _sub_from_dict(text, UNIT_READINGS_SINGLE)
    text = re.sub(
        _NUMBER_RE + "(" + COUNTERS + ")",
        lambda m: number_to_korean(m.group(1), m.group(2), is_count=True),
        text,
    )
    text = re.sub(
        _NUMBER_RE,
        lambda m: number_to_korean(m.group(), is_count=False),
        text,
    )
    return text


def normalize(text: str) -> str:
    """Full normalization pipeline (reference korean.py:164-177)."""
    text = text.strip()
    text = _DATE_DAY_RE.sub("", text)
    text = _HANJA_PAREN_RE.sub("", text)
    text = _sub_from_dict(text, etc_dictionary())
    text = _expand_english_words(text)
    text = _expand_upper_acronyms(text)
    text = _normalize_quotes(text)
    text = normalize_number(text)
    return text


def tokenize(text: str, as_id: bool = False):
    """Normalize then decompose into conjoining jamo, appending EOS
    (reference korean.py:149-157)."""
    tokens = list(hangul_to_jamo(normalize(text)))
    if as_id:
        return [char_to_id[t] for t in tokens] + [char_to_id[EOS]]
    return tokens + [EOS]


def jamo_to_korean(text: str) -> str:
    return jamo_to_hangul_text(text)
