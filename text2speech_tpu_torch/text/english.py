# coding: utf-8
"""English text cleaning: number expansion, abbreviations, ASCII folding.

Behavior-equivalent rebuild of ``reference/text/en_numbers.py`` and the
English parts of ``reference/text/cleaners.py``.  The reference leans on
the ``inflect`` and ``unidecode`` packages; neither is available offline, so the
subset of behavior those provide here (cardinal/ordinal number words, basic
latin transliteration) is implemented directly.
"""

from __future__ import annotations

import re
import unicodedata

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10 ** 12, "trillion"),
    (10 ** 9, "billion"),
    (10 ** 6, "million"),
    (10 ** 3, "thousand"),
    (100, "hundred"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def number_to_words(n: int, andword: str = "and", zero: str = "zero") -> str:
    """Cardinal number -> English words (inflect.number_to_words subset)."""
    if n < 0:
        return "minus " + number_to_words(-n, andword, zero)
    if n == 0:
        return zero
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, ones = divmod(n, 10)
        word = _TENS[tens]
        return word + ("-" + _ONES[ones] if ones else "")
    for scale, name in _SCALES:
        if n >= scale:
            head = number_to_words(n // scale, andword, zero)
            rest = n % scale
            out = "{} {}".format(head, name)
            if rest:
                joiner = " {} ".format(andword) if (andword and rest < 100) else " "
                out += joiner + number_to_words(rest, andword, zero)
            return out
    raise AssertionError


def number_to_ordinal_words(n: int) -> str:
    words = number_to_words(n, andword="")
    head, _, last = words.rpartition(" ")
    hyph_head, _, hyph_last = last.rpartition("-")
    if hyph_last in _ORDINAL_IRREGULAR:
        ord_last = _ORDINAL_IRREGULAR[hyph_last]
    elif hyph_last.endswith("y"):
        ord_last = hyph_last[:-1] + "ieth"
    else:
        ord_last = hyph_last + "th"
    last = (hyph_head + "-" if hyph_head else "") + ord_last
    return (head + " " if head else "") + last


_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        return "%s %s, %s %s" % (
            dollars, "dollar" if dollars == 1 else "dollars",
            cents, "cent" if cents == 1 else "cents")
    if dollars:
        return "%s %s" % (dollars, "dollar" if dollars == 1 else "dollars")
    if cents:
        return "%s %s" % (cents, "cent" if cents == 1 else "cents")
    return "zero dollars"


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    # Year-style reading for 1001..2999 (reference en_numbers.py:47-59).
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100, andword="")
        if num % 100 == 0:
            return number_to_words(num // 100, andword="") + " hundred"
        hi, lo = divmod(num, 100)
        lo_words = "oh " + _ONES[lo] if lo < 10 else number_to_words(lo, andword="")
        return number_to_words(hi, andword="") + " " + lo_words
    return number_to_words(num, andword="")


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _pounds_re.sub(r"\1 pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(
        lambda m: m.group(1).replace(".", " point "), text)
    text = _ordinal_re.sub(
        lambda m: number_to_ordinal_words(int(m.group(0)[:-2])), text)
    text = _number_re.sub(_expand_number, text)
    return text


_ABBREVIATIONS = [
    (re.compile(r"\b%s\." % abbr, re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
        ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
        ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]


def expand_abbreviations(text: str) -> str:
    for pattern, repl in _ABBREVIATIONS:
        text = pattern.sub(repl, text)
    return text


def to_ascii(text: str) -> str:
    """Best-effort latin transliteration (unidecode stand-in): NFKD-decompose
    and drop combining marks / non-ASCII."""
    decomposed = unicodedata.normalize("NFKD", text)
    return "".join(c for c in decomposed if ord(c) < 128)
