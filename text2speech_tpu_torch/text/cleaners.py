# coding: utf-8
"""Named cleaner pipelines (reference ``reference/text/cleaners.py``)."""

from __future__ import annotations

import re

from . import english, korean

_whitespace_re = re.compile(r"\s+")


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text)


def korean_cleaners(text: str):
    """Korean pipeline: normalize + jamo tokenize (returns a token list,
    matching reference cleaners.py:27-30)."""
    return korean.tokenize(text)


def english_cleaners(text: str) -> str:
    """English pipeline: ascii fold, lowercase, numbers, abbreviations."""
    text = english.to_ascii(text)
    text = text.lower()
    text = english.normalize_numbers(text)
    text = english.expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(text.lower())


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(english.to_ascii(text).lower())
