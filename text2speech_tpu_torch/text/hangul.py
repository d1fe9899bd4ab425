"""Hangul <-> jamo conversion via Unicode arithmetic.

The reference relies on the third-party ``jamo`` package
(``reference/text/korean.py:8``: ``hangul_to_jamo``, ``h2j``, ``j2h``).  We
implement the same decomposition/composition directly from the Unicode Hangul
syllable algorithm (syllable = 0xAC00 + (lead*21 + vowel)*28 + tail), producing the
identical conjoining-jamo codepoints: leads U+1100..U+1112, vowels U+1161..U+1175,
tails U+11A8..U+11C2.
"""

from __future__ import annotations

from typing import Iterable, Iterator

SYLLABLE_BASE = 0xAC00
SYLLABLE_END = 0xD7A3
LEAD_BASE = 0x1100     # 19 leads
VOWEL_BASE = 0x1161    # 21 vowels
TAIL_BASE = 0x11A7     # tails are 1-indexed: U+11A8..U+11C2 (27)

N_LEADS = 19
N_VOWELS = 21
N_TAILS = 28  # including "no tail" at index 0

# Compatibility jamo (U+3131..) for the lone-jamo rendering path used by
# sequence_to_text(combine_jamo=True); mirrors jamo lib's hcj tables.
_LEAD_TO_COMPAT = {
    chr(LEAD_BASE + i): c
    for i, c in enumerate("ㄱㄲㄴㄷㄸㄹㅁㅂㅃㅅㅆㅇㅈㅉㅊㅋㅌㅍㅎ")
}
_VOWEL_TO_COMPAT = {
    chr(VOWEL_BASE + i): c
    for i, c in enumerate("ㅏㅐㅑㅒㅓㅔㅕㅖㅗㅘㅙㅚㅛㅜㅝㅞㅟㅠㅡㅢㅣ")
}
_TAIL_TO_COMPAT = {
    chr(TAIL_BASE + 1 + i): c
    for i, c in enumerate("ㄱㄲㄳㄴㄵㄶㄷㄹㄺㄻㄼㄽㄾㄿㅀㅁㅂㅄㅅㅆㅇㅈㅊㅋㅌㅍㅎ")
}
_JAMO_TO_COMPAT = {**_LEAD_TO_COMPAT, **_VOWEL_TO_COMPAT, **_TAIL_TO_COMPAT}


def is_syllable(ch: str) -> bool:
    return SYLLABLE_BASE <= ord(ch) <= SYLLABLE_END


def is_lead(ch: str) -> bool:
    return LEAD_BASE <= ord(ch) < LEAD_BASE + N_LEADS


def is_vowel(ch: str) -> bool:
    return VOWEL_BASE <= ord(ch) < VOWEL_BASE + N_VOWELS


def is_tail(ch: str) -> bool:
    # the 27 modern tails U+11A8..U+11C2 (index 0 of N_TAILS is "no tail");
    # the previous +1 bound accepted the archaic U+11C3, whose index 28
    # overflowed composition into the next lead block (r4 review finding)
    return TAIL_BASE + 1 <= ord(ch) <= TAIL_BASE + N_TAILS - 1


def decompose_syllable(ch: str) -> tuple[str, ...]:
    """One precomposed syllable -> (lead, vowel[, tail]) conjoining jamo."""
    code = ord(ch) - SYLLABLE_BASE
    lead = code // (N_VOWELS * N_TAILS)
    vowel = (code % (N_VOWELS * N_TAILS)) // N_TAILS
    tail = code % N_TAILS
    out = (chr(LEAD_BASE + lead), chr(VOWEL_BASE + vowel))
    if tail:
        out = out + (chr(TAIL_BASE + tail),)
    return out


def compose_syllable(lead: str, vowel: str, tail: str | None = None) -> str:
    """(lead, vowel[, tail]) conjoining jamo -> one precomposed syllable."""
    l = ord(lead) - LEAD_BASE
    v = ord(vowel) - VOWEL_BASE
    t = (ord(tail) - TAIL_BASE) if tail else 0
    return chr(SYLLABLE_BASE + (l * N_VOWELS + v) * N_TAILS + t)


def hangul_to_jamo(text: Iterable[str]) -> Iterator[str]:
    """Decompose each Hangul syllable into conjoining jamo; pass others through.

    Equivalent to ``jamo.hangul_to_jamo`` as used at
    ``reference/text/korean.py:152``.
    """
    for ch in text:
        if is_syllable(ch):
            yield from decompose_syllable(ch)
        else:
            yield ch


def h2j(text: str) -> str:
    return "".join(hangul_to_jamo(text))


def jamo_char_to_compat(ch: str) -> str:
    """A lone conjoining jamo -> its compatibility-jamo display form."""
    return _JAMO_TO_COMPAT.get(ch, ch)


def jamo_to_hangul_text(text: str) -> str:
    """Recompose a jamo stream back into syllables (reference ``jamo_to_korean``,
    ``reference/text/korean.py:62-88``): greedy lead/vowel/tail grouping; an
    incomplete group renders as a compatibility jamo.
    """
    text = h2j(text)
    out: list[str] = []
    pending: list[str] = []

    def flush() -> None:
        # compose ONLY structurally valid groups — (lead, vowel[, tail]).
        # Feeding arbitrary slots into compose_syllable silently produced
        # garbage codepoints (a tail in the vowel slot, or a stray vowel,
        # composed to unrelated syllables or non-Hangul characters; the
        # reference's jamo package raises here).  Invalid leftovers render
        # as visible compatibility jamo instead (r4 review finding).
        if not pending:
            return
        if (len(pending) >= 2 and is_lead(pending[0])
                and is_vowel(pending[1])
                and (len(pending) == 2 or is_tail(pending[2]))):
            out.append(compose_syllable(*pending[:3]))
            pending[:3] = []
        for ch in pending:
            out.append(jamo_char_to_compat(ch))
        pending.clear()

    for ch in text:
        if is_lead(ch):
            flush()
            pending.append(ch)
        elif is_vowel(ch):
            # a vowel extends only a bare lead; anything else starts over
            if not (len(pending) == 1 and is_lead(pending[0])):
                flush()
            pending.append(ch)
        elif is_tail(ch):
            # a tail completes only (lead, vowel)
            if not (len(pending) == 2 and is_lead(pending[0])
                    and is_vowel(pending[1])):
                flush()
            pending.append(ch)
        else:
            flush()
            out.append(ch)
    flush()
    return "".join(out)
