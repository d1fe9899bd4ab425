"""Korean text to symbol ids, written plainly for the texts the traffic
makes: Hangul syllables, single spaces and a closing period.

The ids are the reference vocabulary's (Kyubyong/KSS Tacotron-2, 80
symbols): 0 pad, 1 EOS, 2-20 the 19 leading consonants, 21-41 the 21
vowels, 42-68 the 27 trailing consonants, 69-78 the punctuation
``!'(),-.:;?``, 79 the space.  A syllable U+AC00 + (lead * 21 + vowel) * 28
+ tail decomposes into its lead, its vowel and, when tail > 0, its tail.
"""

from __future__ import annotations

PUNCTUATION = "!'(),-.:;?"
EOS_ID = 1
SPACE_ID = 79


def symbol_ids(text: str) -> list:
    """One text -> its symbol ids, EOS appended."""
    out = []
    for ch in text:
        code = ord(ch) - 0xAC00
        if 0 <= code < 11172:
            lead, rest = divmod(code, 588)
            vowel, tail = divmod(rest, 28)
            out += [2 + lead, 21 + vowel]
            if tail:
                out.append(41 + tail)
        elif ch == " ":
            out.append(SPACE_ID)
        elif ch in PUNCTUATION:
            out.append(69 + PUNCTUATION.index(ch))
        else:
            raise ValueError(f"the reference takes Hangul syllables, spaces "
                             f"and {PUNCTUATION!r}, not {ch!r}")
    return out + [EOS_ID]
