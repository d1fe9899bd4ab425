"""The 80-symbol Korean vocabulary and the English variant.

Identical ID assignment to the reference (``reference/text/korean.py:12-25``,
documented map ``reference/text/symbols.py:19-28``): ``_`` PAD=0, ``~`` EOS=1,
19 jamo leads, 21 vowels, 27 tails, punctuation ``!'(),-.:;?``, space.
"""

from __future__ import annotations

from .hangul import LEAD_BASE, N_LEADS, N_VOWELS, TAIL_BASE, VOWEL_BASE

PAD = "_"
EOS = "~"
PUNCTUATION = "!'(),-.:;?"
SPACE = " "

JAMO_LEADS = "".join(chr(LEAD_BASE + i) for i in range(N_LEADS))
JAMO_VOWELS = "".join(chr(VOWEL_BASE + i) for i in range(N_VOWELS))
JAMO_TAILS = "".join(chr(TAIL_BASE + 1 + i) for i in range(27))

VALID_CHARS = JAMO_LEADS + JAMO_VOWELS + JAMO_TAILS + PUNCTUATION + SPACE
ALL_SYMBOLS = PAD + EOS + VALID_CHARS

symbols = ALL_SYMBOLS                     # Korean (default)
en_symbols = (
    PAD + EOS
    + "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!'(),-.:;? "
)

char_to_id = {c: i for i, c in enumerate(ALL_SYMBOLS)}
id_to_char = {i: c for i, c in enumerate(ALL_SYMBOLS)}

PAD_ID = char_to_id[PAD]   # 0
EOS_ID = char_to_id[EOS]   # 1
N_SYMBOLS = len(ALL_SYMBOLS)  # 80
