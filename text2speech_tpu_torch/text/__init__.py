# coding: utf-8
"""Text frontend: strings -> int32 symbol-ID arrays.

Host-side, pure Python; the port's own copy of the JAX package's text
frontend (``tests/test_torch_config_text.py`` holds the two to the same ids).
The model side consumes padded arrays, so this module also provides a batched,
padded encode (:func:`encode_batch`) —
the piece the reference lacks (it pads per-batch inside the torch collate,
``reference/utils/data_utils.py:113-130``).

Scalar API parity with ``reference/text/__init__.py``:
``text_to_sequence(text, as_token)`` / ``sequence_to_text(seq)``.
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np

from . import cleaners
from .hangul import jamo_to_hangul_text
from .korean import _split_sentences as split_sentences  # noqa: F401
from .symbols import (  # noqa: F401  (public API re-exports)
    ALL_SYMBOLS,
    EOS,
    EOS_ID,
    N_SYMBOLS,
    PAD,
    PAD_ID,
    char_to_id,
    en_symbols,
    id_to_char,
    symbols,
)

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def _clean(text: str, cleaner_name: str = "korean_cleaners"):
    cleaner = getattr(cleaners, cleaner_name)
    return cleaner(text)


def _tokens_to_ids(tokens) -> list[int]:
    # Drop out-of-vocabulary symbols and PAD/EOS occurring inside the text
    # (reference text/__init__.py:81-88).
    return [
        char_to_id[t]
        for t in tokens
        if t in char_to_id and t not in (PAD, EOS)
    ]


def text_to_sequence(text: str, as_token: bool = False, cleaner_name: str = "korean_cleaners"):
    """Convert a string to a sequence of symbol IDs, appending EOS.

    Curly-brace segments pass through as ARPAbet (reference
    text/__init__.py:30-38).  Returns an int32 ndarray, or the recomposed
    Korean string when ``as_token``.
    """
    sequence: list[int] = []
    while len(text):
        m = _curly_re.match(text)
        if not m:
            sequence += _tokens_to_ids(_clean(text, cleaner_name))
            break
        sequence += _tokens_to_ids(_clean(m.group(1), cleaner_name))
        sequence += _tokens_to_ids(["@" + s for s in m.group(2).split()])
        text = m.group(3)

    sequence.append(EOS_ID)
    if as_token:
        return sequence_to_text(sequence, combine_jamo=True)
    return np.asarray(sequence, dtype=np.int32)


def sequence_to_text(
    sequence: Sequence[int],
    skip_eos_and_pad: bool = False,
    combine_jamo: bool = False,
) -> str:
    """Inverse of :func:`text_to_sequence` (reference text/__init__.py:48-67)."""
    result = ""
    for sid in sequence:
        sid = int(sid)
        if sid in id_to_char:
            s = id_to_char[sid]
            if len(s) > 1 and s[0] == "@":
                s = "{%s}" % s[1:]
            if not skip_eos_and_pad or s not in (EOS, PAD):
                result += s
    result = result.replace("}{", " ")
    if combine_jamo:
        return jamo_to_hangul_text(result)
    return result


def intersperse(seq: Sequence[int], item: int = PAD_ID) -> np.ndarray:
    """``item`` before, between and after the ids (VITS's
    ``commons.intersperse``): n ids -> 2n + 1."""
    out = np.full(2 * len(seq) + 1, item, dtype=np.int32)
    out[1::2] = seq
    return out


def encode_batch(
    texts: Sequence[str],
    pad_to: int | None = None,
    bucket_multiple: int = 32,
    add_blank: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Encode a batch of strings to a padded int32 array + lengths.

    Pads to ``pad_to`` if given, else to the max length rounded up to
    ``bucket_multiple`` (few distinct padded lengths reach the model).
    ``add_blank`` interleaves the blank (PAD, id 0) around every id, EOS
    included, as VITS's ``add_blank`` does (:func:`intersperse`).

    Returns ``(ids[B, T], lengths[B])``.
    """
    seqs = [text_to_sequence(t) for t in texts]
    if add_blank:
        seqs = [intersperse(s) for s in seqs]
    lengths = np.asarray([len(s) for s in seqs], dtype=np.int32)
    max_len = int(lengths.max()) if len(seqs) else 0
    if pad_to is None:
        pad_to = -(-max_len // bucket_multiple) * bucket_multiple
    if max_len > pad_to:
        raise ValueError(f"sequence length {max_len} exceeds pad_to={pad_to}")
    out = np.full((len(seqs), pad_to), PAD_ID, dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out, lengths
