"""Trained-model quality metrics (counterpart of
``text2speech_tpu/utils/quality.py``; plain numpy, the port keeps its own
copy): the quantitative form of the reference's "eyeball the alignment
plot" training signal (reference ``train.py:236-246``), used by the corpus
drill's ``--assert_quality`` gate.

All metrics are corpus-agnostic: the expected attended token under a
monotonic reading is the linear token<->frame map ``floor(t * in_len /
out_len)``, which reduces exactly to the synthetic tone corpus's
``t // frames_per_token`` ground truth when frames-per-token is constant.
"""

from __future__ import annotations

import numpy as np


def alignment_diagonality(
    align: np.ndarray,
    in_len: np.ndarray,
    out_len: np.ndarray,
    band: int = 1,
) -> tuple[float, float]:
    """(band mass, attended-position/time correlation) of teacher-forced
    attention maps.

    ``align``: [B, T_dec, T_enc] attention weights; ``band``: tokens of
    slack around the linear-map expected token (natural speech paces
    unevenly: widen for real corpora; the synthetic tone corpus is exact
    at ``band=1``).  Untrained, diffuse attention scores mass about
    ``(2*band+1)/in_len`` and corr about 0; a locked-on diagonal scores
    mass far above chance and corr about 1.
    """
    masses, corrs = [], []
    for b in range(align.shape[0]):
        L, K = int(out_len[b]), int(in_len[b])
        a = align[b, :L, :K]
        a = a / np.maximum(a.sum(-1, keepdims=True), 1e-8)
        t = np.arange(L)
        true_tok = (t * K) // max(L, 1)
        j = np.arange(K)[None, :]
        in_band = np.abs(j - true_tok[:, None]) <= band
        masses.append(float((a * in_band).sum(-1).mean()))
        expected = (a * j).sum(-1)
        if L >= 2 and expected.std() > 1e-8:
            corrs.append(float(np.corrcoef(expected, t)[0, 1]))
        else:
            corrs.append(0.0)
    return float(np.mean(masses)), float(np.mean(corrs))


def standardize_mel(m: np.ndarray) -> np.ndarray:
    """Zero mean, unit std over the whole array: both fidelity metrics are
    invariant to the corpus's affine mel scaling."""
    return (m - m.mean()) / (m.std() + 1e-6)


def mel_fidelity(
    pred_mel: np.ndarray,
    target_mel: np.ndarray,
    lengths: np.ndarray,
) -> tuple[float, float]:
    """(mel correlation, dominant-channel match rate) between predicted and
    recorded mels, within each row's true length.

    ``pred_mel`` / ``target_mel``: [B, n_mel, T] (standardized inside);
    ``lengths``: each row's valid frames.  The dominant-channel match
    counts frames whose argmax channel lands within +-1 of the target's
    (chance about 3/n_mel for diffuse output).
    """
    corrs, match, tot = [], 0, 0
    for b in range(pred_mel.shape[0]):
        L = int(min(lengths[b], pred_mel.shape[-1], target_mel.shape[-1]))
        if L <= 0:
            continue
        p = standardize_mel(pred_mel[b][:, :L])
        g = standardize_mel(target_mel[b][:, :L])
        corrs.append(float(np.corrcoef(g.ravel(), p.ravel())[0, 1]))
        match += int((np.abs(p.argmax(axis=0) - g.argmax(axis=0)) <= 1).sum())
        tot += L
    if not corrs:
        return 0.0, 0.0
    return float(np.mean(corrs)), match / tot
