"""Windowed real-DFT bases, the window sum-square envelope and the Slaney
mel filterbank (host-side numpy, computed once).

A copy of the numpy functions the port needs from
``text2speech_tpu/dsp/filters.py``: importing that module would run
``text2speech_tpu/dsp/__init__.py``, which imports JAX.
"""

from __future__ import annotations

import numpy as np


def hann_window(win_length: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, matching scipy/librosa."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad a window symmetrically to ``size`` (librosa.util.pad_center)."""
    lpad = (size - len(window)) // 2
    return np.pad(window, (lpad, size - len(window) - lpad))


def hz_to_mel_slaney(f):
    f = np.asanyarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        mels,
    )
    return mels


def mel_to_hz_slaney(m):
    m = np.asanyarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = m >= min_log_mel
    freqs = np.where(
        log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs
    )
    return freqs


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, [n_mels, 1 + n_fft//2].

    Bit-compatible with ``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)``
    at float64 construction precision.
    """
    if fmax is None:
        fmax = sample_rate / 2.0
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz_slaney(
        np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2)
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney area normalization (librosa norm=1 default)
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def fourier_basis(n_fft: int, win_length: int, window: str = "hann") -> np.ndarray:
    """Windowed real-DFT analysis basis, [2*(1+n_fft//2), n_fft].

    Row k (k < cutoff) is ``cos(2πkn/N)·w[n]``; row cutoff+k is
    ``-sin(2πkn/N)·w[n]`` — so ``basis @ frame`` yields stacked
    [real; imag] rfft coefficients of the windowed frame.  Equivalent to the
    reference's conv-STFT basis (``utils/stft.py:46-66``) expressed directly.
    """
    cutoff = 1 + n_fft // 2
    n = np.arange(n_fft)
    k = np.arange(cutoff)[:, None]
    ang = 2.0 * np.pi * k * n[None, :] / n_fft
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=0)
    if window is not None:
        w = pad_center(hann_window(win_length), n_fft)
        basis = basis * w[None, :]
    return basis.astype(np.float32)


def inverse_fourier_basis(
    n_fft: int, win_length: int, hop_length: int, window: str = "hann"
) -> np.ndarray:
    """Windowed pseudo-inverse synthesis basis for ISTFT-as-transposed-conv,
    [2*(1+n_fft//2), n_fft] (reference ``utils/stft.py:54-55``)."""
    cutoff = 1 + n_fft // 2
    n = np.arange(n_fft)
    k = np.arange(cutoff)[:, None]
    ang = 2.0 * np.pi * k * n[None, :] / n_fft
    full = np.concatenate([np.cos(ang), -np.sin(ang)], axis=0)
    scale = n_fft / hop_length
    inv = np.linalg.pinv(scale * full).T  # [2*cutoff, n_fft]
    if window is not None:
        w = pad_center(hann_window(win_length), n_fft)
        inv = inv * w[None, :]
    return inv.astype(np.float32)


def window_sumsquare(
    n_frames: int,
    hop_length: int,
    win_length: int,
    n_fft: int,
) -> np.ndarray:
    """Sum-square Hann envelope over overlapping frames
    (reference ``utils/audio_processing.py:7-48``)."""
    n = n_fft + hop_length * (n_frames - 1)
    x = np.zeros(n, dtype=np.float64)
    w_sq = pad_center(hann_window(win_length) ** 2, n_fft)
    for i in range(n_frames):
        s = i * hop_length
        x[s : min(n, s + n_fft)] += w_sq[: max(0, min(n_fft, n - s))]
    return x.astype(np.float32)
