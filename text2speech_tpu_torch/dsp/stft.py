"""STFT / ISTFT as float32 matmuls against the windowed real-DFT basis
(counterpart of ``text2speech_tpu/dsp/stft.py``).

Frames are cut with reflect padding (librosa ``center=True``) and multiplied
by the ``[n_fft, 2 * cutoff]`` basis; the inverse multiplies by the
pseudo-inverse basis and overlap-adds with the window sum-square
correction.  Keep TF32 off on a GPU (``torch.backends.cuda.matmul.
allow_tf32 = False``, PyTorch's default) for float32 accuracy.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .filters import fourier_basis, inverse_fourier_basis, window_sumsquare


class STFTParams(NamedTuple):
    filter_length: int
    hop_length: int
    win_length: int

    @property
    def cutoff(self) -> int:
        return self.filter_length // 2 + 1


@functools.lru_cache(maxsize=8)
def _forward_basis(filter_length: int, win_length: int) -> np.ndarray:
    return fourier_basis(filter_length, win_length).T.copy()


@functools.lru_cache(maxsize=8)
def _inverse_basis(filter_length: int, win_length: int,
                   hop_length: int) -> np.ndarray:
    return inverse_fourier_basis(filter_length, win_length, hop_length)


def frame_signal(y: torch.Tensor, n_fft: int, hop: int,
                 center: bool = True) -> torch.Tensor:
    """Reflect-pad by n_fft // 2 (when ``center``) and cut overlapping
    frames: [B, T] -> [B, 1 + T // hop, n_fft].  ``center=False`` takes a
    signal the caller has padded already (each utterance reflect-padded by
    its own samples before batching) -> [B, 1 + (T - n_fft) // hop,
    n_fft]."""
    if not center:
        return y.unfold(1, n_fft, hop)
    # reflect padding as numpy's: the periodic mirror image (period
    # 2 (T - 1)), so it also holds for pads longer than the signal
    pad, T = n_fft // 2, y.shape[1]
    p = torch.arange(-pad, T + pad, device=y.device) % (2 * (T - 1))
    return y[:, torch.where(p < T, p, 2 * (T - 1) - p)].unfold(1, n_fft, hop)


def stft_real_imag(y: torch.Tensor, params: STFTParams,
                   center: bool = True):
    """y [B, T] -> (real, imag), each [B, cutoff, n_frames], f32."""
    basis = torch.from_numpy(
        _forward_basis(params.filter_length, params.win_length)).to(y.device)
    frames = frame_signal(y.float(), params.filter_length, params.hop_length,
                          center)
    spec = (frames @ basis).transpose(1, 2)          # [B, 2*cutoff, frames]
    return spec[:, : params.cutoff], spec[:, params.cutoff:]


def stft_magnitude(y: torch.Tensor, params: STFTParams,
                   center: bool = True) -> torch.Tensor:
    """|STFT(y)|: [B, T] -> [B, cutoff, n_frames], f32."""
    re, im = stft_real_imag(y, params, center)
    return torch.sqrt(re * re + im * im)


def stft_mag_phase(y: torch.Tensor, params: STFTParams):
    """y [B, T] -> (magnitude, phase), each [B, cutoff, n_frames], f32."""
    re, im = stft_real_imag(y, params)
    return torch.sqrt(re * re + im * im), torch.atan2(im, re)


def istft(magnitude: torch.Tensor, phase: torch.Tensor,
          params: STFTParams) -> torch.Tensor:
    """(magnitude, phase) [B, cutoff, n_frames] -> [B, hop * (n_frames - 1)]
    (overlap-add, window sum-square correction, center padding removed)."""
    n_frames = magnitude.shape[-1]
    n_fft, hop = params.filter_length, params.hop_length
    re_im = torch.cat([magnitude * torch.cos(phase),
                       magnitude * torch.sin(phase)], dim=1)
    inv_basis = torch.from_numpy(
        _inverse_basis(n_fft, params.win_length, hop)).to(magnitude.device)
    frames = re_im.transpose(1, 2) @ inv_basis          # [B, frames, n_fft]
    B = frames.shape[0]
    total = n_fft + hop * (n_frames - 1)
    signal = frames.new_zeros((B, total))
    if n_fft % hop == 0:
        # chunk j of frame i lands in hop-block i + j: r shifted adds
        r = n_fft // hop
        chunks = frames.reshape(B, n_frames, r, hop)
        blocks = signal.view(B, n_frames + r - 1, hop)
        for j in range(r):
            blocks[:, j: j + n_frames] += chunks[:, :, j]
    else:
        for i in range(n_frames):
            signal[:, i * hop: i * hop + n_fft] += frames[:, i]
    wss = window_sumsquare(n_frames, hop, params.win_length, n_fft)
    tiny = np.finfo(np.float32).tiny
    correction = np.where(wss > tiny, 1.0 / np.maximum(wss, tiny), 1.0)
    signal = signal * torch.from_numpy(
        correction.astype(np.float32)).to(signal.device)[None, :]
    signal = signal * (float(n_fft) / hop)
    return signal[:, n_fft // 2: -(n_fft // 2)]


def num_frames(n_samples: int, hop_length: int) -> int:
    """Frame count of a centred STFT (librosa's ``center=True``)."""
    return 1 + n_samples // hop_length
