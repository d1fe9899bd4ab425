"""Online mel frontend, the training-time convention (counterpart of
``text2speech_tpu/dsp/mel.py``): mel = log(clamp(mel_basis @ |STFT(y)|,
1e-5)), fmin 0 / fmax 8000 by default, also for signals the caller has
padded (``center=False``, the Tacotron dataset's batched extraction)."""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .filters import mel_filterbank
from .stft import STFTParams, stft_magnitude


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0,
                              clip_val: float = 1e-5) -> torch.Tensor:
    """log(clamp(x) * C)."""
    return torch.log(torch.clamp_min(x, clip_val) * C)


def dynamic_range_decompression(x: torch.Tensor,
                                C: float = 1.0) -> torch.Tensor:
    """exp(x) / C, the inverse of :func:`dynamic_range_compression`."""
    return torch.exp(x) / C


@functools.lru_cache(maxsize=8)
def _mel_basis(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
               fmax: float) -> np.ndarray:
    return mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)


@dataclass(frozen=True)
class MelFrontend:
    """Waveform -> log-mel transform, on the waveform's device, in f32
    (keep TF32 off on a GPU)."""

    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 80
    sampling_rate: int = 22050
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0

    @property
    def stft_params(self) -> STFTParams:
        return STFTParams(self.filter_length, self.hop_length,
                          self.win_length)

    def mel_spectrogram(self, y: torch.Tensor,
                        center: bool = True) -> torch.Tensor:
        """[B, T] in [-1, 1] -> [B, n_mels, 1 + T // hop] log-mel.
        ``center=False`` takes signals each reflect-padded by
        ``filter_length // 2`` by the caller (batched extraction, where the
        edges must come from each utterance's own samples, not from the
        batch's zero padding)."""
        mag = stft_magnitude(y, self.stft_params, center)
        basis = torch.from_numpy(_mel_basis(
            self.sampling_rate, self.filter_length, self.n_mel_channels,
            self.mel_fmin, self.mel_fmax)).to(mag.device)
        return dynamic_range_compression(basis @ mag)

    @classmethod
    def from_hparams(cls, hp) -> "MelFrontend":
        return cls(filter_length=hp.filter_length, hop_length=hp.hop_length,
                   win_length=hp.win_length, n_mel_channels=hp.n_mel_channels,
                   sampling_rate=hp.sample_rate, mel_fmin=hp.mel_fmin,
                   mel_fmax=hp.mel_fmax)
