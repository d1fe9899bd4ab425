"""WaveGlow bias-spectrum denoiser, whole-utterance form (counterpart of
``text2speech_tpu/models/denoiser.py:40-113``).

The vocoder's bias is estimated once by synthesizing from an all-zero mel
at sigma=0 with the plain f32 :meth:`WaveGlow.infer`; at synthesis time
``strength * bias_spec`` is subtracted from the STFT magnitude and the
signal is re-synthesized with the original phases.  The streaming form
(``StreamingDenoiser``, ``denoise_windows``) is not ported yet.
"""

from __future__ import annotations

import torch

from ..dsp.stft import STFTParams, istft, stft_mag_phase
from .waveglow import WaveGlow


def denoiser_stft_params(filter_length: int = 1024, n_overlap: int = 4,
                         win_length: int = 1024, **_ignored) -> STFTParams:
    """The STFT configuration :func:`make_denoiser` uses for these kwargs
    (defaults are the reference's)."""
    return STFTParams(filter_length, filter_length // n_overlap, win_length)


def make_denoiser_programs(model: WaveGlow, filter_length: int = 1024,
                           n_overlap: int = 4, win_length: int = 1024,
                           mode: str = "zeros", n_frames: int = 88):
    """``(compute_bias() -> bias_spec [1, cutoff, 1],
    denoise(audio, bias_spec, strength) -> audio', params)``."""
    if mode != "zeros":
        raise ValueError(f"unsupported denoiser mode {mode!r} (the port "
                         f"estimates the bias from an all-zero mel)")
    params = denoiser_stft_params(filter_length, n_overlap, win_length)

    @torch.inference_mode()
    def compute_bias() -> torch.Tensor:
        dev = model.upsample_k.device
        mel = torch.zeros((1, model.cfg.n_mel_channels, n_frames), device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        bias_audio = model.infer(mel, sigma=0.0, generator=gen)
        bias_spec, _ = stft_mag_phase(bias_audio, params)
        return bias_spec[:, :, 0:1]

    @torch.inference_mode()
    def denoise(audio: torch.Tensor, bias_spec: torch.Tensor,
                strength: float) -> torch.Tensor:
        """audio [B, T] -> [B, hop * (T // hop)]."""
        mag, phase = stft_mag_phase(audio, params)
        mag = torch.clamp_min(mag - bias_spec * strength, 0.0)
        return istft(mag, phase, params)

    return compute_bias, denoise, params


def make_denoiser(model: WaveGlow, filter_length: int = 1024,
                  n_overlap: int = 4, win_length: int = 1024,
                  mode: str = "zeros", n_frames: int = 88):
    """-> (bias_spec, denoise(audio, strength=0.1))."""
    compute_bias, denoise2, _ = make_denoiser_programs(
        model, filter_length, n_overlap, win_length, mode, n_frames)
    bias_spec = compute_bias()

    def denoise(audio: torch.Tensor, strength: float = 0.1) -> torch.Tensor:
        return denoise2(audio, bias_spec, strength)

    return bias_spec, denoise
