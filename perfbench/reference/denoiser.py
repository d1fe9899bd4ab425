"""NVIDIA/waveglow's ``denoiser.py`` in plain float32 PyTorch: the
vocoder's bias spectrum, estimated once from an all-zero mel at sigma 0,
is subtracted ``strength`` times from the audio's STFT magnitude, and the
audio is resynthesized with its own phases (``stft.py``'s STFT with a
periodic Hann window, reflect padding and the window's sum-square
correction, as ``torch.stft`` / ``torch.istft`` compute them)."""

from __future__ import annotations

import torch

from . import waveglow as ref_wg

FILTER_LENGTH, HOP, WIN = 1024, 256, 1024
BIAS_FRAMES = 88


def _stft(audio):
    window = torch.hann_window(WIN, periodic=True, device=audio.device)
    spec = torch.stft(audio, FILTER_LENGTH, HOP, WIN, window, center=True,
                      pad_mode="reflect", return_complex=True)
    return spec.abs(), torch.angle(spec), window


@torch.no_grad()
def bias_spectrum(sd: dict, wg: dict, folded: dict | None = None):
    """[1, cutoff, 1]: the first frame's magnitude of the audio that an
    all-zero mel of 88 frames gives at sigma 0."""
    dev = sd["upsample.weight"].device
    mel = torch.zeros((1, wg["n_mel_channels"], BIAS_FRAMES), device=dev)
    gpf = wg["upsample_stride"] // wg["n_group"]
    Tg = BIAS_FRAMES * gpf
    n_rem = wg["n_group"] - wg["n_early_size"] * ((wg["n_flows"] - 1)
                                                   // wg["n_early_every"])
    widths = [n_rem] + [wg["n_early_size"]] * ((wg["n_flows"] - 1)
                                               // wg["n_early_every"])
    noise = tuple(torch.zeros((1, Tg, w), device=dev) for w in widths)
    audio = ref_wg.infer(sd, wg, mel, noise, 0.0, folded)
    mag, _, _ = _stft(audio)
    return mag[:, :, 0:1]


@torch.no_grad()
def denoise(audio: torch.Tensor, bias_spec: torch.Tensor,
            strength: float) -> torch.Tensor:
    """audio [B, T] -> [B, hop * (T // hop)]."""
    mag, phase, window = _stft(audio)
    mag = torch.clamp_min(mag - bias_spec * strength, 0.0)
    spec = torch.polar(mag, phase)
    return torch.istft(spec, FILTER_LENGTH, HOP, WIN, window, center=True)
