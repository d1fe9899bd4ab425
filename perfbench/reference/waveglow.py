"""WaveGlow in plain float32 PyTorch (Prenger et al., arXiv:1811.00002, as
NVIDIA/waveglow's ``glow.py`` writes it, with one conditioning conv per
WN layer), over a state dict in that repository's layout: inference from
given noise, the training forward and its loss, and the mel frontend the
training data goes through (``mel2samp.py``'s ``TacotronSTFT``).

Departure from ``glow.py``: ``infer`` takes the standard-normal draws
instead of drawing them, channels-last [B, T_g, width] in consumption
order (the initial draw, then one per early output, from the last flow
down), as the system under test takes them.  Weight norm is folded here,
``g * v / ||v||`` per output channel.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def flow_halves(wg: dict) -> list:
    """n_half of each flow's coupling: early outputs leave the stream
    every ``n_early_every`` flows."""
    out, n_rem = [], wg["n_group"]
    for k in range(wg["n_flows"]):
        if k % wg["n_early_every"] == 0 and k > 0:
            n_rem -= wg["n_early_size"]
        out.append(n_rem // 2)
    return out


def waveglow_shapes(wg: dict) -> dict:
    """Every leaf: name -> (shape, kind).  Kinds: ``weight`` (fan-in
    scaled), ``bias``, ``wn_v`` / ``wn_g`` (weight norm's direction and
    gain), ``orthogonal`` (the 1x1 convs), ``end_t`` / ``end_log_s`` (the
    two halves of the coupling projection's output rows), ``upsample``."""
    M, G = wg["n_mel_channels"], wg["n_group"]
    C, L, K = wg["wn_n_channels"], wg["wn_n_layers"], wg["wn_kernel_size"]
    out = {"upsample.weight": ((M, M, wg["upsample_kernel"]), "upsample"),
           "upsample.bias": ((M,), "bias")}
    n_rem = G
    for k, n_half in enumerate(flow_halves(wg)):
        if k % wg["n_early_every"] == 0 and k > 0:
            n_rem -= wg["n_early_size"]
        out[f"convinv.{k}.conv.weight"] = ((n_rem, n_rem, 1), "orthogonal")
        w = f"WN.{k}"

        def wn_conv(name, cin, cout, k_size):
            out[f"{name}.weight_v"] = ((cout, cin, k_size), "wn_v")
            out[f"{name}.weight_g"] = ((cout, 1, 1), "wn_g")
            out[f"{name}.bias"] = ((cout,), "bias")

        wn_conv(f"{w}.start", n_half, C, 1)
        for i in range(L):
            wn_conv(f"{w}.in_layers.{i}", C, 2 * C, K)
            wn_conv(f"{w}.cond_layers.{i}", M * G, 2 * C, 1)
            wn_conv(f"{w}.res_skip_layers.{i}", C,
                    2 * C if i < L - 1 else C, 1)
        out[f"{w}.end.weight"] = ((2 * n_half, C, 1), "end")
        out[f"{w}.end.bias"] = ((2 * n_half,), "end_bias")
    return out


def fold(sd: dict, name: str) -> torch.Tensor:
    """A weight-normalized conv's kernel, g v / ||v|| per output channel."""
    v, g = sd[f"{name}.weight_v"], sd[f"{name}.weight_g"]
    return g * v / torch.sqrt((v * v).sum(dim=(1, 2), keepdim=True))


def _wn_conv(sd, name, x, dilation=1, folded=None):
    w = fold(sd, name) if folded is None else folded[name]
    k = w.shape[-1]
    return F.conv1d(x, w, sd[f"{name}.bias"], dilation=dilation,
                    padding=dilation * (k - 1) // 2)


def wn(sd: dict, wg: dict, k: int, audio: torch.Tensor,
       spect: torch.Tensor, folded=None) -> torch.Tensor:
    """Flow ``k``'s coupling net: audio half [B, n_half, T], grouped mel
    [B, n_mel * n_group, T] -> [B, 2 n_half, T] (t rows, then log s)."""
    C, L = wg["wn_n_channels"], wg["wn_n_layers"]
    w = f"WN.{k}"
    x = _wn_conv(sd, f"{w}.start", audio, folded=folded)
    output = 0
    for i in range(L):
        a = (_wn_conv(sd, f"{w}.in_layers.{i}", x, 2 ** i, folded)
             + _wn_conv(sd, f"{w}.cond_layers.{i}", spect, folded=folded))
        acts = torch.tanh(a[:, :C]) * torch.sigmoid(a[:, C:])
        rs = _wn_conv(sd, f"{w}.res_skip_layers.{i}", acts, folded=folded)
        if i < L - 1:
            x = x + rs[:, :C]
            output = output + rs[:, C:]
        else:
            output = output + rs
    return F.conv1d(output, sd[f"{w}.end.weight"], sd[f"{w}.end.bias"])


def grouped_cond(sd: dict, wg: dict, mel: torch.Tensor,
                 n_samples: int | None = None) -> torch.Tensor:
    """mel [B, n_mel, F] -> [B, n_mel * n_group, T_g]: the transposed conv,
    its tail cut (inference) or cut to ``n_samples`` (training), and the
    samples grouped by ``n_group``, mel channel major."""
    up = F.conv_transpose1d(mel, sd["upsample.weight"], sd["upsample.bias"],
                            stride=wg["upsample_stride"])
    if n_samples is None:
        up = up[:, :, : up.shape[2] - (wg["upsample_kernel"]
                                       - wg["upsample_stride"])]
    else:
        up = up[:, :, :n_samples]
    G = wg["n_group"]
    B, M, T = up.shape
    up = up.unfold(2, G, G).permute(0, 2, 1, 3).reshape(B, T // G, M * G)
    return up.permute(0, 2, 1)


def fold_all(sd: dict, wg: dict) -> dict:
    """Every weight-normalized kernel folded once (inference)."""
    return {name[: -len(".weight_v")]: fold(sd, name[: -len(".weight_v")])
            for name in sd if name.endswith(".weight_v")}


@torch.no_grad()
def infer(sd: dict, wg: dict, mel: torch.Tensor, noise: tuple, sigma: float,
          folded: dict | None = None) -> torch.Tensor:
    """mel [B, n_mel, F] and the draws -> audio [B, F * hop]."""
    folded = fold_all(sd, wg) if folded is None else folded
    spect = grouped_cond(sd, wg, mel)
    draws = iter(noise)
    audio = sigma * next(draws).transpose(1, 2)
    for k in reversed(range(wg["n_flows"])):
        n_half = audio.shape[1] // 2
        a0, a1 = audio[:, :n_half], audio[:, n_half:]
        out = wn(sd, wg, k, a0, spect, folded)
        a1 = (a1 - out[:, :n_half]) / torch.exp(out[:, n_half:])
        audio = torch.cat([a0, a1], dim=1)
        w_inv = torch.linalg.inv(sd[f"convinv.{k}.conv.weight"][:, :, 0])
        audio = F.conv1d(audio, w_inv[:, :, None])
        if k % wg["n_early_every"] == 0 and k > 0:
            audio = torch.cat([sigma * next(draws).transpose(1, 2), audio], 1)
    return audio.permute(0, 2, 1).reshape(audio.shape[0], -1)


def forward(sd: dict, wg: dict, mel: torch.Tensor, audio: torch.Tensor):
    """The training forward: (mel [B, n_mel, F], audio [B, T]) -> (z,
    [log_s per flow], [log |det W| per flow, times B T_g])."""
    G = wg["n_group"]
    spect = grouped_cond(sd, wg, mel, audio.shape[1])
    x = audio.unfold(1, G, G).permute(0, 2, 1)
    B, _, Tg = x.shape
    outs, log_s_all, log_det_all = [], [], []
    for k in range(wg["n_flows"]):
        if k % wg["n_early_every"] == 0 and k > 0:
            outs.append(x[:, : wg["n_early_size"]])
            x = x[:, wg["n_early_size"]:]
        W = sd[f"convinv.{k}.conv.weight"]
        x = F.conv1d(x, W)
        log_det_all.append(B * Tg * torch.linalg.slogdet(W[:, :, 0])[1])
        n_half = x.shape[1] // 2
        a0, a1 = x[:, :n_half], x[:, n_half:]
        out = wn(sd, wg, k, a0, spect)
        log_s = out[:, n_half:]
        a1 = torch.exp(log_s) * a1 + out[:, :n_half]
        log_s_all.append(log_s)
        x = torch.cat([a0, a1], dim=1)
    outs.append(x)
    return torch.cat(outs, dim=1), log_s_all, log_det_all


def loss(z, log_s_all, log_det_all, sigma: float) -> torch.Tensor:
    """``glow.py``'s ``WaveGlowLoss``: the negative log-likelihood per
    element of z."""
    log_s_total = sum(t.sum() for t in log_s_all)
    log_det_total = sum(log_det_all)
    return ((z * z).sum() / (2 * sigma * sigma) - log_s_total
            - log_det_total) / z.numel()


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    lin = f / (200.0 / 3)
    return np.where(f >= 1000.0,
                    15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                    / (math.log(6.4) / 27.0), lin)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    lin = m * (200.0 / 3)
    return np.where(m >= 15.0,
                    1000.0 * np.exp((math.log(6.4) / 27.0) * (m - 15.0)), lin)


def mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float,
              fmax: float) -> np.ndarray:
    """librosa's default (Slaney) mel filterbank [n_mels, 1 + n_fft // 2]."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                 n_mels + 2))
    lower = (freqs[None, :] - pts[:-2, None]) / (pts[1:-1] - pts[:-2])[:, None]
    upper = (pts[2:, None] - freqs[None, :]) / (pts[2:] - pts[1:-1])[:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (pts[2: n_mels + 2] - pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def mel_spectrogram(wg: dict, audio: torch.Tensor) -> torch.Tensor:
    """audio [B, T] in [-1, 1] -> log mel [B, n_mel, 1 + T // hop]:
    reflect-padded STFT magnitudes, the mel basis, log(max(x, 1e-5))."""
    n_fft, hop = wg["filter_length"], wg["hop_length"]
    window = torch.hann_window(wg["win_length"], periodic=True,
                               device=audio.device)
    spec = torch.stft(audio, n_fft, hop, wg["win_length"], window,
                      center=True, pad_mode="reflect", return_complex=True)
    basis = torch.from_numpy(mel_basis(
        wg["sampling_rate"], n_fft, wg["n_mel_channels"], wg["mel_fmin"],
        wg["mel_fmax"])).to(audio.device)
    return torch.log(torch.clamp_min(basis @ spec.abs(), 1e-5))
