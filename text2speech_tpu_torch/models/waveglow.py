"""WaveGlow inference in PyTorch, plain path (counterpart of
``text2speech_tpu/models/waveglow.py``).

12 flows of affine coupling on audio grouped by 8, run in reverse from
Gaussian noise; mel conditioning upsampled by a transposed conv (k=1024,
s=256) written as one matmul plus r shifted adds.  Weight norm is folded
once, at load (:func:`fold_weightnorm`), so the module holds plain kernels
in the JAX package's layouts: ``[k, in, out]`` convs, channels-last
activations.  The invertible 1x1 convs are inverted and applied in f32.

This is the oracle of the fused serving path (:mod:`.waveglow_fused`) and
the denoiser's bias source.  The masked serving pass (``length=``) is not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import WaveGlowConfig

F32 = torch.float32


def fold_weightnorm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """kernel = v / ||v|| * g, norms per output channel over (k, in), as
    ``waveglow_fused.py:89 _fold``."""
    norm = torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True) + 1e-12)
    return v / norm * g[None, None, :]


def subpixel_upsample(x, kernel, bias, k: int, s: int) -> torch.Tensor:
    """Transposed conv (k = r * s, stride s) as a matmul and r shifted adds:
    x [B, T, C_in], kernel [k, C_in, C_out] -> [B, (T - 1) * s + k, C_out]."""
    r = k // s
    B, T, cin = x.shape
    cout = kernel.shape[-1]
    y = torch.einsum("bti,qpio->btqpo", x, kernel.reshape(r, s, cin, cout))
    out = y.new_zeros((B, T + r - 1, s, cout))
    for q in range(r):
        out[:, q: q + T] += y[:, :, q]
    return out.reshape(B, (T + r - 1) * s, cout) + bias.to(y.dtype)


def upsample_group(spect, kernel, bias, cfg: WaveGlowConfig,
                   dtype=F32) -> torch.Tensor:
    """mel [B, n_mel, frames] -> grouped conditioning [B, T_g, n_mel *
    n_group] at inference (the transposed-conv tail trimmed), channel-major
    within a group as torch's ``unfold`` gives it."""
    k, s, G = cfg.upsample_kernel, cfg.upsample_stride, cfg.n_group
    up = subpixel_upsample(spect.transpose(1, 2).to(dtype), kernel.to(dtype),
                           bias, k, s)
    up = up[:, : up.shape[1] - (k - s)]
    B, T, M = up.shape
    Tg = T // G
    up = up[:, : Tg * G].reshape(B, Tg, G, M).transpose(2, 3)
    return up.reshape(B, Tg, M * G)


def noise_shapes(cfg: WaveGlowConfig, B: int, Tg: int) -> list:
    """Shapes of the standard-normal draws of one inference, in
    consumption order: the initial draw, then one per early-injection point
    (descending flow index)."""
    shapes = [(B, Tg, cfg.n_remaining_channels)]
    shapes += [(B, Tg, cfg.n_early_size)
               for k in reversed(range(cfg.n_flows))
               if k % cfg.n_early_every == 0 and k > 0]
    return shapes


class WN(nn.Module):
    """One flow's coupling net with folded weights: start 1x1 -> L x
    [dilated k=3 conv + per-layer cond + gated tanh.sigmoid + res/skip 1x1]
    -> end 1x1 giving (b, log_s)."""

    def __init__(self, n_half: int, n_cond: int, C: int, L: int,
                 device=None):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, device=device),
                                requires_grad=False)

        self.start_k, self.start_b = p(n_half, C), p(C)
        self.in_w = nn.ParameterList(p(3, C, 2 * C) for _ in range(L))
        self.in_b = nn.ParameterList(p(2 * C) for _ in range(L))
        self.cond_w = nn.ParameterList(p(n_cond, 2 * C) for _ in range(L))
        self.cond_b = nn.ParameterList(p(2 * C) for _ in range(L))
        rs = [2 * C] * (L - 1) + [C]
        self.rs_w = nn.ParameterList(p(C, n) for n in rs)
        self.rs_b = nn.ParameterList(p(n) for n in rs)
        self.end_w, self.end_b = p(C, 2 * n_half), p(2 * n_half)

    def forward(self, audio_half: torch.Tensor,
                spect: torch.Tensor) -> torch.Tensor:
        """[B, T, n_half], [B, T, n_cond] -> (b, log_s) [B, T, 2 n_half]."""
        C = self.start_k.shape[1]
        L = len(self.in_w)
        x = audio_half @ self.start_k + self.start_b
        output = torch.zeros_like(x)
        for i in range(L):
            d = 2 ** i
            in_act = F.conv1d(x.transpose(1, 2),
                              self.in_w[i].permute(2, 1, 0), self.in_b[i],
                              padding=d, dilation=d).transpose(1, 2)
            a = in_act + (spect @ self.cond_w[i] + self.cond_b[i])
            acts = torch.tanh(a[..., :C]) * torch.sigmoid(a[..., C:])
            rs = acts @ self.rs_w[i] + self.rs_b[i]
            if i < L - 1:
                x = x + rs[..., :C]
                output = output + rs[..., C:]
            else:
                output = output + rs
        return (output @ self.end_w + self.end_b).float()


class WaveGlow(nn.Module):
    """The flow's inference half, in float32."""

    def __init__(self, cfg: WaveGlowConfig, device=None):
        super().__init__()
        self.cfg = cfg
        M, C, L = cfg.n_mel_channels, cfg.wn_n_channels, cfg.wn_n_layers
        self.upsample_k = nn.Parameter(
            torch.zeros(cfg.upsample_kernel, M, M, device=device),
            requires_grad=False)
        self.upsample_b = nn.Parameter(torch.zeros(M, device=device),
                                       requires_grad=False)
        convinv, wn = [], []
        n_half, n_rem = cfg.n_group // 2, cfg.n_group
        for k in range(cfg.n_flows):
            if k % cfg.n_early_every == 0 and k > 0:
                n_half -= cfg.n_early_size // 2
                n_rem -= cfg.n_early_size
            convinv.append(nn.Parameter(torch.eye(n_rem, device=device),
                                        requires_grad=False))
            wn.append(WN(n_half, M * cfg.n_group, C, L, device=device))
        self.convinv = nn.ParameterList(convinv)
        self.wn = nn.ModuleList(wn)

    def noise_shapes(self, B: int, Tg: int) -> list:
        return noise_shapes(self.cfg, B, Tg)

    def infer(self, spect: torch.Tensor, sigma: float = 1.0,
              noise: tuple | None = None,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """mel [B, n_mel, frames] -> audio [B, samples].  ``noise`` gives
        the standard-normal draws explicitly, in :meth:`noise_shapes`
        order; otherwise they come from ``generator``."""
        cfg = self.cfg
        cond = upsample_group(spect, self.upsample_k, self.upsample_b, cfg)
        B, Tg, _ = cond.shape
        draws = iter(noise) if noise is not None else None

        def next_noise(shape):
            if draws is None:
                return torch.randn(shape, generator=generator,
                                   device=cond.device)
            z = next(draws)
            if tuple(z.shape) != shape:
                raise ValueError(f"noise draw {tuple(z.shape)}, want {shape}")
            return z.to(cond.device, F32)

        x = sigma * next_noise(noise_shapes(cfg, B, Tg)[0])
        for k in reversed(range(cfg.n_flows)):
            n_half = x.shape[-1] // 2
            x0, x1 = x[..., :n_half], x[..., n_half:]
            wn_out = self.wn[k](x0, cond)
            x1 = (x1 - wn_out[..., :n_half]) * torch.exp(-wn_out[..., n_half:])
            x = torch.cat([x0, x1], dim=-1)
            x = x @ torch.linalg.inv(self.convinv[k].float()).T
            if k % cfg.n_early_every == 0 and k > 0:
                z = sigma * next_noise((B, Tg, cfg.n_early_size))
                x = torch.cat([z, x], dim=-1)
        return x.reshape(B, Tg * cfg.n_group)
