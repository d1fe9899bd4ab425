"""WaveGlow in PyTorch, plain path (counterpart of
``text2speech_tpu/models/waveglow.py``): the frozen inference module
(:class:`WaveGlow`) and the trainable one (:class:`TrainableWaveGlow`).

12 flows of affine coupling on audio grouped by 8, run in reverse from
Gaussian noise; mel conditioning upsampled by a transposed conv (k=1024,
s=256) written as one matmul plus r shifted adds.  Weight norm is folded
once, at load (:func:`fold_weightnorm`), so the module holds plain kernels
in the JAX package's layouts: ``[k, in, out]`` convs, channels-last
activations.  The invertible 1x1 convs are inverted and applied in f32.

This is the oracle of the fused serving path (:mod:`.waveglow_fused`) and
the denoiser's bias source.  ``infer(length=...)`` is the masked serving
pass: one fixed-width call that equals the exact call at any shorter length.

:class:`TrainableWaveGlow` is the training half: parameters under the flax
tree's names and layouts with weight norm applied at every call, the
forward flow ``(mel, audio) -> (z, log_s_total, log_det_total)``, and the
hand-written gated activation (:mod:`..ops.gated`) in every WN layer,
forward and backward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import WaveGlowConfig
from ..ops.gated import gated_activation

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


def upsample_group(spect, kernel, bias, cfg: WaveGlowConfig, dtype=F32,
                   n_samples: int | None = None) -> torch.Tensor:
    """mel [B, n_mel, frames] -> grouped conditioning [B, T_g, n_mel *
    n_group], channel-major within a group as torch's ``unfold`` gives it.
    At inference (``n_samples`` None) the transposed-conv tail is trimmed;
    the training forward cuts the upsampled mel to the audio's length."""
    k, s, G = cfg.upsample_kernel, cfg.upsample_stride, cfg.n_group
    up = subpixel_upsample(spect.transpose(1, 2).to(dtype), kernel.to(dtype),
                           bias, k, s)
    up = up[:, : up.shape[1] - (k - s) if n_samples is None else n_samples]
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

    def forward(self, audio_half: torch.Tensor, spect: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """[B, T, n_half], [B, T, n_cond] -> (b, log_s) [B, T, 2 n_half].

        ``mask``: optional bool [*, T, 1], True at real positions.  The
        hidden state is then re-zeroed before every dilated conv, so
        positions past the valid length contribute exactly what the conv's
        zero padding of an exact-length call would
        (``waveglow.py:197-201``)."""
        C = self.start_k.shape[1]
        L = len(self.in_w)
        x = audio_half @ self.start_k + self.start_b
        if mask is not None:
            x = torch.where(mask, x, 0.0)
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
                if mask is not None:
                    x = torch.where(mask, x, 0.0)
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
              generator: torch.Generator | None = None,
              length: int | torch.Tensor | None = None) -> torch.Tensor:
        """mel [B, n_mel, frames] -> audio [B, samples].  ``noise`` gives
        the standard-normal draws explicitly, in :meth:`noise_shapes`
        order; otherwise they come from ``generator``.

        ``length``: valid mel frames, an int or a tensor that broadcasts
        against [B, 1, 1] (``waveglow.py:380-390``).  Mel and noise must be
        zero past it; every WN hidden state is re-zeroed past it before
        each dilated conv, so ``infer(padded, length=t)[:, :t * hop]``
        equals ``infer(exact_t)``: the in-tensor zero tail then stands for
        the conv's zero padding."""
        cfg = self.cfg
        cond = upsample_group(spect, self.upsample_k, self.upsample_b, cfg)
        B, Tg, _ = cond.shape
        mask = None
        if length is not None:
            gpf = cfg.upsample_stride // cfg.n_group
            mask = (torch.arange(Tg, device=cond.device)[None, :, None]
                    < torch.as_tensor(length, device=cond.device) * gpf)
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
            wn_out = self.wn[k](x0, cond, mask)
            x1 = (x1 - wn_out[..., :n_half]) * torch.exp(-wn_out[..., n_half:])
            x = torch.cat([x0, x1], dim=-1)
            x = x @ torch.linalg.inv(self.convinv[k].float()).T
            if k % cfg.n_early_every == 0 and k > 0:
                z = sigma * next_noise((B, Tg, cfg.n_early_size))
                x = torch.cat([z, x], dim=-1)
        return x.reshape(B, Tg * cfg.n_group)


# ---------------------------------------------------------------------------
# training half
# ---------------------------------------------------------------------------


def dilated_conv(x: torch.Tensor, kernel: torch.Tensor,
                 dilation: int) -> torch.Tensor:
    """SAME zero-padded dilated conv, channels-last: x [B, T, C_in], kernel
    [k, C_in, C_out] (k odd) -> [B, T, C_out] contiguous.  The library's
    conv works channels-first, so the result is copied back to
    channels-last (a height-1 channels-last 2-D conv needs no copy, but its
    dilated bf16 backward measured 35 times slower on an H100)."""
    k = kernel.shape[0]
    y = F.conv1d(x.transpose(1, 2), kernel.permute(2, 1, 0),
                 padding=dilation * (k - 1) // 2, dilation=dilation)
    return y.transpose(1, 2).contiguous()


def lecun_normal(shape: tuple, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in (fan_in = every dimension but
    the last).  Drawn by inverse CDF from ``generator``, f32 on its
    device."""
    fan_in = math.prod(shape[:-1])
    std = fan_in ** -0.5 / 0.87962566103423978
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float64) * (1.0 - 2.0 * lo) + lo
    return (torch.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std)).to(F32)


def flow_widths(cfg: WaveGlowConfig) -> list:
    """(n_half, n_remaining) of each flow: the early outputs leave the
    stream every ``n_early_every`` flows."""
    widths, n_half, n_rem = [], cfg.n_group // 2, cfg.n_group
    for k in range(cfg.n_flows):
        if k % cfg.n_early_every == 0 and k > 0:
            n_half -= cfg.n_early_size // 2
            n_rem -= cfg.n_early_size
        widths.append((n_half, n_rem))
    return widths


class TrainableWaveGlow(nn.Module):
    """The flow's training half.

    Parameters live in ``self.params`` under the flax tree's '/'-joined
    names and layouts: ``upsample/kernel|bias``, ``convinv{k}/W``,
    ``wn{k}/{start,cond,in{i},res_skip{i}}/{v,g,bias}`` with ``v`` [k, in,
    out] and ``g`` [out], ``wn{k}/end/kernel|bias``.  Parameters are f32;
    ``compute_dtype`` (f32 or bf16) is the type of the upsample and WN
    products, with explicit casts where the JAX module casts: a weight-norm
    kernel is normalised in f32 and cast after; the coupling, the 1x1
    convs and their log-determinants stay f32.  ``remat`` recomputes each
    flow's WN in the backward pass (``torch.utils.checkpoint``,
    non-reentrant).  ``gated`` is the WN layers' gated activation: the
    hand-written kernels by default, :func:`..ops.gated.gated_plain` for a
    run to hold them against.

    ``generator`` draws the initial values as the JAX initialisers do
    (lecun-normal ``v``, ``g = ||v||``, zero biases, zero ``end``, ``W`` a
    random rotation with det +1); without one the parameters are zero,
    to be loaded."""

    def __init__(self, cfg: WaveGlowConfig, compute_dtype=F32,
                 remat: bool = False, gated=gated_activation,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if compute_dtype not in (F32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: f32 or bf16")
        if cfg.wn_kernel_size % 2 == 0:
            raise ValueError("wn_kernel_size must be odd (SAME padding)")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.gated = gated
        self.params = nn.ParameterDict()
        M, C, L = cfg.n_mel_channels, cfg.wn_n_channels, cfg.wn_n_layers

        def add(name, value):
            self.params[name] = nn.Parameter(value.to(device))

        def wn_conv(name, k, cin, cout):
            if generator is None:
                v = torch.zeros(k, cin, cout)
            else:
                v = lecun_normal((k, cin, cout), generator)
            add(f"{name}/v", v)
            add(f"{name}/g", torch.linalg.norm(v.reshape(-1, cout), dim=0))
            add(f"{name}/bias", torch.zeros(cout))

        up_shape = (cfg.upsample_kernel, M, M)
        add("upsample/kernel", torch.zeros(up_shape) if generator is None
            else lecun_normal(up_shape, generator))
        add("upsample/bias", torch.zeros(M))
        for k, (n_half, n_rem) in enumerate(flow_widths(cfg)):
            add(f"convinv{k}/W", torch.eye(n_rem) if generator is None
                else random_rotation(n_rem, generator))
            w = f"wn{k}"
            wn_conv(f"{w}/start", 1, n_half, C)
            wn_conv(f"{w}/cond", 1, M * cfg.n_group, 2 * C * L)
            for i in range(L):
                wn_conv(f"{w}/in{i}", cfg.wn_kernel_size, C, 2 * C)
                wn_conv(f"{w}/res_skip{i}", 1, C, 2 * C if i < L - 1 else C)
            add(f"{w}/end/kernel", torch.zeros(1, C, 2 * n_half))
            add(f"{w}/end/bias", torch.zeros(2 * n_half))

    def _wn_conv(self, name: str, x: torch.Tensor,
                 dilation: int = 1) -> torch.Tensor:
        """``WNConv``: kernel = v / ||v|| * g, normalised in f32 and cast to
        the compute dtype after."""
        p, dt = self.params, self.compute_dtype
        kernel = fold_weightnorm(p[f"{name}/v"], p[f"{name}/g"]).to(dt)
        bias = p[f"{name}/bias"].to(dt)
        if kernel.shape[0] == 1:
            return x @ kernel[0] + bias
        return dilated_conv(x, kernel, dilation) + bias

    def wn(self, k: int, audio_half: torch.Tensor,
           cond: torch.Tensor) -> torch.Tensor:
        """Flow ``k``'s coupling net: [B, T, n_half], [B, T, n_cond] ->
        (b, log_s) [B, T, 2 n_half] f32.  The L conditioning projections
        are one matmul; each layer's gated activation reads its column
        slice of it in place."""
        p, dt = self.params, self.compute_dtype
        C, L = self.cfg.wn_n_channels, self.cfg.wn_n_layers
        w = f"wn{k}"
        x = self._wn_conv(f"{w}/start", audio_half.to(dt))
        conds = self._wn_conv(f"{w}/cond", cond.to(dt)).split(2 * C, dim=-1)
        output = None
        for i in range(L):
            in_act = self._wn_conv(f"{w}/in{i}", x, 2 ** i)
            acts = self.gated(in_act, conds[i])
            rs = self._wn_conv(f"{w}/res_skip{i}", acts)
            if i < L - 1:
                res, skip = rs.split(C, dim=-1)
                x = x + res
            else:
                skip = rs
            output = skip if output is None else output + skip
        end = output @ p[f"{w}/end/kernel"][0].to(dt) + p[f"{w}/end/bias"].to(dt)
        return end.to(F32)

    def forward(self, spect: torch.Tensor, audio: torch.Tensor):
        """(mel [B, n_mel, frames], audio [B, T]) -> (z [B, T_g, n_group],
        log_s_total, log_det_w_total): the flow's forward pass.  The
        upsampled mel is cut to the audio's length."""
        cfg, p = self.cfg, self.params
        B, T = audio.shape
        G = cfg.n_group
        Tg = T // G
        cond = upsample_group(spect, p["upsample/kernel"], p["upsample/bias"],
                              cfg, self.compute_dtype, n_samples=T)
        x = audio[:, : Tg * G].reshape(B, Tg, G).to(F32)
        cond = cond[:, :Tg]
        outputs = []
        log_s_total = x.new_zeros(())
        log_det_total = x.new_zeros(())
        for k in range(cfg.n_flows):
            if k % cfg.n_early_every == 0 and k > 0:
                outputs.append(x[..., : cfg.n_early_size])
                x = x[..., cfg.n_early_size:]
            W = p[f"convinv{k}/W"].to(F32)
            x = x @ W.T
            log_det_total = log_det_total + B * Tg * torch.linalg.slogdet(W)[1]
            n_half = x.shape[-1] // 2
            x0, x1 = x[..., :n_half], x[..., n_half:]
            if self.remat:
                wn_out = checkpoint(self.wn, k, x0, cond, use_reentrant=False)
            else:
                wn_out = self.wn(k, x0, cond)
            b, log_s = wn_out[..., :n_half], wn_out[..., n_half:]
            x1 = torch.exp(log_s) * x1 + b
            log_s_total = log_s_total + log_s.sum()
            x = torch.cat([x0, x1], dim=-1)
        outputs.append(x)
        return torch.cat(outputs, dim=-1), log_s_total, log_det_total


def random_rotation(n: int, generator: torch.Generator) -> torch.Tensor:
    """An orthonormal [n, n] matrix with determinant +1: QR of a normal
    draw, first column negated when the determinant is -1."""
    q, _ = torch.linalg.qr(torch.randn(n, n, generator=generator,
                                       device=generator.device))
    if torch.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q
