"""Fused WaveGlow inference, the serving path (counterpart of
``text2speech_tpu/models/waveglow_fused.py``: ``infer_fused``,
``precompute_composed_cond``, ``quantize_waveglow_int8`` and
``infer_fused_int8``).

Each flow's WN net runs as three fused layer kernels: the first layer with
the start projection composed onto its taps, L - 2 standard layers, and
the last layer with the end projection folded in; 12 / 72 / 12 launches
per vocode at the reference config.  :func:`infer_fused` runs them in bf16
(:mod:`..ops.wn_block`), :func:`infer_fused_int8` with the three large
product families (dilated taps, conditioning, res/skip) in int8
(:mod:`..ops.wn_block_int8`).  With ``composed_cond=``
(:func:`precompute_composed_cond`) :func:`infer_fused` takes the
composed-conditioning path: no upsample and no in-kernel projection; each
flow materialises its ``cond_all`` [B, T_g, 2C * L] with one matmul over a
stack of r shifted mel frames and the layers read their column slices of
it (:mod:`..ops.wn_block_dcond`).  Upsample, grouping, the affine coupling
``(x1 - b) exp(-s)`` (f32), the inverse 1x1 convs (f32) and the early-noise
injection are plain PyTorch and shared by both.

Everything that depends only on the checkpoint is prepared once
(:func:`prepare_fused`, :func:`prepare_fused_int8`): casts, the first
layer's composed taps, the final layer's folded end projection, the
inverted 1x1 convs and, for int8, the quantized weights.

Length: the port does not pad.  The JAX path rounds the time axis up to
its 512-row tile and masks; here every buffer is exactly ``T_g`` groups
long and the kernels take ``n_valid = T_g`` at run time, reading rows
outside ``[0, T_g)`` as the conv's zero padding.  So the output on
``[0, T_g)`` cannot depend on any rounding, and equals the JAX path's over
all ``T_g * n_group`` samples.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import WaveGlowConfig
from ..ops import wn_block as wb
from ..ops import wn_block_dcond as wd
from ..ops import wn_block_int8 as wq
from .waveglow import WaveGlow, noise_shapes, upsample_group

F32 = torch.float32
KERNELS = (wb.wn_layer_first, wb.wn_layer, wb.wn_layer_final)
PLAIN = (wb.wn_layer_first_plain, wb.wn_layer_plain, wb.wn_layer_final_plain)
KERNELS_DCOND = (wd.wn_layer_first_dcond, wd.wn_layer_dcond,
                 wd.wn_layer_final_dcond)
PLAIN_DCOND = (wd.wn_layer_first_dcond_plain, wd.wn_layer_dcond_plain,
               wd.wn_layer_final_dcond_plain)
KERNELS_INT8 = (wq.wn_layer_first_int8, wq.wn_layer_int8,
                wq.wn_layer_final_int8)
PLAIN_INT8 = (wq.wn_layer_first_int8_plain, wq.wn_layer_int8_plain,
              wq.wn_layer_final_int8_plain)


@dataclass
class FusedWaveGlow:
    """Serving weights prepared once from a :class:`WaveGlow`: WN weights,
    upsample kernel and noise in ``dtype``, biases and the inverted 1x1
    convs in f32, per-layer conditioning blocks contiguous, the first
    layer's taps and the final layer's end projection folded."""

    cfg: WaveGlowConfig
    dtype: torch.dtype
    up_k: torch.Tensor
    up_b: torch.Tensor
    flows: list            # per flow: dict of tensors (see prepare_fused)

    def noise_shapes(self, B: int, Tg: int) -> list:
        return noise_shapes(self.cfg, B, Tg)

    def infer(self, spect, sigma: float = 1.0, **kw) -> torch.Tensor:
        """:func:`infer_fused` on these weights (the signature of
        ``WaveGlow.infer``, so callers can hold any of the vocoders)."""
        return infer_fused(self, spect, sigma, **kw)


@dataclass
class FusedWaveGlowInt8(FusedWaveGlow):
    """As :class:`FusedWaveGlow`, with the taps of layers 1.., every
    layer's conditioning projection and the res/skip of layers ..L-2 as
    ``(int8 output-major, f32 column scale, f32 bias)`` triples (see
    prepare_fused_int8)."""

    def infer(self, spect, sigma: float = 1.0, **kw) -> torch.Tensor:
        """:func:`infer_fused_int8` on these weights."""
        return infer_fused_int8(self, spect, sigma, **kw)


def _casters(dtype):
    def cw(t):
        return t.detach().to(dtype).contiguous()

    def cf(t):
        return t.detach().to(F32).contiguous()

    return cw, cf


def prepare_fused(model: WaveGlow,
                  dtype: torch.dtype = torch.bfloat16) -> FusedWaveGlow:
    cw, cf = _casters(dtype)
    L = model.cfg.wn_n_layers
    flows = []
    for k, wn in enumerate(model.wn):
        w = {
            "start_k": cw(wn.start_k), "start_b": cf(wn.start_b),
            "in_w": [cw(w) for w in wn.in_w], "in_b": [cf(b) for b in wn.in_b],
            "cond_w": [cw(w) for w in wn.cond_w],
            "cond_b": [cf(b) for b in wn.cond_b],
            "rs_w": [cw(w) for w in wn.rs_w], "rs_b": [cf(b) for b in wn.rs_b],
            "end_w": cw(wn.end_w),
            "w_inv": torch.linalg.inv(cf(model.convinv[k])),
        }
        if L >= 2:   # (wp, b_all, b_edge)
            w["first"] = wb.fold_first_taps(w["start_k"], w["start_b"],
                                            w["in_w"][0], w["in_b"][0])
        # (w_eff, b_eff)
        w["final"] = wb.fold_end(w["rs_w"][L - 1], w["rs_b"][L - 1],
                                 w["end_w"], cf(wn.end_b))
        flows.append(w)
    return FusedWaveGlow(model.cfg, dtype, cw(model.upsample_k),
                         cf(model.upsample_b), flows)


@torch.no_grad()
def precompute_composed_cond(model: WaveGlow,
                             dtype: torch.dtype = torch.bfloat16) -> dict:
    """Collapse upsample, grouping and each flow's conditioning projection
    into per-phase MEL-level weights, once per checkpoint
    (``waveglow_fused.py:50 precompute_composed_cond``).

    The grouped conditioning of audio group g is a linear image of only
    r = upsample_kernel / stride mel frames: with u = g // P, ph = g % P
    (P = stride / n_group),

        cond[g] = sum_q mel[u - q] @ Wc[q, ph] + b_eff

    so the projection's contraction shrinks from n_mel * n_group to
    r * n_mel at the price of phase-expanded weights.  Returns ``{flow: (Wc
    [r, P, n_mel, 2C * L] in ``dtype``, b_eff [2C * L] f32)}``; ``b_eff``
    folds the upsample bias through the projection.  ``Wc`` is stored
    ``[r, n_mel, P, 2C * L]``-contiguous and returned as a transposed view,
    so :func:`infer_fused` reads it as one [r * n_mel, P * 2C * L] matrix
    without a copy."""
    cfg = model.cfg
    k, s, G, M = (cfg.upsample_kernel, cfg.upsample_stride, cfg.n_group,
                  cfg.n_mel_channels)
    if k % s or s % G:
        raise ValueError("the composed path needs stride | upsample_kernel "
                         "and n_group | stride")
    r, P = k // s, s // G
    kq5 = model.upsample_k.to(F32).reshape(r, P, G, M, M)  # [q, ph, j, mi, mo]
    up_b = model.upsample_b.to(F32)
    out = {}
    for kf, wn in enumerate(model.wn):
        cond_k = torch.cat([w.to(F32) for w in wn.cond_w], dim=1)
        cond_b = torch.cat([b.to(F32) for b in wn.cond_b])
        wc3 = cond_k.reshape(M, G, -1)                         # [mo, j, o]
        Wc = torch.einsum("qpjim,mjo->qipo", kq5, wc3).to(dtype).contiguous()
        b_eff = cond_b + torch.einsum("m,mjo->o", up_b, wc3)
        out[kf] = (Wc.permute(0, 2, 1, 3), b_eff.contiguous())
    return out


def prepare_fused_int8(model: WaveGlow, dtype: torch.dtype = torch.bfloat16
                       ) -> FusedWaveGlowInt8:
    """Quantize once per checkpoint (``waveglow_fused.py:98
    quantize_waveglow_int8``): static per-output-column int8 for the
    dilated taps of layers 1..L-1, every layer's conditioning block and
    the res/skip of layers 0..L-2, each from the f32 folded weights.  What
    stays in ``dtype``: layer 0's taps (composed onto the rank-n_half start
    projection), the last res/skip and the end projection (folded to
    [C, E <= 8]; the coupling terms want the precision), the upsample
    kernel.  Biases and the inverted 1x1 convs stay f32."""
    cfg = model.cfg
    L = cfg.wn_n_layers
    if L < 2:
        raise ValueError("the int8 path needs wn_n_layers >= 2 (a first and "
                         "a final layer kernel)")
    cw, cf = _casters(dtype)

    def quant(w, b):
        q, s = wq.quantize_cols(w.detach())
        return wq.to_output_major(q), s.contiguous(), cf(b)

    flows = []
    for k, wn in enumerate(model.wn):
        start_k, start_b, end_w = cw(wn.start_k), cf(wn.start_b), cw(wn.end_w)
        flows.append({
            "start_k": start_k, "start_b": start_b,
            "first": wb.fold_first_taps(start_k, start_b, cw(wn.in_w[0]),
                                        cf(wn.in_b[0])),
            "cond": [quant(wn.cond_w[li], wn.cond_b[li]) for li in range(L)],
            "in": [None] + [quant(wn.in_w[li], wn.in_b[li])
                            for li in range(1, L)],
            "rs": [quant(wn.rs_w[li], wn.rs_b[li]) for li in range(L - 1)],
            "final": wb.fold_end(cw(wn.rs_w[L - 1]), cf(wn.rs_b[L - 1]),
                                 end_w, cf(wn.end_b)),
            "end_w": end_w,
            "w_inv": torch.linalg.inv(cf(model.convinv[k])),
        })
    return FusedWaveGlowInt8(cfg, dtype, cw(model.upsample_k),
                             cf(model.upsample_b), flows)


def _reverse_flows(fw: FusedWaveGlow, B: int, Tg: int, device, wn_net, sigma,
                   noise, generator) -> torch.Tensor:
    """The flow's reverse pass around the WN nets: noise, coupling, inverse
    1x1 convs, early-noise injection.  ``wn_net(k, x0) -> [B, T_g, 2 *
    n_half]`` f32 is flow ``k``'s coupling net on the audio half ``x0``."""
    cfg, dt = fw.cfg, fw.dtype
    shapes = fw.noise_shapes(B, Tg)
    draws = iter(noise) if noise is not None else None

    def next_noise(i):
        if draws is None:
            z = torch.randn(shapes[i], generator=generator, device=device)
        else:
            z = next(draws)
            if tuple(z.shape) != shapes[i]:
                raise ValueError(f"noise draw {tuple(z.shape)}, want "
                                 f"{shapes[i]}")
        return sigma * z.to(device, dt)

    audio = next_noise(0)
    n_draw = 1
    for k in reversed(range(cfg.n_flows)):
        w = fw.flows[k]
        n_half = audio.shape[-1] // 2
        x0 = audio[..., :n_half].contiguous()
        x1 = audio[..., n_half:]
        wn_out = wn_net(k, x0)
        x1 = ((x1.to(F32) - wn_out[..., :n_half])
              * torch.exp(-wn_out[..., n_half:])).to(dt)
        audio = torch.cat([x0, x1], dim=-1)
        audio = (audio.to(F32) @ w["w_inv"].T).to(dt)
        if k % cfg.n_early_every == 0 and k > 0:
            audio = torch.cat([next_noise(n_draw), audio], dim=-1)
            n_draw += 1
    return audio.reshape(B, Tg * cfg.n_group).to(F32)


def infer_fused(fw: FusedWaveGlow, spect: torch.Tensor, sigma: float = 1.0,
                noise: tuple | None = None,
                generator: torch.Generator | None = None,
                plain: bool = False,
                composed_cond: dict | None = None) -> torch.Tensor:
    """mel [B, n_mel, frames] -> audio [B, samples] f32.

    ``noise``: the standard-normal draws at the true length, in
    ``WaveGlow.noise_shapes`` order; otherwise drawn from ``generator``.
    ``plain=True`` runs the layers' plain PyTorch versions instead of the
    kernels (the comparison path on a GPU; CPU tensors take the plain
    versions anyway).

    ``composed_cond`` (:func:`precompute_composed_cond` of the same
    checkpoint, in ``fw``'s dtype) switches to the composed-conditioning
    path (``waveglow_fused.py:350-359``, ``:404-419``): the upsample and
    the in-kernel projections disappear; each flow materialises ``cond_all``
    [B, T_g, 2C * L] in ``fw``'s dtype (f32 accumulation, rounded once, the
    bias added in that dtype, as the JAX path rounds it) from the stack of
    r left-shifted mel frames (group u reads frames u, u-1, .., u-r+1), and
    the ``dcond`` layers read their slices of it in place.  One flow's
    ``cond_all`` is alive at a time."""
    cfg, dt = fw.cfg, fw.dtype
    L = cfg.wn_n_layers
    B, _, frames = spect.shape

    def start(w, x0):       # L == 1: no first-layer kernel
        xh = (x0 @ w["start_k"] + w["start_b"].to(dt)).contiguous()
        return xh, torch.zeros_like(xh)

    if composed_cond is None:
        first, std, final = PLAIN if plain else KERNELS
        cond = upsample_group(spect, fw.up_k, fw.up_b, cfg,
                              dtype=dt).contiguous()
        Tg = cond.shape[1]

        def wn_net(k, x0):
            w = fw.flows[k]
            if L >= 2:
                xh, skip = first(x0, cond, w["start_k"], w["start_b"],
                                 *w["first"], w["cond_w"][0], w["cond_b"][0],
                                 w["rs_w"][0], w["rs_b"][0], 1, n_valid=Tg)
            else:
                xh, skip = start(w, x0)
            for li in range(1, L - 1):
                xh, skip = std(xh, cond, w["in_w"][li], w["in_b"][li],
                               w["cond_w"][li], w["cond_b"][li],
                               w["rs_w"][li], w["rs_b"][li], skip, 2 ** li,
                               n_valid=Tg)
            li = L - 1
            w_eff, b_eff = w["final"]
            return final(xh, cond, w["in_w"][li], w["in_b"][li],
                         w["cond_w"][li], w["cond_b"][li], w_eff, skip,
                         w["end_w"], b_eff, 2 ** li, n_valid=Tg)
    else:
        first, std, final = PLAIN_DCOND if plain else KERNELS_DCOND
        r = cfg.upsample_kernel // cfg.upsample_stride
        Tg = frames * cfg.upsample_stride // cfg.n_group
        melT = spect.transpose(1, 2).to(dt)                    # [B, F, M]
        mel_sh = torch.stack(
            [torch.nn.functional.pad(melT, (0, 0, q, 0))[:, :frames]
             for q in range(r)], dim=2).reshape(B * frames, -1)

        def wn_net(k, x0):
            w = fw.flows[k]
            Wc, b_c = composed_cond[k]
            _, P, M, O = Wc.shape
            cond_all = (
                (mel_sh @ Wc.permute(0, 2, 1, 3).reshape(r * M, P * O))
                .view(B, frames * P, O) + b_c.to(dt)).contiguous()
            if L >= 2:
                xh, skip = first(x0, cond_all, w["start_k"], w["start_b"],
                                 *w["first"], w["rs_w"][0], w["rs_b"][0], 1,
                                 n_valid=Tg)
            else:
                xh, skip = start(w, x0)
            for li in range(1, L - 1):
                xh, skip = std(xh, cond_all, li, w["in_w"][li], w["in_b"][li],
                               w["rs_w"][li], w["rs_b"][li], skip, 2 ** li,
                               n_valid=Tg)
            li = L - 1
            w_eff, b_eff = w["final"]
            return final(xh, cond_all, li, w["in_w"][li], w["in_b"][li],
                         w_eff, skip, w["end_w"], b_eff, 2 ** li, n_valid=Tg)

    return _reverse_flows(fw, B, Tg, spect.device, wn_net, sigma, noise,
                          generator)


def infer_fused_int8(fw: FusedWaveGlowInt8, spect: torch.Tensor,
                     sigma: float = 1.0, noise: tuple | None = None,
                     generator: torch.Generator | None = None,
                     plain: bool = False) -> torch.Tensor:
    """mel [B, n_mel, frames] -> audio [B, samples] f32 with int8 WN
    layers (``waveglow_fused.py:168 infer_fused_int8``); ``noise``,
    ``generator`` and ``plain`` as :func:`infer_fused`.

    The grouped conditioning is quantized per row ONCE per call and serves
    all ``L * n_flows`` layers.  The hidden state travels between the
    layers of a flow as (int8, per-row f32 scale); the audio, the coupling
    and the 1x1 convs are those of the bf16 path."""
    cfg = fw.cfg
    first, std, final = PLAIN_INT8 if plain else KERNELS_INT8
    L = cfg.wn_n_layers
    cond = upsample_group(spect, fw.up_k, fw.up_b, cfg, dtype=fw.dtype)
    Tg = cond.shape[1]
    qspect, sspect = wq.quantize_rows(cond)
    qspect, sspect = qspect.contiguous(), sspect.contiguous()

    def wn_net(k, x0):
        w = fw.flows[k]
        qx, sx, skip = first(x0, qspect, sspect, w["start_k"], w["start_b"],
                             *w["first"], *w["cond"][0], *w["rs"][0], 1,
                             n_valid=Tg)
        for li in range(1, L - 1):
            qx, sx, skip = std(qx, sx, qspect, sspect, *w["in"][li],
                               *w["cond"][li], *w["rs"][li], skip, 2 ** li,
                               n_valid=Tg)
        li = L - 1
        w_eff, b_eff = w["final"]
        return final(qx, sx, qspect, sspect, *w["in"][li], *w["cond"][li],
                     w_eff, skip, w["end_w"], b_eff, 2 ** li, n_valid=Tg)

    return _reverse_flows(fw, cond.shape[0], Tg, spect.device, wn_net, sigma,
                          noise, generator)
