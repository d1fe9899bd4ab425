"""Fused WaveGlow inference, the serving path (counterpart of
``text2speech_tpu/models/waveglow_fused.py::infer_fused`` with
``composed_cond=None``).

Each flow's WN net runs as three fused layer kernels
(:mod:`..ops.wn_block`): the first layer with the start projection composed
onto its taps, L - 2 standard layers, and the last layer with the end
projection folded in; 12 / 72 / 12 launches per vocode at the reference
config.  Upsample, grouping, the affine coupling ``(x1 - b) exp(-s)``
(f32), the inverse 1x1 convs (f32) and the early-noise injection are plain
PyTorch.

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

from text2speech_tpu.config import WaveGlowConfig

from ..ops import wn_block as wb
from .waveglow import WaveGlow, noise_shapes, upsample_group

F32 = torch.float32
KERNELS = (wb.wn_layer_first, wb.wn_layer, wb.wn_layer_final)
PLAIN = (wb.wn_layer_first_plain, wb.wn_layer_plain, wb.wn_layer_final_plain)


@dataclass
class FusedWaveGlow:
    """Serving weights prepared once from a :class:`WaveGlow`: WN weights,
    upsample kernel and noise in ``dtype``, biases and the inverted 1x1
    convs in f32, per-layer conditioning blocks contiguous."""

    cfg: WaveGlowConfig
    dtype: torch.dtype
    up_k: torch.Tensor
    up_b: torch.Tensor
    flows: list            # per flow: dict of tensors (see prepare_fused)

    def noise_shapes(self, B: int, Tg: int) -> list:
        return noise_shapes(self.cfg, B, Tg)


def prepare_fused(model: WaveGlow,
                  dtype: torch.dtype = torch.bfloat16) -> FusedWaveGlow:
    def cw(t):
        return t.detach().to(dtype).contiguous()

    def cf(t):
        return t.detach().to(F32).contiguous()

    flows = []
    for k, wn in enumerate(model.wn):
        flows.append({
            "start_k": cw(wn.start_k), "start_b": cf(wn.start_b),
            "in_w": [cw(w) for w in wn.in_w], "in_b": [cf(b) for b in wn.in_b],
            "cond_w": [cw(w) for w in wn.cond_w],
            "cond_b": [cf(b) for b in wn.cond_b],
            "rs_w": [cw(w) for w in wn.rs_w], "rs_b": [cf(b) for b in wn.rs_b],
            "end_w": cw(wn.end_w), "end_b": cf(wn.end_b),
            "w_inv": torch.linalg.inv(cf(model.convinv[k])),
        })
    return FusedWaveGlow(model.cfg, dtype, cw(model.upsample_k),
                         cf(model.upsample_b), flows)


def infer_fused(fw: FusedWaveGlow, spect: torch.Tensor, sigma: float = 1.0,
                noise: tuple | None = None,
                generator: torch.Generator | None = None,
                plain: bool = False) -> torch.Tensor:
    """mel [B, n_mel, frames] -> audio [B, samples] f32.

    ``noise``: the standard-normal draws at the true length, in
    ``WaveGlow.noise_shapes`` order; otherwise drawn from ``generator``.
    ``plain=True`` runs the layers' plain PyTorch versions instead of the
    kernels (the comparison path on a GPU; CPU tensors take the plain
    versions anyway)."""
    cfg, dt = fw.cfg, fw.dtype
    first, std, final = PLAIN if plain else KERNELS
    L = cfg.wn_n_layers
    cond = upsample_group(spect, fw.up_k, fw.up_b, cfg, dtype=dt).contiguous()
    B, Tg, _ = cond.shape
    shapes = fw.noise_shapes(B, Tg)
    draws = iter(noise) if noise is not None else None

    def next_noise(i):
        if draws is None:
            z = torch.randn(shapes[i], generator=generator,
                            device=cond.device)
        else:
            z = next(draws)
            if tuple(z.shape) != shapes[i]:
                raise ValueError(f"noise draw {tuple(z.shape)}, want "
                                 f"{shapes[i]}")
        return sigma * z.to(cond.device, dt)

    audio = next_noise(0)
    n_draw = 1
    for k in reversed(range(cfg.n_flows)):
        w = fw.flows[k]
        n_half = audio.shape[-1] // 2
        x0 = audio[..., :n_half].contiguous()
        x1 = audio[..., n_half:]
        if L >= 2:
            xh, skip = first(x0, cond, w["start_k"], w["start_b"],
                             w["in_w"][0], w["in_b"][0], w["cond_w"][0],
                             w["cond_b"][0], w["rs_w"][0], w["rs_b"][0], 1,
                             n_valid=Tg)
        else:
            xh = (x0 @ w["start_k"] + w["start_b"].to(dt)).contiguous()
            skip = torch.zeros_like(xh)
        for li in range(1, L - 1):
            xh, skip = std(xh, cond, w["in_w"][li], w["in_b"][li],
                           w["cond_w"][li], w["cond_b"][li], w["rs_w"][li],
                           w["rs_b"][li], skip, 2 ** li, n_valid=Tg)
        li = L - 1
        wn_out = final(xh, cond, w["in_w"][li], w["in_b"][li],
                       w["cond_w"][li], w["cond_b"][li], w["rs_w"][li],
                       w["rs_b"][li], skip, w["end_w"], w["end_b"], 2 ** li,
                       n_valid=Tg)
        x1 = ((x1.to(F32) - wn_out[..., :n_half])
              * torch.exp(-wn_out[..., n_half:])).to(dt)
        audio = torch.cat([x0, x1], dim=-1)
        audio = (audio.to(F32) @ w["w_inv"].T).to(dt)
        if k % cfg.n_early_every == 0 and k > 0:
            audio = torch.cat([next_noise(n_draw), audio], dim=-1)
            n_draw += 1
    return audio.reshape(B, Tg * cfg.n_group).to(F32)
