"""Seeded weights in the reference repositories' layouts (NVIDIA/tacotron2,
NVIDIA/waveglow), made on the card: one standard-normal draw per model
from a ``torch.Generator`` on the device, cut into the leaves and scaled
by their kind.  The scales are the configuration's ``assumed.weights``.
Both sides get these tensors: the system under test through its
reference-checkpoint loaders, the reference as they are."""

from __future__ import annotations

import math

import torch

from .reference.tacotron import tacotron_shapes
from .reference.waveglow import flow_halves, waveglow_shapes


def _fill(shapes: dict, gen: torch.Generator, device, scales: dict,
          halves: dict) -> dict:
    total = sum(math.prod(s) for s, _ in shapes.values())
    z = torch.randn(total, generator=gen, device=device)
    vec = scales["vector_std"]
    out, off = {}, 0
    for name, (shape, kind) in shapes.items():
        n = math.prod(shape)
        x = z[off: off + n].view(shape)
        off += n
        if kind == "weight":
            x = x / math.sqrt(n / shape[0])
        elif kind in ("bias", "bn_bias", "bn_mean"):
            x = x * vec
        elif kind == "bn_weight":
            x = 1.0 + vec * x
        elif kind == "bn_var":
            x = torch.exp(vec * x)
        elif kind == "embedding":
            x = x * scales["embedding_std"]
        elif kind == "gate_bias":
            x = torch.full_like(x, scales["gate_bias"])
        elif kind == "wn_g":
            x = 1.0 + scales["wn_g_std"] * x
        elif kind == "upsample":
            x = x / math.sqrt(shape[0] * shape[2] / scales["upsample_stride"])
        elif kind == "orthogonal":
            q, r = torch.linalg.qr(x[:, :, 0])
            q = q * torch.sign(torch.diagonal(r))[None, :]
            if torch.linalg.det(q) < 0:
                q[:, 0] = -q[:, 0]
            x = q[:, :, None]
        elif kind in ("end", "end_bias"):
            h = halves[name]
            scale = x.new_ones((2 * h,) + (1,) * (x.dim() - 1))
            scale[:h] = scales["end_t_scale"]
            scale[h:] = scales["end_log_s_scale"]
            x = x * scale * (1.0 / math.sqrt(shape[1]) if kind == "end"
                             else vec)
        out[name] = x.contiguous()
    return out


def make_weights(cfg: dict, seed: int, device) -> tuple:
    """(Tacotron state dict, WaveGlow state dict), f32 on ``device``, a
    function of ``seed`` and the configuration alone."""
    hp, wg = cfg["tacotron"], cfg["waveglow"]
    scales = dict(cfg["assumed"]["weights"],
                  upsample_stride=wg["upsample_stride"])
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    taco = _fill(tacotron_shapes(hp), gen, device, scales, {})
    halves = {}
    for k, h in enumerate(flow_halves(wg)):
        halves[f"WN.{k}.end.weight"] = halves[f"WN.{k}.end.bias"] = h
    return taco, _fill(waveglow_shapes(wg), gen, device, scales, halves)
