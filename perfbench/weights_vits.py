"""Seeded VITS weights in the authors' layout (jaywalnut310/vits
``SynthesizerTrn``), made on the card: one standard-normal draw from a
``torch.Generator`` on the device, cut into the leaves and scaled by their
kind.  The scales are the configuration's ``assumed.weights``.  Both sides
get these tensors: the system under test through
``convert.vits_module_from_torch``, the reference as they are."""

from __future__ import annotations

import math

import torch

from .reference.vits import vits_shapes


def up_gains(v: dict) -> dict:
    """Each transposed convolution's weight-norm gain, sqrt(u C_out /
    C_in): every output sample then sums C_in k / u taps of variance
    1 / (C_in k / u), so the stage keeps its input's variance."""
    c0 = v["upsample_initial_channel"]
    return {f"dec.ups.{i}.weight_g": math.sqrt(u * (c0 >> (i + 1))
                                               / (c0 >> i))
            for i, u in enumerate(v["upsample_rates"])}


def make_weights(cfg: dict, seed: int, device, training: bool = False) -> dict:
    """The state dict, f32 on ``device``, a function of ``seed`` and the
    configuration alone (``training``: with the training-only leaves the
    system under test skips)."""
    v, s = cfg["vits"], cfg["assumed"]["weights"]
    shapes = vits_shapes(v, training=training)
    gains = up_gains(v)
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    z = torch.randn(sum(math.prod(sh) for sh, _ in shapes.values()),
                    generator=gen, device=device)
    vec, C = s["vector_std"], v["inter_channels"]
    out, off = {}, 0
    for name, (shape, kind) in shapes.items():
        n = math.prod(shape)
        x = z[off: off + n].view(shape)
        off += n
        fan_in = n / shape[0]
        if kind == "weight":
            x = x / math.sqrt(fan_in)
        elif kind == "proj_logs":
            x = x / math.sqrt(fan_in)
            x[C:] *= s["proj_logs_scale"]
        elif kind == "dp_proj":
            x = x * s["dp_flow_proj_std"] / math.sqrt(fan_in)
        elif kind == "conv_post":
            x = x * s["conv_post_std"] / math.sqrt(fan_in)
        elif kind == "bias":
            x = x * vec
        elif kind == "ln_gamma":
            x = 1.0 + vec * x
        elif kind == "ln_beta":
            x = vec * x
        elif kind == "embedding":
            x = x * s["embedding_std"]
        elif kind == "rel":
            x = x / math.sqrt(shape[-1])
        elif kind == "wn_g":
            x = 1.0 + s["wn_g_std"] * x
        elif kind == "wn_g_up":
            x = gains[name] * (1.0 + s["wn_g_std"] * x)
        elif kind == "ea_m":
            x = torch.full_like(x, s["duration_shift"])
        elif kind == "ea_logs":
            x = torch.zeros_like(x)
        elif kind != "wn_v":
            raise ValueError(f"unknown leaf kind {kind!r} of {name}")
        out[name] = x.contiguous()
    return out
