"""Seeded checkpoints in the reference's own formats, for trying the
converter without a trained model (``python -m
text2speech_tpu_torch.convert_checkpoint``): a Tacotron ``state_dict``
(the reference's ``Tacotron2`` keys), a WaveGlow ``state_dict`` (its
fused ``res_skip_layers`` layout, with live ``end`` convs) and the same
WaveGlow in the pre-fusion ``res_layers`` / ``skip_layers`` layout.  The
weights are random, drawn from a numpy generator, so the audio is noise.

    import torch
    from text2speech_tpu_torch.config import HParams, WaveGlowConfig
    from text2speech_tpu_torch.examples.reference_checkpoints import (
        reference_tacotron_state_dict, reference_waveglow_state_dict)

    hp, cfg = HParams(), WaveGlowConfig()
    torch.save({"iteration": 0, "state_dict":
                reference_tacotron_state_dict(hp, seed=0)}, "taco.pt")
    torch.save(reference_waveglow_state_dict(cfg, seed=0), "wg.pt")
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..models.waveglow import flow_widths
from ..text import N_SYMBOLS


def _normal(rng, shape, fan_in: int, scale: float = 1.0) -> torch.Tensor:
    z = rng.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(z * np.float32(scale / np.sqrt(fan_in)))


def reference_tacotron_state_dict(hp, seed: int) -> dict:
    """A Tacotron ``state_dict`` in the reference's layout (its
    ``Tacotron2`` module's keys: ``encoder.convolutions.{i}.{0.conv,1}``,
    ``encoder.lstm``, ``decoder.prenet`` / ``attention_rnn`` /
    ``attention_layer`` / ``decoder_rnn`` / ``linear_projection`` /
    ``gate_layer``, ``postnet.convolutions.{i}``) from a numpy generator
    seeded ``seed``: weights N(0, 1 / fan_in), biases and BatchNorm affine
    terms N(0, 0.1^2) (scale about 1), running variances in [0.5, 1.5],
    and the stop gate's bias at -10, so that every utterance decodes its
    ``max_steps`` frames, as an untrained model's does."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return _normal(rng, shape, int(np.prod(shape[1:])))

    def vec(n, base=0.0):
        return torch.from_numpy(
            np.float32(base) + 0.1 * rng.standard_normal(n, np.float32))

    E, A, D = hp.enc_conv_channels, hp.attention_rnn_dim, hp.decoder_rnn_dim
    AD, M, P = hp.attention_dim, hp.n_mel_channels, hp.prenet_dim
    sd = {"embedding.weight": w(N_SYMBOLS, hp.embedding_size)}

    def conv_bn(prefix, cout, cin, k):
        sd[f"{prefix}.0.conv.weight"] = w(cout, cin, k)
        sd[f"{prefix}.0.conv.bias"] = vec(cout)
        sd[f"{prefix}.1.weight"] = vec(cout, 1.0)
        sd[f"{prefix}.1.bias"] = vec(cout)
        sd[f"{prefix}.1.running_mean"] = vec(cout)
        sd[f"{prefix}.1.running_var"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, cout).astype(np.float32))
        sd[f"{prefix}.1.num_batches_tracked"] = torch.tensor(0)

    def lstm(prefix, sfx, H, n_in):
        sd[f"{prefix}.weight_ih{sfx}"] = w(4 * H, n_in)
        sd[f"{prefix}.weight_hh{sfx}"] = w(4 * H, H)
        sd[f"{prefix}.bias_ih{sfx}"] = vec(4 * H)
        sd[f"{prefix}.bias_hh{sfx}"] = vec(4 * H)

    for i in range(hp.enc_conv_num_layers):
        conv_bn(f"encoder.convolutions.{i}", E,
                hp.embedding_size if i == 0 else E, hp.enc_conv_kernel_size)
    for sfx in ("_l0", "_l0_reverse"):
        lstm("encoder.lstm", sfx, E // 2, E)
    sd["decoder.prenet.layers.0.linear_layer.weight"] = w(P, M)
    sd["decoder.prenet.layers.1.linear_layer.weight"] = w(P, P)
    lstm("decoder.attention_rnn", "", A, P + E)
    att = "decoder.attention_layer"
    sd[f"{att}.query_layer.linear_layer.weight"] = w(AD, A)
    sd[f"{att}.memory_layer.linear_layer.weight"] = w(AD, E)
    sd[f"{att}.v.linear_layer.weight"] = w(1, AD)
    sd[f"{att}.location_layer.location_conv.conv.weight"] = w(
        hp.attention_location_n_filters, 2,
        hp.attention_location_kernel_size)
    sd[f"{att}.location_layer.location_dense.linear_layer.weight"] = w(
        AD, hp.attention_location_n_filters)
    lstm("decoder.decoder_rnn", "", D, A + E)
    sd["decoder.linear_projection.linear_layer.weight"] = w(M, D + E)
    sd["decoder.linear_projection.linear_layer.bias"] = vec(M)
    sd["decoder.gate_layer.linear_layer.weight"] = w(1, D + E)
    sd["decoder.gate_layer.linear_layer.bias"] = torch.full((1,), -10.0)
    for i in range(hp.postnet_n_convolutions):
        last = i == hp.postnet_n_convolutions - 1
        conv_bn(f"postnet.convolutions.{i}",
                M if last else hp.postnet_embedding_dim,
                M if i == 0 else hp.postnet_embedding_dim,
                hp.postnet_kernel_size)
    return sd


def reference_waveglow_state_dict(cfg, seed: int) -> dict:
    """A WaveGlow ``state_dict`` in the reference's layout from a numpy
    generator seeded ``seed``: per-layer weight-normed ``in_layers``,
    ``cond_layers`` and ``res_skip_layers`` (``weight_g`` is the norm of
    ``weight_v``, so each kernel is its ``weight_v``, drawn N(0, 1 /
    fan_in)), biases N(0, 0.1^2), ``convinv`` random rotations with
    determinant +1, and LIVE ``end`` convs (0.02 x N(0, 1 / C); a real init
    zeroes them, which would leave the audio independent of the mel).  The
    flows shrink by the early outputs (``cfg.n_early_every``,
    ``n_early_size``)."""
    rng = np.random.default_rng(seed)
    C, L, M = cfg.wn_n_channels, cfg.wn_n_layers, cfg.n_mel_channels
    K = cfg.wn_kernel_size
    sd = {"upsample.weight": _normal(rng, (M, M, cfg.upsample_kernel),
                                     M * cfg.upsample_kernel),
          "upsample.bias": torch.from_numpy(
              0.1 * rng.standard_normal(M, np.float32))}

    def wnconv(name, cout, cin, k):
        v = _normal(rng, (cout, cin, k), cin * k)
        sd[f"{name}.weight_v"] = v
        sd[f"{name}.weight_g"] = torch.linalg.vector_norm(
            v, dim=(1, 2), keepdim=True)
        sd[f"{name}.bias"] = torch.from_numpy(
            0.1 * rng.standard_normal(cout, np.float32))

    for k, (n_half, n_rem) in enumerate(flow_widths(cfg)):
        q, _ = np.linalg.qr(rng.standard_normal((n_rem, n_rem)))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        sd[f"convinv.{k}.conv.weight"] = torch.from_numpy(
            q.astype(np.float32)[:, :, None])
        w = f"WN.{k}"
        wnconv(f"{w}.start", C, n_half, 1)
        for i in range(L):
            wnconv(f"{w}.in_layers.{i}", 2 * C, C, K)
            wnconv(f"{w}.cond_layers.{i}", 2 * C, M * cfg.n_group, 1)
            wnconv(f"{w}.res_skip_layers.{i}", 2 * C if i < L - 1 else C,
                   C, 1)
        sd[f"{w}.end.weight"] = _normal(rng, (2 * n_half, C, 1), C, 0.02)
        sd[f"{w}.end.bias"] = torch.from_numpy(
            0.02 * rng.standard_normal(2 * n_half, np.float32))
    return sd


def pre_fusion_layout(sd: dict, cfg) -> dict:
    """The same WaveGlow weights in the reference's pre-fusion layout
    (``glow_old.py``): ``res_layers.{i}`` (the first C rows, every layer
    but the last) and ``skip_layers.{i}`` (the last C rows) in place of
    ``res_skip_layers.{i}``."""
    C = cfg.wn_n_channels
    out = {}
    for key, t in sd.items():
        m = re.match(r"(WN\.\d+)\.res_skip_layers\.(\d+)\.(.+)$", key)
        if m is None:
            out[key] = t
            continue
        w, i, suffix = m.groups()
        if int(i) < cfg.wn_n_layers - 1:
            out[f"{w}.res_layers.{i}.{suffix}"] = t[:C].clone()
            out[f"{w}.skip_layers.{i}.{suffix}"] = t[C:].clone()
        else:                   # the last layer has no res conv
            out[f"{w}.skip_layers.{i}.{suffix}"] = t
    return out
