"""Tacotron-2 inference in plain float32 PyTorch (Shen et al.,
arXiv:1712.05884, as NVIDIA/tacotron2's ``model.py`` writes it), over a
state dict in that repository's layout.

Departures from ``model.py``, both the serving contract of the system
under test: the prenet's dropout masks are given (``keep_masks``
[steps, 2, B, prenet_dim], bool) instead of drawn, and the decoder runs
all ``steps`` steps with no early stop; ``out_lengths`` counts the frames
up to and including the first whose stop gate exceeds the threshold.
The encoder's BiLSTM runs each row over its own length, as
``pack_padded_sequence`` would.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def tacotron_shapes(hp: dict, n_symbols: int = 80) -> dict:
    """Every leaf of the state dict: name -> (shape, kind).  Kinds:
    ``weight`` (fan-in scaled), ``bias``, ``bn_weight``, ``bn_bias``,
    ``bn_mean``, ``bn_var``, ``embedding``, ``gate_bias``."""
    E, ch = hp["embedding_size"], hp["enc_conv_channels"]
    k_enc, k_post = hp["enc_conv_kernel_size"], hp["postnet_kernel_size"]
    att_rnn, dec_rnn = hp["attention_rnn_dim"], hp["decoder_rnn_dim"]
    pre, att, n_mel = hp["prenet_dim"], hp["attention_dim"], hp["n_mel_channels"]
    nf, kl = (hp["attention_location_n_filters"],
              hp["attention_location_kernel_size"])
    out = {"embedding.weight": ((n_symbols, E), "embedding")}

    def conv_bn(name, cin, cout, k):
        out[f"{name}.0.conv.weight"] = ((cout, cin, k), "weight")
        out[f"{name}.0.conv.bias"] = ((cout,), "bias")
        for leaf, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                           ("running_mean", "bn_mean"),
                           ("running_var", "bn_var")):
            out[f"{name}.1.{leaf}"] = ((cout,), kind)

    def lstm(name, cin, h, suffix=""):
        out[f"{name}.weight_ih{suffix}"] = ((4 * h, cin), "weight")
        out[f"{name}.weight_hh{suffix}"] = ((4 * h, h), "weight")
        out[f"{name}.bias_ih{suffix}"] = ((4 * h,), "bias")
        out[f"{name}.bias_hh{suffix}"] = ((4 * h,), "bias")

    for i in range(hp["enc_conv_num_layers"]):
        conv_bn(f"encoder.convolutions.{i}", E if i == 0 else ch, ch, k_enc)
    lstm("encoder.lstm", ch, ch // 2, "_l0")
    lstm("encoder.lstm", ch, ch // 2, "_l0_reverse")
    out["decoder.prenet.layers.0.linear_layer.weight"] = ((pre, n_mel),
                                                          "weight")
    out["decoder.prenet.layers.1.linear_layer.weight"] = ((pre, pre),
                                                          "weight")
    lstm("decoder.attention_rnn", pre + ch, att_rnn)
    a = "decoder.attention_layer"
    out[f"{a}.query_layer.linear_layer.weight"] = ((att, att_rnn), "weight")
    out[f"{a}.memory_layer.linear_layer.weight"] = ((att, ch), "weight")
    out[f"{a}.v.linear_layer.weight"] = ((1, att), "weight")
    out[f"{a}.location_layer.location_conv.conv.weight"] = ((nf, 2, kl),
                                                            "weight")
    out[f"{a}.location_layer.location_dense.linear_layer.weight"] = (
        (att, nf), "weight")
    lstm("decoder.decoder_rnn", att_rnn + ch, dec_rnn)
    out["decoder.linear_projection.linear_layer.weight"] = (
        (n_mel, dec_rnn + ch), "weight")
    out["decoder.linear_projection.linear_layer.bias"] = ((n_mel,), "bias")
    out["decoder.gate_layer.linear_layer.weight"] = ((1, dec_rnn + ch),
                                                     "weight")
    out["decoder.gate_layer.linear_layer.bias"] = ((1,), "gate_bias")
    n_post = hp["postnet_n_convolutions"]
    emb = hp["postnet_embedding_dim"]
    dims = [n_mel] + [emb] * (n_post - 1) + [n_mel]
    for i in range(n_post):
        conv_bn(f"postnet.convolutions.{i}", dims[i], dims[i + 1], k_post)
    return out


def _bn(x, sd, name):
    """Inference BatchNorm over [B, C, T] with the running statistics."""
    return F.batch_norm(x, sd[f"{name}.running_mean"],
                        sd[f"{name}.running_var"], sd[f"{name}.weight"],
                        sd[f"{name}.bias"], training=False, eps=1e-5)


def _cell(x, h, c, sd, name, suffix=""):
    gates = (F.linear(x, sd[f"{name}.weight_ih{suffix}"],
                      sd[f"{name}.bias_ih{suffix}"])
             + F.linear(h, sd[f"{name}.weight_hh{suffix}"],
                        sd[f"{name}.bias_hh{suffix}"]))
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _lstm(xs, sd, name, suffix):
    """Unidirectional LSTM over [B, T, D] from a zero state."""
    B, T, _ = xs.shape
    H = sd[f"{name}.weight_hh{suffix}"].shape[1]
    h = xs.new_zeros((B, H))
    c = xs.new_zeros((B, H))
    ys = []
    for t in range(T):
        h, c = _cell(xs[:, t], h, c, sd, name, suffix)
        ys.append(h)
    return torch.stack(ys, dim=1)


def _reverse_within(xs, lengths):
    """Each row reversed over its first ``lengths[b]`` positions."""
    T = xs.shape[1]
    t = torch.arange(T, device=xs.device)[None, :]
    lens = lengths[:, None]
    idx = torch.where(t < lens, lens - 1 - t, t)
    return torch.gather(xs, 1, idx[:, :, None].expand(-1, -1, xs.shape[2]))


def encode(sd, hp: dict, ids: torch.Tensor, lengths: torch.Tensor):
    """ids [B, T_in] (zero-padded), lengths [B] -> memory [B, T_in, C]."""
    x = sd["embedding.weight"][ids].transpose(1, 2)
    k = hp["enc_conv_kernel_size"]
    for i in range(hp["enc_conv_num_layers"]):
        n = f"encoder.convolutions.{i}"
        x = F.conv1d(x, sd[f"{n}.0.conv.weight"], sd[f"{n}.0.conv.bias"],
                     padding=(k - 1) // 2)
        x = torch.relu(_bn(x, sd, f"{n}.1"))
    x = x.transpose(1, 2)
    fwd = _lstm(x, sd, "encoder.lstm", "_l0")
    bwd = _reverse_within(
        _lstm(_reverse_within(x, lengths), sd, "encoder.lstm",
              "_l0_reverse"), lengths)
    out = torch.cat([fwd, bwd], dim=-1)
    valid = (torch.arange(x.shape[1], device=x.device)[None, :]
             < lengths[:, None])
    return torch.where(valid[..., None], out, 0.0)


def postnet(sd, hp: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, n_mel, T] -> the postnet's residual [B, n_mel, T]."""
    k = hp["postnet_kernel_size"]
    n = hp["postnet_n_convolutions"]
    x = mel
    for i in range(n):
        name = f"postnet.convolutions.{i}"
        x = F.conv1d(x, sd[f"{name}.0.conv.weight"],
                     sd[f"{name}.0.conv.bias"], padding=(k - 1) // 2)
        x = _bn(x, sd, f"{name}.1")
        if i < n - 1:
            x = torch.tanh(x)
    return x


@torch.no_grad()
def infer(sd, hp: dict, ids: torch.Tensor, lengths: torch.Tensor,
          keep_masks: torch.Tensor):
    """-> (mel_post [B, n_mel, steps], out_lengths [B]).  ``mel_post`` is
    the decoded mel plus the postnet's residual over all ``steps`` frames,
    zeroed past each row's length."""
    memory = encode(sd, hp, ids, lengths)
    B, T_in, _ = memory.shape
    a = "decoder.attention_layer"
    processed = F.linear(memory, sd[f"{a}.memory_layer.linear_layer.weight"])
    pad = ~(torch.arange(T_in, device=ids.device)[None, :]
            < lengths[:, None])
    kl = hp["attention_location_kernel_size"]
    att_h = memory.new_zeros((B, hp["attention_rnn_dim"]))
    att_c = torch.zeros_like(att_h)
    dec_h = memory.new_zeros((B, hp["decoder_rnn_dim"]))
    dec_c = torch.zeros_like(dec_h)
    weights = memory.new_zeros((B, T_in))
    cum = torch.zeros_like(weights)
    context = memory.new_zeros((B, memory.shape[2]))
    frame = memory.new_zeros((B, hp["n_mel_channels"]))
    finished = torch.zeros((B,), dtype=torch.bool, device=ids.device)
    out_len = torch.zeros((B,), dtype=torch.long, device=ids.device)
    mels = []
    for t in range(keep_masks.shape[0]):
        x = frame
        for layer in range(2):
            w = sd[f"decoder.prenet.layers.{layer}.linear_layer.weight"]
            x = torch.relu(F.linear(x, w))
            x = torch.where(keep_masks[t, layer], x / 0.5, 0.0)
        att_h, att_c = _cell(torch.cat([x, context], -1), att_h, att_c, sd,
                             "decoder.attention_rnn")
        loc = F.conv1d(torch.stack([weights, cum], dim=1),
                       sd[f"{a}.location_layer.location_conv.conv.weight"],
                       padding=(kl - 1) // 2).transpose(1, 2)
        loc = F.linear(
            loc, sd[f"{a}.location_layer.location_dense.linear_layer.weight"])
        query = F.linear(att_h, sd[f"{a}.query_layer.linear_layer.weight"])
        energies = F.linear(torch.tanh(query[:, None, :] + loc + processed),
                            sd[f"{a}.v.linear_layer.weight"])[..., 0]
        weights = torch.softmax(energies.masked_fill(pad, float("-inf")),
                                dim=1)
        cum = cum + weights
        context = torch.bmm(weights[:, None, :], memory)[:, 0]
        dec_h, dec_c = _cell(torch.cat([att_h, context], -1), dec_h, dec_c,
                             sd, "decoder.decoder_rnn")
        proj = torch.cat([dec_h, context], -1)
        frame = F.linear(proj,
                         sd["decoder.linear_projection.linear_layer.weight"],
                         sd["decoder.linear_projection.linear_layer.bias"])
        gate = F.linear(proj, sd["decoder.gate_layer.linear_layer.weight"],
                        sd["decoder.gate_layer.linear_layer.bias"])[:, 0]
        out_len += (~finished).long()
        finished = finished | (torch.sigmoid(gate) > hp["gate_threshold"])
        mels.append(frame)
    mel = torch.stack(mels, dim=2)
    mel_post = mel + postnet(sd, hp, mel)
    valid = (torch.arange(mel.shape[2], device=ids.device)[None, :]
             < out_len[:, None])
    return torch.where(valid[:, None, :], mel_post, 0.0), out_len
