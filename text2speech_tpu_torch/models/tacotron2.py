"""Tacotron-2 inference in PyTorch (counterpart of
``text2speech_tpu/models/tacotron2.py``).

Character embedding -> 3 x (conv k5 + BatchNorm + ReLU) -> BiLSTM encoder ->
location-sensitive attention LSTM decoder -> 5-conv postnet.  Only the
inference path is ported.  Layouts follow the JAX package: encoder
activations are channels-last ``[B, T, C]``; mels are ``[B, n_mel, T]``.

Three behaviours of the reference that the port keeps:

* prenet dropout is always on, also at inference.  ``autoregressive`` takes
  explicit keep-masks ``[T, 2, B, prenet_dim]`` (so a test can hand it the
  masks JAX drew) or draws them from a ``torch.Generator``;
* the decoder always runs ``max_steps`` steps and never stops early when
  every row has stopped: the postnet (k=5 x 5 layers) reads ~10 frames past
  each stop frame, so an early stop would change the last valid frames;
* ``out_lengths`` counts frames up to and including the stop frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import HParams

from ..ops.lstm import BiLSTM, LSTMCell


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] -> bool [B, max_len], True inside the valid region."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths[:, None])


class Conv1d(nn.Conv1d):
    """1-D convolution over channels-last [B, T, C] with 'same' padding
    (``(k - 1) // 2`` each side, odd k)."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 bias: bool = True, device=None):
        super().__init__(cin, cout, kernel_size,
                         padding=(kernel_size - 1) // 2, bias=bias,
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class BatchNorm(nn.BatchNorm1d):
    """Inference BatchNorm over channels-last [B, T, C]: running statistics
    and flax's eps 1e-5, whatever the module's train flag."""

    def __init__(self, channels: int, device=None):
        super().__init__(channels, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(x.transpose(1, 2), self.running_mean,
                         self.running_var, self.weight, self.bias,
                         training=False, eps=self.eps)
        return y.transpose(1, 2)


class Prenet(nn.Module):
    """Two bias-free ReLU layers, each followed by dropout 0.5 from an
    explicit keep-mask (``x / 0.5`` where kept, else 0)."""

    def __init__(self, n_in: int, size: int, device=None):
        super().__init__()
        self.fc0 = nn.Linear(n_in, size, bias=False, device=device)
        self.fc1 = nn.Linear(size, size, bias=False, device=device)

    def forward(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """keep: bool [2, B, size]."""
        for i, fc in enumerate((self.fc0, self.fc1)):
            x = torch.relu(fc(x))
            x = torch.where(keep[i], x / 0.5, 0.0)
        return x


class Encoder(nn.Module):
    def __init__(self, hp: HParams, device=None):
        super().__init__()
        ch = hp.enc_conv_channels
        ins = [hp.embedding_size] + [ch] * (hp.enc_conv_num_layers - 1)
        self.convs = nn.ModuleList(
            Conv1d(i, ch, hp.enc_conv_kernel_size, device=device) for i in ins)
        self.bns = nn.ModuleList(
            BatchNorm(ch, device=device) for _ in ins)
        self.bilstm = BiLSTM(ch, ch // 2, device=device)

    def forward(self, x: torch.Tensor,
                lengths: torch.Tensor | None) -> torch.Tensor:
        for conv, bn in zip(self.convs, self.bns):
            x = torch.relu(bn(conv(x)))
        return self.bilstm(x, lengths)


class Postnet(nn.Module):
    """5 convs n_mel -> 512 -> ... -> n_mel, k=5, BatchNorm, tanh on all
    but the last.  [B, n_mel, T] -> [B, n_mel, T]."""

    def __init__(self, hp: HParams, device=None):
        super().__init__()
        n, emb = hp.postnet_n_convolutions, hp.postnet_embedding_dim
        dims = [hp.n_mel_channels] + [emb] * (n - 1) + [hp.n_mel_channels]
        self.convs = nn.ModuleList(
            Conv1d(dims[i], dims[i + 1], hp.postnet_kernel_size,
                   device=device) for i in range(n))
        self.bns = nn.ModuleList(
            BatchNorm(dims[i + 1], device=device) for i in range(n))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel.transpose(1, 2)
        last = len(self.convs) - 1
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            x = bn(conv(x))
            if i != last:
                x = torch.tanh(x)
        return x.transpose(1, 2)


class LocationAttention(nn.Module):
    """Location-sensitive additive attention; the memory projection is
    computed once per utterance (:meth:`process_memory`)."""

    def __init__(self, hp: HParams, device=None):
        super().__init__()
        a, enc = hp.attention_dim, hp.enc_conv_channels
        self.query = nn.Linear(hp.attention_rnn_dim, a, bias=False,
                               device=device)
        self.memory = nn.Linear(enc, a, bias=False, device=device)
        self.v = nn.Linear(a, 1, bias=False, device=device)
        self.loc_conv = Conv1d(2, hp.attention_location_n_filters,
                               hp.attention_location_kernel_size, bias=False,
                               device=device)
        self.loc_dense = nn.Linear(hp.attention_location_n_filters, a,
                                   bias=False, device=device)

    def process_memory(self, memory: torch.Tensor) -> torch.Tensor:
        return self.memory(memory)

    def forward(self, query, memory, processed_memory, weights_cat, mask):
        """query [B, att_rnn], memory [B, T_in, enc], weights_cat
        [B, T_in, 2] (previous, cumulative), mask bool [B, T_in] or None ->
        (context [B, enc], weights [B, T_in]).  Softmax in f32."""
        pq = self.query(query)[:, None, :]
        pl = self.loc_dense(self.loc_conv(weights_cat))
        energies = self.v(torch.tanh(pq + pl + processed_memory))[..., 0]
        energies = energies.float()
        if mask is not None:
            energies = energies.masked_fill(~mask, float("-inf"))
        weights = torch.softmax(energies, dim=1).to(memory.dtype)
        context = torch.einsum("bt,bte->be", weights, memory)
        return context, weights


class DecoderState(NamedTuple):
    attention_h: torch.Tensor
    attention_c: torch.Tensor
    decoder_h: torch.Tensor
    decoder_c: torch.Tensor
    attention_weights: torch.Tensor
    attention_weights_cum: torch.Tensor
    attention_context: torch.Tensor


class Decoder(nn.Module):
    """One step = prenet -> attention LSTM -> location attention ->
    decoder LSTM -> mel and gate projections."""

    def __init__(self, hp: HParams, device=None):
        super().__init__()
        self.hp = hp
        enc = hp.enc_conv_channels
        self.prenet = Prenet(hp.n_mel_channels, hp.prenet_dim, device=device)
        self.attention_rnn = LSTMCell(hp.prenet_dim + enc,
                                      hp.attention_rnn_dim, device=device)
        self.attention = LocationAttention(hp, device=device)
        self.decoder_rnn = LSTMCell(hp.attention_rnn_dim + enc,
                                    hp.decoder_rnn_dim, device=device)
        self.mel_proj = nn.Linear(hp.decoder_rnn_dim + enc,
                                  hp.n_mel_channels * hp.n_frames_per_step,
                                  device=device)
        self.gate_proj = nn.Linear(hp.decoder_rnn_dim + enc, 1,
                                   device=device)

    def initial_state(self, memory: torch.Tensor) -> DecoderState:
        hp = self.hp
        B, T_in, _ = memory.shape
        z = lambda *s: memory.new_zeros(s)  # noqa: E731
        return DecoderState(
            z(B, hp.attention_rnn_dim), z(B, hp.attention_rnn_dim),
            z(B, hp.decoder_rnn_dim), z(B, hp.decoder_rnn_dim),
            z(B, T_in), z(B, T_in), z(B, hp.enc_conv_channels))

    def step(self, state: DecoderState, prenet_out, memory,
             processed_memory, mask):
        att_h, att_c = self.attention_rnn(
            (state.attention_h, state.attention_c),
            torch.cat([prenet_out, state.attention_context], -1))
        weights_cat = torch.stack(
            [state.attention_weights, state.attention_weights_cum], dim=-1)
        context, weights = self.attention(att_h, memory, processed_memory,
                                          weights_cat, mask)
        dec_h, dec_c = self.decoder_rnn(
            (state.decoder_h, state.decoder_c),
            torch.cat([att_h, context], -1))
        proj_in = torch.cat([dec_h, context], -1)
        mel_frame = self.mel_proj(proj_in)
        gate = self.gate_proj(proj_in)[..., 0]
        new = DecoderState(att_h, att_c, dec_h, dec_c, weights,
                           state.attention_weights_cum + weights, context)
        return new, (mel_frame, gate, weights)

    def draw_keep_masks(self, steps: int, batch: int,
                        generator: torch.Generator | None,
                        device) -> torch.Tensor:
        """Prenet dropout keep-masks bool [steps, 2, B, prenet_dim], each
        kept with probability 0.5, drawn on the generator's device."""
        gdev = generator.device if generator is not None else device
        shape = (steps, 2, batch, self.hp.prenet_dim)
        return (torch.rand(shape, generator=generator, device=gdev)
                < 0.5).to(device)

    def autoregressive(self, memory: torch.Tensor,
                       memory_lengths: torch.Tensor | None = None,
                       max_steps: int | None = None,
                       keep_masks: torch.Tensor | None = None,
                       generator: torch.Generator | None = None):
        """Fixed-trip decode of ``max_steps`` steps with stop-token masking
        -> (mel [B, n_mel, T], gate [B, T], align [B, T, T_in],
        out_lengths [B])."""
        hp = self.hp
        T = hp.max_decoder_steps if max_steps is None else max_steps
        B, T_in, _ = memory.shape
        if keep_masks is None:
            keep_masks = self.draw_keep_masks(T, B, generator, memory.device)
        if tuple(keep_masks.shape) != (T, 2, B, hp.prenet_dim):
            raise ValueError(f"keep_masks shape {tuple(keep_masks.shape)}, "
                             f"want {(T, 2, B, hp.prenet_dim)}")
        mask = (sequence_mask(memory_lengths.to(memory.device), T_in)
                if memory_lengths is not None else None)
        processed_memory = self.attention.process_memory(memory)
        state = self.initial_state(memory)
        frame = memory.new_zeros((B, hp.n_mel_channels))
        finished = torch.zeros((B,), dtype=torch.bool, device=memory.device)
        mels, gates, aligns, actives = [], [], [], []
        for t in range(T):
            pre = self.prenet(frame, keep_masks[t])
            state, (frame, gate, weights) = self.step(
                state, pre, memory, processed_memory, mask)
            actives.append(~finished)
            finished = finished | (torch.sigmoid(gate) > hp.gate_threshold)
            mels.append(frame)
            gates.append(gate)
            aligns.append(weights)
        out_lengths = torch.stack(actives, 1).sum(1).to(torch.int32)
        return (torch.stack(mels, 2), torch.stack(gates, 1),
                torch.stack(aligns, 1), out_lengths)


class Tacotron2(nn.Module):
    """Inference-only Tacotron-2.  ``num_speakers > 1`` adds additive
    speaker conditioning of the encoder memory."""

    def __init__(self, hp: HParams, n_vocab: int = 80, num_speakers: int = 1,
                 device=None):
        super().__init__()
        self.hp = hp
        self.num_speakers = num_speakers
        self.embedding = nn.Embedding(n_vocab, hp.embedding_size,
                                      device=device)
        if num_speakers > 1:
            self.speaker_embedding = nn.Embedding(
                num_speakers, hp.speaker_embedding_size, device=device)
            self.speaker_proj = nn.Linear(hp.speaker_embedding_size,
                                          hp.enc_conv_channels, device=device)
        self.encoder = Encoder(hp, device=device)
        self.decoder = Decoder(hp, device=device)
        self.postnet = Postnet(hp, device=device)

    def condition_on_speaker(self, encoder_out: torch.Tensor,
                             speaker_ids: torch.Tensor | None):
        """encoder_out + speaker_proj(softsign(embed(id))), broadcast over
        time (``tacotron2.py:460-469``)."""
        if speaker_ids is None or self.num_speakers <= 1:
            return encoder_out
        s = F.softsign(self.speaker_embedding(speaker_ids))
        return encoder_out + self.speaker_proj(s)[:, None, :]

    def encode(self, text_ids, speaker_ids=None, text_lengths=None):
        out = self.encoder(self.embedding(text_ids), text_lengths)
        return self.condition_on_speaker(out, speaker_ids)

    def inference(self, text_ids: torch.Tensor,
                  speaker_ids: torch.Tensor | None = None,
                  text_lengths: torch.Tensor | None = None,
                  max_steps: int | None = None,
                  keep_masks: torch.Tensor | None = None,
                  generator: torch.Generator | None = None):
        """text_ids [B, T_in] -> (mel_out, mel_post, gate_out, align,
        out_lengths), masked past each length (mels zero, gate 1e3)."""
        memory = self.encode(text_ids, speaker_ids, text_lengths)
        mel_out, gate_out, align, out_lengths = self.decoder.autoregressive(
            memory, text_lengths, max_steps, keep_masks, generator)
        mel_post = mel_out + self.postnet(mel_out)
        mel_out, mel_post, gate_out = mask_outputs(
            mel_out.float(), mel_post.float(), gate_out.float(), out_lengths)
        return mel_out, mel_post, gate_out, align.float(), out_lengths


def mask_outputs(mel_out, mel_post, gate_out, output_lengths):
    """Zero mels and pin gate energies to 1e3 past each length."""
    valid = sequence_mask(output_lengths.to(mel_out.device),
                          mel_out.shape[-1])
    mel_out = torch.where(valid[:, None, :], mel_out, 0.0)
    mel_post = torch.where(valid[:, None, :], mel_post, 0.0)
    gate_out = torch.where(valid, gate_out, 1e3)
    return mel_out, mel_post, gate_out
