"""Tacotron-2 inference in PyTorch (counterpart of
``text2speech_tpu/models/tacotron2.py``).

Character embedding -> 3 x (conv k5 + BatchNorm + ReLU) -> BiLSTM encoder ->
location-sensitive attention LSTM decoder -> 5-conv postnet.  Only the
inference path is ported: the whole-utterance decode (:meth:`Tacotron2.
inference`) and its streaming unit (:meth:`Tacotron2.decode_chunk`, a run
of decoder steps from an explicit carry).  Layouts follow the JAX package:
encoder activations are channels-last ``[B, T, C]``; mels are
``[B, n_mel, T]``.

Three behaviours of the reference that the port keeps:

* prenet dropout is always on, also at inference.  ``autoregressive`` takes
  explicit keep-masks ``[T, 2, B, prenet_dim]`` (so a test can hand it the
  masks JAX drew) or draws them from a ``torch.Generator``, in blocks of
  :data:`MASK_BLOCK` steps, so the masks of the first n steps do not depend
  on how many steps are drawn (a chunked decode that runs past the
  requested length sees the batch decode's masks);
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


# Keep-masks are drawn MASK_BLOCK steps at a time: on a CUDA generator a
# larger draw need not start with a smaller draw's values, equal-shaped
# draws in sequence do.
MASK_BLOCK = 64


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
        kept with probability 0.5, drawn on the generator's device in
        blocks of :data:`MASK_BLOCK` steps: the first n steps' masks are
        the same for every ``steps >= n``."""
        gdev = generator.device if generator is not None else device
        shape = (MASK_BLOCK, 2, batch, self.hp.prenet_dim)
        blocks = [torch.rand(shape, generator=generator, device=gdev) < 0.5
                  for _ in range(-(-steps // MASK_BLOCK))]
        return torch.cat(blocks)[:steps].to(device)

    def draw_keep_masks_per_row(self, steps: int, generators,
                                device) -> torch.Tensor:
        """Keep-masks bool [steps, 2, B, prenet_dim] with row b drawn from
        ``generators[b]`` alone ([steps, 2, prenet_dim] per call), so a
        row's masks depend neither on the batch size nor on the other rows
        (the JAX per-row keys, ``tacotron2.py:542-547``): what a server
        needs to admit a request into any slot.  Each call advances every
        generator by one chunk."""
        shape = (steps, 2, self.hp.prenet_dim)
        rows = [(torch.rand(shape, generator=g, device=g.device) < 0.5)
                .to(device) for g in generators]
        return torch.stack(rows, dim=2)

    def run_steps(self, carry, keep_masks: torch.Tensor, memory,
                  processed_memory, mask):
        """``keep_masks.shape[0]`` decoder steps from ``carry = (state,
        frame, finished)`` -> (carry, mel [B, n_mel, n], gate [B, n], align
        [B, n, T_in], active bool [B, n]).  ``active[b, t]`` marks frames
        produced at or before row b's stop frame.  The one step loop of the
        whole-utterance and the chunked decode, so that the two agree bit
        for bit."""
        state, frame, finished = carry
        mels, gates, aligns, actives = [], [], [], []
        for t in range(keep_masks.shape[0]):
            pre = self.prenet(frame, keep_masks[t])
            state, (frame, gate, weights) = self.step(
                state, pre, memory, processed_memory, mask)
            actives.append(~finished)
            finished = finished | (torch.sigmoid(gate)
                                   > self.hp.gate_threshold)
            mels.append(frame)
            gates.append(gate)
            aligns.append(weights)
        return ((state, frame, finished), torch.stack(mels, 2),
                torch.stack(gates, 1), torch.stack(aligns, 1),
                torch.stack(actives, 1))

    def initial_carry(self, memory: torch.Tensor):
        """(zero state, zero go-frame, nobody finished)."""
        B = memory.shape[0]
        return (self.initial_state(memory),
                memory.new_zeros((B, self.hp.n_mel_channels)),
                torch.zeros((B,), dtype=torch.bool, device=memory.device))

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
        _, mel, gate, align, active = self.run_steps(
            self.initial_carry(memory), keep_masks, memory,
            self.attention.process_memory(memory), mask)
        return mel, gate, align, active.sum(1).to(torch.int32)


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

    def process_memory(self, memory: torch.Tensor) -> torch.Tensor:
        """The attention's memory projection [B, T_in, attention_dim],
        computed once per utterance and handed to the serving decode."""
        return self.decoder.attention.process_memory(memory)

    def decode_chunk(self, memory: torch.Tensor, state: DecoderState,
                     frame: torch.Tensor, finished: torch.Tensor,
                     keep_masks: torch.Tensor,
                     text_lengths: torch.Tensor | None = None):
        """``n_steps`` decoder steps from an explicit carry, the streaming
        unit of :meth:`inference` (``tacotron2.py:521 decode_chunk``).

        ``keep_masks`` bool [n_steps, 2, B, prenet_dim]: consecutive slices
        of :meth:`Decoder.draw_keep_masks`'s draw make the chunked decode
        equal to one :meth:`inference` decode bit for bit; masks from
        :meth:`Decoder.draw_keep_masks_per_row` make each row independent
        of the batch.  Returns ``((state, frame, finished), mel [B, n_mel,
        n] f32, gate [B, n] f32, align [B, n, T_in] f32, active bool
        [B, n])``."""
        T_in = memory.shape[1]
        mask = (sequence_mask(text_lengths.to(memory.device), T_in)
                if text_lengths is not None else None)
        carry, mel, gate, align, active = self.decoder.run_steps(
            (state, frame, finished), keep_masks, memory,
            self.process_memory(memory), mask)
        return carry, mel.float(), gate.float(), align.float(), active

    def postnet_residual(self, mel: torch.Tensor) -> torch.Tensor:
        """The postnet's residual for a mel window [B, n_mel, T], f32, for
        windowed application (one-sided receptive field
        ``(postnet_kernel_size // 2) * postnet_n_convolutions`` frames)."""
        return self.postnet(mel).float()

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
