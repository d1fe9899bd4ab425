"""Tacotron-2 in PyTorch (counterpart of
``text2speech_tpu/models/tacotron2.py``).

Character embedding -> 3 x (conv k5 + BatchNorm + ReLU) -> BiLSTM encoder ->
location-sensitive attention LSTM decoder -> 5-conv postnet.  Inference:
the whole-utterance decode (:meth:`Tacotron2.inference`) and its streaming
unit (:meth:`Tacotron2.decode_chunk`, a run of decoder steps from an
explicit carry).  Training: the teacher-forced forward
(:meth:`Tacotron2.forward`, ``tacotron2.py:471 __call__``).  Layouts follow
the JAX package: encoder activations are channels-last ``[B, T, C]``; mels
are ``[B, n_mel, T]``.

Training follows flax, not ``torch.nn``'s habits:

* BatchNorm in training normalizes by the statistics over batch and time
  (padded frames included), with the biased variance ``E[x^2] - E[x]^2``
  in f32, and updates the running statistics as ``0.9 running + 0.1
  batch`` (the biased variance there too; ``F.batch_norm`` would store the
  unbiased one).  Under a data-parallel group (:func:`sync_batch_norm`)
  those statistics are the global batch's, as they are under jit over a
  sharded batch;
* every dropout takes an explicit keep-mask (:class:`TrainMasks`: encoder
  ``hp.dropout_prob``, postnet 0.5, prenet 0.5, attention and decoder LSTM
  outputs ``hp.p_attention_dropout`` / ``hp.p_decoder_dropout``), so a
  test can hand it the masks JAX drew; without them the masks are drawn
  from a ``torch.Generator`` (:meth:`Tacotron2.draw_train_masks`);
* ``compute_dtype=torch.bfloat16`` runs the products in bf16 (autocast)
  with f32 parameters; the outputs, and the loss, are f32;
* ``decoder_remat`` recomputes each teacher-forced decoder step in the
  backward pass (``torch.utils.checkpoint``): the same loss and gradients
  with one step's activations kept instead of every step's.

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

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import HParams

from ..ops.lstm import BiLSTM, LSTMCell
from ..utils import cuda_graphs
from ..utils.profiling import annotate, count


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
    """BatchNorm over channels-last [B, T, C] with flax's semantics (eps
    1e-5, momentum 0.9), whatever the module's own train flag: the running
    statistics unless ``train=True``; then the batch's, and the running
    ones are updated in place.

    ``sync_group`` (set by :func:`sync_batch_norm`): a data-parallel
    process group whose ranks hold equal row blocks of one batch padded to
    one length.  In training the f32 ``mean`` and ``E[x^2]`` are then
    averaged over its ranks by an all-reduce that carries gradients, so
    the statistics, their backward and the running statistics (the same on
    every rank) are the global batch's."""

    sync_group = None

    def __init__(self, channels: int, device=None):
        super().__init__(channels, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            y = F.batch_norm(x.transpose(1, 2), self.running_mean,
                             self.running_var, self.weight, self.bias,
                             training=False, eps=self.eps)
            return y.transpose(1, 2)
        # flax's _compute_stats / _normalize: f32 statistics over (B, T),
        # var = max(E[x^2] - E[x]^2, 0), y = (x - mean) (rsqrt(var + eps)
        # scale) + bias
        xf = x.float()
        mean = xf.mean(dim=(0, 1))
        ex2 = (xf * xf).mean(dim=(0, 1))
        if self.sync_group is not None:
            import torch.distributed as dist
            from torch.distributed.nn.functional import all_reduce

            stats = all_reduce(torch.stack([mean, ex2]),
                               group=self.sync_group)
            stats = stats / dist.get_world_size(self.sync_group)
            mean, ex2 = stats[0], stats[1]
        var = torch.clamp_min(ex2 - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.float())
        return (y + self.bias.float()).to(x.dtype)


@contextlib.contextmanager
def sync_batch_norm(model: nn.Module, group):
    """Within the block, every :class:`BatchNorm` of ``model`` takes its
    training statistics over the ranks of ``group`` (None: this process's
    batch alone)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.sync_group = group
    try:
        yield
    finally:
        for m in norms:
            m.sync_group = None


def dropout(x: torch.Tensor, keep: torch.Tensor | None,
            rate: float) -> torch.Tensor:
    """flax ``nn.Dropout``: ``x / (1 - rate)`` where kept, else 0; no
    mask, or rate 0, leaves ``x`` as it is."""
    if keep is None or rate == 0.0:
        return x
    return torch.where(keep, x / (1.0 - rate), 0.0)


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
        self.dropout_prob = hp.dropout_prob

    def forward(self, x: torch.Tensor, lengths: torch.Tensor | None,
                train: bool = False, keep=None) -> torch.Tensor:
        """``keep``: with ``train``, one bool [B, T, C] dropout keep-mask
        per conv layer (rate ``hp.dropout_prob``)."""
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            x = torch.relu(bn(conv(x), train))
            if train:
                x = dropout(x, keep[i], self.dropout_prob)
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

    def forward(self, mel: torch.Tensor, train: bool = False,
                keep=None) -> torch.Tensor:
        """``keep``: with ``train``, one bool [B, T, C_i] dropout keep-mask
        per conv layer (rate 0.5)."""
        x = mel.transpose(1, 2)
        last = len(self.convs) - 1
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            x = bn(conv(x), train)
            if i != last:
                x = torch.tanh(x)
            if train:
                x = dropout(x, keep[i], 0.5)
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


# the carry's tensors: DecoderState's seven, the frame, the stop flags
_CARRY = len(DecoderState._fields) + 2
# the step axis of run_steps' mel, gate, align and active
_STEP_DIMS = (2, 1, 1, 1)


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
        self._graphs = cuda_graphs.GraphCache("taco.graph_captures")

    def initial_state(self, memory: torch.Tensor) -> DecoderState:
        hp = self.hp
        B, T_in, _ = memory.shape
        z = lambda *s: memory.new_zeros(s)  # noqa: E731
        return DecoderState(
            z(B, hp.attention_rnn_dim), z(B, hp.attention_rnn_dim),
            z(B, hp.decoder_rnn_dim), z(B, hp.decoder_rnn_dim),
            z(B, T_in), z(B, T_in), z(B, hp.enc_conv_channels))

    def step(self, state: DecoderState, prenet_out, memory,
             processed_memory, mask, att_keep=None, dec_keep=None):
        """One decoder step.  ``att_keep`` / ``dec_keep`` (training): bool
        dropout keep-masks [B, attention_rnn_dim] / [B, decoder_rnn_dim] of
        the two LSTMs' outputs (``tacotron2.py:284-302``)."""
        hp = self.hp
        att_h, att_c = self.attention_rnn(
            (state.attention_h, state.attention_c),
            torch.cat([prenet_out, state.attention_context], -1))
        att_h = dropout(att_h, att_keep, hp.p_attention_dropout)
        weights_cat = torch.stack(
            [state.attention_weights, state.attention_weights_cum], dim=-1)
        context, weights = self.attention(att_h, memory, processed_memory,
                                          weights_cat, mask)
        dec_h, dec_c = self.decoder_rnn(
            (state.decoder_h, state.decoder_c),
            torch.cat([att_h, context], -1))
        dec_h = dropout(dec_h, dec_keep, hp.p_decoder_dropout)
        proj_in = torch.cat([dec_h, context], -1)
        mel_frame = self.mel_proj(proj_in)
        gate = self.gate_proj(proj_in)[..., 0]
        new = DecoderState(att_h, att_c, dec_h, dec_c, weights,
                           state.attention_weights_cum + weights, context)
        return new, (mel_frame, gate, weights)

    def forward(self, *args):
        """:meth:`step`: what ``torch.func.functional_call`` runs."""
        return self.step(*args)

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
        for bit.

        Where ``cuda_graphs.usable`` allows (on the card, autograd off),
        the steps run as replays of a CUDA graph of :meth:`run_steps_eager`
        over a block of :data:`MASK_BLOCK` steps (a shorter tail is a graph
        of its own): the same kernels in the same order, so the results
        equal the eager loop's bit for bit.  The carry stays in the graph's
        static inputs from one block to the next."""
        tensors = [keep_masks, *carry[0], *carry[1:], memory,
                   processed_memory] + ([] if mask is None else [mask])
        if not cuda_graphs.usable(*tensors):
            return self.run_steps_eager(carry, keep_masks, memory,
                                        processed_memory, mask)
        T = keep_masks.shape[0]
        full, tail = divmod(T, MASK_BLOCK)
        runs = ([(MASK_BLOCK, range(0, full * MASK_BLOCK, MASK_BLOCK))]
                if full else [])
        if tail:
            runs.append((tail, [full * MASK_BLOCK]))
        carry_in = tensors[1:_CARRY + 1]
        outs = None
        for n, starts in runs:
            tensors[0] = keep_masks[:n]
            tensors[1:_CARRY + 1] = carry_in
            graph = self._graphs.get(cuda_graphs.graph_key(self, tensors),
                                     self._graphed_block, tensors)
            with graph.lock:
                for i, t0 in enumerate(starts):
                    block = graph.replay(*([keep_masks[t0:t0 + n]]
                                           + (tensors[1:] if i == 0 else [])))
                    if outs is None:
                        outs = [o.new_empty(o.shape[:d] + (T,)
                                            + o.shape[d + 1:])
                                for o, d in zip(block, _STEP_DIMS)]
                    for out, o, d in zip(outs, block, _STEP_DIMS):
                        out.narrow(d, t0, n).copy_(o)
                carry_in = [t.clone() for t in graph.inputs[1:_CARRY + 1]]
        count("taco.graph_replays", full + (tail > 0))
        state = DecoderState(*carry_in[:-2])
        return ((state, carry_in[-2], carry_in[-1]), *outs)

    def _graphed_block(self, keep_masks, *tensors):
        """:meth:`run_steps_eager` over static inputs (``keep_masks``, the
        carry's tensors, memory, processed memory, then the mask if any)
        that leaves the new carry in the carry's inputs -> (mel, gate,
        align, active)."""
        carry_in = tensors[:_CARRY]
        memory, processed_memory = tensors[_CARRY:_CARRY + 2]
        mask = tensors[_CARRY + 2] if len(tensors) > _CARRY + 2 else None
        carry = (DecoderState(*carry_in[:-2]), carry_in[-2], carry_in[-1])
        (state, frame, finished), *outs = self.run_steps_eager(
            carry, keep_masks, memory, processed_memory, mask)
        for static, t in zip(carry_in, (*state, frame, finished)):
            static.copy_(t)
        return outs

    def run_steps_eager(self, carry, keep_masks: torch.Tensor, memory,
                        processed_memory, mask):
        """:meth:`run_steps` as a Python loop of steps, each kernel
        launched from the host."""
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

    def teacher_forced(self, memory: torch.Tensor, mels: torch.Tensor,
                       memory_lengths: torch.Tensor, masks: "TrainMasks",
                       train: bool = True, remat: bool = False):
        """All steps with the ground-truth frames as inputs
        (``tacotron2.py:313``): a go frame, then the targets shifted by one;
        the prenet over every frame at once (its keep-masks
        ``masks.prenet`` [2, B, T_out, prenet_dim]), then ``step`` per
        frame with the attention and decoder LSTM dropout of
        ``masks.attention`` [T_out, B, attention_rnn_dim] and
        ``masks.decoder`` [T_out, B, decoder_rnn_dim] when ``train``.
        ``remat`` recomputes each step in the backward pass.  -> (mel
        [B, n_mel, T_out], gate [B, T_out], align [B, T_out, T_in])."""
        B, n_mel, T_out = mels.shape
        mask = sequence_mask(memory_lengths.to(memory.device),
                             memory.shape[1])
        processed_memory = self.attention.process_memory(memory)
        go = mels.new_zeros((B, 1, n_mel))
        frames_in = torch.cat([go, mels.transpose(1, 2)[:, :-1]], 1)
        prenet_out = self.prenet(frames_in, masks.prenet)
        low = _low_precision_copies(self, memory.device)

        def one_step(state, pre, att_keep, dec_keep):
            args = (state, pre, memory, processed_memory, mask, att_keep,
                    dec_keep)
            if low is None:
                return self.step(*args)
            return torch.func.functional_call(
                self, {n: _SharedCast.apply(p, w) for n, (p, w)
                       in low.items()}, args)

        state = self.initial_state(memory)
        mels_out, gates, aligns = [], [], []
        for t in range(T_out):
            keeps = ((masks.attention[t], masks.decoder[t]) if train
                     else (None, None))
            if remat:
                state, (frame, gate, weights) = checkpoint(
                    one_step, state, prenet_out[:, t], *keeps,
                    use_reentrant=False)
            else:
                state, (frame, gate, weights) = one_step(
                    state, prenet_out[:, t], *keeps)
            mels_out.append(frame)
            gates.append(gate)
            aligns.append(weights)
        return (torch.stack(mels_out, 2), torch.stack(gates, 1),
                torch.stack(aligns, 1))

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


class _SharedCast(torch.autograd.Function):
    """``w_low``, the low-precision copy of parameter ``w`` that every
    teacher-forced step uses; each use sends its gradient back to ``w`` in
    f32.  So the steps' gradients are summed in f32, as the JAX package's
    scan sums them, and the copy is stored once for the backward pass.
    autocast's cached cast would sum them in bf16; its uncached casts would
    keep one copy per step."""

    @staticmethod
    def forward(ctx, w, w_low):
        return w_low.view_as(w_low)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(torch.float32), None


def _low_precision_copies(decoder: Decoder, device: torch.device):
    """{name: (parameter, its copy in the autocast type)} of the decoder
    step's parameters, or None outside a low-precision autocast."""
    if not torch.is_autocast_enabled(device.type):
        return None
    dtype = torch.get_autocast_dtype(device.type)
    return {n: (p, p.detach().to(dtype))
            for n, p in decoder.named_parameters()
            if not n.startswith("prenet.")}


class TrainMasks(NamedTuple):
    """Dropout keep-masks of one teacher-forced forward (bool): ``encoder``
    one [B, T_in, enc_conv_channels] per conv layer; ``prenet`` [2, B,
    T_out, prenet_dim]; ``attention`` [T_out, B, attention_rnn_dim];
    ``decoder`` [T_out, B, decoder_rnn_dim]; ``postnet`` one [B, T_out,
    C_i] per conv layer."""

    encoder: list
    prenet: torch.Tensor
    attention: torch.Tensor
    decoder: torch.Tensor
    postnet: list

    def rows(self, block: slice) -> "TrainMasks":
        """The masks of the batch rows ``block``."""
        return TrainMasks([m[block] for m in self.encoder],
                          self.prenet[:, block], self.attention[:, block],
                          self.decoder[:, block],
                          [m[block] for m in self.postnet])


class Tacotron2(nn.Module):
    """Tacotron-2.  ``num_speakers > 1`` adds additive speaker conditioning
    of the encoder memory.  ``compute_dtype`` (None or ``torch.bfloat16``)
    sets the products' type, ``decoder_remat`` the teacher-forced decoder's
    recomputation in the backward pass."""

    def __init__(self, hp: HParams, n_vocab: int = 80, num_speakers: int = 1,
                 device=None, compute_dtype: torch.dtype | None = None,
                 decoder_remat: bool = False):
        super().__init__()
        self.hp = hp
        self.num_speakers = num_speakers
        self.compute_dtype = compute_dtype
        self.decoder_remat = decoder_remat
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

    def _autocast(self, device: torch.device):
        """bf16 products under ``compute_dtype``; a no-op without it.  The
        weight casts are not cached: a cached cast is one node that every
        step of an LSTM loop shares, so its gradient would be summed over
        the steps in bf16; uncached, each step's cast sends an f32 gradient
        to the parameter.  The teacher-forced decoder steps take their
        weights from :class:`_SharedCast` instead, which sums in f32 too
        but keeps one copy for all steps."""
        if self.compute_dtype in (None, torch.float32):
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=self.compute_dtype,
                              cache_enabled=False)

    def condition_on_speaker(self, encoder_out: torch.Tensor,
                             speaker_ids: torch.Tensor | None):
        """encoder_out + speaker_proj(softsign(embed(id))), broadcast over
        time (``tacotron2.py:460-469``)."""
        if speaker_ids is None or self.num_speakers <= 1:
            return encoder_out
        # f32 whatever the compute type, as the JAX modules (no dtype)
        with torch.autocast(encoder_out.device.type, enabled=False):
            s = F.softsign(self.speaker_embedding(speaker_ids))
            return encoder_out + self.speaker_proj(s)[:, None, :]

    def encode(self, text_ids, speaker_ids=None, text_lengths=None,
               train: bool = False, keep=None):
        out = self.encoder(self.embedding(text_ids), text_lengths, train,
                           keep)
        return self.condition_on_speaker(out, speaker_ids)

    def draw_train_masks(self, batch: int, t_in: int, t_out: int,
                         generator: torch.Generator | None = None,
                         device=None) -> TrainMasks:
        """Dropout keep-masks of one teacher-forced forward, drawn on the
        generator's device in a fixed order (encoder, prenet, attention,
        decoder, postnet) and moved to ``device``."""
        hp = self.hp
        gdev = generator.device if generator is not None else device

        def keep(rate, *shape):
            return (torch.rand(shape, generator=generator, device=gdev)
                    < 1.0 - rate).to(device)

        post = ([hp.postnet_embedding_dim] * (hp.postnet_n_convolutions - 1)
                + [hp.n_mel_channels])
        return TrainMasks(
            [keep(hp.dropout_prob, batch, t_in, hp.enc_conv_channels)
             for _ in range(hp.enc_conv_num_layers)],
            keep(0.5, 2, batch, t_out, hp.prenet_dim),
            keep(hp.p_attention_dropout, t_out, batch, hp.attention_rnn_dim),
            keep(hp.p_decoder_dropout, t_out, batch, hp.decoder_rnn_dim),
            [keep(0.5, batch, t_out, c) for c in post])

    def forward(self, text_ids: torch.Tensor, text_lengths: torch.Tensor,
                mels: torch.Tensor, output_lengths: torch.Tensor,
                speaker_ids: torch.Tensor | None = None, train: bool = True,
                masks: TrainMasks | None = None,
                generator: torch.Generator | None = None):
        """Teacher-forced forward (``tacotron2.py:471 __call__``): text
        [B, T_in], mels [B, n_mel, T_out] -> (mel_out, mel_post, gate_out,
        align), f32, masked past ``output_lengths`` when
        ``hp.mask_padding`` (mels 0, gate 1e3).  ``train`` turns on batch
        statistics (the running ones are updated) and every dropout; the
        prenet always drops.  ``masks`` (:class:`TrainMasks`) or, when it
        is None, masks drawn from ``generator``."""
        if masks is None:
            masks = self.draw_train_masks(text_ids.shape[0],
                                          text_ids.shape[1], mels.shape[-1],
                                          generator, mels.device)
        with self._autocast(mels.device):
            memory = self.encode(text_ids, speaker_ids, text_lengths, train,
                                 masks.encoder)
            mel_out, gate_out, align = self.decoder.teacher_forced(
                memory, mels, text_lengths, masks, train,
                self.decoder_remat)
            mel_post = mel_out + self.postnet(mel_out, train, masks.postnet)
        mel_out, mel_post = mel_out.float(), mel_post.float()
        gate_out, align = gate_out.float(), align.float()
        if self.hp.mask_padding:
            mel_out, mel_post, gate_out = mask_outputs(
                mel_out, mel_post, gate_out, output_lengths)
        return mel_out, mel_post, gate_out, align

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
        with annotate("taco.decoder"):
            carry, mel, gate, align, active = self.decoder.run_steps(
                (state, frame, finished), keep_masks, memory,
                self.process_memory(memory), mask)
            count("taco.decoder_steps", keep_masks.shape[0])
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
        with self._autocast(text_ids.device):
            with annotate("taco.encoder"):
                memory = self.encode(text_ids, speaker_ids, text_lengths)
            with annotate("taco.decoder"):
                mel_out, gate_out, align, out_lengths = \
                    self.decoder.autoregressive(memory, text_lengths,
                                                max_steps, keep_masks,
                                                generator)
                count("taco.decoder_steps", mel_out.shape[2])
            with annotate("taco.postnet"):
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


@torch.no_grad()
def init_weights_(model: Tacotron2, generator: torch.Generator) -> Tacotron2:
    """Initialise every parameter in place as the JAX package's ``init``
    draws its kind (other numbers, the same distributions): convs
    Xavier-uniform, dense kernels LeCun truncated-normal, biases zero,
    BatchNorm scale 1 / bias 0 / running mean 0 / var 1, the character
    embedding uniform in +-sqrt(3) sqrt(2 / (n_vocab + embedding_size))
    (``tacotron2.py:429-435``), the speaker embedding normal with variance
    1 / features.  Returns ``model``."""
    def fill(p, t):
        p.copy_(t.to(p.device))

    def rand(*shape):
        return torch.rand(shape, generator=generator,
                          device=generator.device)

    for m in model.modules():
        if isinstance(m, nn.Conv1d):
            out, cin, k = m.weight.shape
            limit = (6.0 / ((cin + out) * k)) ** 0.5
            fill(m.weight, (rand(*m.weight.shape) * 2 - 1) * limit)
        elif isinstance(m, nn.Linear):
            fan_in = m.weight.shape[1]
            std = fan_in ** -0.5 / 0.87962566103423978
            w = torch.empty(m.weight.shape, device=generator.device)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            fill(m.weight, w)
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.running_var.fill_(1.0)
            m.running_mean.zero_()
            m.bias.zero_()
            continue
        elif isinstance(m, nn.Embedding):
            n, f = m.weight.shape
            if m is model.embedding:
                val = 3.0 ** 0.5 * (2.0 / (n + f)) ** 0.5
                fill(m.weight, (rand(n, f) * 2 - 1) * val)
            else:
                fill(m.weight, torch.randn((n, f), generator=generator,
                                           device=generator.device)
                     * f ** -0.5)
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()
    return model
