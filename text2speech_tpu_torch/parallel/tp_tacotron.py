"""Tensor-parallel Tacotron decode (counterpart of
``text2speech_tpu/parallel/tp_tacotron.py``).

Partitioning, as the JAX package's:

* the four LSTM kernels (``att``/``dec`` x ``ih``/``hh``) are split over
  ``p`` ranks by hidden unit, consistently across the gates: rank i owns
  hidden units ``[i H/p, (i+1) H/p)`` of all four gate blocks (i|f|g|o,
  :func:`_gate_cols`), so it computes its slice of the cell state and of
  the hidden state from the replicated cell input;
* one gather of the hidden state per LSTM per step (two a decode step, B x
  H values) rebuilds the full hidden state the next products need.  The
  cell state ``c`` is never gathered: it stays with its rank;
* the prenet, the location attention, the mel and gate projections and the
  context product are replicated.

The port's kernels are ``[out, in]`` (``models/tacotron_serve.py``), so a
rank's share is a ROW slice of each kernel where the JAX package cuts
columns.  The step body is not duplicated: the sharded cell hangs on
:func:`..models.tacotron_serve.decode_chunk_serve`'s ``lstm_fn`` hook and
keeps the single-device cell's grouping ``(x W_ih + b_ih) + (h W_hh +
b_hh)`` per slice, so each hidden unit sees the same contraction as on one
device.

Where the ranks live follows :class:`.tp.TPWaveGlowServer`.  Without a
group, one process holds all ``n_model`` shards on one device, runs them in
rank order and gathers the hidden state with a ``torch.cat``; the carry's
cell states are then full [B, H] tensors.  With a ``torch.distributed``
group (or the model axis of a :class:`.mesh.Mesh`), a process holds its own
rank's shard, the gather is :func:`.mesh.gather_cols`, and the carry's cell
states are the rank's [B, H/p] slice.  Under a mesh with a ``data`` axis a
rank decodes its row block of the memory, the carry and the keep-masks
(every rank passes the global tensors) and the outputs are gathered back,
so every rank returns the global batch.

On an H100 the decode is bound by its launches, not by the LSTM weights'
bytes (``PERF.md``): splitting the weights over ranks adds launches and
collectives to each step and is no gain on one card.  The module serves the
full-chain tensor-parallel synthesizer (``parallel/serve.py``) and its
server (``server.make_server_tp``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import HParams
from ..models.tacotron2 import DecoderState, Tacotron2
from ..models.tacotron_serve import (_dense, decode_chunk_serve,
                                     extract_decoder_params, lstm_cell_update,
                                     quantize_kernel_int8)
from .mesh import DATA_AXIS, MODEL_AXIS, gather_cols, gather_rows, row_block

F32 = torch.float32

# the four sharded cells: (kernel key, bias key, hidden size attribute)
_LSTM_KEYS = (
    ("att_ih_w", "att_ih_b", "attention_rnn_dim"),
    ("att_hh_w", "att_hh_b", "attention_rnn_dim"),
    ("dec_ih_w", "dec_ih_b", "decoder_rnn_dim"),
    ("dec_hh_w", "dec_hh_b", "decoder_rnn_dim"),
)
_SHARDED = frozenset(k for wk, bk, _ in _LSTM_KEYS for k in (wk, bk))


def _gate_cols(H: int, p: int, i: int) -> np.ndarray:
    """Rows of a [4H, in] LSTM kernel (columns of the JAX package's
    [in, 4H]) owned by rank i: hidden units [i H/p, (i+1) H/p) of each of
    the four gate blocks, in the i|f|g|o order ``lstm_cell_update``
    splits."""
    s = H // p
    return np.concatenate(
        [np.arange(g * H + i * s, g * H + (i + 1) * s) for g in range(4)])


@torch.no_grad()
def shard_decoder_params(dp: dict, hp: HParams, n_model: int,
                         int8: bool = False, ranks=None) -> dict:
    """Split the four LSTM kernels and biases of a serving dict
    (:func:`..models.tacotron_serve.extract_decoder_params`) into
    gate-consistent row slices with a leading axis over ``ranks`` (default:
    all ``n_model``): kernels [R, 4H/p, in], biases [R, 4H/p].  Every other
    weight stays whole (the same tensors).

    ``int8``: each rank's kernel slice is quantized per output channel by
    :func:`..models.tacotron_serve.quantize_kernel_int8` into ``{"q": int8
    [R, 4H/p, in], "s": f32 [R, 4H/p]}``.  Slicing keeps each output
    channel's amax, so the scales equal the rows of the whole kernel's."""
    p = n_model
    ranks = list(range(p)) if ranks is None else list(ranks)
    if any(not 0 <= i < p for i in ranks):
        raise ValueError(f"ranks {ranks} outside [0, {p})")
    out = dict(dp)
    for wk, bk, dim in _LSTM_KEYS:
        H = getattr(hp, dim)
        if p < 1 or H % p:
            raise ValueError(f"{dim} {H} does not split {p} ways")
        w, b = dp[wk].detach(), dp[bk].detach()
        rows = [torch.from_numpy(_gate_cols(H, p, i)).to(w.device)
                for i in ranks]
        ws = [w.index_select(0, r) for r in rows]
        if int8:
            qd = [quantize_kernel_int8(x) for x in ws]
            out[wk] = {"q": torch.stack([d["q"] for d in qd]),
                       "s": torch.stack([d["s"] for d in qd])}
        else:
            out[wk] = torch.stack(ws)
        out[bk] = torch.stack([b.index_select(0, r) for r in rows])
    return out


def _take(entry, j: int):
    if isinstance(entry, dict):
        return {k: v[j] for k, v in entry.items()}
    return entry[j]


def _cast(entry, dtype):
    """A serving weight in the compute type, once (int8 payloads stay)."""
    if isinstance(entry, dict) or not entry.is_floating_point():
        return entry
    return entry.detach().to(dtype)


class TPTacotronDecoder:
    """Build-once tensor-parallel decode endpoint (``tp_tacotron.py:151
    TPTacotronDecoder``).

    ``dp_or_taco``: a :class:`..models.tacotron2.Tacotron2` or its serving
    dict.  ``n_model`` ranks without a ``group``: all shards on the
    weights' device.  With ``group``: ``n_model`` is its size and this
    process holds its own rank's shard.  With ``mesh`` (a
    :class:`.mesh.Mesh` with a ``model`` axis, and maybe a ``data`` axis):
    the model group is the mesh's, and a rank decodes its row block of the
    batch.  ``int8`` quantizes the four LSTM slices; ``dtype`` is the
    products' type (:func:`..models.tacotron_serve.decode_chunk_serve`'s).

    A call has ``decode_chunk_serve``'s signature without the dict:
    ``(memory, processed_memory, state, frame, finished, keep_masks
    [n, 2, B, prenet_dim], text_lengths) -> ((state, frame, finished), mel
    [B, n_mel, n], gate, align, active)``; the returned carry feeds the
    next call.  Under a group every rank must pass the same tensors (and
    its own cell-state slices)."""

    def __init__(self, dp_or_taco, hp: HParams, n_model: int | None = None,
                 group=None, mesh=None, int8: bool = False,
                 dtype: torch.dtype = F32):
        dp = (extract_decoder_params(dp_or_taco)
              if isinstance(dp_or_taco, Tacotron2) else dp_or_taco)
        self.hp, self.int8, self.dtype = hp, int8, dtype
        self.mesh = mesh
        if mesh is not None:
            if group is not None:
                raise ValueError("give a process group or a mesh, not both")
            group = mesh.group(MODEL_AXIS)
        self.group = group
        if group is not None:
            size = dist.get_world_size(group)
            if n_model not in (None, size):
                raise ValueError(f"n_model {n_model} but the group has "
                                 f"{size} ranks")
            self.n_model = size
            self.ranks = [dist.get_rank(group)]
        else:
            if n_model is None:
                raise ValueError("give n_model or a process group")
            self.n_model = n_model
            self.ranks = list(range(n_model))
        self.params = shard_decoder_params(dp, hp, self.n_model, int8,
                                           self.ranks)
        common = {k: _cast(v, dtype) for k, v in self.params.items()
                  if k not in _SHARDED}
        # one serving dict per held shard; the replicated weights shared
        self._shards = [
            {**common, **{k: _cast(_take(self.params[k], j), dtype)
                          for k in _SHARDED}}
            for j in range(len(self.ranks))]
        self._data = (mesh is not None and mesh.size(DATA_AXIS) > 1)

    def _lstm_fn(self, kind: str, h: torch.Tensor, c: torch.Tensor,
                 x: torch.Tensor):
        """The sharded cell: per held shard the local gates (all four, its
        hidden units) and the cell update on its slice of ``c``; then the
        hidden state gathered.  ``c`` stays local."""
        dt = self.dtype
        s = c.shape[-1] // len(self._shards)
        hs, cs = [], []
        for j, sh in enumerate(self._shards):
            # the single-device cell's grouping, per slice: (x W_ih + b_ih)
            # + (h W_hh + b_hh)
            gates = (_dense(x, sh[kind + "_ih_w"], sh[kind + "_ih_b"], dt)
                     + _dense(h, sh[kind + "_hh_w"], sh[kind + "_hh_b"], dt))
            h_j, c_j = lstm_cell_update(gates, c[..., j * s:(j + 1) * s])
            hs.append(h_j)
            cs.append(c_j)
        h_loc = hs[0] if len(hs) == 1 else torch.cat(hs, -1)
        c_new = cs[0] if len(cs) == 1 else torch.cat(cs, -1)
        if self.group is not None:
            h_loc = gather_cols(h_loc, self.group)
        return h_loc, c_new

    @torch.no_grad()
    def __call__(self, memory: torch.Tensor, processed_memory: torch.Tensor,
                 state: DecoderState, frame: torch.Tensor,
                 finished: torch.Tensor, keep_masks: torch.Tensor,
                 text_lengths: torch.Tensor | None = None):
        B = memory.shape[0]
        if text_lengths is None:
            text_lengths = torch.full((B,), memory.shape[1],
                                      dtype=torch.long, device=memory.device)
        state = DecoderState(*state)
        if self._data:      # this rank's row block of every batch tensor
            rows = row_block(B, self.mesh, DATA_AXIS)
            memory, processed_memory = memory[rows], processed_memory[rows]
            state = DecoderState(*(t[rows] for t in state))
            frame, finished = frame[rows], finished[rows]
            keep_masks, text_lengths = keep_masks[:, :, rows], \
                text_lengths[rows]
        (st, fr, fin), mel, gate, align, active = decode_chunk_serve(
            self._shards[0], self.hp, memory, processed_memory, state, frame,
            finished, keep_masks, text_lengths, dtype=self.dtype,
            lstm_fn=self._lstm_fn)
        if self._data:
            def g(t):
                return gather_rows(t, self.mesh, DATA_AXIS)

            st = DecoderState(*(g(t) for t in st))
            fr, fin = g(fr), g(fin)
            mel, gate, align, active = g(mel), g(gate), g(align), g(active)
        return (st, fr, fin), mel, gate, align, active

    def initial_state(self, memory: torch.Tensor) -> DecoderState:
        """The zero carry's state for ``memory``'s batch, in its type: the
        cell states as wide as the shards this process holds."""
        hp = self.hp
        B, T_in, E = memory.shape
        held = len(self.ranks)

        def z(*s):
            return memory.new_zeros(s)

        return DecoderState(
            z(B, hp.attention_rnn_dim),
            z(B, hp.attention_rnn_dim * held // self.n_model),
            z(B, hp.decoder_rnn_dim),
            z(B, hp.decoder_rnn_dim * held // self.n_model),
            z(B, T_in), z(B, T_in), z(B, E))

    def initial_carry(self, memory: torch.Tensor):
        """(zero state, zero go-frame, nobody finished)."""
        B = memory.shape[0]
        return (self.initial_state(memory),
                memory.new_zeros((B, self.hp.n_mel_channels)),
                torch.zeros((B,), dtype=torch.bool, device=memory.device))
