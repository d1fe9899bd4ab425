"""LSTM cells and the bidirectional encoder LSTM (counterpart of
``text2speech_tpu/ops/lstm.py``).

Gate order is (i, f, g, o), as in torch and the JAX package.  The gates are
grouped ``(x W_ih + b_ih) + (h W_hh + b_hh)``, the JAX package's order,
which keeps the port's float32 decode close to the reference step by step.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils import cuda_graphs
from ..utils.profiling import count


class LSTMCell(nn.Module):
    """One LSTM step over ``(h, c)``; ``ih``/``hh`` are ``nn.Linear`` layers
    (weights [4H, in] and [4H, H], both with bias)."""

    def __init__(self, input_size: int, hidden: int, device=None):
        super().__init__()
        self.hidden = hidden
        self.ih = nn.Linear(input_size, 4 * hidden, device=device)
        self.hh = nn.Linear(hidden, 4 * hidden, device=device)

    def forward(self, state, x):
        h, c = state
        gates = self.ih(x) + self.hh(h)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, c_new

    def zero_state(self, batch: int, like: torch.Tensor):
        z = like.new_zeros((batch, self.hidden))
        return z, z.clone()


def run_lstm(cell: LSTMCell, xs: torch.Tensor) -> torch.Tensor:
    """Run ``cell`` over the time axis: [B, T, D] -> [B, T, H]."""
    state = cell.zero_state(xs.shape[0], xs)
    ys = []
    for t in range(xs.shape[1]):
        state = cell(state, xs[:, t])
        ys.append(state[0])
    return torch.stack(ys, dim=1)


def reverse_padded(xs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each sequence within its valid length, padding kept at the
    tail (what ``pack_padded_sequence`` gives a backward RNN).
    xs [B, T, D], lengths [B] -> [B, T, D]."""
    T = xs.shape[1]
    t = torch.arange(T, device=xs.device)[None, :]
    lens = lengths.to(xs.device)[:, None]
    idx = torch.where(t < lens, lens - 1 - t, t)
    return torch.gather(xs, 1, idx[:, :, None].expand(-1, -1, xs.shape[2]))


class BiLSTM(nn.Module):
    """Bidirectional LSTM with length-aware reversal: [B, T, D] ->
    [B, T, 2H], positions past each length zeroed.

    Where ``cuda_graphs.usable`` allows (on the card, autograd off), a call
    replays a CUDA graph of :meth:`forward_eager` (both directions, the
    reversal and the mask; ``lengths`` a static input): the same kernels in
    the same order, so the result equals the eager loop's bit for bit."""

    def __init__(self, input_size: int, hidden: int, device=None):
        super().__init__()
        self.fwd = LSTMCell(input_size, hidden, device=device)
        self.bwd = LSTMCell(input_size, hidden, device=device)
        self._graphs = cuda_graphs.GraphCache("taco.graph_captures")

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor | None = None):
        if lengths is not None:
            lengths = lengths.to(xs.device)
        tensors = [xs] if lengths is None else [xs, lengths]
        if not cuda_graphs.usable(*tensors):
            return self.forward_eager(xs, lengths)
        graph = self._graphs.get(cuda_graphs.graph_key(self, tensors),
                                 self.forward_eager, tensors)
        with graph.lock:
            out = graph.replay(*tensors).clone()
        count("taco.graph_replays", 1)
        return out

    def forward_eager(self, xs: torch.Tensor,
                      lengths: torch.Tensor | None = None):
        """:meth:`forward` as two Python loops of steps, each kernel
        launched from the host."""
        fwd = run_lstm(self.fwd, xs)
        if lengths is None:
            bwd = run_lstm(self.bwd, xs.flip(1)).flip(1)
            return torch.cat([fwd, bwd], dim=-1)
        bwd = reverse_padded(
            run_lstm(self.bwd, reverse_padded(xs, lengths)), lengths)
        out = torch.cat([fwd, bwd], dim=-1)
        valid = (torch.arange(xs.shape[1], device=xs.device)[None, :]
                 < lengths.to(xs.device)[:, None])
        return torch.where(valid[..., None], out, 0.0)
