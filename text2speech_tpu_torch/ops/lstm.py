"""LSTM cells and the bidirectional encoder LSTM (counterpart of
``text2speech_tpu/ops/lstm.py``).

Gate order is (i, f, g, o), as in torch and the JAX package.  The gates are
grouped ``(x W_ih + b_ih) + (h W_hh + b_hh)``, the JAX package's order,
which keeps the port's float32 decode close to the reference step by step.
"""

from __future__ import annotations

import torch
from torch import nn


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
    [B, T, 2H], positions past each length zeroed."""

    def __init__(self, input_size: int, hidden: int, device=None):
        super().__init__()
        self.fwd = LSTMCell(input_size, hidden, device=device)
        self.bwd = LSTMCell(input_size, hidden, device=device)

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor | None = None):
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
