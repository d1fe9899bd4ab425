"""Train state and the pieces of one optimizer step that WaveGlow training
needs (counterpart of ``text2speech_tpu/train/state.py``).

The optimizer is ``torch.optim.Adam(lr)`` with optax's ``adam`` defaults
(b1 0.9, b2 0.999, eps 1e-8 added outside the root), no clipping and no
decay.  ``make_optimizer`` and ``noam_schedule`` wait for Tacotron
training.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import torch


@dataclass
class TrainState:
    """The step counter, the parameters by name and the optimizer that
    holds their moments.  :meth:`apply_gradients` updates it in place."""

    step: int
    params: dict
    opt: torch.optim.Optimizer

    def apply_gradients(self) -> None:
        """One optimizer update from the parameters' ``.grad``."""
        self.opt.step()
        self.step += 1


def create_train_state(model: torch.nn.Module, lr: float) -> TrainState:
    """Step 0, ``model``'s parameters under their own names, and a fresh
    Adam over them."""
    params = dict(model.named_parameters())
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    return TrainState(0, params, opt)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares over every tensor), in f32."""
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2)
                          for t in tensors))


def microbatch_split(x: torch.Tensor, grad_accum: int) -> torch.Tensor:
    """[B, ...] -> [grad_accum, B // grad_accum, ...] with a STRIDED row
    split: microbatch i holds rows ``i::grad_accum``, as the JAX package
    splits (there so that every microbatch spans every data-parallel
    device)."""
    mb = x.shape[0] // grad_accum
    return x.reshape(mb, grad_accum, *x.shape[1:]).transpose(0, 1)
