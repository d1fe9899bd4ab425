"""Train state and optimizers (counterpart of
``text2speech_tpu/train/state.py``).

WaveGlow: ``torch.optim.Adam(lr)`` with optax's ``adam`` defaults (b1 0.9,
b2 0.999, eps 1e-8 added outside the root), no clipping and no decay.

Tacotron (``state.py:115 make_optimizer``): clip the gradients by their
global norm, then Adam with ``weight_decay``, which is optax's
``add_decayed_weights`` BEFORE ``scale_by_adam`` (the decay joins the
gradient ahead of the moments: coupled L2, not AdamW), then the Noam
schedule, set on the parameter groups before each update.  The first
update uses ``schedule(0)``, as optax's ``scale_by_learning_rate`` does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable

import torch


@dataclass
class TrainState:
    """The step counter, the parameters by name, the optimizer that holds
    their moments and, for Tacotron, the BatchNorm running statistics by
    name (updated in place by the training forward), the learning-rate
    schedule and the clipping norm.  :meth:`apply_gradients` updates it in
    place."""

    step: int
    params: dict
    opt: torch.optim.Optimizer
    batch_stats: dict = field(default_factory=dict)
    schedule: Callable[[int], float] | None = None
    clip_norm: float | None = None

    def apply_gradients(self) -> None:
        """One optimizer update from the parameters' ``.grad``: clipped by
        their global norm when :attr:`clip_norm` is set, at the learning
        rate ``schedule(step)`` when :attr:`schedule` is set."""
        if self.clip_norm is not None:
            clip_by_global_norm_([p.grad for p in self.params.values()
                                  if p.grad is not None], self.clip_norm)
        if self.schedule is not None:
            lr = self.schedule(self.step)
            for group in self.opt.param_groups:
                group["lr"] = lr
        self.opt.step()
        self.step += 1


def create_train_state(model: torch.nn.Module, lr: float) -> TrainState:
    """Step 0, ``model``'s parameters under their own names, and a fresh
    Adam over them."""
    params = dict(model.named_parameters())
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    return TrainState(0, params, opt)


def noam_schedule(init_lr: float, warmup_steps: int = 4000):
    """lr(step) = init_lr sqrt(warmup) min((step + 1) warmup^-1.5,
    (step + 1)^-0.5) (``state.py:103``)."""
    w = float(warmup_steps)

    def fn(step: int) -> float:
        s = float(step) + 1.0
        return init_lr * w ** 0.5 * min(s * w ** -1.5, s ** -0.5)

    return fn


def make_optimizer(hp, params: Iterable[torch.Tensor],
                   schedule=None) -> torch.optim.Adam:
    """Adam over ``params`` with ``hp``'s betas, eps 1e-8 and coupled
    weight decay, at the schedule's first rate (the clip and the per-step
    rate are :class:`TrainState`'s)."""
    schedule = schedule or noam_schedule(hp.learning_rate, hp.warmup_steps)
    return torch.optim.Adam(list(params), lr=schedule(0),
                            betas=(hp.adam_beta1, hp.adam_beta2), eps=1e-8,
                            weight_decay=hp.weight_decay)


def create_tacotron_state(model: torch.nn.Module, hp,
                          schedule=None) -> TrainState:
    """Step 0, the model's parameters and BatchNorm running statistics by
    their own names, :func:`make_optimizer` over the parameters, the Noam
    schedule and ``hp.grad_clip_norm``."""
    schedule = schedule or noam_schedule(hp.learning_rate, hp.warmup_steps)
    params = dict(model.named_parameters())
    stats = {n: b for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return TrainState(0, params, make_optimizer(hp, params.values(),
                                                schedule),
                      stats, schedule, hp.grad_clip_norm)


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` when their global
    norm is at least ``max_norm`` (optax ``clip_by_global_norm``; no
    epsilon, no host read).  Returns the norm before clipping."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


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


def check_grad_accum_mesh(batch_size: int, grad_accum: int, mesh) -> None:
    """The microbatches are a strided row split (:func:`microbatch_split`)
    of each rank's contiguous row block (:func:`..parallel.mesh.
    shard_batch`).  With ``B = grad_accum * n * k`` over ``n`` data ranks,
    rank r's local microbatch i is rows ``r B / n + i + grad_accum j``, j <
    k, which are rows ``[r k, (r + 1) k)`` of the global microbatch i (rows
    ``i::grad_accum``): a contiguous slice, so every rank holds an equal
    share of every microbatch and the ranks' microbatch i together are the
    one-process step's.  That needs the microbatch size to be divisible by
    the data-axis size; fail at build time otherwise (``state.py:101``).
    Shared by both trainers."""
    if grad_accum <= 1 or mesh is None:
        return
    data = mesh.size("data")
    mb = batch_size // grad_accum
    if batch_size % grad_accum or mb % data:
        raise ValueError(
            f"batch {batch_size} / grad_accum {grad_accum} = microbatch "
            f"{mb} must be divisible by the data-axis size {data}")
