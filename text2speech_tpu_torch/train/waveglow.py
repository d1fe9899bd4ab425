"""WaveGlow training loop on one GPU (counterpart of
``text2speech_tpu/train/waveglow.py``).  The data-parallel ``mesh=``
argument waits for the multi-GPU slice."""

from __future__ import annotations

import time
from collections import deque

import torch

from ..config import WaveGlowConfig
from ..data.mel2samp import Mel2Samp, VocoderBatch, files_to_list
from ..data.prefetch import prefetch
from ..models.losses import waveglow_loss
from ..models.waveglow import TrainableWaveGlow
from ..utils import infolog
from ..utils.logger import MetricsLogger
from .checkpoint import CheckpointManager
from .state import (TrainState, create_train_state, global_norm,
                    microbatch_split)

log = infolog.log


def make_wg_train_step(model: TrainableWaveGlow, sigma: float,
                       grad_accum: int = 1):
    """One optimizer step: ``train_step(state, batch) -> (state, {"loss",
    "grad_norm"})``; ``state`` (over ``model``'s parameters) is updated in
    place.  ``grad_accum > 1`` splits the batch into that many strided
    microbatches and accumulates their gradients one after the other:
    activation memory is one microbatch's, and because the loss is a
    per-element mean over equal-sized microbatches the averaged gradients
    equal the full-batch step's."""

    def loss_fn(mel, audio):
        z, log_s, log_det = model(mel, audio)
        return waveglow_loss(z, log_s, log_det, sigma)

    def train_step(state: TrainState, batch: VocoderBatch):
        state.opt.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss = loss_fn(batch.mel, batch.audio)
            loss.backward()
            loss = loss.detach()
        else:
            B = batch.mel.shape[0]
            if B % grad_accum:
                raise ValueError(
                    f"batch {B} not divisible by grad_accum {grad_accum}")
            losses = []
            for mel, audio in zip(microbatch_split(batch.mel, grad_accum),
                                  microbatch_split(batch.audio, grad_accum)):
                mb_loss = loss_fn(mel, audio)
                mb_loss.backward()           # sums into .grad
                losses.append(mb_loss.detach())
            for p in state.params.values():
                p.grad.div_(grad_accum)
            loss = torch.stack(losses).mean()
        grad_norm = global_norm(p.grad for p in state.params.values())
        state.apply_gradients()
        return state, {"loss": loss, "grad_norm": grad_norm}

    return train_step


class WaveGlowTrainer:
    """``remat`` recomputes each flow's WN in the backward pass (same
    gradients, less activation memory, one more forward); ``bf16`` runs
    the upsample and WN products in bf16 with f32 parameters and f32 loss
    accumulation.  f32 stays f32: TF32 is turned off for matmuls and
    convolutions."""

    def __init__(self, cfg: WaveGlowConfig, training_files: str,
                 output_directory: str, remat: bool = False,
                 grad_accum: int = 1, bf16: bool = False,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if cfg.batch_size % grad_accum:
            raise ValueError(f"batch {cfg.batch_size} not divisible by "
                             f"grad_accum {grad_accum}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"WaveGlow trainer on {self.device}: compute dtype "
            f"{'bf16' if bf16 else 'f32'}, remat={remat}, "
            f"grad_accum={grad_accum}; allow_tf32 matmul="
            f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
            f"{torch.backends.cudnn.allow_tf32}")
        self.dataset = Mel2Samp(files_to_list(training_files), cfg,
                                shuffle_seed=cfg.seed, device=self.device)
        self.model = TrainableWaveGlow(
            cfg, compute_dtype=torch.bfloat16 if bf16 else torch.float32,
            remat=remat, generator=torch.Generator().manual_seed(cfg.seed),
            device=self.device)
        self.state = create_train_state(self.model.params, cfg.learning_rate)
        self._train_step = make_wg_train_step(self.model, cfg.sigma,
                                              grad_accum=grad_accum)
        self.ckpt = CheckpointManager(output_directory)
        self.logger = MetricsLogger(f"{output_directory}/tb")
        # (step, metrics) of the newest steps, as device scalars: reading
        # them waits for the device, appending does not
        self.recent: deque = deque(maxlen=64)

    def restore(self) -> int:
        self.state, step = self.ckpt.restore(self.state)
        if step:
            log(f"Resumed WaveGlow from step {step}")
        return step

    def fit(self, num_steps: int, log_every: int = 10) -> None:
        """Run training to ``num_steps``; on KeyboardInterrupt the current
        step is checkpointed before the interrupt is passed on."""
        try:
            self._fit(num_steps, log_every)
        except KeyboardInterrupt:
            log(f"interrupted at step {self.state.step}; saving checkpoint")
            self.ckpt.save(self.state.step, self.state)
            raise

    def _fit(self, num_steps: int, log_every: int) -> None:
        cfg = self.cfg
        n_batches = len(self.dataset)
        if n_batches == 0:
            raise ValueError(
                f"dataset yields 0 batches "
                f"({len(self.dataset.training_files)} files < batch_size "
                f"{self.dataset.batch_size}): the epoch loop would spin "
                "forever")
        step = self.state.step
        epoch = step // n_batches
        while step < num_steps:
            for batch in prefetch(self.dataset.epoch(epoch,
                                                     step % n_batches)):
                t0 = time.perf_counter()
                self.state, metrics = self._train_step(self.state, batch)
                step = self.state.step
                self.recent.append((step, metrics))
                if step % log_every == 0:
                    # float() waits for the device, so the clock is read
                    # after the step has run, not after it was enqueued
                    loss = float(metrics["loss"])
                    dur = time.perf_counter() - t0
                    log(f"wg step {step} loss={loss:.5f} {dur:.2f}s/it")
                    self.logger.log_training(
                        loss, float(metrics["grad_norm"]),
                        cfg.learning_rate, dur, step)
                if step % cfg.iters_per_checkpoint == 0:
                    self.ckpt.save(step, self.state)
                if step >= num_steps:
                    break
            epoch += 1
        self.ckpt.save(step, self.state)
