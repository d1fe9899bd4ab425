"""WaveGlow training loop (counterpart of
``text2speech_tpu/train/waveglow.py``), on one GPU or data-parallel over a
``torch.distributed`` group (``mesh=``, :mod:`..parallel.mesh`): every
rank reads the same global batch and keeps its contiguous row block, one
all-reduce after the last microbatch averages the gradients (and the
loss) over the ranks, and the update runs alike on every rank.  The gated
activation's kernels run in each rank's forward and backward.
Checkpoints and the scalars writer run on rank 0."""

from __future__ import annotations

import time
from collections import deque

import torch

from ..config import WaveGlowConfig
from ..data.mel2samp import Mel2Samp, VocoderBatch, files_to_list
from ..data.prefetch import prefetch
from ..models.losses import waveglow_loss
from ..models.waveglow import TrainableWaveGlow
from ..parallel.mesh import (Mesh, all_reduce_mean_, default_data_mesh,
                             replicate, require_member, shard_batch,
                             trainer_device)
from ..utils import infolog
from ..utils.logger import MetricsLogger
from .checkpoint import CheckpointManager
from .state import (TrainState, check_grad_accum_mesh, create_train_state,
                    global_norm, microbatch_split)

log = infolog.log


def make_wg_train_step(model: TrainableWaveGlow, sigma: float,
                       grad_accum: int = 1, mesh: Mesh | None = None):
    """One optimizer step: ``train_step(state, batch) -> (state, {"loss",
    "grad_norm"})``; ``state`` (over ``model``'s parameters) is updated in
    place.  ``grad_accum > 1`` splits the batch into that many strided
    microbatches and accumulates their gradients one after the other:
    activation memory is one microbatch's, and because the loss is a
    per-element mean over equal-sized microbatches the averaged gradients
    equal the full-batch step's.  ``mesh``: data parallel over its
    ``'data'`` ranks; ``batch`` is the global one, the same on every rank,
    and each rank keeps its rows; the ranks' equal shares make the mean of
    their losses the global batch's."""

    def loss_fn(mel, audio):
        z, log_s, log_det = model(mel, audio)
        return waveglow_loss(z, log_s, log_det, sigma)

    def train_step(state: TrainState, batch: VocoderBatch):
        if mesh is not None:
            check_grad_accum_mesh(batch.mel.shape[0], grad_accum, mesh)
            batch = shard_batch(batch, mesh)
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
        if mesh is not None:
            # the psum XLA inserts: gradients and loss in one all-reduce
            all_reduce_mean_([p.grad for p in state.params.values()]
                             + [loss], mesh)
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
                 device: str | torch.device = "cuda",
                 mesh: Mesh | None = None):
        self.cfg = cfg
        if mesh is None:
            mesh = default_data_mesh(cfg.batch_size)
        if mesh is not None:
            require_member(mesh, cfg.batch_size)
        self.mesh = mesh
        self.chief = mesh is None or mesh.rank() == 0
        self.device = trainer_device(mesh, device)
        if cfg.batch_size % grad_accum:
            raise ValueError(f"batch {cfg.batch_size} not divisible by "
                             f"grad_accum {grad_accum}")
        check_grad_accum_mesh(cfg.batch_size, grad_accum, mesh)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"WaveGlow trainer on {self.device}: compute dtype "
            f"{'bf16' if bf16 else 'f32'}, remat={remat}, "
            f"grad_accum={grad_accum}"
            + ("" if mesh is None else
               f", data rank {mesh.rank()} of {mesh.size()}")
            + "; allow_tf32 matmul="
            f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
            f"{torch.backends.cudnn.allow_tf32}")
        self.dataset = Mel2Samp(files_to_list(training_files), cfg,
                                shuffle_seed=cfg.seed, device=self.device)
        self.model = TrainableWaveGlow(
            cfg, compute_dtype=torch.bfloat16 if bf16 else torch.float32,
            remat=remat, generator=torch.Generator().manual_seed(cfg.seed),
            device=self.device)
        self.state = create_train_state(self.model.params, cfg.learning_rate)
        if mesh is not None:
            replicate(self.state, mesh)
        self._train_step = make_wg_train_step(self.model, cfg.sigma,
                                              grad_accum=grad_accum,
                                              mesh=mesh)
        self.ckpt = CheckpointManager(
            output_directory, group=None if mesh is None else mesh.group())
        self.logger = (MetricsLogger(f"{output_directory}/tb")
                       if self.chief else None)
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
                if step % log_every == 0 and self.chief:
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
