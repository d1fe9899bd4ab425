"""Tacotron-2 training loop (counterpart of
``text2speech_tpu/train/tacotron.py``), on one GPU or data-parallel over a
``torch.distributed`` group (``mesh=``, :mod:`..parallel.mesh`).

Data parallelism does explicitly what XLA does for the JAX package under
jit over a batch sharded on ``'data'``: every rank reads the same global
batch (padded to the global lengths) and keeps its contiguous row block;
the dropout masks of each microbatch are drawn at the global microbatch's
shape and each rank takes its rows; BatchNorm's statistics are the global
microbatch's (:func:`..models.tacotron2.sync_batch_norm`); after the last
microbatch one all-reduce averages the gradients (and the metrics) over
the ranks; then the clip and the update run alike on every rank.  The
step's numbers are the one-process step's on the global batch, up to the
order of the sums.  Checkpoints, the scalars writer and validation run on
rank 0.

Determinism: the dropout masks of step ``s`` come from a generator seeded
from ``(hp.seed, s)`` (:func:`step_generator`; the JAX package folds ``s``
into its key), and the data order is a function of (seed, epoch), so a
resumed run takes the uninterrupted run's steps.  As in the JAX package,
gradients are clipped before the update and training runs whatever the
speaker count.
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np
import torch

from ..config import HParams
from ..data.dataset import Batch, TextMelDataset
from ..data.prefetch import prefetch
from ..models.losses import tacotron2_loss
from ..models.tacotron2 import (Tacotron2, TrainMasks, init_weights_,
                                sync_batch_norm)
from ..parallel.mesh import (Mesh, all_reduce_mean_, default_data_mesh,
                             replicate, require_member, row_block,
                             shard_batch, trainer_device)
from ..text import N_SYMBOLS
from ..utils import infolog
from ..utils.logger import MetricsLogger
from ..utils.run_dirs import ValueWindow
from .checkpoint import CheckpointManager
from .state import (TrainState, check_grad_accum_mesh,
                    create_tacotron_state, global_norm, microbatch_split)

log = infolog.log


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s dropout masks."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def _forward(model: Tacotron2, b: Batch, train: bool, masks, generator):
    return model(b.text, b.input_lengths, b.mel, b.output_lengths,
                 speaker_ids=b.speaker_id, train=train, masks=masks,
                 generator=generator)


def make_train_step(model: Tacotron2, hp: HParams, grad_accum: int = 1,
                    mesh: Mesh | None = None):
    """One optimizer step: ``train_step(state, batch, generator=None,
    masks=None) -> (state, {"loss", "mel_loss", "gate_loss",
    "grad_norm"})``, ``state`` updated in place.  ``masks``: one
    :class:`TrainMasks` per microbatch (a list, or one for
    ``grad_accum == 1``), else drawn from ``generator`` in microbatch
    order.  ``grad_accum > 1`` splits the batch into strided microbatches
    (rows ``i::grad_accum``); their gradients, all taken at the same
    parameters, are averaged; each normalizes by its own batch statistics
    and the running statistics thread through them in order; one update
    (``tacotron.py:215``).

    ``mesh``: data parallel over its ``'data'`` ranks.  ``batch`` and
    ``masks`` are then the GLOBAL ones, the same on every rank (masks at
    the global microbatch's shape); each rank keeps its rows
    (:func:`..train.state.check_grad_accum_mesh` says why a rank's
    microbatch i is a row block of the global microbatch i)."""
    group = None if mesh is None else mesh.group()

    def train_step(state: TrainState, batch: Batch, generator=None,
                   masks=None):
        B = batch.text.shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} not divisible by grad_accum "
                             f"{grad_accum}")
        if isinstance(masks, TrainMasks):
            masks = [masks]
        if mesh is not None:
            check_grad_accum_mesh(B, grad_accum, mesh)
            batch = shard_batch(batch, mesh)
            block = row_block(B // grad_accum, mesh)
        micro = ([batch] if grad_accum == 1 else
                 [Batch(*(microbatch_split(x, grad_accum)[i] for x in batch))
                  for i in range(grad_accum)])
        state.opt.zero_grad(set_to_none=True)
        metrics = []
        for i, mb in enumerate(micro):
            m_i = None if masks is None else masks[i]
            if mesh is not None:
                if m_i is None:
                    m_i = model.draw_train_masks(
                        B // grad_accum, mb.text.shape[1], mb.mel.shape[-1],
                        generator, mb.mel.device)
                m_i = m_i.rows(block)
            with sync_batch_norm(model, group):
                mel_out, mel_post, gate_out, _ = _forward(
                    model, mb, True, m_i, generator)
                loss, m = tacotron2_loss(mel_out, mel_post, gate_out, mb.mel,
                                         mb.gate)
                loss.backward()               # sums into .grad
            metrics.append({k: v.detach() for k, v in m.items()})
        if grad_accum > 1:
            for p in state.params.values():
                p.grad.div_(grad_accum)
        out = {k: torch.stack([m[k] for m in metrics]).mean()
               for k in metrics[0]}
        if mesh is not None:
            # the psum XLA inserts: gradients and metrics in one all-reduce
            all_reduce_mean_([p.grad for p in state.params.values()]
                             + list(out.values()), mesh)
        out["grad_norm"] = global_norm(p.grad for p in state.params.values())
        state.apply_gradients()
        return state, out

    return train_step


def make_eval_step(model: Tacotron2):
    """``eval_step(batch, generator) -> (metrics, (mel_out, mel_post,
    gate_out, align))``: running statistics, no dropout but the prenet's."""

    @torch.no_grad()
    def eval_step(batch: Batch, generator=None):
        preds = _forward(model, batch, False, None, generator)
        _, metrics = tacotron2_loss(*preds[:3], batch.mel, batch.gate)
        return metrics, preds

    return eval_step


class TacotronTrainer:
    """``remat`` recomputes each teacher-forced decoder step in the backward
    pass (same gradients, one step's activations kept); ``bf16`` runs the
    products in bf16 with f32 parameters and f32 loss accumulation;
    ``grad_accum`` splits each batch into that many microbatches.  f32
    stays f32: TF32 is turned off for matmuls and convolutions."""

    def __init__(self, hp: HParams, data_dirs, run_dir: str,
                 checkpoint_dir: str | None = None,
                 logger_dir: str | None = None,
                 num_test_per_speaker: int = 0,
                 skip_path_filter: bool = False, data_format: str = "auto",
                 remat: bool = False, grad_accum: int = 1, bf16: bool = False,
                 device: str | torch.device = "cuda",
                 mesh: Mesh | None = None):
        self.hp = hp
        self.run_dir = run_dir
        if mesh is None:
            mesh = default_data_mesh(hp.batch_size)
        if mesh is not None:
            require_member(mesh, hp.batch_size)
        self.mesh = mesh
        self.chief = mesh is None or mesh.rank() == 0
        self.device = trainer_device(mesh, device)
        if hp.batch_size % grad_accum:
            raise ValueError(f"batch {hp.batch_size} not divisible by "
                             f"grad_accum {grad_accum}")
        check_grad_accum_mesh(hp.batch_size, grad_accum, mesh)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"Tacotron trainer on {self.device}: compute dtype "
            f"{'bf16' if bf16 else 'f32'}, remat={remat}, "
            f"grad_accum={grad_accum}"
            + ("" if mesh is None else
               f", data rank {mesh.rank()} of {mesh.size()}"))
        if data_format == "auto":
            # directories of preprocess output (*.npz) train from the npz
            # feeder; transcript corpora compute mels on the fly
            data_format = ("npz" if data_dirs and glob.glob(
                os.path.join(data_dirs[0], "*.npz")) else "wav")
        self.valset = None
        if data_format == "npz":
            from ..data.npz_dataset import NpzDataFeeder

            self.dataset = NpzDataFeeder(data_dirs, hp,
                                         max_n_frame=hp.max_decoder_steps,
                                         device=self.device)
            log(f"training from preprocessed npz ({len(self.dataset)} "
                f"batches/epoch)")
        else:
            self.dataset = TextMelDataset(data_dirs, hp, "train",
                                          skip_path_filter=skip_path_filter,
                                          device=self.device)
            try:
                self.valset = TextMelDataset(
                    data_dirs, hp, "val", skip_path_filter=skip_path_filter,
                    device=self.device)
            except FileNotFoundError:
                self.valset = None
            if self.valset is None and num_test_per_speaker > 0:
                # no val.txt: hold out N utterances per speaker
                self.valset = self.dataset.hold_out_per_speaker(
                    num_test_per_speaker)
                if self.valset is not None:
                    log(f"held out {len(self.valset.items)} utterances "
                        f"({num_test_per_speaker}/speaker) for validation")
        self.model = Tacotron2(
            hp, n_vocab=N_SYMBOLS, num_speakers=len(data_dirs),
            device=self.device,
            compute_dtype=torch.bfloat16 if bf16 else None,
            decoder_remat=remat)
        init_weights_(self.model, torch.Generator().manual_seed(hp.seed))
        self.state = create_tacotron_state(self.model, hp)
        if mesh is not None:
            replicate(self.state, mesh)
        self._train_step = make_train_step(self.model, hp, grad_accum, mesh)
        self._eval_step = make_eval_step(self.model)
        self.ckpt = CheckpointManager(
            checkpoint_dir or f"{run_dir}/checkpoints",
            group=None if mesh is None else mesh.group())
        self.logger = (MetricsLogger(logger_dir or f"{run_dir}/tb")
                       if self.chief else None)
        self.loss_window = ValueWindow(100)
        self.time_window = ValueWindow(100)
        self.last_metrics: dict = {}

    def restore(self, checkpoint_file: str | None = None) -> int:
        """Resume from this run's checkpoint directory or, when
        ``checkpoint_file`` names another run's checkpoint directory,
        warm-start the weights, statistics, optimizer and step from
        there."""
        if checkpoint_file:
            self.state, step = CheckpointManager(checkpoint_file).restore(
                self.state)
            log(f"Warm-started from {checkpoint_file} at step {step}")
            return step
        self.state, step = self.ckpt.restore(self.state)
        if step:
            log(f"Resumed from checkpoint at step {step}")
        return step

    def fit(self, num_steps: int, log_every: int = 10) -> None:
        """Train to ``num_steps``; on KeyboardInterrupt the current step is
        checkpointed before the interrupt is passed on."""
        try:
            self._fit(num_steps, log_every)
        except KeyboardInterrupt:
            log(f"interrupted at step {self.state.step}; saving checkpoint")
            self.ckpt.save(self.state.step, self.state)
            raise

    def _fit(self, num_steps: int, log_every: int) -> None:
        hp = self.hp
        n_batches = len(self.dataset)
        if n_batches == 0:
            n_utts = (len(self.dataset.items) if hasattr(self.dataset,
                                                         "items")
                      else sum(len(c) for c in self.dataset.corpus_files))
            raise ValueError(
                f"dataset yields 0 batches ({n_utts} usable utterances < "
                f"batch_size {self.dataset.batch_size}): the epoch loop "
                "would spin forever")
        step = self.state.step
        epoch = step // n_batches
        while step < num_steps:
            for batch in prefetch(self.dataset.epoch(epoch,
                                                     step % n_batches)):
                t0 = time.perf_counter()
                gen = step_generator(hp.seed, step, self.device)
                self.state, metrics = self._train_step(self.state, batch,
                                                       gen)
                step = self.state.step
                self.last_metrics = metrics
                if step % log_every == 0 and self.chief:
                    # float() waits for the device: the clock is read after
                    # the step ran, not after it was enqueued
                    loss = float(metrics["loss"])
                    dur = time.perf_counter() - t0
                    self.loss_window.append(loss)
                    self.time_window.append(dur)
                    lr = self.state.schedule(step)
                    log(f"step {step} loss={loss:.5f} "
                        f"avg={self.loss_window.average:.5f} "
                        f"grad_norm={float(metrics['grad_norm']):.3f} "
                        f"lr={lr:.2e} {self.time_window.average:.2f}s/it")
                    self.logger.log_training(loss, metrics["grad_norm"], lr,
                                             dur, step)
                if step % hp.checkpoint_interval == 0:
                    self.ckpt.save(step, self.state)
                    self.validate(step)
                if step >= num_steps:
                    break
            epoch += 1
        self.ckpt.save(step, self.state)

    def validate(self, step: int):
        """Mean loss over the validation set (running statistics, the
        prenet's dropout from a generator seeded 0); None without one, and
        on every rank but the first."""
        if not self.chief or self.valset is None or len(self.valset) == 0:
            return None
        losses, last = [], None
        for batch in self.valset.epoch(0):
            metrics, preds = self._eval_step(
                batch, torch.Generator(device=self.device).manual_seed(0))
            losses.append(float(metrics["loss"]))
            last = (batch, preds)
        val_loss = float(np.mean(losses))
        log(f"validation loss {val_loss:.6f}")
        batch, preds = last
        self.logger.log_validation(val_loss, self.state.params,
                                   (batch.mel, batch.gate), preds, step)
        return val_loss
