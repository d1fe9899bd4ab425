"""Preprocessed ``.npz`` data feeder (counterpart of
``text2speech_tpu/data/npz_dataset.py``): per-corpus ``.npz`` discovery,
filtering by mel frames and token count, per-corpus weighting with a
greedy initial phase, and batches padded like :mod:`.dataset`'s, the mel
read off disk (no STFT at train time).  Each step's draws are a function
of (seed, epoch, step), so a resumed run sees the uninterrupted run's
batches.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
import torch

from ..config import HParams
from .dataset import Batch, round_up


@dataclass
class NpzDataFeeder:
    data_dirs: Sequence[str]
    hp: HParams
    batch_size: int | None = None
    min_n_frame: int = 5
    max_n_frame: int = 1000
    min_tokens: int = 0
    corpus_weights: Sequence[float] | None = None
    initial_phase_step: int = 0       # steps drawn from corpus 0 alone
    text_bucket: int = 32
    mel_bucket: int = 64
    shuffle_seed: int = 1234
    device: str | torch.device = "cpu"

    def __post_init__(self):
        self.batch_size = self.batch_size or self.hp.batch_size
        self.corpus_files: list[list[str]] = []
        for d in self.data_dirs:
            kept = []
            for f in sorted(glob.glob(os.path.join(d, "*.npz"))):
                try:
                    with np.load(f, allow_pickle=True) as z:
                        frames = int(z["mel_frames"])
                        tokens = len(z["tokens"])
                except (OSError, KeyError, ValueError):
                    continue  # an unreadable npz is skipped
                if not self.min_n_frame <= frames <= self.max_n_frame:
                    continue
                if tokens < self.min_tokens:
                    continue
                kept.append(f)
            self.corpus_files.append(kept)
        total = sum(len(c) for c in self.corpus_files)
        if total == 0:
            raise FileNotFoundError(
                f"no usable npz files under {list(self.data_dirs)}")
        for d, files in zip(self.data_dirs, self.corpus_files):
            if not files:
                raise FileNotFoundError(
                    f"corpus {d!r} has no usable npz files after the "
                    f"frame/token filters (min_n_frame={self.min_n_frame}, "
                    f"max_n_frame={self.max_n_frame}, "
                    f"min_tokens={self.min_tokens})")
        if self.corpus_weights is None:
            self.corpus_weights = [len(c) / total for c in self.corpus_files]

    def __len__(self) -> int:
        return sum(len(c) for c in self.corpus_files) // self.batch_size

    def _sample_paths(self, rng: np.random.RandomState,
                      step: int) -> list[tuple[str, int]]:
        out = []
        for _ in range(self.batch_size):
            if step < self.initial_phase_step:
                corpus = 0
            else:
                corpus = rng.choice(len(self.corpus_files),
                                    p=self.corpus_weights)
            files = self.corpus_files[corpus]
            out.append((files[rng.randint(len(files))], corpus))
        return out

    def make_batch(self, paths: list[tuple[str, int]]) -> Batch:
        hp = self.hp
        items = []
        for path, corpus in paths:
            with np.load(path, allow_pickle=True) as z:
                items.append((z["tokens"].astype(np.int32),
                              z["mel"].astype(np.float32), corpus))
        items.sort(key=lambda it: -len(it[0]))

        in_lengths = np.asarray([len(t) for t, _, _ in items], np.int32)
        T_in = round_up(int(in_lengths.max()), self.text_bucket)
        text = np.zeros((len(items), T_in), np.int32)
        for i, (t, _, _) in enumerate(items):
            text[i, : len(t)] = t

        out_lengths = np.asarray([m.shape[0] for _, m, _ in items], np.int32)
        T_out = round_up(int(out_lengths.max()), self.mel_bucket)
        mel = np.zeros((len(items), hp.n_mel_channels, T_out), np.float32)
        gate = np.zeros((len(items), T_out), np.float32)
        for i, (_, m, _) in enumerate(items):
            mel[i, :, : m.shape[0]] = m.T
            gate[i, m.shape[0] - 1:] = 1.0
        speakers = np.asarray([c for _, _, c in items], np.int32)
        dev = torch.device(self.device)
        return Batch(*(torch.from_numpy(a).to(dev) for a in
                       (text, in_lengths, mel, gate, speakers, out_lengths)))

    def sample_batch(self) -> Batch:
        """A two-row batch (shape discovery)."""
        files = self.corpus_files[0]
        return self.make_batch([(files[i % len(files)], 0) for i in range(2)])

    def epoch(self, epoch_idx: int, start_step: int = 0) -> Iterator[Batch]:
        for step in range(start_step, len(self)):
            rng = np.random.RandomState(np.random.SeedSequence(
                [self.shuffle_seed, epoch_idx, step]).generate_state(1)[0])
            yield self.make_batch(self._sample_paths(rng, step))
