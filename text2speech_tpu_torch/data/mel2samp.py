"""WaveGlow training data: random fixed-length audio segments and their
mels (counterpart of ``text2speech_tpu/data/mel2samp.py``).

Segments are fixed-length (``segment_length``), so every batch is one
shape.  Which files a step reads and where each is cropped are pure
functions of ``(shuffle_seed, epoch, step, row)`` through numpy, the same
functions as the JAX package's: both packages cut the same segments from
the same files, and a run resumed at step k crops what the uninterrupted
run would have.  The mel is computed on ``device``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch

from ..config import WaveGlowConfig
from ..dsp.audio import load_wav
from ..dsp.mel import MelFrontend


class VocoderBatch(NamedTuple):
    mel: torch.Tensor     # [B, n_mel, frames]
    audio: torch.Tensor   # [B, segment_length]


def files_to_list(path: str) -> list[str]:
    """One wav path per line, relative to the list's directory."""
    base = os.path.dirname(path)
    with open(path, encoding="utf-8") as f:
        return [os.path.join(base, line.strip()) for line in f
                if line.strip()]


@dataclass
class Mel2Samp:
    training_files: Sequence[str]
    cfg: WaveGlowConfig
    batch_size: int | None = None
    shuffle_seed: int = 1234
    io_workers: int = 8
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.batch_size = self.batch_size or self.cfg.batch_size
        self.frontend = MelFrontend(
            filter_length=self.cfg.filter_length,
            hop_length=self.cfg.hop_length,
            win_length=self.cfg.win_length,
            n_mel_channels=self.cfg.n_mel_channels,
            sampling_rate=self.cfg.sampling_rate,
            mel_fmin=self.cfg.mel_fmin,
            mel_fmax=self.cfg.mel_fmax,
        )
        self._pool = ThreadPoolExecutor(self.io_workers)

    def __len__(self) -> int:
        return len(self.training_files) // self.batch_size

    def _segment(self, path: str, seed: int) -> np.ndarray:
        """Random fixed-length crop; short files zero-pad at the tail.  The
        crop position is a pure function of ``seed``, not drawn from a
        shared generator, so the IO threads cannot reorder draws."""
        seg = self.cfg.segment_length
        wav = load_wav(path, self.cfg.sampling_rate)
        if len(wav) >= seg:
            start = np.random.RandomState(seed).randint(
                0, len(wav) - seg + 1)
            return wav[start: start + seg]
        return np.pad(wav, (0, seg - len(wav)))

    def make_batch(self, paths: Sequence[str],
                   seeds: Sequence[int]) -> VocoderBatch:
        segs = list(self._pool.map(
            lambda ps: self._segment(*ps), zip(paths, seeds)))
        audio = torch.from_numpy(
            np.stack(segs).astype(np.float32)).to(self.device)
        with torch.no_grad():
            mel = self.frontend.mel_spectrogram(audio)
        return VocoderBatch(mel, audio)

    def _crop_seed(self, epoch_idx: int, step: int, row: int) -> int:
        return int(np.random.SeedSequence(
            [self.shuffle_seed, epoch_idx, step, row]).generate_state(1)[0])

    def epoch(self, epoch_idx: int,
              start_step: int = 0) -> Iterator[VocoderBatch]:
        rng = np.random.RandomState(self.shuffle_seed + epoch_idx)
        order = rng.permutation(len(self.training_files))
        B = self.batch_size
        for step in range(start_step, len(self)):
            idx = order[step * B: (step + 1) * B]
            yield self.make_batch(
                [self.training_files[i] for i in idx],
                [self._crop_seed(epoch_idx, step, r)
                 for r in range(len(idx))])
