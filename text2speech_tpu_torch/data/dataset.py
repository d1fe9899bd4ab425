"""Tacotron training data (counterpart of ``text2speech_tpu/data/
dataset.py``): multi-corpus transcript lists (the directory index is the
speaker id), wav -> log-mel on the trainer's device, text -> symbol IDs,
zero padding and stop-gate targets of 1 from each utterance's last frame
on.

The same batches as the JAX package's: rows sorted by text length
(longest first), text padded to a multiple of ``text_bucket``, mel frames
to a multiple of lcm(``mel_bucket``, ``n_frames_per_step``), each wav
reflect-padded by ``filter_length // 2`` on the host and framed with
``center=False`` (the last frames read the utterance's own samples, not the
batch's zero padding), padded frames zeroed, and the epoch order a
permutation from ``RandomState(shuffle_seed + epoch)``, resumable from any
step.
"""

from __future__ import annotations

import copy
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch

from ..config import HParams
from ..dsp.audio import load_wav
from ..dsp.mel import MelFrontend
from ..text import text_to_sequence
from ..utils import infolog


class Batch(NamedTuple):
    """One padded batch on the dataset's device (``dataset.py:43``)."""

    text: torch.Tensor            # [B, T_in] int32
    input_lengths: torch.Tensor   # [B] int32
    mel: torch.Tensor             # [B, n_mel, T_out] f32
    gate: torch.Tensor            # [B, T_out] f32
    speaker_id: torch.Tensor      # [B] int32
    output_lengths: torch.Tensor  # [B] int32

    def numpy(self) -> "Batch":
        return Batch(*(t.cpu().numpy() for t in self))


def load_manifest(data_dirs: Sequence[str], split: str = "train"):
    """``transcript.txt`` (train) or ``val.txt`` (val) rows ``wav|text|...``
    of each corpus directory -> [(wav path, text, speaker id)]."""
    fname = "transcript.txt" if split == "train" else "val.txt"
    items: list[tuple[str, str, int]] = []
    for speaker, d in enumerate(data_dirs):
        with open(os.path.join(d, fname), encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("|")
                if len(parts) < 2:
                    continue
                items.append((os.path.join(d, parts[0]), parts[1], speaker))
    return items


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass
class TextMelDataset:
    """Batched text + mel producer; mels are computed on ``device``."""

    data_dirs: Sequence[str]
    hp: HParams
    split: str = "train"
    batch_size: int | None = None
    text_bucket: int = 32
    mel_bucket: int = 64
    shuffle_seed: int = 1234
    io_workers: int = 8
    skip_path_filter: bool = False
    device: str | torch.device = "cpu"

    def __post_init__(self):
        self.items = load_manifest(self.data_dirs, self.split)
        if not self.skip_path_filter:
            # drop manifest rows whose wav is missing on disk
            kept = [it for it in self.items if os.path.exists(it[0])]
            if len(kept) < len(self.items):
                infolog.log(f"path filter: dropped "
                            f"{len(self.items) - len(kept)} manifest rows "
                            f"with missing wavs")
            self.items = kept
        self.batch_size = self.batch_size or self.hp.batch_size
        self.frontend = MelFrontend.from_hparams(self.hp)
        self._pool = ThreadPoolExecutor(self.io_workers)

    def hold_out_per_speaker(self, n: int) -> "TextMelDataset | None":
        """Remove the last ``n`` manifest rows of every speaker and return
        them as a validation dataset (a corpus without ``val.txt``); None
        when the remainder could not fill one training batch."""
        by_speaker: dict[int, list] = {}
        for it in self.items:
            by_speaker.setdefault(it[2], []).append(it)
        held, kept = [], []
        for speaker in sorted(by_speaker):
            rows = by_speaker[speaker]
            k = min(n, len(rows))
            held.extend(rows[len(rows) - k:])
            kept.extend(rows[: len(rows) - k])
        if not held or len(kept) < self.batch_size:
            return None
        val = copy.copy(self)
        val.items = held
        val.split = "val"
        self.items = kept
        return val

    def __len__(self) -> int:
        return len(self.items) // self.batch_size

    def _load_one(self, item):
        path, text, speaker = item
        return load_wav(path, self.hp.sample_rate), text_to_sequence(text), \
            speaker

    def sample_batch(self) -> Batch:
        """A two-row batch (shape discovery)."""
        return self.make_batch(self.items[:2])

    def make_batch(self, items) -> Batch:
        hp = self.hp
        loaded = list(self._pool.map(self._load_one, items))
        loaded.sort(key=lambda x: -len(x[1]))    # longest text first
        wavs = [w for w, _, _ in loaded]
        txts = [t for _, t, _ in loaded]
        speakers = np.asarray([s for _, _, s in loaded], np.int32)

        in_lengths = np.asarray([len(t) for t in txts], np.int32)
        T_in = round_up(int(in_lengths.max()), self.text_bucket)
        text = np.zeros((len(txts), T_in), np.int32)
        for i, t in enumerate(txts):
            text[i, : len(t)] = t

        n_samples = np.asarray([len(w) for w in wavs], np.int64)
        out_lengths = (1 + n_samples // hp.hop_length).astype(np.int32)
        T_out = round_up(int(out_lengths.max()),
                         int(np.lcm(self.mel_bucket, hp.n_frames_per_step)))
        pad = hp.filter_length // 2
        # wide enough for every row's reflect-padded signal and >= T_out
        # frames under center=False framing
        wav_pad = (T_out - 1) * hp.hop_length + hp.filter_length \
            + hp.hop_length
        wav_batch = np.zeros((len(wavs), wav_pad), np.float32)
        for i, w in enumerate(wavs):
            w = np.clip(w, -1.0, 1.0)
            wav_batch[i, : len(w) + 2 * pad] = np.pad(w, pad, mode="reflect")

        dev = torch.device(self.device)
        mel = self.frontend.mel_spectrogram(
            torch.from_numpy(wav_batch).to(dev), center=False)[:, :, :T_out]
        lengths = torch.from_numpy(out_lengths).to(dev)
        valid = torch.arange(T_out, device=dev)[None, :] < lengths[:, None]
        # zero the padded frames (the mel of zero padding is log(1e-5))
        mel = torch.where(valid[:, None, :], mel, 0.0)
        gate = np.zeros((len(wavs), T_out), np.float32)
        for i, n in enumerate(out_lengths):
            gate[i, n - 1:] = 1.0
        return Batch(torch.from_numpy(text).to(dev),
                     torch.from_numpy(in_lengths).to(dev), mel,
                     torch.from_numpy(gate).to(dev),
                     torch.from_numpy(speakers).to(dev), lengths)

    def epoch(self, epoch_idx: int, start_step: int = 0) -> Iterator[Batch]:
        """The shuffled epoch ``epoch_idx`` from batch ``start_step`` on."""
        order = np.random.RandomState(
            self.shuffle_seed + epoch_idx).permutation(len(self.items))
        B = self.batch_size
        for step in range(start_step, len(self)):
            idx = order[step * B: (step + 1) * B]
            yield self.make_batch([self.items[i] for i in idx])
