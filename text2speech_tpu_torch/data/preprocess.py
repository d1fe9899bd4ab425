"""Corpus preprocessing (counterpart of ``text2speech_tpu/data/
preprocess.py``): a KSS-style corpus of WAVs and a transcript -> one
``.npz`` per utterance and ``train.txt``.

Per utterance: load (the native decoder, :mod:`..native`) -> peak rescale
-> silence trim -> the mu-law branch of ``input_type`` -> reflect pad ->
mel and linear spectrograms -> ``.npz``.  The chain is split by where each
part runs best:

* **host stage** (a thread pool): WAV decode and resampling, peak rescale,
  the per-utterance silence trim when ``trim_impl="host"``, the mu-law
  branch, the per-utterance reflect pad;
* **device stage** (``device``, the card on every entry point): the
  silence-trim bounds of whole batches when ``trim_impl="device"``
  (:func:`..dsp.audio.trim_bounds_batch`), and both spectrograms of a
  padded batch from one STFT (``mel_and_linear_spectrogram(center=
  False)``).  The loop is double-buffered: batch k + 1 is computed before
  batch k's results are waited for, and the results come back by
  ``non_blocking`` copies into pinned host buffers, each batch waited on
  by its own event, so that compute, transfer and the writes overlap;
* **write stage** (the same pool): ``.npz`` files with the keys ``audio,
  mel, linear, time_steps, mel_frames, text, tokens, loss_coeff`` and
  pipe-delimited ``train.txt`` rows (:func:`write_metadata`): the JAX
  package's contract, so that either package trains from either one's
  output.

Utterances longer than ``max_mel_frames`` are dropped when
``clip_mels_length`` is set.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np
import torch

from ..config import HParams
from ..dsp import audio as dsp_audio
from ..dsp.audio import (load_wav, mel_and_linear_spectrogram,
                         start_and_end_indices, trim_bounds_batch,
                         trim_silence)
from ..text import text_to_sequence
from .dataset import round_up


def parse_transcript(in_dir: str) -> list[tuple[str, str]]:
    """KSS ``transcript.txt`` rows ``wav|text|text2|...`` -> (wav path,
    text) pairs.  A row whose two text columns differ in word count gives
    both; a row whose columns agree gives one."""
    rows: list[tuple[str, str]] = []
    with open(os.path.join(in_dir, "transcript.txt"), encoding="utf-8") as f:
        for line in f:
            sp = line.rstrip("\n").split("|")
            if len(sp) < 2:
                continue
            wav = os.path.join(in_dir, sp[0])
            if len(sp) >= 3 and len(sp[1].split()) != len(sp[2].split()):
                rows.append((wav, sp[1]))
                rows.append((wav, sp[2]))
            else:
                rows.append((wav, sp[1]))
    return rows


# --- dataset dispatch --------------------------------------------------------
# A corpus differs from another only in its transcript parser: register one
# with :func:`register_transcript_parser`, or ship a module
# ``datasets.<name>`` (or an importable ``<name>``) with
# ``parse_transcript(in_dir)``.

_TRANSCRIPT_PARSERS = {"kss": parse_transcript}


def register_transcript_parser(name: str, fn) -> None:
    _TRANSCRIPT_PARSERS[name] = fn


def get_transcript_parser(name: str):
    """Resolve a dataset name to its transcript parser."""
    if name in _TRANSCRIPT_PARSERS:
        return _TRANSCRIPT_PARSERS[name]
    import importlib

    for modname in (f"datasets.{name}", name):
        try:
            mod = importlib.import_module(modname)
        except ImportError:
            continue
        fn = getattr(mod, "parse_transcript", None)
        if fn is not None:
            _TRANSCRIPT_PARSERS[name] = fn
            return fn
    raise ValueError(
        f"unknown dataset {name!r}: not registered and no importable "
        f"'datasets.{name}' / '{name}' module with parse_transcript()")


@dataclass
class _HostItem:
    wav_path: str
    text: str
    wav: np.ndarray          # trimmed, rescaled waveform (mel source)
    out: np.ndarray          # audio branch output (raw / mulaw / quantized)
    out_dtype: np.dtype
    n_samples: int           # len(wav) after trim
    row: int                 # the item's place in the transcript


def _load_stage(args):
    """Host IO: WAV decode and peak rescale (no trim) of (path, text, hp,
    device, row) -> (path, text, wav, row), or None for a missing file."""
    wav_path, text, hp, _, row = args
    try:
        wav = load_wav(wav_path, hp.sample_rate)
    except FileNotFoundError:
        print(f"missing wav {wav_path}; skipping")
        return None
    if hp.rescaling:
        peak = np.abs(wav).max()
        if peak > 0:
            wav = wav / peak * hp.rescaling_max
    return wav_path, text, wav, row


def _branch_stage(wav_path: str, text: str, wav: np.ndarray, hp: HParams,
                  device, row: int) -> _HostItem | None:
    """After the trim: the mu-law branch of ``hp.input_type``, its
    companding on ``device``."""
    if hp.input_type == "mulaw-quantize":
        out = dsp_audio.mulaw_quantize(
            torch.from_numpy(np.ascontiguousarray(wav)).to(device),
            hp.quantize_channels).cpu().numpy()
        start, end = start_and_end_indices(out, hp.silence_threshold)
        wav, out = wav[start:end], out[start:end]
        out_dtype = np.int16
    elif hp.input_type == "mulaw":
        out = dsp_audio.mulaw(
            torch.from_numpy(np.ascontiguousarray(wav)).to(device),
            hp.quantize_channels).cpu().numpy()
        out_dtype = np.float32
    else:
        out = wav
        out_dtype = np.float32
    if len(wav) == 0:
        return None
    return _HostItem(wav_path, text, wav, out, np.dtype(out_dtype), len(wav),
                     row)


def _host_stage(args) -> _HostItem | None:
    """The whole host chain (load -> rescale -> host trim -> mu-law
    branch): ``trim_impl="host"``, and the oracle of the device trim."""
    loaded = _load_stage(args)
    if loaded is None:
        return None
    wav_path, text, wav, row = loaded
    hp, device = args[2], args[3]
    if hp.trim_silence:
        wav = trim_silence(wav, hp)
    return _branch_stage(wav_path, text, wav, hp, device, row)


def _host_trim_items(loaded: list, hp: HParams, pool,
                     device) -> list[_HostItem]:
    """Per-utterance host trim and the mu-law branch over loaded (path,
    text, wav, row) tuples: the ``trim_impl="host"`` body after loading."""

    def one(x):
        path, text, wav, row = x
        if hp.trim_silence:
            wav = trim_silence(wav, hp)
        return _branch_stage(path, text, wav, hp, device, row)

    return [it for it in pool.map(one, loaded) if it is not None]


def choose_trim_impl(
    h2d_MBps: float,
    host_trim_samples_per_sec: float,
    avg_samples: float,
    length_bucket: int = 16384,
) -> str:
    """The faster silence-trim placement from measured costs.  The device
    trim's cost per utterance beyond the host's is one more upload of its
    length-bucketed samples (the bounds pass uploads the waveform; the
    spectrogram pass uploads it in either placement); the host trim's is
    the measured numpy trim time of its samples."""
    bucketed = -(-int(avg_samples) // length_bucket) * length_bucket
    t_device = bucketed * 4.0 / (h2d_MBps * 1e6)
    t_host = avg_samples / host_trim_samples_per_sec
    return "host" if t_host < t_device else "device"


_PROBE_CACHE: dict = {}


def _h2d_MBps(device: torch.device, big_mb: int, reps: int) -> float:
    """Host -> ``device`` copy rate in MB/s: a pinned host buffer copied to
    the card, timed across ``torch.cuda.synchronize``, the median of
    ``reps`` copies after a warm one.  On the CPU nothing is copied:
    infinite."""
    if device.type != "cuda":
        return float("inf")
    big = torch.ones(big_mb * 1024 * 1024 // 4).pin_memory()
    dst = torch.empty(big.shape, device=device)
    dst.copy_(big, non_blocking=True)
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        dst.copy_(big, non_blocking=True)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return big.nbytes / 1e6 / max(float(np.median(times)), 1e-9)


def probe_trim_costs(hp: HParams, device="cuda", probe_mb: int = 8,
                     reps: int = 3,
                     probe_seconds: float = 3.0) -> tuple[float, float]:
    """(h2d_MBps, host_trim_samples_per_sec) for :func:`choose_trim_impl`:
    the copy rate to ``device`` and the rate of ``trim_silence`` on a
    synthetic clip with silent edges.  Cached per process and device."""
    device = torch.device(device)
    key = (probe_mb, hp.sample_rate, hp.trim_fft_size, hp.trim_hop_size,
           str(device))
    if key in _PROBE_CACHE:
        return _PROBE_CACHE[key]
    n = int(probe_seconds * hp.sample_rate)
    sig = 0.4 * np.sin(2 * np.pi * 220.0 * np.arange(n) / hp.sample_rate)
    sig[: n // 8] = 0.0
    sig[-n // 8:] = 0.0
    wav = sig.astype(np.float32)
    trim_silence(wav, hp)            # warm-up outside the timed part
    t0 = time.perf_counter()
    host_reps = 3
    for _ in range(host_reps):
        trim_silence(wav, hp)
    host_sps = host_reps * n / max(time.perf_counter() - t0, 1e-9)
    _PROBE_CACHE[key] = (_h2d_MBps(device, probe_mb, reps), host_sps)
    return _PROBE_CACHE[key]


def _device_trim_items(loaded: list, hp: HParams, device, batch: int = 64,
                       length_bucket: int = 16384) -> list[_HostItem]:
    """Silence-trim bounds of whole batches on ``device``
    (:func:`..dsp.audio.trim_bounds_batch`) over loaded (path, text, wav,
    row) tuples, then the mu-law branch."""
    items: list[_HostItem] = []
    order = sorted(range(len(loaded)), key=lambda i: len(loaded[i][2]))
    for i0 in range(0, len(order), batch):
        chunk = [loaded[i] for i in order[i0:i0 + batch]]
        T = round_up(max(len(x[2]) for x in chunk), length_bucket)
        padded = np.zeros((len(chunk), T), np.float32)
        lens = np.zeros((len(chunk),), np.int32)
        for j, (_, _, w, _) in enumerate(chunk):
            padded[j, :len(w)] = w
            lens[j] = len(w)
        starts, ends = trim_bounds_batch(
            torch.from_numpy(padded).to(device),
            torch.from_numpy(lens).to(device), hp.trim_top_db,
            hp.trim_fft_size, hp.trim_hop_size)
        starts, ends = starts.cpu().numpy(), ends.cpu().numpy()
        for j, (path, text, w, row) in enumerate(chunk):
            it = _branch_stage(path, text, w[starts[j]:ends[j]], hp, device,
                               row)
            if it is not None:
                items.append(it)
    return items


def _device_batch_fn(hp: HParams, transfer_dtype=None):
    """Both spectrograms of a padded batch on its device; ``transfer_dtype``
    (e.g. ``torch.float16``) casts them there before the copy to the host
    (half the bytes; the ``.npz`` stays f32 after the cast back, ~1e-3
    relative error)."""

    @torch.no_grad()
    def fn(padded: torch.Tensor):
        mel, lin = mel_and_linear_spectrogram(padded, hp, center=False)
        if transfer_dtype is not None:
            mel, lin = mel.to(transfer_dtype), lin.to(transfer_dtype)
        return mel, lin

    return fn


def preprocess_corpus(
    hp: HParams,
    in_dir: str,
    out_dir: str,
    num_workers: int = 8,
    device_batch: int = 16,
    length_bucket: int = 16384,
    progress=lambda x: x,
    parser=None,
    trim_impl: str = "auto",
    transfer_fp16: bool = False,
    device="cuda",
) -> list[tuple]:
    """Preprocess a corpus; returns the ``train.txt`` rows (``(audio_fn,
    mel_fn, linear_fn, time_steps, mel_frames, text, npz_fn)``).

    ``parser`` overrides the transcript parser (:func:`get_transcript_
    parser`; default the KSS format).  ``trim_impl``: ``"device"`` takes
    the silence-trim bounds of whole batches on ``device``, ``"host"`` the
    per-utterance numpy trim in the thread pool, ``"auto"`` measures both
    costs once (:func:`probe_trim_costs`) and takes the cheaper
    (:func:`choose_trim_impl`); both placements write equal arrays.
    ``transfer_fp16`` casts the spectrograms to f16 on ``device`` before
    the copy to the host (opt-in: it changes the output, ~1e-3 relative).
    ``device`` runs the spectrograms, the device trim and the mu-law
    companding."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    os.makedirs(out_dir, exist_ok=True)
    rows = (parser or parse_transcript)(in_dir)
    pad = hp.filter_length // 2
    hop = hp.hop_length
    pool = ThreadPoolExecutor(num_workers)
    device_fn = _device_batch_fn(hp, torch.float16 if transfer_fp16 else None)
    metadata: list[tuple] = []
    name_counts: dict = {}

    jobs = [(w, t, hp, device, i) for i, (w, t) in enumerate(rows)]

    def load_all():
        return [x for x in progress(pool.map(_load_stage, jobs))
                if x is not None]

    # sorted by length, so that a device batch pads little; equal lengths
    # in transcript order, so that both trim placements batch alike
    def batches() -> Iterable[list[_HostItem]]:
        impl = trim_impl if hp.trim_silence else "host"
        if impl == "auto":
            # load first (either placement needs the waveforms), then decide
            # from the measured costs at this corpus's mean length
            loaded = load_all()
            h2d, host_sps = probe_trim_costs(hp, device)
            avg = (float(np.mean([len(x[2]) for x in loaded]))
                   if loaded else 0.0)
            impl = choose_trim_impl(h2d, host_sps, avg,
                                    length_bucket=length_bucket)
            print(f"trim_impl auto -> {impl} (H2D {h2d:.0f} MB/s, host trim "
                  f"{host_sps / 1e6:.1f} Msamples/s, mean utterance "
                  f"{avg:.0f} samples)")
            items = (_device_trim_items(loaded, hp, device,
                                        length_bucket=length_bucket)
                     if impl == "device"
                     else _host_trim_items(loaded, hp, pool, device))
        elif impl == "device":
            items = _device_trim_items(load_all(), hp, device,
                                       length_bucket=length_bucket)
        else:
            items = [it for it in progress(pool.map(_host_stage, jobs))
                     if it is not None]
        items.sort(key=lambda it: (it.n_samples, it.row))
        for i in range(0, len(items), device_batch):
            yield items[i:i + device_batch]

    def write_one(it: _HostItem, frames: int, mel: np.ndarray,
                  linear: np.ndarray, npz_name: str) -> None:
        # the audio's time resolution: reflect pad, then whole hops
        out = np.pad(it.out, pad, mode="reflect")[:frames * hop]
        assert len(out) >= frames * hop and len(out) % hop == 0
        np.savez(os.path.join(out_dir, npz_name),
                 audio=out.astype(it.out_dtype), mel=mel.T, linear=linear.T,
                 time_steps=len(out), mel_frames=frames, text=it.text,
                 tokens=text_to_sequence(it.text), loss_coeff=1)

    def drain(pending) -> None:
        """Wait for a dispatched batch's copies and hand its writes to the
        pool."""
        chunk, n_frames, mel_h, lin_h, done = pending[:5]
        if done is not None:
            done.synchronize()
        mel_b, lin_b = mel_h.numpy(), lin_h.numpy()
        for j, it in enumerate(chunk):
            frames = n_frames[j]
            wav_id = os.path.splitext(os.path.basename(it.wav_path))[0]
            # a transcript row whose two text columns differ gives two items
            # of one wav: each gets an npz of its own
            n_seen = name_counts[wav_id] = name_counts.get(wav_id, 0) + 1
            npz_name = (f"{wav_id}.npz" if n_seen == 1
                        else f"{wav_id}-{n_seen}.npz")
            write_futures.append(pool.submit(
                write_one, it, frames,
                mel_b[j, :, :frames].astype(np.float32),
                lin_b[j, :, :frames].astype(np.float32), npz_name))
            metadata.append((f"{wav_id}-audio.npy", f"{wav_id}-mel.npy",
                             f"{wav_id}-linear.npy", frames * hop, frames,
                             it.text, npz_name))

    write_futures: list = []
    pending = None
    for chunk in batches():
        n_frames = [1 + it.n_samples // hop for it in chunk]
        keep = [j for j, f in enumerate(n_frames)
                if not (hp.clip_mels_length and f > hp.max_mel_frames)]
        if not keep:
            continue
        chunk = [chunk[j] for j in keep]
        n_frames = [n_frames[j] for j in keep]
        # per-utterance reflect pad, then zeros to the length bucket
        T = round_up(max(it.n_samples for it in chunk) + 2 * pad,
                     length_bucket)
        batch = np.zeros((len(chunk), T), np.float32)
        for j, it in enumerate(chunk):
            batch[j, :it.n_samples + 2 * pad] = np.pad(it.wav, pad,
                                                       mode="reflect")
        host_in = torch.from_numpy(batch)
        if cuda:
            host_in = host_in.pin_memory()
        mel, lin = device_fn(host_in.to(device, non_blocking=True))
        # only the batch's frames come back (bucketed to 16)
        f_max = min(mel.shape[-1], round_up(max(n_frames), 16))
        mel, lin = mel[:, :, :f_max], lin[:, :, :f_max]
        mel_h = torch.empty(mel.shape, dtype=mel.dtype, pin_memory=cuda)
        lin_h = torch.empty(lin.shape, dtype=lin.dtype, pin_memory=cuda)
        mel_h.copy_(mel, non_blocking=True)
        lin_h.copy_(lin, non_blocking=True)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record()
        if pending is not None:
            drain(pending)
        # host_in stays referenced until its upload is waited for
        pending = (chunk, n_frames, mel_h, lin_h, done, host_in)
    if pending is not None:
        drain(pending)
    for f in write_futures:
        f.result()              # surface write errors
    pool.shutdown()
    return metadata


def write_metadata(metadata: Sequence[tuple], out_dir: str,
                   hp: HParams) -> None:
    """``train.txt`` (one ``|``-joined row per utterance) and the corpus'
    totals."""
    with open(os.path.join(out_dir, "train.txt"), "w", encoding="utf-8") as f:
        for m in metadata:
            f.write("|".join(str(x) for x in m) + "\n")
    frames = sum(int(m[4]) for m in metadata)
    timesteps = sum(int(m[3]) for m in metadata)
    hours = timesteps / hp.sample_rate / 3600
    print(f"Wrote {len(metadata)} utterances, {frames} mel frames, "
          f"{timesteps} audio timesteps, ({hours:.2f} hours)")
