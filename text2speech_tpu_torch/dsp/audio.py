"""The offline audio chain on tensors, and WAV input and output on the host
(counterpart of ``text2speech_tpu/dsp/audio.py``).

Pre-emphasis and its inverse, amplitude <-> dB, spectrogram normalisation,
the offline linear and mel spectrograms (``amp_to_db(.) - ref_level_db``),
the mu-law family, the batched silence-trim bounds
(:func:`trim_bounds_batch`) and Griffin-Lim inversion with
``inv_linear_spectrogram`` / ``inv_mel_spectrogram``.  Each runs on its
input's device in float32; keep TF32 off on a GPU
(``torch.backends.cuda.matmul.allow_tf32 = False``) so the products stay
float32, as the JAX package's ``Precision.HIGHEST``.  The JAX package's
PRNG key of ``griffin_lim`` becomes a ``torch.Generator`` or the initial
phase itself.  ``start_and_end_indices`` and the per-utterance silence trim
(``trim_silence_bounds``, ``trim_silence``) are host numpy, as in the JAX
package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .filters import mel_filterbank
from .stft import STFTParams, istft, stft_mag_phase, stft_magnitude

# ---------------------------------------------------------------------------
# host-side wav IO
# ---------------------------------------------------------------------------


def load_wav(path: str, sr: int) -> np.ndarray:
    """Load a wav as float32 in [-1, 1] at sample rate ``sr``: integer PCM
    scaled by its full range, channels averaged, polyphase resampling when
    the file's rate differs.  The native C++ decoder and resampler first
    (:mod:`..native`, equal to scipy's on the taps it is handed), scipy's
    path where the library is unavailable or the format is not one it
    decodes."""
    from ..native import load_wav_native

    y = load_wav_native(path, sr)
    if y is not None:
        return y

    from scipy.io import wavfile
    from scipy.signal import resample_poly

    file_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        y = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        y = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        y = (data.astype(np.float32) - 128.0) / 128.0
    else:
        y = data.astype(np.float32)
    if y.ndim == 2:
        y = y.mean(axis=1)
    if file_sr != sr:
        g = np.gcd(int(sr), int(file_sr))
        y = resample_poly(y, sr // g, file_sr // g).astype(np.float32)
    return y


def save_wav(wav, path: str, sr: int) -> None:
    """Peak-scaled PCM16 write through ``scipy.io.wavfile``."""
    from scipy.io import wavfile

    wav = np.asarray(wav, dtype=np.float32)
    wav = wav * (32767 / max(0.01, float(np.max(np.abs(wav)))))
    wavfile.write(path, sr, wav.astype(np.int16))


# ---------------------------------------------------------------------------
# elementwise chains
# ---------------------------------------------------------------------------


def preemphasis(y: torch.Tensor, k: float, enabled: bool = True):
    """FIR pre-emphasis y[t] - k y[t-1] along the last axis."""
    if not enabled:
        return y
    prev = torch.cat([torch.zeros_like(y[..., :1]), y[..., :-1]], -1)
    return y - k * prev


# samples per block of the closed-form de-emphasis
IIR_BLOCK = 256


def _decay(k: float, n: int, device) -> torch.Tensor:
    """[n, n] lower-triangular matrix of powers k^(i - j), j <= i, rounded
    to float32 from float64."""
    i = np.arange(n)
    e = i[:, None] - i[None, :]
    m = np.where(e >= 0, float(k) ** np.maximum(e, 0), 0.0)
    return torch.from_numpy(m.astype(np.float32)).to(device)


def _iir(x: torch.Tensor, k: float, block: int) -> torch.Tensor:
    """y[t] = x[t] + k y[t-1] along the last axis, without a loop over t:
    each block of ``block`` samples is one product with the powers of k;
    the blocks' ends, y at each block's last sample, are the same
    recurrence with k^block over the blocks' local ends, solved the same
    way; then each sample adds k^(i+1) times the previous block's end."""
    T = x.shape[-1]
    if T <= block:
        return x @ _decay(k, T, x.device).T
    nb = -(-T // block)
    xb = torch.nn.functional.pad(x, (0, nb * block - T))
    local = xb.unflatten(-1, (nb, block)) @ _decay(k, block, x.device).T
    ends = _iir(local[..., -1], float(k) ** block, block)
    carry = torch.cat([torch.zeros_like(ends[..., :1]), ends[..., :-1]], -1)
    pows = torch.from_numpy(
        (float(k) ** np.arange(1, block + 1)).astype(np.float32)
    ).to(x.device)
    y = local + carry[..., None] * pows
    return y.flatten(-2)[..., :T]


def inv_preemphasis(y: torch.Tensor, k: float, enabled: bool = True):
    """IIR de-emphasis y[t] = x[t] + k y[t-1] along the last axis (the JAX
    package's ``lax.scan``), in closed form over blocks of
    :data:`IIR_BLOCK` samples: a few products on the device instead of one
    launch per sample."""
    if not enabled:
        return y
    return _iir(y.float(), k, IIR_BLOCK)


def amp_to_db(x: torch.Tensor, min_level_db: float) -> torch.Tensor:
    min_level = float(np.exp(min_level_db / 20 * np.log(10)))
    return 20.0 * torch.log10(torch.clamp_min(x, min_level))


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize_spec(S: torch.Tensor, hp) -> torch.Tensor:
    """dB spectrogram -> the normalised range of ``hp``."""
    mad, mld = hp.max_abs_value, hp.min_level_db
    if hp.symmetric_mels:
        out = (2 * mad) * ((S - mld) / (-mld)) - mad
        lo, hi = -mad, mad
    else:
        out = mad * ((S - mld) / (-mld))
        lo, hi = 0.0, mad
    if hp.allow_clipping_in_normalization:
        out = torch.clamp(out, lo, hi)
    return out


def denormalize_spec(D: torch.Tensor, hp) -> torch.Tensor:
    mad, mld = hp.max_abs_value, hp.min_level_db
    if hp.allow_clipping_in_normalization:
        D = torch.clamp(D, -mad if hp.symmetric_mels else 0.0, mad)
    if hp.symmetric_mels:
        return ((D + mad) * -mld / (2 * mad)) + mld
    return (D * -mld / mad) + mld


# ---------------------------------------------------------------------------
# mu-law family
# ---------------------------------------------------------------------------


def _log1p_of(mu: float, like: torch.Tensor) -> torch.Tensor:
    """log1p(mu) as a float32 operation (the JAX package's
    ``jnp.log1p(mu)``), on ``like``'s device."""
    return torch.log1p(torch.tensor(float(mu), dtype=torch.float32,
                                    device=like.device))


def mulaw(x: torch.Tensor, mu: float = 256) -> torch.Tensor:
    """sign(x) log1p(mu |x|) / log1p(mu) in float32."""
    x = x.float()
    return torch.sign(x) * torch.log1p(mu * torch.abs(x)) / _log1p_of(mu, x)


def inv_mulaw(y: torch.Tensor, mu: float = 256) -> torch.Tensor:
    """The inverse of :func:`mulaw`."""
    y = y.float()
    return torch.sign(y) * (1.0 / mu) * (
        torch.pow(1.0 + mu, torch.abs(y)) - 1.0)


def mulaw_quantize(x: torch.Tensor, mu: int = 256) -> torch.Tensor:
    """Mu-law codes in [0, mu) as int32: the companded value scaled to
    [0, mu - 1] and truncated toward zero (the reference's ``astype(int)``;
    the values are never negative, so this is the floor)."""
    mu = mu - 1
    return ((mulaw(x, mu) + 1) / 2 * mu).to(torch.int32)


def inv_mulaw_quantize(y: torch.Tensor, mu: int = 256) -> torch.Tensor:
    mu = mu - 1
    return inv_mulaw(2.0 * y.float() / mu - 1.0, mu)


def start_and_end_indices(quantized: np.ndarray, silence_threshold: int = 2):
    """First and last sample whose mu-law code deviates from mid-scale by
    more than ``silence_threshold``.  Host numpy (an output of variable
    length follows)."""
    nonsilent = np.abs(quantized - 127) > silence_threshold
    idx = np.flatnonzero(nonsilent)
    start = int(idx[0]) if idx.size else 0
    end = int(idx[-1]) if idx.size else len(quantized) - 1
    return start, end


# ---------------------------------------------------------------------------
# silence trim (librosa.effects.trim semantics)
# ---------------------------------------------------------------------------


def _frame_rms_db(y: np.ndarray, frame_length: int,
                  hop_length: int) -> np.ndarray:
    pad = frame_length // 2
    yp = np.pad(y, pad, mode="constant")
    n_frames = 1 + (len(yp) - frame_length) // hop_length
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(frame_length)[None, :])
    mse = np.mean(yp[idx].astype(np.float64) ** 2, axis=1)
    amin = 1e-10
    ref = max(mse.max(), amin)
    return 10.0 * np.log10(np.maximum(amin, mse)) - 10.0 * np.log10(ref)


def trim_silence_bounds(y: np.ndarray, top_db: float, frame_length: int,
                        hop_length: int) -> tuple[int, int]:
    """[start, end) sample bounds of the non-silent span of one utterance
    (``librosa.effects.trim``: frames of mean square within ``top_db`` of
    the loudest frame).  Host numpy."""
    db = _frame_rms_db(y, frame_length, hop_length)
    nonsilent = np.flatnonzero(db > -top_db)
    if nonsilent.size == 0:
        return 0, 0
    start = int(nonsilent[0]) * hop_length
    end = min(len(y), int(nonsilent[-1] + 1) * hop_length)
    return start, end


def trim_silence(y: np.ndarray, hp) -> np.ndarray:
    s, e = trim_silence_bounds(y, hp.trim_top_db, hp.trim_fft_size,
                               hp.trim_hop_size)
    return y[s:e]


def trim_bounds_batch(y: torch.Tensor, lengths: torch.Tensor, top_db: float,
                      frame_length: int, hop_length: int):
    """[start, end) bounds of each row's non-silent span, on ``y``'s device:
    the batched counterpart of :func:`trim_silence_bounds` over a
    zero-padded batch ``y`` [B, T] of true lengths ``lengths`` [B] -> (start,
    end) int32 [B].

    Each frame's mean square is a difference of a float64 running sum of
    the squared samples (no convolution: cuDNN would take it in TF32, and
    float32 sums could move a frame across the threshold against the host's
    float64 mean), then the host's dB and threshold in float64.  Zero
    padding past a row's length adds silent frames only, so each row's
    bounds are those of its true-length signal."""
    pad = frame_length // 2
    yp = torch.nn.functional.pad(y.to(torch.float64), (pad, pad))
    cs = torch.nn.functional.pad(torch.cumsum(yp * yp, dim=1), (1, 0))
    n = 1 + (yp.shape[1] - frame_length) // hop_length
    starts = torch.arange(n, device=y.device) * hop_length
    mse = (cs[:, starts + frame_length] - cs[:, starts]) / frame_length
    amin = 1e-10
    ref = torch.clamp_min(mse.max(dim=1, keepdim=True).values, amin)
    db = 10.0 * torch.log10(torch.clamp_min(mse, amin)) - 10.0 * torch.log10(
        ref)
    nonsilent = db > -top_db
    any_ns = nonsilent.any(dim=1)
    first = torch.argmax(nonsilent.to(torch.int8), dim=1)
    last = n - 1 - torch.argmax(nonsilent.flip(1).to(torch.int8), dim=1)
    zero = torch.zeros_like(first)
    start = torch.where(any_ns, first * hop_length, zero)
    end = torch.where(any_ns, torch.minimum(
        lengths.to(first), (last + 1) * hop_length), zero)
    return start.to(torch.int32), end.to(torch.int32)


# ---------------------------------------------------------------------------
# spectrograms, offline convention (amp_to_db - ref_level_db)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _offline_mel_basis(sample_rate: int, n_fft: int,
                       n_mels: int) -> np.ndarray:
    # fmin 0, fmax sr / 2
    return mel_filterbank(sample_rate, n_fft, n_mels)


def _stft_params(hp) -> STFTParams:
    return STFTParams(hp.filter_length, hp.hop_length, hp.win_length)


def _mel_basis_on(hp, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(_offline_mel_basis(
        hp.sample_rate, hp.filter_length, hp.n_mel_channels),
        np.float32)).to(device)


def _to_db(D: torch.Tensor, hp) -> torch.Tensor:
    S = amp_to_db(D, hp.min_level_db) - hp.ref_level_db
    return normalize_spec(S, hp) if hp.signal_normalization else S


def linear_spectrogram(y: torch.Tensor, hp) -> torch.Tensor:
    """[B, T] -> [B, n_freq, n_frames] linear-dB spectrogram."""
    D = stft_magnitude(preemphasis(y, hp.preemphasis, hp.preemphasize),
                       _stft_params(hp))
    return _to_db(D, hp)


def mel_spectrogram(y: torch.Tensor, hp) -> torch.Tensor:
    """[B, T] -> [B, n_mels, n_frames] mel-dB spectrogram."""
    D = stft_magnitude(preemphasis(y, hp.preemphasis, hp.preemphasize),
                       _stft_params(hp))
    return _to_db(torch.einsum("mf,bft->bmt", _mel_basis_on(hp, D.device), D),
                  hp)


def mel_and_linear_spectrogram(y: torch.Tensor, hp, center: bool = True):
    """One STFT, both spectrograms -> (mel, linear).  ``center=False``
    takes signals each reflect-padded by ``filter_length // 2`` by the
    caller (batched preprocessing)."""
    D = stft_magnitude(preemphasis(y, hp.preemphasis, hp.preemphasize),
                       _stft_params(hp), center=center)
    mel = torch.einsum("mf,bft->bmt", _mel_basis_on(hp, D.device), D)
    return _to_db(mel, hp), _to_db(D, hp)


# ---------------------------------------------------------------------------
# Griffin-Lim inversion
# ---------------------------------------------------------------------------


def griffin_lim(S: torch.Tensor, hp, generator: torch.Generator | None = None,
                n_iters: int | None = None,
                phase: torch.Tensor | None = None) -> torch.Tensor:
    """Magnitude spectrogram [B, n_freq, n_frames] -> waveform [B, T]:
    the initial phase (``phase``, or 2 pi U[0, 1) drawn from ``generator``
    on the generator's device), then ``n_iters`` rounds of ISTFT -> STFT ->
    keep the phase, on ``S``'s device."""
    params = _stft_params(hp)
    n_iters = hp.griffin_lim_iters if n_iters is None else n_iters
    if phase is None:
        dev = generator.device if generator is not None else S.device
        phase = 2.0 * np.pi * torch.rand(S.shape, generator=generator,
                                         device=dev)
    S = S.float()
    y = istft(S, phase.to(S.device, torch.float32), params)
    for _ in range(n_iters):
        _, ang = stft_mag_phase(y, params)
        y = istft(S, ang, params)
    return y


def inv_linear_spectrogram(linear: torch.Tensor, hp,
                           generator: torch.Generator | None = None,
                           phase: torch.Tensor | None = None) -> torch.Tensor:
    """dB linear spectrogram -> waveform."""
    D = denormalize_spec(linear, hp) if hp.signal_normalization else linear
    S = db_to_amp(D + hp.ref_level_db)
    y = griffin_lim(S ** hp.power, hp, generator, phase=phase)
    return inv_preemphasis(y, hp.preemphasis, hp.preemphasize)


def inv_mel_spectrogram(mel: torch.Tensor, hp,
                        generator: torch.Generator | None = None,
                        phase: torch.Tensor | None = None) -> torch.Tensor:
    """dB mel spectrogram -> waveform through the pseudo-inverse of the
    offline mel basis and Griffin-Lim."""
    D = denormalize_spec(mel, hp) if hp.signal_normalization else mel
    amp = db_to_amp(D + hp.ref_level_db)
    y = griffin_lim(mel_to_linear(amp, hp) ** hp.power, hp, generator,
                    phase=phase)
    return inv_preemphasis(y, hp.preemphasis, hp.preemphasize)


def mel_to_linear(amp: torch.Tensor, hp) -> torch.Tensor:
    """Mel amplitudes [B, n_mels, T] -> linear magnitudes [B, n_freq, T]:
    max(1e-10, pinv(mel basis) @ amp)."""
    inv_basis = torch.from_numpy(np.linalg.pinv(_offline_mel_basis(
        hp.sample_rate, hp.filter_length, hp.n_mel_channels)).astype(
            np.float32)).to(amp.device)
    return torch.clamp_min(
        torch.einsum("fm,bmt->bft", inv_basis, amp.float()), 1e-10)


def frames_to_hours(n_frames, hp) -> float:
    """Total mel-frame count -> audio hours."""
    return sum(int(n) for n in n_frames) * hp.frame_shift_ms / (3600 * 1000)


def get_duration(audio_arr, hp) -> float:
    """Waveform length in seconds."""
    return len(audio_arr) / hp.sample_rate


# the reference's name for the linear-spectrogram inversion
inv_spectrogram = inv_linear_spectrogram
