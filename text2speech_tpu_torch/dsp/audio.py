"""WAV input and output on the host (counterpart of
``text2speech_tpu/dsp/audio.py:32 load_wav`` and ``:65 save_wav``)."""

from __future__ import annotations

import numpy as np


def load_wav(path: str, sr: int) -> np.ndarray:
    """Load a wav as float32 in [-1, 1] at sample rate ``sr``: integer PCM
    scaled by its full range, channels averaged, polyphase resampling when
    the file's rate differs.  This is the JAX package's scipy path; its
    native C++ decoder waits for the preprocess slice."""
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
