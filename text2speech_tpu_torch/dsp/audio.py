"""WAV output (counterpart of ``text2speech_tpu/dsp/audio.py:65
save_wav``)."""

from __future__ import annotations

import numpy as np


def save_wav(wav, path: str, sr: int) -> None:
    """Peak-scaled PCM16 write through ``scipy.io.wavfile``."""
    from scipy.io import wavfile

    wav = np.asarray(wav, dtype=np.float32)
    wav = wav * (32767 / max(0.01, float(np.max(np.abs(wav)))))
    wavfile.write(path, sr, wav.astype(np.int16))
