"""ctypes binding of the native audio IO library (``wavio.cc``; counterpart
of ``text2speech_tpu/native/``).

``wavio.cc`` is built on first use with the host's ``g++`` into
``build/t2s_torch/libwavio.so`` under the checkout root (beside the CUDA
libraries of :mod:`..ops.build`, never beside the source), again when the
source is newer.  This is host IO, not a device kernel: where the library
does not build or load, or a file is in a format it does not decode,
:func:`load_wav_native` returns None and ``dsp.audio.load_wav`` takes its
scipy path.  ``loads`` counts the files decoded natively, so that a run can
show the native path was taken.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "wavio.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "t2s_torch"
LIB_PATH = BUILD_DIR / "libwavio.so"
# files decoded by the native library in this process (the loader's
# thread pool counts under the lock)
loads = 0
_loads_lock = threading.Lock()


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("bits_per_sample", ctypes.c_int32),
        ("format", ctypes.c_int32),
        ("n_frames", ctypes.c_int64),
        ("data_offset", ctypes.c_int64),
    ]


def build() -> bool:
    """Compile ``wavio.cc`` into :data:`LIB_PATH` (a temporary file renamed
    into place, so that a concurrent reader never loads half a library);
    False when the compiler is missing or fails."""
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
    except OSError:
        return False
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        str(SRC), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.cache
def get_lib():
    """The loaded library, built first when missing or older than its
    source; None when it cannot be built or loaded."""
    if (not LIB_PATH.exists()
            or LIB_PATH.stat().st_mtime < SRC.stat().st_mtime):
        if not build():
            return None
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError:
        return None
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(_WavInfo)]
    lib.wav_info.restype = ctypes.c_int
    lib.wav_read_f32.argtypes = [ctypes.c_char_p, f32, ctypes.c_int64]
    lib.wav_read_f32.restype = ctypes.c_int64
    lib.resample_poly.argtypes = [f32, ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_int, f64, ctypes.c_int, f32,
                                  ctypes.c_int64]
    lib.mulaw_quantize.argtypes = [f32, ctypes.c_int64, ctypes.c_int, i16]
    lib.peak_rescale.argtypes = [f32, ctypes.c_int64, ctypes.c_float]
    return lib


@functools.lru_cache(maxsize=32)
def _resample_taps(up: int, down: int) -> np.ndarray:
    """Kaiser-windowed FIR taps as ``scipy.signal.resample_poly`` designs
    them (``firwin``, half-width 10 max(up, down), beta 5)."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    return firwin(2 * 10 * max_rate + 1, 1.0 / max_rate,
                  window=("kaiser", 5.0)).astype(np.float64)


def load_wav_native(path: str, sr: int) -> np.ndarray | None:
    """Native decode (mono float32 in [-1, 1]) and polyphase resampling to
    ``sr``; None when the library is missing or the file is in a format it
    does not decode (the caller then takes scipy's path)."""
    global loads
    lib = get_lib()
    if lib is None:
        return None
    info = _WavInfo()
    if lib.wav_info(path.encode(), ctypes.byref(info)) != 0:
        return None
    out = np.empty(info.n_frames, np.float32)
    n = lib.wav_read_f32(path.encode(), out, info.n_frames)
    if n < 0:
        return None
    y = out[:n]
    if info.sample_rate != sr:
        g = int(np.gcd(int(sr), int(info.sample_rate)))
        up, down = sr // g, info.sample_rate // g
        taps = _resample_taps(up, down)
        n_out = -(-len(y) * up // down)
        res = np.empty(n_out, np.float32)
        lib.resample_poly(np.ascontiguousarray(y), len(y), up, down, taps,
                          len(taps), res, n_out)
        y = res
    with _loads_lock:
        loads += 1
    return y


def mulaw_quantize_native(x: np.ndarray, mu: int = 256) -> np.ndarray | None:
    """Mu-law quantization of ``x`` to int16 codes in [0, mu); None without
    the library."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(len(x), np.int16)
    lib.mulaw_quantize(x, len(x), mu, out)
    return out
