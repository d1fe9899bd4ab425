"""The port's native audio IO (``text2speech_tpu_torch/native``) against
scipy and against the JAX package's copy (``text2speech_tpu/native``):
WAV decode, polyphase resampling, mu-law quantization, the formats it
rejects (and ``dsp.audio.load_wav``'s scipy path for them), and where it
builds.

Tolerances, those of ``tests/test_native.py``: PCM16 decode to 1e-6 of
scipy's scaling (an exact int16 / 32768 on both sides, float32); the
resampler to 1e-4 of ``scipy.signal.resample_poly`` (the same taps summed in
another order in float32 over ~400 terms); mu-law codes equal.  Against the
JAX package's library on the same file: equal arrays (the same source)."""

from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile
from scipy.signal import resample_poly

from text2speech_tpu import native as jnative
from text2speech_tpu_torch import native


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("no C++ compiler for the native library")
    return lib


def _tone(sr=22050, n=22050):
    t = np.arange(n) / sr
    return (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)


def test_source_is_the_jax_packages_and_builds_outside_the_source(lib):
    """The port's ``wavio.cc`` is the JAX package's code (its header
    comment aside), and its library lies under ``build/t2s_torch/``."""
    def body(p):
        s = Path(p).read_text()
        return s[s.index("#include <cstdint>"):]

    assert body(native.SRC) == body(Path(jnative._SRC))
    assert native.LIB_PATH.parent.name == "t2s_torch"
    assert native.LIB_PATH.parent.parent.name == "build"
    assert native.LIB_PATH.exists()
    assert not list(native.SRC.parent.glob("*.so"))


def test_wav_decode_pcm16(lib, tmp_path):
    y = _tone()
    path = str(tmp_path / "t.wav")
    wavfile.write(path, 22050, (y * 32767).astype(np.int16))
    n0 = native.loads
    got = native.load_wav_native(path, 22050)
    assert native.loads == n0 + 1
    assert got is not None and len(got) == len(y)
    want = (y * 32767).astype(np.int16).astype(np.float32) / 32768.0
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got, jnative.load_wav_native(path, 22050))


def test_wav_decode_float32_stereo(lib, tmp_path):
    y = _tone(n=4000)
    path = str(tmp_path / "s.wav")
    wavfile.write(path, 22050, np.stack([y, -y], axis=1))
    got = native.load_wav_native(path, 22050)
    # the mono downmix of (y, -y) is 0
    np.testing.assert_allclose(got, np.zeros_like(y), atol=1e-6)


@pytest.mark.parametrize("file_sr,sr", [(44100, 22050), (44100, 44800),
                                        (44100, 44100)])
def test_native_resample_matches_scipy(lib, tmp_path, file_sr, sr):
    """Down by 2, and up from KSS's 44,100 Hz to the reference hparams'
    44,800 Hz (448 / 441)."""
    y = _tone(sr=file_sr, n=file_sr // 2)
    path = str(tmp_path / "r.wav")
    wavfile.write(path, file_sr, (y * 32767).astype(np.int16))
    got = native.load_wav_native(path, sr)
    y16 = (y * 32767).astype(np.int16).astype(np.float32) / 32768.0
    g = np.gcd(sr, file_sr)
    want = resample_poly(y16, sr // g, file_sr // g).astype(np.float32)
    assert got is not None and len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(got, jnative.load_wav_native(path, sr))


def test_native_mulaw_matches_reference(lib):
    x = np.linspace(-1, 1, 513).astype(np.float32)
    got = native.mulaw_quantize_native(x, 256)
    y = np.sign(x) * np.log1p(255 * np.abs(x)) / np.log1p(255)
    np.testing.assert_array_equal(got, ((y + 1) / 2 * 255).astype(int))
    np.testing.assert_array_equal(got, jnative.mulaw_quantize_native(x, 256))


def test_wav_unsupported_formats_reject_and_fall_back(lib, tmp_path):
    """A 64-bit float WAV has no native branch: the native read fails, and
    ``load_wav`` decodes it through scipy."""
    from text2speech_tpu_torch.dsp.audio import load_wav

    y = _tone(n=4000).astype(np.float64)
    path = str(tmp_path / "f64.wav")
    wavfile.write(path, 22050, y)
    n0 = native.loads
    assert native.load_wav_native(path, 22050) is None
    got = load_wav(path, 22050)
    assert native.loads == n0
    np.testing.assert_allclose(got, y.astype(np.float32), atol=1e-6)


def test_wav_wide_frames_reject_not_overflow(lib, tmp_path):
    """Frames wider than the native read's 8 bytes (6 channels of 16 bits)
    are rejected, not read past the buffer; scipy's path loads them."""
    from text2speech_tpu_torch.dsp.audio import load_wav

    y = _tone(n=1000)
    path = str(tmp_path / "six.wav")
    wavfile.write(path, 22050, (np.stack([y] * 6, axis=1) * 32767).astype(
        np.int16))
    assert native.load_wav_native(path, 22050) is None
    assert len(load_wav(path, 22050)) == len(y)


def test_load_wav_takes_the_native_path_first(lib, tmp_path):
    """``dsp.audio.load_wav`` decodes a PCM16 file natively (the counter
    moves) and returns what the JAX package's ``load_wav`` returns."""
    from text2speech_tpu.dsp.audio import load_wav as jload
    from text2speech_tpu_torch.dsp.audio import load_wav

    y = _tone(sr=44100, n=30000)
    path = str(tmp_path / "k.wav")
    wavfile.write(path, 44100, (y * 32767).astype(np.int16))
    n0 = native.loads
    got = load_wav(path, 44800)
    assert native.loads == n0 + 1
    np.testing.assert_array_equal(got, jload(path, 44800))


def test_a_failed_build_leaves_scipy_to_decode(monkeypatch, tmp_path):
    """Without a compiler ``build`` reports False; ``load_wav`` then
    decodes through scipy (no native load counted)."""
    from text2speech_tpu_torch.dsp import audio

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libwavio.so")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    native.get_lib.cache_clear()
    try:
        assert native.build() is False
        assert native.get_lib() is None
        y = _tone(n=2000)
        path = str(tmp_path / "p.wav")
        wavfile.write(path, 22050, (y * 32767).astype(np.int16))
        n0 = native.loads
        got = audio.load_wav(path, 22050)
        assert native.loads == n0 and len(got) == len(y)
    finally:
        monkeypatch.undo()
        native.get_lib.cache_clear()
