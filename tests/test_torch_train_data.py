"""The port's WaveGlow training data (``data/mel2samp.py``, ``dsp/mel.py``,
``dsp/audio.load_wav``, ``data/prefetch.py``) against the JAX package's on
the same wav files: the same files in the same order, the same crops bit
for bit, and mels that agree.

Mel tolerance: both sides take log(clamp(mel_basis @ |frames @ dft_basis|,
1e-5)) in f32 with the products summed in another order; 1e-4 absolute on
a log-magnitude of a few units (relative 1e-5 on the magnitude, more near
the 1e-5 clamp, where the log steepens: the test signal is a tone in
noise whose mel bins stay well above it)."""

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from text2speech_tpu.config import WaveGlowConfig as JaxConfig
from text2speech_tpu.data.mel2samp import Mel2Samp as JaxMel2Samp
from text2speech_tpu.dsp import filters as jax_filters
from text2speech_tpu.dsp.audio import load_wav as jax_load_wav
from text2speech_tpu.dsp.mel import MelFrontend as JaxMelFrontend
from text2speech_tpu_torch.config import WaveGlowConfig
from text2speech_tpu_torch.data.mel2samp import (Mel2Samp, VocoderBatch,
                                                 files_to_list)
from text2speech_tpu_torch.data.prefetch import prefetch
from text2speech_tpu_torch.dsp import filters
from text2speech_tpu_torch.dsp.audio import load_wav
from text2speech_tpu_torch.dsp.mel import (MelFrontend,
                                           dynamic_range_compression)

torch.set_num_threads(1)

DATA = dict(segment_length=2048, filter_length=256, hop_length=64,
            win_length=256, n_mel_channels=20, batch_size=2,
            upsample_kernel=256, upsample_stride=64)
MEL_ATOL = 1e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seven wavs at 22050 Hz: five longer than a segment, one shorter
    (zero-padded), one stereo (averaged); and ``r.wav``, stereo at 16 kHz
    (resampled), which is not in the file list."""
    root = tmp_path_factory.mktemp("wgdata")
    rng = np.random.RandomState(0)
    names = []
    for i in range(8):
        sr = 16000 if i == 7 else 22050
        n = 1500 if i == 5 else 6000 + 700 * i
        t = np.arange(n) / sr
        sig = 0.4 * np.sin(2 * np.pi * (200 + 40 * i) * t) \
            + 0.05 * rng.randn(n)
        if i >= 6:
            sig = np.stack([sig, 0.5 * sig], axis=1)
        name = "r.wav" if i == 7 else f"u{i}.wav"
        wavfile.write(str(root / name), sr, (sig * 32767).astype(np.int16))
        if i < 7:
            names.append(name)
    (root / "files.txt").write_text("\n".join(names) + "\n\n")
    return root


def test_load_wav_matches_jax(corpus, monkeypatch):
    """Bit-equal to the JAX package's loader at the file's own rate.  A
    resampled file too: both take their native decoder first (the same
    C++ source).  It is within one f32 step of the JAX package's scipy
    path, which sums the polyphase taps in another order; with the port's
    native decoder out of the way, the port's scipy path is that one bit
    for bit."""
    for name in ("u0.wav", "u5.wav", "u6.wav"):
        path = str(corpus / name)
        got, want = load_wav(path, 22050), jax_load_wav(path, 22050)
        assert got.dtype == np.float32 and got.ndim == 1
        np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() <= 1.0
    path = str(corpus / "r.wav")
    got = load_wav(path, 22050)
    assert got.dtype == np.float32 and got.ndim == 1
    assert abs(len(got) - 10900 * 22050 / 16000) <= 1
    np.testing.assert_array_equal(got, jax_load_wav(path, 22050))
    from text2speech_tpu import native
    from text2speech_tpu_torch import native as torch_native
    monkeypatch.setattr(native, "load_wav_native", lambda path, sr: None)
    np.testing.assert_allclose(got, jax_load_wav(path, 22050), atol=2.0 ** -23)
    monkeypatch.setattr(torch_native, "load_wav_native", lambda path, sr: None)
    np.testing.assert_array_equal(load_wav(path, 22050),
                                  jax_load_wav(path, 22050))


def test_mel_filterbank_is_the_jax_package_s():
    for args in ((22050, 1024, 80, 0.0, 8000.0), (16000, 256, 20, 50.0, None)):
        np.testing.assert_array_equal(filters.mel_filterbank(*args),
                                      jax_filters.mel_filterbank(*args))


def test_mel_spectrogram_matches_jax():
    rng = np.random.RandomState(1)
    t = np.arange(4000) / 22050
    y = (0.3 * np.sin(2 * np.pi * 440 * t)[None]
         + 0.05 * rng.randn(2, 4000)).astype(np.float32)
    kw = dict(filter_length=256, hop_length=64, win_length=256,
              n_mel_channels=20)
    want = np.asarray(JaxMelFrontend(**kw).mel_spectrogram(jnp.asarray(y)))
    got = MelFrontend(**kw).mel_spectrogram(torch.from_numpy(y))
    assert got.shape == want.shape == (2, 20, 1 + 4000 // 64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=MEL_ATOL)
    x = torch.tensor([0.0, 1e-6, 1.0, 10.0])
    np.testing.assert_allclose(
        dynamic_range_compression(x).numpy(),
        np.log(np.maximum(x.numpy(), 1e-5)), rtol=1e-6)


def test_files_to_list(corpus):
    files = files_to_list(str(corpus / "files.txt"))
    assert files == [str(corpus / f"u{i}.wav") for i in range(7)]


def test_mel2samp_epochs_match_jax(corpus):
    """Two epochs, and one resumed in the middle: the same batches as the
    JAX dataset's, audio bit for bit."""
    files = files_to_list(str(corpus / "files.txt"))
    ds = Mel2Samp(files, WaveGlowConfig(**DATA), shuffle_seed=7,
                  device="cpu")
    jds = JaxMel2Samp(files, JaxConfig(**DATA), shuffle_seed=7)
    assert len(ds) == len(jds) == 3
    for epoch in (0, 1):
        got, want = list(ds.epoch(epoch)), list(jds.epoch(epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert isinstance(g, VocoderBatch)
            assert g.audio.shape == (2, 2048) and g.mel.shape == (2, 20, 33)
            assert g.audio.dtype == g.mel.dtype == torch.float32
            np.testing.assert_array_equal(g.audio.numpy(), w.audio)
            np.testing.assert_allclose(g.mel.numpy(), w.mel, atol=MEL_ATOL)
    first = [b.audio for b in ds.epoch(0)]
    second = [b.audio for b in ds.epoch(1)]
    assert not all(torch.equal(a, b) for a, b in zip(first, second))
    resumed = list(ds.epoch(1, start_step=2))
    assert len(resumed) == 1 and torch.equal(resumed[0].audio, second[2])
    for row in range(2):
        assert ds._crop_seed(1, 2, row) == jds._crop_seed(1, 2, row)


def test_short_file_is_zero_padded(corpus):
    ds = Mel2Samp([str(corpus / "u5.wav")], WaveGlowConfig(**DATA),
                  batch_size=1, device="cpu")
    seg = ds._segment(str(corpus / "u5.wav"), 0)
    assert seg.shape == (2048,) and not seg[1500:].any() and seg[:1500].any()


def test_prefetch_keeps_order_and_passes_errors_on():
    assert list(prefetch(iter(range(20)), depth=3)) == list(range(20))
    assert list(prefetch(iter(range(5)), depth=0)) == list(range(5))

    def broken():
        yield 1
        raise RuntimeError("boom")

    it = prefetch(broken())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
