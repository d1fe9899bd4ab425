"""The port's streaming denoiser (``text2speech_tpu_torch.models.denoiser``:
``denoise_windows`` driven by ``StreamingDenoiser``'s plan over a
``DenoiseBuffer``) against the port's whole-utterance denoise and against
the JAX package's windowed program.

Contract, as in ``tests/test_denoiser_stream.py``: for any chunking of the
input (all at once, uniform, ragged, on or off the hop grid, shorter than
the reflect padding) the windowed program emits the samples of the
whole-signal denoise.  The STFT / ISTFT pair is frame-local, so windows
that hold every frame covering the emitted range compute frame-identical
math; float32 products at another batch shape may sum in another order:
2e-6 absolute and 2e-5 relative, the JAX package's own bound."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text2speech_tpu.dsp.stft import STFTParams as JaxSTFTParams
from text2speech_tpu.models import denoiser as jden
from text2speech_tpu_torch.dsp.stft import STFTParams, istft, stft_mag_phase
from text2speech_tpu_torch.models.denoiser import (DenoiseBuffer,
                                                   StreamingDenoiser,
                                                   _window_correction,
                                                   denoise_stream,
                                                   denoise_windows,
                                                   serving_denoiser)

torch.set_num_threads(1)

PARAMS = STFTParams(64, 16, 64)          # the reference config, scaled down
TOL = dict(atol=2e-6, rtol=2e-5)


def offline(audio: np.ndarray, bias: np.ndarray, strength: float):
    mag, phase = stft_mag_phase(torch.from_numpy(audio[None]), PARAMS)
    mag = torch.clamp_min(mag - torch.from_numpy(bias) * strength, 0.0)
    return istft(mag, phase, PARAMS)[0].numpy()


def stream(audio, bias, strength, feed, f_win=9) -> np.ndarray:
    """Drive the planner as a server would, feeding ``audio`` in
    ``feed``-sized chunks; a decoy second row with other content and
    strength shares every call (rows are independent)."""
    den = StreamingDenoiser(lambda: torch.from_numpy(bias), PARAMS,
                            f_win=f_win)
    hop, pad = PARAMS.hop_length, den.pad
    buf = DenoiseBuffer(den)
    out, emitted, pos = [], 0, 0
    for n in feed:
        buf.append(torch.from_numpy(audio[pos: pos + n]))
        pos += n
        flushed = pos >= len(audio)
        for f0, nv, e0, e1 in den.plan(buf.total, emitted, flushed):
            win = buf.window(f0, nv, flushed)
            x = torch.zeros((2, den.l_pad))
            corr = torch.ones((2, den.l_pad))
            den.fill_row(x[0], corr[0], win, nv)
            den.fill_row(x[1], corr[1], win.flip(0), nv)       # decoy
            o = den(x, [strength, 0.77], [nv, nv], corr)
            out.append(o[0, e0 + pad - f0 * hop: e1 + pad - f0 * hop])
            emitted = e1
            buf.trim(emitted)
    assert pos == len(audio)
    return (torch.cat(out).numpy() if out else np.zeros((0,), np.float32))


CASES = {
    "single_shot": (320, [320], 9),
    "single_shot_multi_window": (1000, [1000], 9),
    "uniform_a": (320, [128, 128, 64], 9),
    "uniform_b": (512, [128] * 4, 9),
    "long_stream_trims": (4000, [250] * 16, 9),
    "long_flush_only": (4000, [4000], 9),
    "ragged_off_grid": (333, [50, 7, 200, 76], 9),
    "ragged_97": (97, [96, 1], 9),
    "short_96": (96, [96], 9),
    "short_80": (80, [48, 32], 9),
    # shorter than the reflect padding (32): the mirror image wraps
    "shorter_than_pad_20": (20, [20], 9),
    "shorter_than_pad_17": (17, [9, 8], 9),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_equals_offline(name):
    T, feed, f_win = CASES[name]
    rng = np.random.RandomState(T + len(feed))
    audio = rng.randn(T).astype(np.float32)
    bias = (0.1 * np.abs(rng.randn(1, PARAMS.cutoff, 1))).astype(np.float32)
    ref = offline(audio, bias, 0.2)
    got = stream(audio, bias, 0.2, feed, f_win=f_win)
    assert got.shape == ref.shape == (16 * (T // 16),)
    np.testing.assert_allclose(got, ref, **TOL)


def test_strength_zero_is_the_resynthesis():
    rng = np.random.RandomState(7)
    audio = rng.randn(320).astype(np.float32)
    bias = np.abs(rng.randn(1, PARAMS.cutoff, 1)).astype(np.float32)
    got = stream(audio, bias, 0.0, [160, 160])
    np.testing.assert_allclose(got, offline(audio, bias, 0.0), **TOL)
    np.testing.assert_allclose(got, audio[: got.shape[0]], atol=2e-5)


def test_plan_covers_exactly_once_and_matches_jax():
    """Window plans partition the emitted range without gaps or overlaps,
    never read past the buffered samples mid-stream, and are the JAX
    planner's."""
    den = StreamingDenoiser(lambda: None, PARAMS, f_win=9)
    jd = jden.StreamingDenoiser(lambda: None, JaxSTFTParams(64, 16, 64),
                                f_win=9)
    hop, pad, n_fft = PARAMS.hop_length, den.pad, PARAMS.filter_length
    emitted = a = 0
    for add, flushed in [(100, False), (37, False), (512, False),
                         (200, True)]:
        a += add
        plan = den.plan(a, emitted, flushed)
        assert plan == jd.plan(a, emitted, flushed)
        for f0, nv, e0, e1 in plan:
            assert e0 == emitted and e1 > e0
            assert (e0 + pad) // hop >= f0 >= 0
            if not flushed:
                assert (f0 + nv - 1) * hop + n_fft <= a + pad
            emitted = e1
        assert emitted == den.emit_bound(a, flushed) == jd.emit_bound(
            a, flushed)
    assert emitted == hop * (a // hop)
    sd = serving_denoiser(lambda: None, PARAMS, 8, 16)
    js = jden.serving_denoiser(lambda: None, JaxSTFTParams(64, 16, 64), 8, 16)
    assert (sd.f_win, sd.l_pad) == (js.f_win, js.l_pad)


def test_denoise_windows_matches_jax():
    """The windowed program itself against the JAX package's on the same
    windows, strengths, frame counts and corrections: float32 matmuls at
    full precision on both sides, 2e-6 / 2e-5 on the overlap-add.  The
    correction multiplies both by the same factor, which grows without
    bound towards a window's outer edge (samples that a stream never emits:
    they lie in the reflect padding), so it is divided out again."""
    jp = JaxSTFTParams(64, 16, 64)
    rng = np.random.RandomState(3)
    f_win, B = 9, 3
    l_pad = 64 + 16 * (f_win - 1)
    n_valid = np.asarray([9, 4, 1], np.int32)
    x = np.zeros((B, l_pad), np.float32)
    corr = np.ones((B, l_pad), np.float32)
    for b, nv in enumerate(n_valid):
        need = 64 + 16 * (nv - 1)
        x[b, :need] = rng.randn(need)
        corr[b] = _window_correction(int(nv), PARAMS, l_pad)
        np.testing.assert_array_equal(
            corr[b], jden._window_correction(int(nv), jp, l_pad))
    bias = (0.1 * np.abs(rng.randn(1, 33, 1))).astype(np.float32)
    strengths = np.asarray([0.2, 0.0, 0.9], np.float32)
    want = jden.denoise_windows(
        jnp.asarray(x), jnp.asarray(bias), jnp.asarray(strengths),
        jnp.asarray(n_valid), jnp.asarray(corr), jp)
    got = denoise_windows(
        torch.from_numpy(x), torch.from_numpy(bias),
        torch.from_numpy(strengths), torch.from_numpy(n_valid),
        torch.from_numpy(corr), PARAMS)
    scale = corr * (64 / 16)
    np.testing.assert_allclose(got.numpy() / scale, np.asarray(want) / scale,
                               **TOL)
    emitted = slice(32, l_pad - 32)     # row 0, all frames real
    np.testing.assert_allclose(got.numpy()[0, emitted],
                               np.asarray(want)[0, emitted], **TOL)


@pytest.mark.parametrize("sizes", [[300, 300, 300, 124], [1024], [7] * 40])
def test_denoise_stream_equals_offline(sizes):
    """The single-stream wrapper over an iterator of chunks."""
    rng = np.random.RandomState(len(sizes))
    audio = rng.randn(sum(sizes)).astype(np.float32)
    bias = (0.1 * np.abs(rng.randn(1, PARAMS.cutoff, 1))).astype(np.float32)
    den = serving_denoiser(lambda: torch.from_numpy(bias), PARAMS, 8, 16)
    cuts = np.cumsum([0] + sizes)
    chunks = (torch.from_numpy(audio[a:b]) for a, b in zip(cuts, cuts[1:]))
    out = list(denoise_stream(chunks, den, 0.3))
    got = torch.cat(out).numpy()
    ref = offline(audio, bias, 0.3)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)
    assert len(out) >= 1 and all(o.numel() for o in out)


def test_synthesize_incremental_denoised_equals_offline():
    """``synthesize_incremental(denoiser_strength=s)`` streams the
    whole-utterance denoiser's output over the raw stream, and raises
    without a denoiser."""
    from text2speech_tpu_torch.config import HParams, WaveGlowConfig
    from text2speech_tpu_torch.infer import random_synthesizer

    hp = HParams(
        sample_rate=22050, embedding_size=16, enc_conv_num_layers=1,
        enc_conv_channels=16, attention_rnn_dim=16, decoder_rnn_dim=16,
        attention_dim=8, attention_location_n_filters=4,
        attention_location_kernel_size=7, prenet_dim=8, n_mel_channels=8,
        postnet_embedding_dim=8, postnet_n_convolutions=2,
        max_decoder_steps=44)
    wg = WaveGlowConfig(
        n_mel_channels=8, n_flows=2, n_group=8, n_early_every=4,
        n_early_size=2, wn_n_layers=2, wn_n_channels=16, upsample_kernel=64,
        upsample_stride=16, sampling_rate=22050, hop_length=16)
    dkw = dict(filter_length=64, n_overlap=4, win_length=64, n_frames=16)
    synth = random_synthesizer(hp, wg, 0, device="cpu",
                               use_fused_vocoder=False, denoiser_kwargs=dkw)
    kw = dict(sigma=0.8, seed=3, chunk_steps=8)
    raw = np.concatenate(list(synth.synthesize_incremental("안녕하세요.", **kw)))
    den = np.concatenate(list(synth.synthesize_incremental(
        "안녕하세요.", denoiser_strength=0.07, **kw)))
    ref = synth._denoise(torch.from_numpy(raw[None]), 0.07)[0].numpy()
    assert den.shape == ref.shape
    np.testing.assert_allclose(den, ref, **TOL)
    assert np.abs(den - raw[: den.shape[0]]).max() > 1e-4   # the knob is live
    # the window planner is cached per (STFT config, chunk_steps)
    first = synth._stream_den
    list(synth.synthesize_incremental("네.", denoiser_strength=0.1, **kw))
    assert synth._stream_den is first

    bare = random_synthesizer(hp, wg, 0, device="cpu", use_denoiser=False,
                              use_fused_vocoder=False)
    with pytest.raises(ValueError, match="use_denoiser"):
        next(iter(bare.synthesize_incremental("안녕.", denoiser_strength=0.1,
                                              chunk_steps=8)))
