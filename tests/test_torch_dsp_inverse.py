"""The port's offline audio chain and Griffin-Lim path against the JAX
package's (``text2speech_tpu/dsp/audio.py``, ``dsp/mel.py``,
``dsp/stft.py`` and root ``inference.py``'s vocoder-free branch), on the
CPU at tiny hparams, from seeded numpy inputs.

Tolerances (f32 on both sides).  Elementwise functions: the same f32
operations, 1e-6 relative.  Spectrograms: the same f32 STFT products and
mel einsum summed in another order, then dB: 1e-4 absolute on dB values
of order 100 (a few ulp of the magnitudes, x 20 log10).  Pre-emphasis'
inverse: the closed form sums k^(i-j) x[j] in another order than the JAX
scan's running sum; values of order 1 / (1 - k) = 33: 2e-5 relative to
the peak.  Griffin-Lim from the same initial phase, 4 iterations: f32
STFT products in another order, 1e-4 relative L2 (measured
3e-7..6e-6 here).  The CLI chain adds the two
Tacotrons' mels (f32 decoders on the same weights and masks,
``tests/test_torch_synth.py``) through exp and the pseudo-inverse: the
same 1e-4 relative L2 (measured 2.4e-6)."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2speech_tpu.config import HParams as JaxHParams
from text2speech_tpu.config import WaveGlowConfig as JaxWaveGlowConfig
from text2speech_tpu.dsp import audio as ja
from text2speech_tpu.dsp import mel as jmel
from text2speech_tpu.dsp import stft as jstft
from text2speech_tpu.infer import Synthesizer as JaxSynthesizer
from text2speech_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from text2speech_tpu.text import N_SYMBOLS
from text2speech_tpu_torch import convert, inference
from text2speech_tpu_torch.config import HParams, WaveGlowConfig
from text2speech_tpu_torch.dsp import audio as ta
from text2speech_tpu_torch.dsp import mel as tmel
from text2speech_tpu_torch.dsp import stft as tstft
from tests.conftest import GOLDEN_DIR

torch.set_num_threads(1)

DSP = dict(sample_rate=8000, filter_length=128, hop_length=32,
           win_length=128, n_mel_channels=12)
SPEC_ATOL = 1e-4
GL_REL = 1e-4


def _hp(**kw):
    return JaxHParams(**DSP, **kw), HParams(**DSP, **kw)


def _signal(seed, B=2, T=1500):
    rng = np.random.RandomState(seed)
    t = np.arange(T) / 8000.0
    y = 0.5 * np.sin(2 * np.pi * 440 * t)[None] + 0.1 * rng.randn(B, T)
    return y.astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# --- elementwise chains ------------------------------------------------------


def test_preemphasis_matches_jax():
    y = _signal(0)
    want = np.asarray(ja.preemphasis(jnp.asarray(y), 0.97))
    got = ta.preemphasis(torch.from_numpy(y), 0.97).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        ta.preemphasis(torch.from_numpy(y), 0.97, enabled=False).numpy(), y)


@pytest.mark.parametrize("T", [100, 256, 3001, 70000])
def test_inv_preemphasis_matches_the_jax_scan(T):
    """Signals within one block, of exactly one, of many and of more than
    a block of blocks (two levels of the closed form)."""
    rng = np.random.RandomState(T)
    x = rng.randn(2, T).astype(np.float32)
    want = np.asarray(ja.inv_preemphasis(jnp.asarray(x), 0.97))
    got = ta.inv_preemphasis(torch.from_numpy(x), 0.97).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    # a round trip through the FIR filter
    back = ta.preemphasis(torch.from_numpy(got), 0.97).numpy()
    np.testing.assert_allclose(back, x, atol=2e-5 * np.abs(want).max())
    np.testing.assert_array_equal(
        ta.inv_preemphasis(torch.from_numpy(x), 0.97, enabled=False).numpy(),
        x)


def test_inv_preemphasis_block_boundaries_carry_the_state():
    """An impulse at the end of one block decays across the next blocks
    as k^n, exactly the scan's."""
    x = np.zeros((1, 4 * ta.IIR_BLOCK), np.float32)
    x[0, ta.IIR_BLOCK - 1] = 1.0
    got = ta.inv_preemphasis(torch.from_numpy(x), 0.5).numpy()[0]
    n = np.arange(x.shape[1]) - (ta.IIR_BLOCK - 1)
    want = np.where(n >= 0, 0.5 ** np.maximum(n, 0), 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("clip", [True, False])
def test_db_and_normalisation_match_jax(symmetric, clip):
    jhp, thp = _hp(symmetric_mels=symmetric,
                   allow_clipping_in_normalization=clip)
    rng = np.random.RandomState(3)
    amp = np.abs(rng.randn(2, 9, 11)).astype(np.float32) * 3
    amp[0, 0, :3] = 0.0                          # below min_level
    for jf, tf in ((lambda a: ja.amp_to_db(a, -100), lambda a:
                    ta.amp_to_db(a, -100)),
                   (ja.db_to_amp, ta.db_to_amp)):
        np.testing.assert_allclose(tf(torch.from_numpy(amp)).numpy(),
                                   np.asarray(jf(jnp.asarray(amp))),
                                   rtol=1e-6, atol=1e-6)
    db = (rng.randn(2, 9, 11) * 60 - 40).astype(np.float32)
    for jf, tf in ((ja.normalize_spec, ta.normalize_spec),
                   (ja.denormalize_spec, ta.denormalize_spec)):
        np.testing.assert_allclose(
            tf(torch.from_numpy(db), thp).numpy(),
            np.asarray(jf(jnp.asarray(db), jhp)), rtol=1e-6, atol=1e-5)


# --- spectrograms ------------------------------------------------------------


def test_offline_mel_basis_is_the_jax_one():
    np.testing.assert_array_equal(ta._offline_mel_basis(8000, 128, 12),
                                  ja._offline_mel_basis(8000, 128, 12))


@pytest.mark.parametrize("preemph,norm", [(False, False), (True, True)])
def test_spectrograms_match_jax(preemph, norm):
    jhp, thp = _hp(preemphasize=preemph, signal_normalization=norm)
    y = _signal(4)
    jy, ty = jnp.asarray(y), torch.from_numpy(y)
    pairs = [(ja.linear_spectrogram(jy, jhp), ta.linear_spectrogram(ty, thp)),
             (ja.mel_spectrogram(jy, jhp), ta.mel_spectrogram(ty, thp))]
    jm, jl = ja.mel_and_linear_spectrogram(jy, jhp)
    tm, tl = ta.mel_and_linear_spectrogram(ty, thp)
    pairs += [(jm, tm), (jl, tl)]
    # center=False: each signal reflect-padded by the caller
    pad = np.pad(y, ((0, 0), (64, 64)), mode="reflect")
    jm, jl = ja.mel_and_linear_spectrogram(jnp.asarray(pad), jhp,
                                           center=False)
    tm, tl = ta.mel_and_linear_spectrogram(torch.from_numpy(pad), thp,
                                           center=False)
    pairs += [(jm, tm), (jl, tl)]
    for want, got in pairs:
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SPEC_ATOL)
    # the two spectrograms of one STFT are the single ones
    np.testing.assert_allclose(pairs[2][1].numpy(), pairs[1][1].numpy(),
                               atol=1e-5)


def test_offline_mel_chain_matches_golden():
    """As ``tests/test_mel_golden.py`` holds the JAX package: the full
    offline mel chain against the committed independent numpy chain."""
    from tests.golden.gen_mel_golden import fixture_signal

    hp = HParams(sample_rate=22050, filter_length=1024, hop_length=256,
                 win_length=1024, n_mel_channels=80,
                 signal_normalization=False, preemphasize=False)
    y = fixture_signal(22050).astype(np.float32)
    got = ta.mel_spectrogram(torch.from_numpy(y)[None], hp).numpy()[0]
    want = np.load(GOLDEN_DIR / "mel_golden.npz")["fixture_mel_22050"]
    assert got.shape == want.shape
    assert float(np.mean(np.abs(got - want))) < 1e-3
    assert float(np.max(np.abs(got - want))) < 2e-2


# --- Griffin-Lim -------------------------------------------------------------


def _jax_phase(key, shape):
    """The initial phase ``griffin_lim`` draws from ``key``."""
    return np.array(2.0 * jnp.pi * jax.random.uniform(key, shape,
                                                         dtype=jnp.float32))


def test_griffin_lim_matches_jax_from_the_same_phase():
    jhp, thp = _hp()
    S = np.abs(np.asarray(jstft.stft_magnitude(
        jnp.asarray(_signal(5)), jstft.STFTParams(128, 32, 128))))
    key = jax.random.PRNGKey(7)
    want = np.asarray(ja.griffin_lim(jnp.asarray(S), jhp, key, n_iters=4))
    got = ta.griffin_lim(torch.from_numpy(S), thp, n_iters=4,
                         phase=torch.from_numpy(_jax_phase(key, S.shape)))
    assert tuple(got.shape) == want.shape == (2, 32 * (S.shape[-1] - 1))
    assert _rel(got.numpy(), want) < GL_REL
    # a generator draws the phase on its device; the same seed, the same
    # waveform
    g1 = ta.griffin_lim(torch.from_numpy(S), thp, torch.Generator().manual_seed(0),
                        n_iters=2)
    g2 = ta.griffin_lim(torch.from_numpy(S), thp, torch.Generator().manual_seed(0),
                        n_iters=2)
    assert torch.equal(g1, g2) and torch.isfinite(g1).all()


@pytest.mark.parametrize("preemph,norm", [(False, False), (True, True)])
def test_inverse_spectrograms_match_jax(preemph, norm):
    jhp, thp = _hp(preemphasize=preemph, signal_normalization=norm,
                   griffin_lim_iters=4)
    y = _signal(6)
    jm, jl = ja.mel_and_linear_spectrogram(jnp.asarray(y), jhp)
    key = jax.random.PRNGKey(3)
    want = np.asarray(ja.inv_linear_spectrogram(jl, jhp, key))
    got = ta.inv_spectrogram(torch.from_numpy(np.array(jl)), thp,
                             phase=torch.from_numpy(_jax_phase(key,
                                                               jl.shape)))
    assert ta.inv_spectrogram is ta.inv_linear_spectrogram
    assert _rel(got.numpy(), want) < GL_REL
    want = np.asarray(ja.inv_mel_spectrogram(jm, jhp, key))
    n_freq = thp.filter_length // 2 + 1
    got = ta.inv_mel_spectrogram(
        torch.from_numpy(np.array(jm)), thp,
        phase=torch.from_numpy(_jax_phase(key, (2, n_freq, jm.shape[-1]))))
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _rel(got.numpy(), want) < GL_REL


def test_small_helpers_match_jax():
    jhp, thp = _hp()
    x = np.linspace(-3, 2, 17, dtype=np.float32).reshape(1, 17)
    np.testing.assert_allclose(
        tmel.dynamic_range_decompression(torch.from_numpy(x), 2.0).numpy(),
        np.asarray(jmel.dynamic_range_decompression(jnp.asarray(x), 2.0)),
        rtol=1e-6)
    for n in (0, 1, 31, 32, 1000):
        assert tstft.num_frames(n, 32) == jstft.num_frames(n, 32)
    frames = [10, 250, 3]
    assert ta.frames_to_hours(frames, thp) == ja.frames_to_hours(frames, jhp)
    wav = np.zeros(12345, np.float32)
    assert ta.get_duration(wav, thp) == ja.get_duration(wav, jhp)


# --- the CLI's vocoder-free path ---------------------------------------------

CLI_HP = dict(
    sample_rate=8000, filter_length=128, hop_length=32, win_length=128,
    embedding_size=16, enc_conv_num_layers=1, enc_conv_channels=16,
    attention_rnn_dim=16, decoder_rnn_dim=16, attention_dim=8,
    attention_location_n_filters=4, attention_location_kernel_size=7,
    prenet_dim=8, n_mel_channels=8, postnet_embedding_dim=8,
    postnet_n_convolutions=2, max_decoder_steps=20)
CLI_WG = dict(n_mel_channels=8, n_flows=2, n_group=4, n_early_every=4,
              n_early_size=2, wn_n_layers=2, wn_n_channels=8,
              upsample_kernel=64, upsample_stride=32, sampling_rate=8000,
              hop_length=32)


def _jax_keep_masks(taco, tvars, seed, hp, B=1):
    """The JAX decoder's prenet masks of ``seed``, as
    ``tests/test_torch_synth.py`` draws them."""
    rng = taco.apply(tvars, method=JaxTacotron2.derive_rng,
                     rngs={"dropout": jax.random.PRNGKey(seed)})
    masks = []
    for rng_t in jax.random.split(rng, hp.max_decoder_steps):
        rng_pre, _ = jax.random.split(rng_t)
        layers = []
        for _ in range(2):
            rng_pre, sub = jax.random.split(rng_pre)
            layers.append(np.asarray(jax.random.bernoulli(
                sub, 0.5, (B, hp.prenet_dim))))
        masks.append(np.stack(layers))
    return torch.from_numpy(np.stack(masks))


def test_cli_griffin_lim_matches_the_jax_chain(tmp_path):
    """``--taco_checkpoint DIR`` without a vocoder: a port checkpoint of the
    JAX Tacotron's weights through ``synthesize_griffin_lim`` on the CPU
    against root ``inference.py``'s chain on the JAX Synthesizer (its mel,
    decompression, pinv, 4 Griffin-Lim rounds from PRNGKey(0)), with the
    JAX prenet masks and initial phase handed over."""
    from text2speech_tpu_torch.train.checkpoint import CheckpointManager
    from text2speech_tpu_torch.train.state import create_tacotron_state

    jhp, thp = JaxHParams(**CLI_HP), HParams(**CLI_HP)
    jwg, twg = JaxWaveGlowConfig(**CLI_WG), WaveGlowConfig(**CLI_WG)
    rng = jax.random.PRNGKey(0)
    taco = JaxTacotron2(jhp, n_vocab=N_SYMBOLS)
    tvars = jax.jit(taco.init)(
        {"params": rng, "dropout": rng}, jnp.zeros((1, 8), jnp.int32),
        jnp.asarray([8]), jnp.zeros((1, jhp.n_mel_channels, 8)),
        jnp.asarray([8]))
    # text_to_mel reads no vocoder weights
    jsyn = JaxSynthesizer(hp=jhp, taco=taco, taco_variables=tvars,
                          wg_cfg=jwg, waveglow=None, wg_variables=None,
                          use_denoiser=False)
    text = "안녕하세요."
    mel, lengths = jsyn.text_to_mel([text])
    T = int(np.asarray(lengths)[0])
    amp = jmel.dynamic_range_decompression(mel[:, :, :T])
    basis = ja._offline_mel_basis(jhp.sample_rate, jhp.filter_length,
                                  jhp.n_mel_channels)
    linear = jnp.maximum(1e-10, jnp.einsum(
        "fm,bmt->bft", jnp.asarray(np.linalg.pinv(basis)), amp))
    key = jax.random.PRNGKey(0)
    want = np.asarray(ja.griffin_lim(linear ** jhp.power, jhp, key,
                                     n_iters=4))[0]

    model = convert.load_tacotron(tvars, thp, N_SYMBOLS)
    CheckpointManager(str(tmp_path / "taco")).save(
        1, create_tacotron_state(model, thp))
    out = tmp_path / "gl.wav"
    args = inference.build_parser().parse_args(
        ["--taco_checkpoint", str(tmp_path / "taco"), "--text", text,
         "--griffin_lim_iters", "4", "--out", str(out),
         "--sample_rate", "8000"])
    got, frames = inference.synthesize_griffin_lim(
        args, thp, twg, "cpu", keep_masks=_jax_keep_masks(taco, tvars, 0,
                                                           jhp),
        phase=torch.from_numpy(_jax_phase(key, linear.shape)))
    assert frames == T and got.shape == want.shape == (32 * (T - 1),)
    assert _rel(got, want) < GL_REL
    from scipy.io import wavfile

    sr, pcm = wavfile.read(out)
    assert sr == 8000 and pcm.dtype == np.int16 and pcm.shape == got.shape
    # a decoder that stops at its first frame leaves nothing to invert
    import dataclasses

    with pytest.raises(ValueError, match="two or more"):
        inference.synthesize_griffin_lim(
            args, dataclasses.replace(thp, gate_threshold=0.0), twg, "cpu")


def test_cli_parses_the_griffin_lim_flags():
    p = inference.build_parser()
    args = p.parse_args(["--taco_checkpoint", "t"])
    assert args.griffin_lim_iters == 60 and args.waveglow_checkpoint is None
    assert p.parse_args(["--taco_checkpoint", "t", "--griffin_lim_iters",
                         "8"]).griffin_lim_iters == 8
    assert isinstance(args, argparse.Namespace)
