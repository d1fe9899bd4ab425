"""Parity of the port's long-form synthesis (``models/chunked.py``,
``Synthesizer.mel_to_audio_long`` / ``synthesize_long``) with the JAX
package's ``models/chunked.py``, and the equivalence it promises: chunked
output equals a single pass given the same full-utterance noise.

Config: that of ``tests/test_chunked.py`` (6 flows, 3 WN layers, C=32; each
stack reaches 7 groups a side, 42 over the flows = 21 frames, + 3 frames of
upsampler = 24), every parameter perturbed so the ``end`` convs are live.
Noise is drawn with numpy at full length and handed to both sides.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_synth import HP, WG
from text2speech_tpu.config import WaveGlowConfig
from text2speech_tpu.models import chunked as jchunked
from text2speech_tpu.models import waveglow_fused as jwf
from text2speech_tpu.models.waveglow import WaveGlow as JaxWaveGlow
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.infer import random_synthesizer
from text2speech_tpu_torch.models import chunked
from text2speech_tpu_torch.models.waveglow_fused import (prepare_fused,
                                                         prepare_fused_int8)

torch.set_num_threads(1)

CFG = WaveGlowConfig(
    n_mel_channels=16, n_flows=6, n_group=8, n_early_every=2, n_early_size=2,
    wn_n_layers=3, wn_n_channels=32, wn_kernel_size=3,
    upsample_kernel=64, upsample_stride=16, segment_length=1024,
)
FRAMES, SIGMA = 200, 0.9
HOP = CFG.upsample_stride


@pytest.fixture(scope="module")
def setup():
    model = JaxWaveGlow(CFG)
    variables = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, CFG.n_mel_channels, 20)),
        jnp.zeros((1, 20 * HOP)))
    prng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.01 * prng.randn(*x.shape).astype(
            np.float32), variables["params"])
    port = convert.load_waveglow({"params": params}, CFG)
    rng = np.random.RandomState(3)
    spect = rng.randn(1, CFG.n_mel_channels, FRAMES).astype(np.float32)
    noise = [rng.randn(1, FRAMES * HOP // CFG.n_group, w).astype(np.float32)
             for w in chunked.noise_schedule(CFG)]
    return model, params, port, spect, noise


@pytest.mark.parametrize("cfg", [
    CFG, WaveGlowConfig(), WG,
    WaveGlowConfig(n_flows=4, n_early_every=4, wn_n_layers=5,
                   upsample_kernel=512, upsample_stride=128),
])
def test_schedule_and_overlap_equal_jax(cfg):
    assert chunked.noise_schedule(cfg) == jchunked.noise_schedule(cfg)
    assert (chunked.receptive_overlap_frames(cfg)
            == jchunked.receptive_overlap_frames(cfg))


def test_reference_values():
    assert chunked.noise_schedule(WaveGlowConfig()) == [4, 2, 2]
    assert chunked.receptive_overlap_frames(CFG) == 24
    assert chunked.receptive_overlap_frames(WaveGlowConfig()) == 99


def test_draw_noise_shapes_and_determinism():
    a = chunked.draw_noise(CFG, torch.Generator().manual_seed(4), 2, 50)
    b = chunked.draw_noise(CFG, torch.Generator().manual_seed(4), 2, 50)
    assert [tuple(z.shape) for z in a] == [(2, 50, 4), (2, 50, 2), (2, 50, 2)]
    assert all(z.dtype == torch.float32 for z in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _jnoise(noise):
    return tuple(jnp.asarray(z) for z in noise)


def _tnoise(noise):
    return tuple(torch.from_numpy(z) for z in noise)


def test_infer_long_plain_matches_jax_and_single_pass(setup):
    """f32 on both sides.  Port against JAX: the same products summed in
    another order through 6 flows, 2e-4 on audio of unit scale (the JAX
    test's own bound for chunked against single pass).  Chunked against the
    port's single pass: the same bound on the interior, and 1e-6 at the
    utterance's ends, where the clamped windows see the same zero padding
    and compute the same values."""
    model, params, port, spect, noise = setup
    kw = dict(chunk_frames=32, overlap_frames=64)
    want = np.asarray(jchunked.infer_long(
        model, {"params": params}, jnp.asarray(spect), None, sigma=SIGMA,
        noise=_jnoise(noise), **kw))
    with torch.inference_mode():
        got = chunked.infer_long(port, torch.from_numpy(spect), SIGMA,
                                 noise=_tnoise(noise), **kw).numpy()
        single = port.infer(torch.from_numpy(spect), SIGMA,
                            noise=_tnoise(noise)).numpy()
    assert got.shape == want.shape == (1, FRAMES * HOP)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    np.testing.assert_allclose(got, single, atol=2e-4, rtol=0)
    np.testing.assert_allclose(got[:, :8 * HOP], single[:, :8 * HOP],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[:, -8 * HOP:], single[:, -8 * HOP:],
                               atol=1e-6, rtol=0)


def test_infer_long_default_overlap_matches_single_pass(setup):
    """``overlap_frames=None`` is the flow stack's receptive field, the
    upsampler's r - 1 frames included; 150 frames in windows of 32 + 2 * 24
    give 5 windows whose last is clamped to the end."""
    _, _, port, spect, noise = setup
    mel = torch.from_numpy(spect[:, :, :150])
    nz = tuple(z[:, :150 * HOP // CFG.n_group] for z in _tnoise(noise))
    with torch.inference_mode():
        got = chunked.infer_long(port, mel, SIGMA, chunk_frames=32, noise=nz)
        single = port.infer(mel, SIGMA, noise=nz)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=2e-4,
                               rtol=0)


def test_infer_long_fused_matches_jax(setup, monkeypatch):
    """Windows through the fused layer path, pinned to f32 on both sides as
    ``tests/test_chunked.py`` pins it, so the comparison is numerical:
    3e-4, that test's bound."""
    model, params, port, spect, noise = setup
    kw = dict(chunk_frames=48, overlap_frames=40)
    monkeypatch.setattr(
        jwf, "infer_fused",
        functools.partial(jwf.infer_fused, compute_dtype=jnp.float32))
    want = np.asarray(jchunked.infer_long(
        model, {"params": params}, jnp.asarray(spect), None, sigma=SIGMA,
        noise=_jnoise(noise), fused=True, **kw))
    fw = prepare_fused(port, torch.float32)
    with torch.inference_mode():
        got = chunked.infer_long(fw, torch.from_numpy(spect), SIGMA,
                                 noise=_tnoise(noise), **kw).numpy()
        single = fw.infer(torch.from_numpy(spect), SIGMA,
                          noise=_tnoise(noise)).numpy()
    assert got.shape == want.shape == (1, FRAMES * HOP)
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=0)
    np.testing.assert_allclose(got, single, atol=3e-4, rtol=0)


def test_infer_long_int8_matches_jax_and_single_pass(setup):
    """Windows through the int8 path, bf16 around it, on the same int8
    weights (through the bridge).  Quantization is per row, so a window's
    row scales are the single pass's and the interiors carry the same
    quantized values.  Chunked against the port's single pass: bf16
    coupling arithmetic differs at window edges, 0.02 absolute on audio of
    unit scale, the JAX test's bound (``tests/test_chunked.py:199``).  Port
    against JAX: knife-edge rounding between the frameworks, carried
    through the later layers and flows, as in ``tests/
    test_torch_int8_vocoder.py``: 8 bf16 steps at the audio's peak and 2e-2
    relative L2."""
    model, params, port, spect, noise = setup
    kw = dict(chunk_frames=48, overlap_frames=40)
    qparams = jwf.quantize_waveglow_int8(params, CFG)
    want = np.asarray(jchunked.infer_long(
        model, {"params": params}, jnp.asarray(spect), None, sigma=SIGMA,
        noise=_jnoise(noise), int8_params=qparams, **kw))
    tree = jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)
                             if a.dtype == jnp.bfloat16 else a), qparams)
    fw = convert.fused_int8_from_qparams(tree, CFG)
    with torch.inference_mode():
        got = chunked.infer_long(fw, torch.from_numpy(spect), SIGMA,
                                 noise=_tnoise(noise), **kw).numpy()
        single = fw.infer(torch.from_numpy(spect), SIGMA,
                          noise=_tnoise(noise)).numpy()
    assert got.shape == want.shape == (1, FRAMES * HOP)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=8 * 2.0 ** -8 * np.abs(want).max())
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2
    np.testing.assert_allclose(got, single, atol=0.02, rtol=0)


@pytest.mark.parametrize("which", ["plain", "fused", "int8"])
def test_short_utterance_takes_a_single_pass(setup, which):
    """``frames <= chunk + 2 * overlap``: one pass, the same values."""
    _, _, port, spect, noise = setup
    vocoder = {"plain": lambda: port, "fused": lambda: prepare_fused(port),
               "int8": lambda: prepare_fused_int8(port)}[which]()
    mel = torch.from_numpy(spect[:, :, :40])
    nz = tuple(z[:, :40 * HOP // CFG.n_group] for z in _tnoise(noise))
    with torch.inference_mode():
        got = chunked.infer_long(vocoder, mel, 1.0, chunk_frames=32,
                                 overlap_frames=16, noise=nz)
        want = vocoder.infer(mel, 1.0, noise=nz)
    assert torch.equal(got, want)


def test_infer_long_draws_from_the_generator(setup):
    _, _, port, spect, _ = setup
    mel = torch.from_numpy(spect)
    with torch.inference_mode():
        a, b, c = (chunked.infer_long(
            port, mel, SIGMA, chunk_frames=64, overlap_frames=32,
            generator=torch.Generator().manual_seed(s)) for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_chunking_needs_whole_groups_per_frame(setup):
    _, _, port, spect, _ = setup
    odd = dataclasses.replace(CFG, upsample_stride=20, upsample_kernel=80)
    port_odd = convert.WaveGlow(odd)
    with pytest.raises(ValueError, match="hop % n_group"):
        chunked.infer_long(port_odd, torch.from_numpy(spect))


@pytest.mark.parametrize("which", ["plain", "fused", "int8"])
def test_synthesize_long_matches_synthesize(which):
    """Text to waveforms through the chunked path against the single pass,
    on seeded random weights: the same decoder masks (seed) and the same
    noise (drawn once at full length from seed + 1, in the order the single
    pass draws it).  80 decoded frames in chunks of 8 with the default
    overlap (17 frames at this config) are 10 windows.  Plain f32: 2e-4.
    Fused bf16 and int8: the windows' bf16 roundings differ from the single
    pass's at the seams' far side only by values that were rounded from
    sums taken over the same terms, so agreement is at the level of a few
    bf16 steps: 4 steps at the peak."""
    hp = dataclasses.replace(HP, max_decoder_steps=80)
    synth = random_synthesizer(
        hp, WG, seed=0, device="cpu", use_denoiser=False,
        use_fused_vocoder=which == "fused", int8_vocoder=which == "int8")
    texts = ["안녕하세요.", "존경하는 사람"]
    want = synth.synthesize(texts, seed=2)
    got = synth.synthesize_long(texts, seed=2, chunk_frames=8)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (80 * WG.upsample_stride,)
        assert np.isfinite(g).all()
        atol = 2e-4 if which == "plain" else 4 * 2.0 ** -8 * np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)
    # the mel-level entry point, with the noise given explicitly
    mel, _ = synth.text_to_mel(texts, seed=2)
    noise = chunked.draw_noise(WG, torch.Generator().manual_seed(9), 2,
                               80 * WG.upsample_stride // WG.n_group)
    a = synth.mel_to_audio_long(mel, chunk_frames=8, noise=noise)
    b = synth.mel_to_audio(mel, noise=noise)
    atol = 2e-4 if which == "plain" else 4 * 2.0 ** -8 * b.abs().max().item()
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol, rtol=0)
