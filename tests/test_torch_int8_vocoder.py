"""Parity of the port's int8 vocoder (``prepare_fused_int8``,
``infer_fused_int8``, ``Synthesizer(int8_vocoder=True)``) with the JAX
package's (``quantize_waveglow_int8``, ``infer_fused_int8``, its
Synthesizer), whose Pallas kernels run here in interpret mode.

Config: the tiny one of ``tests/test_int8_vocoder.py`` (4 flows, 3 WN
layers, C=32, M = 16 * 8 = 128), every parameter perturbed by 0.01 N(0, 1)
so the zero-init ``end`` convs are live.  Mels and noise come from numpy
and go to both sides; both run bf16 around the int8 layers, as served.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_synth import DKW, HP, WG, _jax_draws
from text2speech_tpu.config import WaveGlowConfig
from text2speech_tpu.infer import Synthesizer as JaxSynthesizer
from text2speech_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from text2speech_tpu.models.waveglow import WaveGlow as JaxWaveGlow
from text2speech_tpu.models.waveglow_fused import (
    infer_fused as jax_fused, infer_fused_int8 as jax_fused_int8,
    quantize_waveglow_int8)
from text2speech_tpu.text import N_SYMBOLS
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.infer import Synthesizer
from text2speech_tpu_torch.models.waveglow_fused import (
    FusedWaveGlowInt8, infer_fused_int8, prepare_fused_int8)

torch.set_num_threads(1)

CFG = WaveGlowConfig(
    n_mel_channels=16, n_flows=4, n_group=8, n_early_every=2, n_early_size=2,
    wn_n_layers=3, wn_n_channels=32, wn_kernel_size=3,
    upsample_kernel=64, upsample_stride=16,
)
B, FRAMES, SIGMA = 2, 24, 0.8


def _numpy_tree(tree):
    """A JAX tree -> nested dict of numpy arrays (bf16 leaves as f32, which
    holds every bf16 value exactly)."""
    return jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)
                             if a.dtype == jnp.bfloat16 else a), tree)


@pytest.fixture(scope="module")
def setup():
    model = JaxWaveGlow(CFG)
    variables = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, CFG.n_mel_channels, 20)),
        jnp.zeros((1, 20 * CFG.upsample_stride)))
    prng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.01 * prng.randn(*x.shape).astype(
            np.float32), variables["params"])
    qparams = quantize_waveglow_int8(params, CFG)
    port = convert.load_waveglow({"params": params}, CFG)
    bridged = convert.fused_int8_from_qparams(_numpy_tree(qparams), CFG)
    rng = np.random.RandomState(0)
    spect = rng.randn(B, CFG.n_mel_channels, FRAMES).astype(np.float32)
    Tg = FRAMES * CFG.upsample_stride // CFG.n_group
    noise = [rng.randn(*s).astype(np.float32)
             for s in port.noise_shapes(B, Tg)]
    return model, params, qparams, port, bridged, spect, noise


def test_prepare_fused_int8_matches_quantize_waveglow_int8(setup):
    """The port's quantizer on converted weights against the JAX package's,
    read through the weight bridge.  Both quantize the f32 weight-norm
    fold; the fold itself is computed by another framework (a sum of
    squares in another order), so a weight can differ in its last f32 bit.
    Scales therefore agree to 1e-6 relative, and an int8 payload may differ
    by one count where w / s sits on a rounding knife edge: at most one
    such value in 10^4 (none is typical)."""
    *_, port, bridged, _, _ = setup
    got = prepare_fused_int8(port)
    assert isinstance(got, FusedWaveGlowInt8) and got.dtype == torch.bfloat16
    n_vals = n_flips = 0
    for wg, wb_ in zip(got.flows, bridged.flows):
        assert wg.keys() == wb_.keys()
        for fam in ("cond", "in", "rs"):
            assert len(wg[fam]) == len(wb_[fam])
            for tg, tb in zip(wg[fam], wb_[fam]):
                if tg is None:
                    assert tb is None      # layer 0's taps stay bf16
                    continue
                (qg, sg, bg), (qb, sb, bb) = tg, tb
                assert qg.dtype == torch.int8 and qg.is_contiguous()
                assert qg.shape == qb.shape
                diff = (qg.int() - qb.int()).abs()
                assert diff.max().item() <= 1
                n_vals += diff.numel()
                n_flips += int(diff.sum())
                torch.testing.assert_close(sg, sb, rtol=1e-6, atol=0)
                torch.testing.assert_close(bg, bb, rtol=1e-6, atol=1e-7)
        for key in ("start_k", "start_b", "end_w", "w_inv"):
            torch.testing.assert_close(wg[key].float(), wb_[key].float(),
                                       rtol=1e-5, atol=1e-6)
        # folds over bf16 casts of the weights: where the f32 weight-norm
        # folds differ in the last bit, a cast can land one bf16 step
        # (2^-8) away, which moves a folded sum by that step of one term:
        # two bf16 steps at the folded tensor's peak
        for tg, tb in zip(wg["first"] + wg["final"],
                          wb_["first"] + wb_["final"]):
            assert tg.dtype == tb.dtype and tg.shape == tb.shape
            torch.testing.assert_close(
                tg.float(), tb.float(), rtol=0,
                atol=2.0 ** -7 * tb.abs().max().item())
    assert n_flips <= n_vals * 1e-4, (n_flips, n_vals)
    torch.testing.assert_close(got.up_k.float(), bridged.up_k.float(),
                               rtol=0, atol=0)


def test_bridge_carries_the_jax_payloads_bit_for_bit(setup):
    """``fused_int8_from_qparams``: the same int8 values, transposed to
    output-major, and the same scales and biases."""
    _, _, qparams, _, bridged, _, _ = setup
    L = CFG.wn_n_layers
    for k in range(CFG.n_flows):
        wn = qparams[f"wn{k}"]
        w = bridged.flows[k]
        for li in range(L):
            for fam, key in (("cond", f"cond{li}"), ("in", f"in{li}"),
                             ("rs", f"rs{li}")):
                if key not in wn:
                    continue
                q, s, b = w[fam][li]
                np.testing.assert_array_equal(
                    q.numpy(), np.swapaxes(np.asarray(wn[key]["q"]), -1, -2))
                np.testing.assert_array_equal(s.numpy(),
                                              np.asarray(wn[key]["s"]))
                np.testing.assert_array_equal(b.numpy(),
                                              np.asarray(wn[key]["b"]))
        assert w["in"][0] is None and len(w["rs"]) == L - 1


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_infer_fused_int8_matches_jax(setup):
    """Same int8 weights (through the bridge), mel and noise on both
    sides.  The arithmetic is the same; f32 operations around the exact
    integer products run in another order, so a gate value or a hidden
    payload can land on the other side of a rounding knife edge (one count
    = 1/127 of a row's peak) and a bf16 audio value one bf16 step away;
    both are carried through the later layers and flows.  Bounds: 8 bf16
    steps at the audio's peak and 2e-2 relative L2, the bound the bf16
    fused path is held to end to end (``tests/test_torch_synth.py``)."""
    _, _, qparams, _, bridged, spect, noise = setup
    want = np.asarray(jax_fused_int8(
        qparams, CFG, jnp.asarray(spect), None, SIGMA,
        noise=tuple(jnp.asarray(z) for z in noise)))
    with torch.inference_mode():
        got = infer_fused_int8(bridged, torch.from_numpy(spect), SIGMA,
                               noise=tuple(map(torch.from_numpy, noise)))
    got = got.numpy()
    assert got.shape == want.shape == (B, FRAMES * CFG.upsample_stride)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want,
                               atol=8 * 2.0 ** -8 * np.abs(want).max())
    assert _rel(got, want) < 2e-2, _rel(got, want)


def test_infer_fused_int8_tracks_f32(setup):
    """The JAX package's own bound (``tests/test_int8_vocoder.py:301-310``):
    relative L2 against the f32 ``WaveGlow.infer`` under max(5 x the bf16
    fused path's, 0.05)."""
    model, params, _, port, _, spect, noise = setup
    nz = tuple(map(torch.from_numpy, noise))
    with torch.inference_mode():
        ref = port.infer(torch.from_numpy(spect), SIGMA, noise=nz).numpy()
        got = infer_fused_int8(prepare_fused_int8(port),
                               torch.from_numpy(spect), SIGMA,
                               noise=nz).numpy()
    bf16 = np.asarray(jax_fused(params, CFG, jnp.asarray(spect), None, SIGMA,
                                noise=tuple(jnp.asarray(z) for z in noise)))
    err, err_bf16 = _rel(got, ref), _rel(bf16, ref)
    assert err < max(5 * err_bf16, 0.05), (err, err_bf16)


def test_infer_fused_int8_deterministic_under_a_generator(setup):
    *_, port, _, spect, _ = setup
    fw = prepare_fused_int8(port)
    mel = torch.from_numpy(spect[:1, :, :12])
    with torch.inference_mode():
        a = infer_fused_int8(fw, mel, 0.7,
                             generator=torch.Generator().manual_seed(5))
        b = fw.infer(mel, 0.7, generator=torch.Generator().manual_seed(5))
        c = infer_fused_int8(fw, mel, 0.7,
                             generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_int8_needs_two_layers_and_matching_noise(setup):
    *_, port, _, spect, noise = setup
    one = WaveGlowConfig(n_mel_channels=8, n_flows=2, n_group=4,
                         n_early_every=4, n_early_size=2, wn_n_layers=1,
                         wn_n_channels=16, upsample_kernel=64,
                         upsample_stride=16)
    from text2speech_tpu_torch.models.waveglow import WaveGlow

    with pytest.raises(ValueError, match="wn_n_layers >= 2"):
        prepare_fused_int8(WaveGlow(one))
    bad = [torch.from_numpy(z) for z in noise]
    bad[1] = bad[1][:, :-1]
    with pytest.raises(ValueError, match="noise draw"):
        infer_fused_int8(prepare_fused_int8(port), torch.from_numpy(spect),
                         SIGMA, noise=tuple(bad))


@pytest.fixture(scope="module")
def int8_pair():
    """The JAX Synthesizer and the port's, both with the int8 vocoder, on
    the same perturbed weights (the models of ``tests/test_torch_synth``)."""
    rng = jax.random.PRNGKey(0)
    taco = JaxTacotron2(HP, n_vocab=N_SYMBOLS)
    tvars = taco.init({"params": rng, "dropout": rng},
                      jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
                      jnp.zeros((1, HP.n_mel_channels, 8)), jnp.asarray([8]))
    wg = JaxWaveGlow(WG)
    wvars = wg.init(rng, jnp.zeros((1, WG.n_mel_channels, 16)),
                    jnp.zeros((1, 16 * WG.upsample_stride)))
    prng = np.random.RandomState(1)
    wparams = jax.tree.map(
        lambda x: np.asarray(x) + 0.01 * prng.randn(*x.shape).astype(
            np.float32), wvars["params"])
    jsyn = JaxSynthesizer(
        hp=HP, taco=taco, taco_variables=tvars, wg_cfg=WG, waveglow=wg,
        wg_variables={"params": wparams}, use_denoiser=True,
        int8_vocoder=True, denoiser_kwargs=DKW)
    tsyn = Synthesizer(
        HP, convert.load_tacotron(tvars, HP, N_SYMBOLS), WG,
        convert.load_waveglow({"params": wparams}, WG),
        use_denoiser=True, int8_vocoder=True, denoiser_kwargs=DKW)
    return taco, tvars, jsyn, tsyn


def test_int8_synthesizer_matches_jax(int8_pair):
    """``Synthesizer(int8_vocoder=True)`` with the denoiser, end to end,
    given the prenet masks and the vocoder noise that JAX drew.  Mels are
    f32 on both sides (1e-4).  Audio: as in
    ``test_infer_fused_int8_matches_jax``, with two more sources of
    knife-edge flips: each side quantizes its own weight-norm fold, and the
    denoiser resynthesizes, so a step taken at a larger value can land on a
    smaller sample.  Bounds: 8 bf16 steps at the peak and 3e-2 relative
    L2."""
    taco, tvars, jsyn, tsyn = int8_pair
    assert isinstance(tsyn.fused, FusedWaveGlowInt8)
    assert tsyn.vocoder is tsyn.fused
    texts = ["안녕하세요.", "존경하는 사람"]
    seed = 3
    jmel, jlen = jsyn.text_to_mel(texts, seed)
    jlen = np.asarray(jlen)
    Tg = int(jlen.max()) * WG.upsample_stride // WG.n_group
    keep, noise = _jax_draws(taco, tvars, seed, Tg, len(texts))
    tmel, tlen = tsyn.text_to_mel(texts, seed, keep_masks=keep)
    np.testing.assert_array_equal(tlen.numpy(), jlen)
    np.testing.assert_allclose(tmel.numpy(), np.asarray(jmel), atol=1e-4)

    want = jsyn.synthesize(texts, seed=seed, denoiser_strength=0.1)
    got = tsyn.synthesize(texts, seed=seed, denoiser_strength=0.1,
                          keep_masks=keep, noise=noise)
    for g, w, n in zip(got, want, jlen):
        assert g.shape == w.shape == (int(n) * WG.upsample_stride,)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=8 * 2.0 ** -8 * np.abs(w).max())
        assert _rel(g, w) < 3e-2, _rel(g, w)
