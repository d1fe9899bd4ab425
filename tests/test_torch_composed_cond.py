"""The composed-conditioning vocoder of the port
(``precompute_composed_cond`` and ``infer_fused(composed_cond=...)`` in
``text2speech_tpu_torch.models.waveglow_fused``) against the JAX package's
(``text2speech_tpu.models.waveglow_fused``), whose ``dcond`` Pallas kernels
run here in interpret mode, on the same perturbed weights, mel and noise
made with numpy from a seed.

Tolerances, float32 throughout: the phase-expanded weights ``Wc`` are sums
of n_mel * n_group = 64 float32 products in another order: 1e-6; the audio
passes 3 flows x 3 layers of float32 products in another order: 3e-4, the
JAX package's own bound for composed against in-kernel conditioning
(``tests/test_pallas.py:254-287``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text2speech_tpu.config import WaveGlowConfig as JaxWaveGlowConfig
from text2speech_tpu.models.waveglow import WaveGlow as JaxWaveGlow
from text2speech_tpu.models import waveglow_fused as jfused
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.config import WaveGlowConfig
from text2speech_tpu_torch.models import waveglow_fused as tfused

torch.set_num_threads(1)

KW = dict(n_mel_channels=8, n_flows=3, n_group=8, n_early_every=2,
          n_early_size=2, wn_n_layers=3, wn_n_channels=32,
          upsample_kernel=64, upsample_stride=16)
FRAMES = 70      # T_g = 140: the JAX path pads it to one 512-row tile
ATOL = 3e-4


@pytest.fixture(scope="module")
def pair():
    """(JAX params, JAX cfg, the port's WaveGlow, mel, noise)."""
    jcfg = JaxWaveGlowConfig(**KW)
    rng = np.random.RandomState(0)
    mel = rng.randn(2, 8, FRAMES).astype(np.float32)
    variables = JaxWaveGlow(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(mel),
        jnp.zeros((2, FRAMES * 16)))
    prng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.01 * prng.randn(*x.shape).astype(
            np.float32), variables["params"])
    model = convert.load_waveglow({"params": params}, WaveGlowConfig(**KW))
    Tg = FRAMES * 16 // 8
    noise = tuple(rng.randn(*s).astype(np.float32)
                  for s in model.noise_shapes(2, Tg))
    return params, jcfg, model, mel, noise


def test_precompute_composed_cond_matches_jax(pair):
    params, jcfg, model, _, _ = pair
    want = jfused.precompute_composed_cond(params, jcfg,
                                           compute_dtype=jnp.float32)
    got = tfused.precompute_composed_cond(model, torch.float32)
    assert sorted(got) == sorted(want) == list(range(jcfg.n_flows))
    for k in want:
        Wc, b_eff = got[k]
        assert tuple(Wc.shape) == want[k][0].shape == (4, 2, 8, 2 * 32 * 3)
        np.testing.assert_allclose(Wc.numpy(), np.asarray(want[k][0]),
                                   atol=1e-6)
        np.testing.assert_allclose(b_eff.numpy(), np.asarray(want[k][1]),
                                   atol=1e-6)
    # stored so that infer_fused reads it as one matrix without a copy
    r, P, M, O = got[0][0].shape
    assert got[0][0].permute(0, 2, 1, 3).is_contiguous()


def test_composed_cond_dtype_is_rounded_once(pair):
    *_, model, _, _ = pair
    f32 = tfused.precompute_composed_cond(model, torch.float32)
    bf = tfused.precompute_composed_cond(model, torch.bfloat16)
    for k in f32:
        assert bf[k][0].dtype == torch.bfloat16
        assert bf[k][1].dtype == torch.float32
        assert torch.equal(bf[k][0], f32[k][0].to(torch.bfloat16))
        assert torch.equal(bf[k][1], f32[k][1])


def test_composed_infer_fused_matches_jax_and_the_in_kernel_path(pair):
    params, jcfg, model, mel, noise = pair
    jcc = jfused.precompute_composed_cond(params, jcfg,
                                          compute_dtype=jnp.float32)
    want = np.asarray(jfused.infer_fused(
        params, jcfg, jnp.asarray(mel), None, 0.7,
        compute_dtype=jnp.float32, noise=tuple(map(jnp.asarray, noise)),
        composed_cond=jcc))
    fw = tfused.prepare_fused(model, torch.float32)
    cc = tfused.precompute_composed_cond(model, torch.float32)
    tn = tuple(map(torch.from_numpy, noise))
    tm = torch.from_numpy(mel)
    got = tfused.infer_fused(fw, tm, 0.7, noise=tn, composed_cond=cc)
    assert got.shape == want.shape == (2, FRAMES * 16)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    inkernel = tfused.infer_fused(fw, tm, 0.7, noise=tn)
    np.testing.assert_allclose(got.numpy(), inkernel.numpy(), atol=ATOL)
    exact = model.infer(tm, 0.7, noise=tn)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=ATOL)
    # plain=True selects the same plain layers a CPU tensor takes anyway
    again = tfused.infer_fused(fw, tm, 0.7, noise=tn, composed_cond=cc,
                               plain=True)
    assert torch.equal(got, again)


@pytest.mark.parametrize("layers", [1, 2])
def test_composed_infer_fused_shallow_wn(layers):
    """L = 1 (no first-layer kernel: the final layer reads slice 0) and
    L = 2 (first and final only) against the plain f32 vocoder."""
    from text2speech_tpu_torch.infer import random_weights_
    from text2speech_tpu_torch.models.waveglow import WaveGlow

    cfg = WaveGlowConfig(**{**KW, "wn_n_layers": layers})
    gen = torch.Generator().manual_seed(layers)
    model = WaveGlow(cfg)
    random_weights_(model, gen, out_first=False)
    with torch.no_grad():
        for wn in model.wn:
            wn.end_w.mul_(0.05)
    mel = torch.randn(1, 8, 23, generator=gen)
    noise = tuple(torch.randn(s, generator=gen)
                  for s in model.noise_shapes(1, 46))
    fw = tfused.prepare_fused(model, torch.float32)
    cc = tfused.precompute_composed_cond(model, torch.float32)
    got = tfused.infer_fused(fw, mel, 0.7, noise=noise, composed_cond=cc)
    want = model.infer(mel, 0.7, noise=noise)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_composed_bf16_rounds_cond_all_where_the_jax_path_does(pair):
    """bf16: ``cond_all`` is rounded to bf16 when it is materialised (the
    matmul's f32 sums rounded once, the bias added in bf16) and the layers
    widen it to f32: the same places as ``waveglow_fused.py:409-413``.  The
    audio then agrees with the JAX bf16 composed path as the in-kernel bf16
    paths agree (``tests/test_torch_synth.py``): single bf16 steps flip on
    scattered samples, 2^-6 of the peak and 2e-2 relative L2."""
    params, jcfg, model, mel, noise = pair
    jcc = jfused.precompute_composed_cond(params, jcfg)
    want = np.asarray(jfused.infer_fused(
        params, jcfg, jnp.asarray(mel), None, 0.7,
        noise=tuple(map(jnp.asarray, noise)), composed_cond=jcc))
    fw = tfused.prepare_fused(model, torch.bfloat16)
    cc = tfused.precompute_composed_cond(model, torch.bfloat16)
    got = tfused.infer_fused(fw, torch.from_numpy(mel), 0.7,
                             noise=tuple(map(torch.from_numpy, noise)),
                             composed_cond=cc).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2.0 ** -6 * np.abs(want).max())
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2


def test_precompute_composed_cond_rejects_unaligned_upsample():
    from text2speech_tpu_torch.models.waveglow import WaveGlow

    cfg = WaveGlowConfig(**{**KW, "upsample_stride": 12,
                            "upsample_kernel": 48})
    with pytest.raises(ValueError, match="n_group"):
        tfused.precompute_composed_cond(WaveGlow(cfg), torch.float32)
