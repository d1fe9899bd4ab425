"""Parity of the port's WaveGlow (plain ``WaveGlow.infer`` and the fused
serving path ``infer_fused``) with the JAX package's, and the weight
bridge's round trip.

Config: the tiny one of ``tests/test_pallas.py`` (4 flows, 3 WN layers,
C=32), every parameter perturbed by 0.01 N(0, 1) so the zero-init ``end``
convs are live and the audio depends on the mel.  300 mel frames give
T_g = 600 groups, which leaves the JAX path a partial 512-row tile.  Noise
is drawn with numpy and handed to both sides.  Everything is float32.

Tolerance 1e-4 absolute on audio of unit scale: both sides compute the
same float32 products and sums in another order (XLA conv and einsum on
one side, PyTorch matmul and conv on the other), through 4 flows whose
exp(-log_s) coupling and f32 matrix inverses amplify rounding mildly."""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text2speech_tpu.config import WaveGlowConfig
from text2speech_tpu.models.waveglow import WaveGlow as JaxWaveGlow
from text2speech_tpu.models.waveglow_fused import infer_fused as jax_fused
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.models.waveglow_fused import (infer_fused,
                                                         prepare_fused)

torch.set_num_threads(1)

CFG = WaveGlowConfig(
    n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2,
    n_early_size=2, wn_n_layers=3, wn_n_channels=32,
    upsample_kernel=64, upsample_stride=16,
)
B, FRAMES, SIGMA = 2, 300, 0.8
ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    spect = rng.randn(B, CFG.n_mel_channels, FRAMES).astype(np.float32)
    model = JaxWaveGlow(CFG)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(spect[:, :, :20]),
                           jnp.zeros((B, 20 * CFG.upsample_stride)))
    prng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.01 * prng.randn(*x.shape).astype(
            np.float32), variables["params"])
    port = convert.load_waveglow({"params": params}, CFG)
    Tg = FRAMES * CFG.upsample_stride // CFG.n_group
    nrng = np.random.RandomState(2)
    noise = [nrng.randn(*s).astype(np.float32)
             for s in port.noise_shapes(B, Tg)]
    return model, params, port, spect, noise


def test_plain_infer_matches_jax(setup):
    model, params, port, spect, noise = setup
    want = np.asarray(model.apply(
        {"params": params}, jnp.asarray(spect), None, SIGMA,
        noise=tuple(jnp.asarray(z) for z in noise), method=JaxWaveGlow.infer))
    with torch.inference_mode():
        got = port.infer(torch.from_numpy(spect), SIGMA,
                         noise=tuple(torch.from_numpy(z) for z in noise))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_fused_infer_matches_jax_over_all_samples(setup):
    """The port pads nothing and reads past T_g as zero; the JAX path pads
    to its tile and masks.  The two agree on every one of the T_g *
    n_group samples, tail included."""
    _, params, port, spect, noise = setup
    want = np.asarray(jax_fused(
        params, CFG, jnp.asarray(spect), None, SIGMA,
        compute_dtype=jnp.float32,
        noise=tuple(jnp.asarray(z) for z in noise)))
    with torch.inference_mode():
        got = infer_fused(prepare_fused(port, torch.float32),
                          torch.from_numpy(spect), SIGMA,
                          noise=tuple(torch.from_numpy(z) for z in noise))
    assert got.shape == want.shape == (B, FRAMES * CFG.upsample_stride)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_fused_matches_plain_port(setup):
    """Within the port: fused serving path == plain flow, all samples."""
    _, _, port, spect, noise = setup
    with torch.inference_mode():
        nz = tuple(torch.from_numpy(z) for z in noise)
        a = port.infer(torch.from_numpy(spect), SIGMA, noise=nz)
        b = infer_fused(prepare_fused(port, torch.float32),
                        torch.from_numpy(spect), SIGMA, noise=nz)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=ATOL)


def test_single_layer_flow_takes_plain_start_branch():
    """L < 2: no first-layer kernel; the start projection runs plainly and
    the final-layer kernel is the only WN layer (``waveglow_fused.py:
    458-464``)."""
    cfg = WaveGlowConfig(
        n_mel_channels=8, n_flows=2, n_group=4, n_early_every=4,
        n_early_size=2, wn_n_layers=1, wn_n_channels=16,
        upsample_kernel=64, upsample_stride=16)
    rng = np.random.RandomState(3)
    spect = rng.randn(1, 8, 40).astype(np.float32)
    model = JaxWaveGlow(cfg)
    v = model.init(jax.random.PRNGKey(1), jnp.asarray(spect[:, :, :10]),
                   jnp.zeros((1, 160)))
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.01 * rng.randn(*x.shape).astype(
            np.float32), v["params"])
    port = convert.load_waveglow({"params": params}, cfg)
    noise = [rng.randn(*s).astype(np.float32)
             for s in port.noise_shapes(1, 40 * 16 // 4)]
    want = np.asarray(jax_fused(params, cfg, jnp.asarray(spect), None, 1.0,
                                compute_dtype=jnp.float32,
                                noise=tuple(map(jnp.asarray, noise))))
    with torch.inference_mode():
        got = infer_fused(prepare_fused(port, torch.float32),
                          torch.from_numpy(spect), 1.0,
                          noise=tuple(map(torch.from_numpy, noise)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_weight_bridge_round_trip(setup):
    """flax tree -> flat .npz -> port: every leaf survives bit for bit, and
    the port built from the file equals the one built from the tree, with
    weight norm folded as the JAX fused path folds it."""
    from text2speech_tpu.models.waveglow_fused import _fold

    _, params, port, _, _ = setup
    flat = convert.flatten_tree({"waveglow": {"params": params}})
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "w.npz")
        convert.save_npz(path, flat)
        back = convert.load_npz(path)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    port2 = convert.load_waveglow(convert.sub_tree(back, "waveglow"), CFG)
    sd1, sd2 = port.state_dict(), port2.state_dict()
    assert sd1.keys() == sd2.keys()
    for k in sd1:
        assert torch.equal(sd1[k], sd2[k]), k
    C = CFG.wn_n_channels
    in_k, _ = _fold(params["wn1"]["in2"])
    cond_k, _ = _fold(params["wn1"]["cond"])
    np.testing.assert_allclose(sd1["wn.1.in_w.2"].numpy(), np.asarray(in_k),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sd1["wn.1.cond_w.1"].numpy(),
                               np.asarray(cond_k)[0, :, 2 * C:4 * C],
                               rtol=1e-6, atol=1e-7)
