"""The port's reference-checkpoint loaders (``text2speech_tpu_torch/
convert.py``: ``_dense``, ``_conv1d``, ``_lstm_gates``, ``_bn``,
``_wnconv``, ``_fuse_res_skip``, ``tacotron_from_torch``,
``waveglow_from_torch``, ``load_torch_checkpoint`` and the module
conveniences) against the JAX package's copies on seeded reference-format
state dicts, made by ``examples/reference_checkpoints.py`` (which
``chip_smoke.py`` phase 29 runs at full width on the card).  The JAX
package's own Tacotron state dict (``tests/test_convert.py:150``) is built
inside its test, so it cannot be shared; this one has the same keys and
shapes.

The trees must be EQUAL, leaf for leaf (``np.array_equal``, f32): both
sides do the same transposes and concatenations, and the fold of a plain
weight into weight norm is the same f32 numpy expression.  The modules
built from them are held to the JAX models: the teacher-forced mel in eval
mode on JAX's prenet masks within 1e-4 (the mel tolerance of
``tests/test_torch_synth.py:164``), and the vocoder on the same mel and
noise: the plain f32 ``infer`` within 1e-4 (``tests/test_torch_waveglow.
py``'s f32 tolerance), the fused bf16 serving path against the JAX fused
path within ``tests/test_torch_synth.py``'s vocoder bound (4 bf16 steps at
the peak, 2e-2 relative L2).

The WaveGlow has 5 flows with an early output every 2, so its flows hold
8, 6 and 4 channels (``convinv`` [8, 8, 1], [6, 6, 1], [4, 4, 1]; ``start``
[C, n_half, 1]; ``end`` [2 n_half, C, 1]) as the reference config's do,
and live ``end`` convs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_tacotron_train import TINY, jax_decoder_masks
from text2speech_tpu import convert as jconvert
from text2speech_tpu.config import HParams as JaxHParams
from text2speech_tpu.config import WaveGlowConfig as JaxWaveGlowConfig
from text2speech_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from text2speech_tpu.models.waveglow import WaveGlow as JaxWaveGlow
from text2speech_tpu.models.waveglow_fused import infer_fused as jax_fused
from text2speech_tpu.text import N_SYMBOLS
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.config import HParams, WaveGlowConfig
from text2speech_tpu_torch.examples.reference_checkpoints import (
    pre_fusion_layout, reference_tacotron_state_dict,
    reference_waveglow_state_dict)
from text2speech_tpu_torch.models.tacotron2 import TrainMasks
from text2speech_tpu_torch.models.waveglow_fused import (infer_fused,
                                                         prepare_fused)

torch.set_num_threads(1)

HP, JHP = HParams(**TINY), JaxHParams(**TINY)
WG_KW = dict(n_mel_channels=8, n_flows=5, n_group=8, n_early_every=2,
             n_early_size=2, wn_n_layers=3, wn_n_channels=32,
             upsample_kernel=64, upsample_stride=16)
WG, JWG = WaveGlowConfig(**WG_KW), JaxWaveGlowConfig(**WG_KW)
MEL_ATOL = 1e-4
AUDIO_F32_ATOL = 1e-4
AUDIO_BF16_STEPS, AUDIO_BF16_REL_L2 = 2.0 ** -6, 2e-2


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(set(got) ^ set(want)))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    assert isinstance(got, np.ndarray) and got.dtype == np.float32, path
    assert np.asarray(want).dtype == np.float32, path
    assert np.array_equal(got, np.asarray(want)), path


class ReferenceModule(torch.nn.Module):
    """Stands in for a reference model class in a whole-model pickle (it
    must be importable where the file is read)."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 2)


@pytest.fixture(scope="module")
def taco_sd():
    return reference_tacotron_state_dict(HP, 0)


@pytest.fixture(scope="module")
def wg_sd():
    return reference_waveglow_state_dict(WG, 1)


def _rng_sd():
    g = torch.Generator().manual_seed(5)

    def t(*s):
        return torch.randn(*s, generator=g)

    return {
        "lin.weight": t(4, 6), "lin.bias": t(4), "nob.weight": t(3, 5),
        "c.weight": t(8, 6, 5), "c.bias": t(8), "cn.weight": t(4, 2, 3),
        "bn.weight": t(5), "bn.bias": t(5), "bn.running_mean": t(5),
        "bn.running_var": t(5).abs(),
        "w.weight_v": t(6, 4, 3), "w.weight_g": t(6, 1, 1), "w.bias": t(6),
        "p.weight": t(6, 4, 1), "p.bias": t(6), "q.weight": t(5, 3, 3),
        "l.w_ih": t(12, 5), "l.w_hh": t(12, 3), "l.b_ih": t(12),
        "l.b_hh": t(12),
    }


HELPERS = [
    ("_dense", ("lin",)), ("_dense", ("nob",)),
    ("_conv1d", ("c",)), ("_conv1d", ("cn",)),
    ("_bn", ("bn",)),
    ("_wnconv", ("w",)),          # weight norm kept
    ("_wnconv", ("p",)),          # weight norm removed: folded
    ("_wnconv", ("q",)),          # folded, no bias
]


@pytest.mark.parametrize("fn,args", HELPERS + [("_lstm_gates", None)],
                         ids=lambda x: x if isinstance(x, str) else None)
def test_helper_equals_jax(fn, args):
    sd = _rng_sd()
    if args is None:
        args = (sd["l.w_ih"], sd["l.w_hh"], sd["l.b_ih"], sd["l.b_hh"])
        got = getattr(convert, fn)(*args)
        want = getattr(jconvert, fn)(*args)
    else:
        got = getattr(convert, fn)(sd, *args)
        want = getattr(jconvert, fn)(sd, *args)
    if fn == "_bn":
        for g, w in zip(got, want):
            assert_trees_equal(g, w)
    else:
        assert_trees_equal(got, want)


@pytest.mark.parametrize("layout", ["fused", "both_convs_every_layer"])
def test_fuse_res_skip_equals_jax(wg_sd, layout):
    """A fused checkpoint comes back as it is; a pre-fusion one whose every
    layer has both convs (the form the JAX copy takes) fuses to the same
    arrays on both sides."""
    sd = dict(wg_sd)
    if layout != "fused":
        C = WG.wn_n_channels
        for key in [k for k in sd if ".res_skip_layers." in k]:
            t = sd.pop(key)
            res = key.replace("res_skip_layers", "res_layers")
            skip = key.replace("res_skip_layers", "skip_layers")
            sd[res], sd[skip] = t[:C], t[C:]
            if t.shape[0] == C:             # the last layer: res is empty
                sd[res], sd[skip] = t[:0], t
    got, want = convert._fuse_res_skip(sd), jconvert._fuse_res_skip(sd)
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        if layout == "fused":
            assert g is sd[k] and w is sd[k]
        else:
            assert np.array_equal(np.asarray(g), np.asarray(w)), k


def test_the_true_pre_fusion_layout_converts(wg_sd):
    """The reference's pre-fusion WN has no res conv after its last layer
    (``glow_old.py``); its skip conv alone is the fused layer's, as the
    reference's ``update_model`` makes it.  The port converts such a
    checkpoint to the fused one's tree; the JAX copy fuses only layers
    with both convs and so misses the last layer."""
    old = pre_fusion_layout(wg_sd, WG)
    last = WG.wn_n_layers - 1
    assert f"WN.0.res_layers.{last}.weight_v" not in old
    assert f"WN.0.skip_layers.{last}.weight_v" in old
    assert f"WN.0.res_layers.{last - 1}.weight_v" in old
    assert not any("res_skip_layers" in k for k in old)
    assert_trees_equal(convert.waveglow_from_torch(old, WG),
                       convert.waveglow_from_torch(wg_sd, WG))
    with pytest.raises(KeyError, match=f"res_skip_layers.{last}"):
        jconvert.waveglow_from_torch(old, JWG)


def test_tacotron_tree_equals_jax(taco_sd):
    got = convert.tacotron_from_torch(taco_sd, HP)
    want = jconvert.tacotron_from_torch(taco_sd, JHP)
    for g, w in zip(got, want):
        assert_trees_equal(g, w)


def test_tacotron_module_matches_jax(taco_sd):
    """Teacher-forced, eval mode (running statistics; only the prenet
    drops, on JAX's masks): the port module from the state dict against
    the JAX ``Tacotron2`` on the JAX tree."""
    params, stats = jconvert.tacotron_from_torch(taco_sd, JHP)
    variables = {"params": params, "batch_stats": stats}
    model = JaxTacotron2(JHP, n_vocab=N_SYMBOLS)
    rng = np.random.RandomState(3)
    B, T_in, T_out = 2, 9, 12
    in_len = np.asarray([9, 6], np.int32)
    out_len = np.asarray([12, 8], np.int32)
    text = rng.randint(2, 70, (B, T_in)).astype(np.int32)
    text[np.arange(T_in)[None, :] >= in_len[:, None]] = 0
    mel = rng.randn(B, HP.n_mel_channels, T_out).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = model.apply(variables, jnp.asarray(text), jnp.asarray(in_len),
                       jnp.asarray(mel), jnp.asarray(out_len), train=False,
                       rngs={"dropout": key})
    prenet, att, dec = jax_decoder_masks(model, variables, key, B, T_out)
    port = convert.tacotron_module_from_torch(taco_sd, HP)
    assert port.embedding.weight.shape[0] == N_SYMBOLS
    with torch.no_grad():
        got = port(torch.from_numpy(text).long(), torch.from_numpy(in_len),
                   torch.from_numpy(mel), torch.from_numpy(out_len),
                   train=False, masks=TrainMasks([], prenet, att, dec, []))
    for name, g, w in zip(("mel_out", "mel_post", "gate_out", "align"),
                          got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=MEL_ATOL,
                                   err_msg=name)


def test_waveglow_tree_equals_jax_with_early_outputs(wg_sd):
    assert tuple(wg_sd["convinv.0.conv.weight"].shape) == (8, 8, 1)
    assert tuple(wg_sd["convinv.2.conv.weight"].shape) == (6, 6, 1)
    assert tuple(wg_sd["convinv.4.conv.weight"].shape) == (4, 4, 1)
    assert tuple(wg_sd["WN.4.start.weight_v"].shape) == (32, 2, 1)
    assert tuple(wg_sd["WN.4.end.weight"].shape) == (4, 32, 1)
    assert wg_sd["WN.4.end.weight"].abs().max() > 0       # live
    got = convert.waveglow_from_torch(wg_sd, WG)
    assert_trees_equal(got, jconvert.waveglow_from_torch(wg_sd, JWG))


@pytest.fixture(scope="module")
def vocoded(wg_sd):
    """The JAX model's plain and fused audio, the port module and the
    shared mel and noise."""
    jparams = jconvert.waveglow_from_torch(wg_sd, JWG)
    port = convert.waveglow_module_from_torch(wg_sd, WG)
    rng = np.random.RandomState(6)
    B, frames = 2, 40
    spect = rng.randn(B, WG.n_mel_channels, frames).astype(np.float32)
    Tg = frames * WG.upsample_stride // WG.n_group
    noise = [rng.randn(*s).astype(np.float32)
             for s in port.noise_shapes(B, Tg)]
    jnoise = tuple(jnp.asarray(z) for z in noise)
    model = JaxWaveGlow(JWG)
    plain = np.asarray(model.apply({"params": jparams}, jnp.asarray(spect),
                                   None, 0.8, noise=jnoise,
                                   method=JaxWaveGlow.infer))
    fused = np.asarray(jax_fused(jparams, JWG, jnp.asarray(spect), None, 0.8,
                                 compute_dtype=jnp.bfloat16, noise=jnoise))
    return port, spect, noise, plain, fused


def test_waveglow_module_matches_jax(vocoded):
    port, spect, noise, plain, _ = vocoded
    with torch.inference_mode():
        got = port.infer(torch.from_numpy(spect), 0.8,
                         noise=tuple(torch.from_numpy(z) for z in noise))
    assert got.shape == plain.shape
    assert np.abs(plain).max() > 0.1
    np.testing.assert_allclose(got.numpy(), plain, atol=AUDIO_F32_ATOL)


def test_fused_vocoder_on_converted_weights_matches_jax(vocoded):
    port, spect, noise, _, fused = vocoded
    with torch.inference_mode():
        got = infer_fused(prepare_fused(port, torch.bfloat16),
                          torch.from_numpy(spect), 0.8,
                          noise=tuple(torch.from_numpy(z) for z in noise))
    got = got.numpy()
    assert got.shape == fused.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, fused,
                               atol=AUDIO_BF16_STEPS * np.abs(fused).max())
    assert np.linalg.norm(got - fused) / np.linalg.norm(fused) < \
        AUDIO_BF16_REL_L2


@pytest.mark.parametrize("form", ["state_dict", "model", "bare"])
def test_load_torch_checkpoint_equals_jax(tmp_path, taco_sd, form):
    if form == "state_dict":      # the Tacotron's train.py:72 format
        obj, want = {"iteration": 3, "state_dict": taco_sd,
                     "learning_rate": 1e-3}, taco_sd
    elif form == "model":         # the WaveGlow whole-model pickle
        m = ReferenceModule()
        obj, want = {"model": m, "iteration": 1}, m.state_dict()
    else:
        obj, want = taco_sd, taco_sd
    path = str(tmp_path / "ckpt.pt")
    torch.save(obj, path)
    got = convert.load_torch_checkpoint(path)
    jgot = jconvert.load_torch_checkpoint(path)
    assert set(got) == set(jgot) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]) and torch.equal(jgot[k], want[k])


def test_load_torch_checkpoint_refuses_a_list(tmp_path):
    path = str(tmp_path / "list.pt")
    torch.save([torch.zeros(2)], path)
    for loader in (convert.load_torch_checkpoint,
                   jconvert.load_torch_checkpoint):
        with pytest.raises(ValueError, match="unrecognized checkpoint"):
            loader(path)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_precision_tensors_convert(wg_sd, dtype):
    """bf16 and f16 state dicts: ``_np`` widens through ``.float()``
    (numpy has no bf16).  f16 values equal the JAX ``_np``'s (numpy widens
    them the same way); bf16 tensors, which the JAX ``_np`` refuses, give
    the tree of their f32 widening."""
    half = {k: v.to(dtype) for k, v in wg_sd.items()}
    wide = {k: v.float() for k, v in half.items()}
    got = convert.waveglow_from_torch(half, WG)
    assert_trees_equal(got, convert.waveglow_from_torch(wide, WG))
    if dtype == torch.float16:
        assert_trees_equal(got, jconvert.waveglow_from_torch(half, JWG))
    else:
        with pytest.raises(TypeError):
            jconvert.waveglow_from_torch(half, JWG)
