"""Parity of the port's LSTM and Tacotron-2 inference with the JAX
package's, at a tiny HParams, float32 on both sides.

The prenet dropout keep-masks are rebuilt from JAX's key schedule
(``Tacotron2.derive_rng``; ``split(rng, T)``; per step ``split`` into
prenet/step keys; per prenet layer ``split`` then ``bernoulli(0.5)``) and
handed to the port.

Tolerances: the LSTM cases are one-step or short scans over the same
float32 products summed in another order: 1e-5.  The decode runs 20
autoregressive steps whose attention softmax and LSTM state feed back,
so rounding differences grow; 1e-4 on mels of order 1."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text2speech_tpu.config import HParams
from text2speech_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from text2speech_tpu.ops import lstm as jlstm
from text2speech_tpu.text import N_SYMBOLS, encode_batch
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.ops import lstm as tlstm

torch.set_num_threads(1)

HP = HParams(
    embedding_size=16, enc_conv_num_layers=2, enc_conv_channels=16,
    attention_rnn_dim=16, decoder_rnn_dim=16, attention_dim=8,
    attention_location_n_filters=4, attention_location_kernel_size=7,
    prenet_dim=8, n_mel_channels=8, postnet_embedding_dim=8,
    postnet_n_convolutions=3, max_decoder_steps=20,
)


def _dense_sd(tree):
    return {"weight": torch.from_numpy(np.asarray(tree["kernel"]).T.copy()),
            "bias": torch.from_numpy(np.array(tree["bias"]))}


def test_lstm_cell_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5).astype(np.float32)
    h = rng.randn(3, 7).astype(np.float32)
    c = rng.randn(3, 7).astype(np.float32)
    cell = jlstm.LSTMCell(7)
    v = cell.init(jax.random.PRNGKey(0), (jnp.asarray(h), jnp.asarray(c)),
                  jnp.asarray(x))
    (jh, jc), _ = cell.apply(v, (jnp.asarray(h), jnp.asarray(c)),
                             jnp.asarray(x))
    port = tlstm.LSTMCell(5, 7)
    port.ih.load_state_dict(_dense_sd(v["params"]["ih"]))
    port.hh.load_state_dict(_dense_sd(v["params"]["hh"]))
    with torch.inference_mode():
        th, tc = port((torch.from_numpy(h), torch.from_numpy(c)),
                      torch.from_numpy(x))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)


@pytest.mark.parametrize("with_lengths", [True, False])
def test_bilstm_ragged_matches_jax(with_lengths):
    rng = np.random.RandomState(1)
    xs = rng.randn(3, 9, 6).astype(np.float32)
    lengths = np.asarray([9, 4, 1], np.int32)
    mod = jlstm.BiLSTM(5)
    jl = jnp.asarray(lengths) if with_lengths else None
    v = mod.init(jax.random.PRNGKey(1), jnp.asarray(xs), jl)
    want = np.asarray(mod.apply(v, jnp.asarray(xs), jl))
    port = tlstm.BiLSTM(6, 5)
    for d in ("fwd", "bwd"):
        p = v["params"][d]["LSTMCell_0"]
        getattr(port, d).ih.load_state_dict(_dense_sd(p["ih"]))
        getattr(port, d).hh.load_state_dict(_dense_sd(p["hh"]))
    with torch.inference_mode():
        got = port(torch.from_numpy(xs),
                   torch.from_numpy(lengths) if with_lengths else None)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_reverse_padded_matches_jax():
    xs = np.arange(2 * 5 * 1, dtype=np.float32).reshape(2, 5, 1)
    lengths = np.asarray([5, 3], np.int32)
    want = np.asarray(jlstm.reverse_padded(jnp.asarray(xs),
                                           jnp.asarray(lengths)))
    got = tlstm.reverse_padded(torch.from_numpy(xs), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), want)


def jax_keep_masks(taco, variables, seed: int, steps: int, batch: int):
    """The prenet keep-masks JAX's ``Tacotron2.inference`` draws under
    ``rngs={"dropout": PRNGKey(seed)}``: [steps, 2, B, prenet_dim]."""
    rng = taco.apply(variables, method=JaxTacotron2.derive_rng,
                     rngs={"dropout": jax.random.PRNGKey(seed)})
    masks = []
    for rng_t in jax.random.split(rng, steps):
        rng_pre, _ = jax.random.split(rng_t)
        layers = []
        for _ in range(2):
            rng_pre, sub = jax.random.split(rng_pre)
            layers.append(np.asarray(jax.random.bernoulli(
                sub, 0.5, (batch, HP.prenet_dim))))
        masks.append(np.stack(layers))
    return torch.from_numpy(np.stack(masks))


def _models(num_speakers: int, gate_bias: float = 0.0):
    taco = JaxTacotron2(HP, n_vocab=N_SYMBOLS, num_speakers=num_speakers)
    rng = jax.random.PRNGKey(3)
    v = taco.init({"params": rng, "dropout": rng},
                  jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
                  jnp.zeros((1, HP.n_mel_channels, 8)), jnp.asarray([8]),
                  speaker_ids=(jnp.zeros((1,), jnp.int32)
                               if num_speakers > 1 else None))
    prng = np.random.RandomState(4)
    v = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * prng.randn(*x.shape).astype(
            np.float32), jax.tree.map(np.asarray, v))
    v["batch_stats"] = jax.tree.map(np.abs, v["batch_stats"])  # var > 0
    v["params"]["decoder"]["gate_proj"]["bias"] = (
        v["params"]["decoder"]["gate_proj"]["bias"] + gate_bias)
    port = convert.load_tacotron(v, HP, N_SYMBOLS, num_speakers)
    return taco, v, port


_JAX_INFER = {}


def _jax_inference(taco, v, ids, spk, lengths, seed):
    """Jitted once per model structure, so the cases share compiles."""
    key = taco.num_speakers
    if key not in _JAX_INFER:
        _JAX_INFER[key] = jax.jit(lambda v, ids, spk, lens, rng: taco.apply(
            v, ids, speaker_ids=spk, text_lengths=lens,
            method=JaxTacotron2.inference, rngs={"dropout": rng}))
    return _JAX_INFER[key](v, jnp.asarray(ids),
                           None if spk is None else jnp.asarray(spk),
                           jnp.asarray(lengths), jax.random.PRNGKey(seed))


@pytest.mark.parametrize("gate_bias,num_speakers", [
    (-10.0, 1),  # the gate never fires: runs out max_steps
    (10.0, 1),   # the stop path fires
    (-10.0, 2),  # speaker conditioning
])
def test_tacotron_inference_matches_jax(gate_bias, num_speakers):
    taco, v, port = _models(num_speakers, gate_bias)
    ids, lengths = encode_batch(["안녕하세요.", "네."])
    B = ids.shape[0]
    spk = np.asarray([1, 0], np.int32) if num_speakers > 1 else None
    seed = 7
    want = _jax_inference(taco, v, ids, spk, lengths, seed)
    keep = jax_keep_masks(taco, v, seed, HP.max_decoder_steps, B)
    with torch.inference_mode():
        got = port.inference(
            torch.from_numpy(ids).long(),
            speaker_ids=None if spk is None else torch.from_numpy(spk).long(),
            text_lengths=torch.from_numpy(lengths), keep_masks=keep)
    names = ("mel_out", "mel_post", "gate_out", "align", "out_lengths")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        if name == "out_lengths":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=1e-4, err_msg=name)
    out_len = got[-1].numpy()
    if gate_bias > 0:
        assert (out_len < HP.max_decoder_steps).all()
    else:
        assert (out_len == HP.max_decoder_steps).all()
