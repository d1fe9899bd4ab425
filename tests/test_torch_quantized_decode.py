"""The port's weight-quantized serving decode
(``text2speech_tpu_torch.models.tacotron_serve``) against the JAX package's
(``text2speech_tpu.models.tacotron_serve``) and against the port's own
``Tacotron2.decode_chunk``, on the same weights and prenet masks.

The floating-point serving path must equal the module's decode bit for bit
(same operations in the same grouping); the int8 path runs the JAX
package's int8 arithmetic: the same payloads, the same row quantization of
the activations, exact integer products, the same scales applied in
float32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text2speech_tpu.config import HParams as JaxHParams
from text2speech_tpu.models import tacotron_serve as jserve
from text2speech_tpu.models.tacotron2 import DecoderState as JaxDecoderState
from text2speech_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from text2speech_tpu.text import N_SYMBOLS
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.config import HParams
from text2speech_tpu_torch.models import tacotron_serve as tserve

torch.set_num_threads(1)

HP_KW = dict(
    sample_rate=22050, embedding_size=16, enc_conv_num_layers=1,
    enc_conv_channels=16, attention_rnn_dim=16, decoder_rnn_dim=16,
    attention_dim=8, attention_location_n_filters=4,
    attention_location_kernel_size=7, prenet_dim=8, n_mel_channels=8,
    postnet_embedding_dim=8, postnet_n_convolutions=2, max_decoder_steps=20)
HP = HParams(**HP_KW)
B, T_IN, STEPS = 2, 12, 10


@pytest.fixture(scope="module")
def setup():
    jhp = JaxHParams(**HP_KW)
    rng = jax.random.PRNGKey(0)
    model = JaxTacotron2(jhp, n_vocab=N_SYMBOLS)
    text = np.random.RandomState(0).randint(2, 70, (B, T_IN)).astype(np.int32)
    lengths = np.asarray([12, 9], np.int32)
    variables = model.init(
        {"params": rng, "dropout": rng}, jnp.asarray(text),
        jnp.asarray(lengths), jnp.zeros((B, HP.n_mel_channels, 8)),
        jnp.asarray([8, 8]))
    jmem = model.apply(variables, jnp.asarray(text),
                       text_lengths=jnp.asarray(lengths),
                       method=JaxTacotron2.encode)
    jpmem = model.apply(
        variables, jmem,
        method=lambda m, mem: m.decoder.attention.process_memory(mem))
    rngs = jax.random.split(jax.random.PRNGKey(7), STEPS)
    # the masks those keys draw (decode_chunk_serve's own key discipline)
    masks = []
    for rng_t in rngs:
        rng_pre, _ = jax.random.split(rng_t)
        layers = []
        for _ in range(2):
            rng_pre, sub = jax.random.split(rng_pre)
            layers.append(np.asarray(jax.random.bernoulli(
                sub, 0.5, (B, HP.prenet_dim))))
        masks.append(np.stack(layers))
    taco = convert.load_tacotron(variables, HP, N_SYMBOLS)
    return dict(model=model, variables=variables, jhp=jhp, jmem=jmem,
                jpmem=jpmem, rngs=rngs, lengths=lengths, taco=taco,
                masks=torch.from_numpy(np.stack(masks)),
                tmem=torch.from_numpy(np.asarray(jmem)),
                tpmem=torch.from_numpy(np.asarray(jpmem)))


def jax_carry():
    z = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
    return (JaxDecoderState(z(B, 16), z(B, 16), z(B, 16), z(B, 16),
                            z(B, T_IN), z(B, T_IN), z(B, 16)),
            z(B, HP.n_mel_channels), jnp.zeros((B,), bool))


def test_extract_decoder_params_matches_jax(setup):
    """Every entry of the JAX dict, carried across by
    ``decoder_params_from_jax``, is the module's own parameter."""
    want = convert.decoder_params_from_jax(
        jax.tree.map(np.asarray, jserve.extract_decoder_params(
            setup["variables"], setup["jhp"])))
    got = tserve.extract_decoder_params(setup["taco"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k].detach(), want[k]), k


def test_serve_fp_path_equals_decode_chunk_bit_for_bit(setup):
    taco = setup["taco"]
    lengths = torch.from_numpy(setup["lengths"])
    with torch.no_grad():
        memory = taco.encode(
            torch.from_numpy(np.random.RandomState(0).randint(
                2, 70, (B, T_IN))).long(), text_lengths=lengths)
        carry = taco.decoder.initial_carry(memory)
        (st_a, fr_a, fin_a), *outs_a = taco.decode_chunk(
            memory, *carry, setup["masks"], lengths)
        (st_b, fr_b, fin_b), *outs_b = tserve.decode_chunk_serve(
            tserve.extract_decoder_params(taco), HP, memory,
            taco.process_memory(memory), *carry, setup["masks"], lengths)
    for a, b in zip(outs_a, outs_b):
        assert torch.equal(a, b)
    assert torch.equal(fr_a, fr_b) and torch.equal(fin_a, fin_b)
    for a, b in zip(st_a, st_b):
        assert torch.equal(a, b)


def test_serve_fp_path_matches_jax(setup):
    """Against the JAX serving decode fed the keys of the port's masks:
    float32 on both sides, 1e-4."""
    s = setup
    _, jmel, jgate, jalign, jact = jserve.decode_chunk_serve(
        jserve.extract_decoder_params(s["variables"], s["jhp"]), s["jhp"],
        s["jmem"], s["jpmem"], *jax_carry(), s["rngs"],
        text_lengths=jnp.asarray(s["lengths"]))
    with torch.no_grad():
        _, tmel, tgate, talign, tact = tserve.decode_chunk_serve(
            tserve.extract_decoder_params(s["taco"]), HP, s["tmem"],
            s["tpmem"], *s["taco"].decoder.initial_carry(s["tmem"]),
            s["masks"], torch.from_numpy(s["lengths"]))
    for got, want in ((tmel, jmel), (tgate, jgate), (talign, jalign)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))


def test_quantize_decoder_params_matches_jax(setup):
    """Same payloads and scales as the JAX quantizer on the same weights
    (the port quantizes [out, in] kernels per row, the JAX package
    [in, out] per column); a dead output channel gets zeros and scale 1."""
    s = setup
    jq = jserve.quantize_decoder_params(
        jserve.extract_decoder_params(s["variables"], s["jhp"]), min_elems=1)
    want = convert.decoder_params_from_jax(jax.tree.map(np.asarray, jq))
    got = tserve.quantize_decoder_params(
        tserve.extract_decoder_params(s["taco"]), min_elems=1)
    n_q = 0
    for k, w in want.items():
        if isinstance(w, dict):
            n_q += 1
            assert got[k]["q"].dtype == torch.int8
            assert torch.equal(got[k]["q"], w["q"]), k
            np.testing.assert_allclose(got[k]["s"].numpy(), w["s"].numpy(),
                                       rtol=1e-6)
        else:
            assert torch.equal(got[k].detach(), w), k
    assert n_q >= 10
    # the default threshold keeps this tiny model in floating point
    assert not any(isinstance(v, dict) for v in
                   tserve.quantize_decoder_params(
                       tserve.extract_decoder_params(s["taco"])).values())
    dead = torch.zeros(3, 5)
    dead[1] = torch.tensor([0.5, -1.0, 0.25, 0.0, 1.0])
    q = tserve.quantize_kernel_int8(dead)
    assert q["q"][0].abs().sum() == 0 and q["s"][0] == 1.0
    assert q["q"][1].tolist() == [64, -127, 32, 0, 127]


def test_serve_int8_path_matches_jax_and_tracks_fp(setup):
    """The int8 decode on the JAX package's quantized tree against the JAX
    int8 decode: integer products are exact on both sides and the float32
    operations around them are the same, up to the order of float32 sums
    elsewhere in the step; a sum on a rounding knife edge can move one
    activation payload by a count, which the recurrence carries on.  Over
    10 steps: 5e-3 on the mel.  And int8 tracks floating point as the JAX
    package asks of its own (``tests/test_quantized_decode.py:98-100``)."""
    s = setup
    jq = jserve.quantize_decoder_params(
        jserve.extract_decoder_params(s["variables"], s["jhp"]), min_elems=1)
    _, jmel, *_ = jserve.decode_chunk_serve(
        jq, s["jhp"], s["jmem"], s["jpmem"], *jax_carry(), s["rngs"],
        text_lengths=jnp.asarray(s["lengths"]))
    tq = convert.decoder_params_from_jax(jax.tree.map(np.asarray, jq))
    carry = s["taco"].decoder.initial_carry(s["tmem"])
    lengths = torch.from_numpy(s["lengths"])
    with torch.no_grad():
        _, tmel, *_ = tserve.decode_chunk_serve(
            tq, HP, s["tmem"], s["tpmem"], *carry, s["masks"], lengths)
        _, fmel, *_ = tserve.decode_chunk_serve(
            tserve.extract_decoder_params(s["taco"]), HP, s["tmem"],
            s["tpmem"], *carry, s["masks"], lengths)
    assert torch.isfinite(tmel).all()
    np.testing.assert_allclose(tmel.numpy(), np.asarray(jmel), atol=5e-3)
    err = (tmel - fmel).abs().mean() / (fmel.abs().mean() + 1e-6)
    assert 0 < err < 0.2, err


def test_lstm_fn_hook_replaces_both_cells(setup):
    s = setup
    calls = []

    def lstm_fn(kind, h, c, x):
        calls.append((kind, tuple(x.shape)))
        return h, c

    with torch.no_grad():
        tserve.decode_chunk_serve(
            tserve.extract_decoder_params(s["taco"]), HP, s["tmem"],
            s["tpmem"], *s["taco"].decoder.initial_carry(s["tmem"]),
            s["masks"][:2], lstm_fn=lstm_fn)
    assert calls == [("att", (B, 8 + 16)), ("dec", (B, 16 + 16))] * 2


def test_int8_decode_threshold_and_synthesizer_quantized_streaming(
        monkeypatch):
    """``int8_decode_worthwhile`` follows the module's measured threshold
    (None: never).  With the threshold forced down,
    ``Synthesizer(quantized_decode=True)`` streams finite, deterministic
    audio through the int8 decode that differs from the floating-point
    stream."""
    from text2speech_tpu_torch.config import WaveGlowConfig
    from text2speech_tpu_torch.infer import random_synthesizer

    assert tserve.INT8_DECODE_MIN_BATCH is None
    assert not any(tserve.int8_decode_worthwhile(b) for b in (1, 32, 4096))
    monkeypatch.setattr(tserve, "INT8_DECODE_MIN_BATCH", 4)
    assert [tserve.int8_decode_worthwhile(b) for b in (3, 4, 5)] == [
        False, True, True]

    wg = WaveGlowConfig(
        n_mel_channels=8, n_flows=2, n_group=8, n_early_every=4,
        n_early_size=2, wn_n_layers=2, wn_n_channels=16, upsample_kernel=64,
        upsample_stride=16, sampling_rate=22050, hop_length=16)
    monkeypatch.setattr(tserve, "QUANT_MIN_ELEMS", 1)
    synth = random_synthesizer(HP, wg, 0, device="cpu", use_denoiser=False,
                               use_fused_vocoder=False, quantized_decode=True)
    assert any(isinstance(v, dict) for v in synth._dp_q.values())
    kw = dict(seed=4, chunk_steps=8, max_steps=20)
    fp = np.concatenate(list(synth.synthesize_incremental("안녕하세요.", **kw)))
    monkeypatch.setattr(tserve, "INT8_DECODE_MIN_BATCH", 1)
    a = np.concatenate(list(synth.synthesize_incremental("안녕하세요.", **kw)))
    b = np.concatenate(list(synth.synthesize_incremental("안녕하세요.", **kw)))
    assert a.size == fp.size > 0 and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - fp).max() > 0
