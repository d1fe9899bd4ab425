"""Streaming synthesis of the port (``text2speech_tpu_torch.infer``: chunked
decode, windowed vocoding; ``WaveGlow.infer(length=...)``;
``Tacotron2.decode_chunk``) against the JAX package given the same weights,
prenet masks and noise, and against the port's own single pass.

Contracts held here, as in ``tests/test_streaming.py``: the chunked decode
equals the whole-utterance decode bit for bit (same carry, same masks, the
masks of the first n steps independent of how many are drawn); the windowed
postnet equals the whole-sequence postnet; streamed audio equals a single
pass over the final mel with the same noise stream; frames after a row's
stop never enter a window; a row shorter than a window takes the exact
pass.  Tolerances are stated at each comparison."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text2speech_tpu.config import HParams as JaxHParams
from text2speech_tpu.config import WaveGlowConfig as JaxWaveGlowConfig
from text2speech_tpu.infer import Synthesizer as JaxSynthesizer
from text2speech_tpu.models.chunked import draw_noise as jax_draw_noise
from text2speech_tpu.models.tacotron2 import DecoderState as JaxDecoderState
from text2speech_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from text2speech_tpu.models.waveglow import WaveGlow as JaxWaveGlow
from text2speech_tpu.text import N_SYMBOLS
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.config import HParams, WaveGlowConfig
from text2speech_tpu_torch.infer import (Synthesizer,
                                         incremental_vocode_stream,
                                         incremental_vocode_stream_batch,
                                         random_weights_)
from text2speech_tpu_torch.models.chunked import (draw_noise,
                                                  receptive_overlap_frames)
from text2speech_tpu_torch.models.tacotron2 import DecoderState
from text2speech_tpu_torch.models.waveglow import WaveGlow

torch.set_num_threads(1)

HP_KW = dict(
    sample_rate=22050, embedding_size=16, enc_conv_num_layers=1,
    enc_conv_channels=16, attention_rnn_dim=16, decoder_rnn_dim=16,
    attention_dim=8, attention_location_n_filters=4,
    attention_location_kernel_size=7, prenet_dim=8, n_mel_channels=8,
    postnet_embedding_dim=8, postnet_n_convolutions=2, max_decoder_steps=44)
# 2 flows of 2 layers: one-sided receptive field 6 frames, so a chunk of 8
# gives windows of 20 frames (14 for the first) inside a 44-frame utterance
WG_KW = dict(
    n_mel_channels=8, n_flows=2, n_group=8, n_early_every=4, n_early_size=2,
    wn_n_layers=2, wn_n_channels=16, upsample_kernel=64, upsample_stride=16,
    sampling_rate=22050, hop_length=16)
HP, WG = HParams(**HP_KW), WaveGlowConfig(**WG_KW)
CHUNK = 8
REQUESTED = 44          # not a multiple of the chunk: 48 steps are decoded
LIMIT = 48
HOP = WG.upsample_stride
GPF = HOP // WG.n_group
TEXTS = ["안녕하세요.", "존경하는 사람"]


@pytest.fixture(scope="module")
def pair():
    """The JAX Synthesizer and the port's (plain f32 vocoder, no denoiser)
    on the same weights, the WaveGlow's perturbed so that its ``end`` convs
    are not zero."""
    jhp, jwg = JaxHParams(**HP_KW), JaxWaveGlowConfig(**WG_KW)
    rng = jax.random.PRNGKey(0)
    taco = JaxTacotron2(jhp, n_vocab=N_SYMBOLS)
    tvars = taco.init({"params": rng, "dropout": rng},
                      jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
                      jnp.zeros((1, HP.n_mel_channels, 8)), jnp.asarray([8]))
    wg = JaxWaveGlow(jwg)
    wvars = wg.init(rng, jnp.zeros((1, WG.n_mel_channels, 16)),
                    jnp.zeros((1, 16 * HOP)))
    prng = np.random.RandomState(1)
    wparams = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * prng.randn(*x.shape).astype(
            np.float32), wvars["params"])
    jsyn = JaxSynthesizer(hp=jhp, taco=taco, taco_variables=tvars, wg_cfg=jwg,
                          waveglow=wg, wg_variables={"params": wparams},
                          use_denoiser=False)
    tsyn = Synthesizer(HP, convert.load_tacotron(tvars, HP, N_SYMBOLS), WG,
                       convert.load_waveglow({"params": wparams}, WG),
                       use_denoiser=False)
    return taco, tvars, jsyn, tsyn


def jax_keep_masks(taco, tvars, seed: int, steps: int, B: int) -> torch.Tensor:
    """The masks ``Tacotron2.decode_chunk`` draws from ``split(derive_rng(
    PRNGKey(seed)), steps)``: per step a prenet/step split, per prenet
    layer a split and ``bernoulli(0.5)`` -> bool [steps, 2, B, prenet]."""
    rng = taco.apply(tvars, method=JaxTacotron2.derive_rng,
                     rngs={"dropout": jax.random.PRNGKey(seed)})
    masks = []
    for rng_t in jax.random.split(rng, steps):
        rng_pre, _ = jax.random.split(rng_t)
        layers = []
        for _ in range(2):
            rng_pre, sub = jax.random.split(rng_pre)
            layers.append(np.asarray(jax.random.bernoulli(
                sub, 0.5, (B, HP.prenet_dim))))
        masks.append(np.stack(layers))
    return torch.from_numpy(np.stack(masks))


def jax_chunk_noise(seed: int):
    """The JAX engine's noise stream as the port's ``noise=`` callable:
    ``draw_noise(fold_in(PRNGKey(seed + 1), chunk index))``."""
    key = jax.random.PRNGKey(seed + 1)
    jwg = JaxWaveGlowConfig(**WG_KW)
    return lambda ci, B, n: tuple(
        np.array(z) for z in jax_draw_noise(
            jwg, jax.random.fold_in(key, ci), B, n))


# --- WaveGlow.infer(length=...) -----------------------------------------


def small_waveglow(seed: int = 0) -> WaveGlow:
    """Seeded random weights, ``end`` convs included (bias-driven hidden
    values past the valid length would otherwise stay hidden)."""
    model = WaveGlow(WG)
    random_weights_(model, torch.Generator().manual_seed(seed),
                    out_first=False)
    with torch.no_grad():
        for wn in model.wn:
            wn.end_w.mul_(0.3)
    return model


@pytest.mark.parametrize("tl", [1, 7, 13, 20])
def test_masked_length_equals_the_exact_call(tl):
    """``infer(padded, length=t)[:, :t * hop]`` equals ``infer(exact_t)``:
    float32 sums over the same values, the padded call's convs summing
    zeros where the exact call pads: 1e-5."""
    model = small_waveglow()
    W = 20
    g = torch.Generator().manual_seed(tl)
    mel = torch.randn(2, 8, tl, generator=g)
    noise = tuple(torch.randn(s, generator=g)
                  for s in model.noise_shapes(2, tl * GPF))
    want = model.infer(mel, 0.8, noise=noise)
    pmel = torch.zeros(2, 8, W)
    pmel[:, :, :tl] = mel
    pnoise = []
    for z in noise:
        pz = torch.zeros(2, W * GPF, z.shape[-1])
        pz[:, : tl * GPF] = z
        pnoise.append(pz)
    got = model.infer(pmel, 0.8, noise=tuple(pnoise), length=tl)
    np.testing.assert_allclose(got[:, : tl * HOP].numpy(), want.numpy(),
                               atol=1e-5)
    if tl < W:      # and without the mask the zero tail does leak
        leaky = model.infer(pmel, 0.8, noise=tuple(pnoise))
        assert (leaky[:, : tl * HOP] - want).abs().max() > 1e-3


def test_masked_length_matches_jax(pair):
    """The masked pass against the JAX package's on the same weights, mel
    and noise: float32 on both sides, 1e-4."""
    _, _, jsyn, tsyn = pair
    rng = np.random.RandomState(3)
    W, tl = 20, 9
    mel = np.zeros((1, 8, W), np.float32)
    mel[:, :, :tl] = rng.randn(1, 8, tl)
    noise = []
    for s in tsyn.waveglow.noise_shapes(1, W * GPF):
        z = np.zeros(s, np.float32)
        z[:, : tl * GPF] = rng.randn(s[0], tl * GPF, s[2])
        noise.append(z)
    want = jsyn.waveglow.apply(
        jsyn.wg_variables, jnp.asarray(mel), None, 0.8,
        noise=tuple(map(jnp.asarray, noise)), length=tl,
        method=JaxWaveGlow.infer)
    got = tsyn.waveglow.infer(torch.from_numpy(mel), 0.8,
                              noise=tuple(map(torch.from_numpy, noise)),
                              length=tl)
    np.testing.assert_allclose(got.numpy()[:, : tl * HOP],
                               np.asarray(want)[:, : tl * HOP], atol=1e-4)


# --- the chunked decode ---------------------------------------------------


def test_decode_chunk_matches_jax(pair):
    """Two chunks of ``Tacotron2.decode_chunk`` from the carry against the
    JAX method fed keys whose masks the port is handed: float32, 1e-4 on
    mel, gate and alignment; the same stop decisions."""
    from text2speech_tpu.text import encode_batch

    taco, tvars, jsyn, tsyn = pair
    ids, lengths = encode_batch(TEXTS)
    B, T_in = ids.shape
    n = 6
    base = taco.apply(tvars, method=JaxTacotron2.derive_rng,
                      rngs={"dropout": jax.random.PRNGKey(7)})
    rngs = jax.random.split(base, 2 * n)
    masks = jax_keep_masks(taco, tvars, 7, 2 * n, B)

    jmem = taco.apply(tvars, jnp.asarray(ids), text_lengths=jnp.asarray(
        lengths), method=JaxTacotron2.encode)
    z = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
    jcarry = (JaxDecoderState(z(B, 16), z(B, 16), z(B, 16), z(B, 16),
                              z(B, T_in), z(B, T_in), z(B, 16)),
              z(B, HP.n_mel_channels), jnp.zeros((B,), bool))
    tl = torch.from_numpy(lengths)
    tmem = tsyn.taco.encode(torch.from_numpy(ids).long(), text_lengths=tl)
    np.testing.assert_allclose(tmem.detach().numpy(), np.asarray(jmem),
                               atol=1e-5)
    tcarry = tsyn.taco.decoder.initial_carry(tmem)
    assert isinstance(tcarry[0], DecoderState)
    with torch.no_grad():
        for c in range(2):
            jcarry, jmel, jgate, jalign, jact = taco.apply(
                tvars, jmem, *jcarry, rngs[c * n: (c + 1) * n],
                text_lengths=jnp.asarray(lengths),
                method=JaxTacotron2.decode_chunk)
            tcarry, tmel, tgate, talign, tact = tsyn.taco.decode_chunk(
                tmem, *tcarry, masks[c * n: (c + 1) * n], tl)
            for got, want in ((tmel, jmel), (tgate, jgate), (talign, jalign)):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           atol=1e-4)
            np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
            np.testing.assert_array_equal(tcarry[2].numpy(),
                                          np.asarray(jcarry[2]))


def test_chunked_decode_equals_batch_decode_bit_for_bit(pair):
    """``text_to_mel_stream`` (44 requested steps in chunks of 8: 48
    decoded, masks drawn for 48) against ``text_to_mel`` (44 steps, masks
    drawn for 44): the decode is equal bit for bit, the windowed postnet
    runs the same float32 convs on windows, which on the CPU sum in the
    same order: equal."""
    *_, tsyn = pair
    mel_ref, len_ref = tsyn.text_to_mel(TEXTS, seed=3, max_steps=REQUESTED)
    chunks, lens, finals = [], None, []
    for mel_c, lens, final in tsyn.text_to_mel_stream(
            TEXTS, chunk_steps=CHUNK, seed=3, max_steps=REQUESTED):
        chunks.append(mel_c)
        finals.append(final)
    got = torch.cat(chunks, dim=-1)
    assert finals == [False] * (len(finals) - 1) + [True]
    assert got.shape == mel_ref.shape == (2, 8, REQUESTED)
    np.testing.assert_array_equal(lens, len_ref.numpy())
    assert torch.equal(got, mel_ref)


def test_keep_masks_are_prefix_stable_and_rows_independent(pair):
    """The first n steps' masks do not depend on how many steps are drawn;
    per-row generators make a row's masks independent of the batch."""
    *_, tsyn = pair
    dec = tsyn.taco.decoder

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    short = dec.draw_keep_masks(70, 3, gen(5), "cpu")
    long = dec.draw_keep_masks(200, 3, gen(5), "cpu")
    assert short.shape == (70, 2, 3, HP.prenet_dim) and short.dtype == \
        torch.bool
    assert torch.equal(short, long[:70])
    assert 0.4 < short.float().mean() < 0.6

    solo = dec.draw_keep_masks_per_row(16, [gen(11)], "cpu")
    trio = dec.draw_keep_masks_per_row(16, [gen(10), gen(11), gen(12)], "cpu")
    assert trio.shape == (16, 2, 3, HP.prenet_dim)
    assert torch.equal(solo[:, :, 0], trio[:, :, 1])
    assert not torch.equal(trio[:, :, 0], trio[:, :, 1])
    # chunk after chunk from one generator per row: one longer stream
    g = gen(11)
    two = torch.cat([dec.draw_keep_masks_per_row(8, [g], "cpu")
                     for _ in range(2)])
    assert torch.equal(two[:8], solo[:8])


def test_per_row_masks_make_a_row_independent_of_the_batch(pair):
    """A row decoded alone equals the same row decoded in a batch when
    both draw its masks from its own generator (float32; the batched
    matmuls may sum in another order: 1e-5)."""
    from text2speech_tpu_torch.text import encode_batch

    *_, tsyn = pair
    taco = tsyn.taco

    def decode(texts, seeds):
        ids, lengths = encode_batch(texts)
        lengths = torch.from_numpy(lengths)
        with torch.no_grad():
            memory = taco.encode(torch.from_numpy(ids).long(),
                                 text_lengths=lengths)
            masks = taco.decoder.draw_keep_masks_per_row(
                10, [torch.Generator().manual_seed(s) for s in seeds], "cpu")
            _, mel, *_ = taco.decode_chunk(
                memory, *taco.decoder.initial_carry(memory), masks, lengths)
        return mel

    both = decode(TEXTS, [21, 22])
    alone = decode(TEXTS[1:], [22])
    np.testing.assert_allclose(both[1].numpy(), alone[0].numpy(), atol=1e-5)


def test_mel_stream_matches_jax(pair):
    """The port's mel stream against the JAX package's, the port handed
    the masks the JAX keys draw: float32, 1e-4 (the JAX package holds its
    own stream to its batch path at 2e-5)."""
    taco, tvars, jsyn, tsyn = pair
    masks = jax_keep_masks(taco, tvars, 3, LIMIT, len(TEXTS))
    want = [(np.asarray(m), np.asarray(l), f)
            for m, l, f in jsyn.text_to_mel_stream(
                TEXTS, chunk_steps=CHUNK, seed=3, max_steps=REQUESTED)]
    got = list(tsyn.text_to_mel_stream(
        TEXTS, chunk_steps=CHUNK, seed=3, max_steps=REQUESTED,
        keep_masks=masks))
    assert len(got) == len(want)
    for (gm, gl, gf), (wm, wl, wf) in zip(got, want):
        assert gm.shape == wm.shape and gf == wf
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gm.numpy(), wm, atol=1e-4)


def test_mel_stream_early_gate_matches_batch(pair):
    """Gates biased to fire early: the stream decodes a postnet receptive
    field of REAL context past the last stop frame before it ends, so the
    valid frames equal the batch path's, and it ends before the limit."""
    *_, tsyn = pair
    taco = tsyn.taco
    bias = taco.decoder.gate_proj.bias
    old = bias.detach().clone()
    try:
        with torch.no_grad():
            bias.add_(10.0)
        mel_ref, len_ref = tsyn.text_to_mel(["안녕하세요.", "네."], seed=3)
        assert (len_ref < HP.max_decoder_steps).all()
        chunks, lens = [], None
        for mel_c, lens, _ in tsyn.text_to_mel_stream(
                ["안녕하세요.", "네."], chunk_steps=4, seed=3):
            chunks.append(mel_c)
        got = torch.cat(chunks, dim=-1)
        assert got.shape[-1] < HP.max_decoder_steps
        np.testing.assert_array_equal(lens, len_ref.numpy())
        for i, n in enumerate(lens):
            assert torch.equal(got[i, :, : int(n)], mel_ref[i, :, : int(n)])
    finally:
        with torch.no_grad():
            bias.copy_(old)


# --- the window engine on a toy vocoder ------------------------------------


def toy_vocoder(r: int, widths: list | None = None):
    """A linear vocoder with a receptive field of ``r`` frames: any leak of
    a wrong frame or noise sample into a window shows exactly."""
    def vocode(mel, noise, sigma):
        if widths is not None:
            widths.append(mel.shape[-1])
        F = mel.shape[-1]
        pad = torch.nn.functional.pad(mel, (r, r))
        sm = torch.stack([pad[:, :, i: i + F] for i in range(2 * r + 1)],
                         0).mean(dim=(0, 2))                     # [B, F]
        audio = sm.repeat_interleave(HOP, dim=-1)
        n0 = noise[0].mean(-1)                                   # [B, F*gpf]
        return audio + sigma * n0.repeat_interleave(WG.n_group, dim=-1)
    return vocode


def engine_noise(seed: int, B: int, n_chunks: int, cs: int) -> list:
    """The engine's own noise stream: one draw per chunk from a generator
    seeded ``seed + 1``."""
    gen = torch.Generator().manual_seed(seed + 1)
    parts = None
    for _ in range(n_chunks):
        nz = draw_noise(WG, gen, B, cs * GPF)
        parts = (list(nz) if parts is None
                 else [torch.cat([a, z], 1) for a, z in zip(parts, nz)])
    return parts


def test_engine_excludes_post_stop_garbage_toy():
    """Once the gate has fired the decode's tail chunks carry garbage mel:
    the windows must neither emit those frames nor let them into the
    context.  Against the single pass over the TRUE frames: 1e-4 (float32
    means over the same values)."""
    cs, true_len, requested, seed, GARBAGE = 4, 18, 40, 5, 1e3
    r = 2
    rng = np.random.RandomState(0)
    mel_true = torch.from_numpy(rng.randn(1, 8, requested).astype(np.float32))
    mel_full = mel_true.clone()
    mel_full[:, :, true_len:] = GARBAGE

    def mel_stream():
        total = 0
        while total < requested:
            chunk = mel_full[:, :, total: total + cs]
            total += cs
            final = total >= true_len + 2 * cs or total >= requested
            yield chunk, np.asarray([min(total, true_len)], np.int64), final
            if final:
                return

    vocode = toy_vocoder(r)
    got = torch.cat(list(incremental_vocode_stream(
        WG, mel_stream(), vocode, 0.8, seed, cs)))
    parts = engine_noise(seed, 1, (true_len + 2 * cs) // cs + 1, cs)
    ref = vocode(mel_true[:, :, :true_len],
                 tuple(p[:, : true_len * GPF] for p in parts), 0.8)[0]
    assert got.shape == ref.shape
    assert got.abs().max() < GARBAGE / 10
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)


def test_batch_engine_staggered_gates_toy():
    """Three rows whose gates fire at different steps (one mid-stream, one
    shorter than a window, one never): each row equals the single pass over
    its TRUE frames with its slice of the batch noise, no garbage leaks,
    and the early row flushes before the later ones finish."""
    cs, requested, seed, GARBAGE, B = 4, 40, 7, 1e3, 3
    true_lens = [18, 7, requested]
    rng = np.random.RandomState(1)
    mel_true = torch.from_numpy(rng.randn(B, 8, requested).astype(np.float32))
    mel_full = mel_true.clone()
    for b, tl in enumerate(true_lens):
        mel_full[b, :, tl:] = GARBAGE

    def mel_stream():
        total = 0
        while total < requested:
            chunk = mel_full[:, :, total: total + cs]
            total += cs
            yield (chunk, np.asarray([min(total, tl) for tl in true_lens],
                                     np.int64), total >= requested)

    vocode = toy_vocoder(2)
    emissions = list(incremental_vocode_stream_batch(
        WG, mel_stream(), vocode, 0.8, seed, cs))
    last = {b: max(i for i, (rr, _) in enumerate(emissions) if rr == b)
            for b in range(B)}
    assert last[1] < last[0] < last[2], last
    parts = engine_noise(seed, B, requested // cs, cs)
    for b, tl in enumerate(true_lens):
        got = torch.cat([ch for rr, ch in emissions if rr == b])
        ref = vocode(mel_true[b: b + 1, :, :tl],
                     tuple(p[b: b + 1, : tl * GPF] for p in parts), 0.8)[0]
        assert got.shape == ref.shape, (b, got.shape, ref.shape)
        assert got.abs().max() < GARBAGE / 10
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)


def test_first_window_fast_path_widths_and_equality_toy():
    """A round whose windows all start at 0 within the first chunk runs at
    width chunk + ov; every other windowed round at chunk + 2 ov; the audio
    is that of the single pass."""
    cs, requested, seed, B = 4, 40, 11, 2
    ov = receptive_overlap_frames(WG)
    rng = np.random.RandomState(2)
    mel = torch.from_numpy(rng.randn(B, 8, requested).astype(np.float32))
    widths: list = []
    vocode = toy_vocoder(2, widths)

    def mel_stream():
        total = 0
        while total < requested:
            chunk = mel[:, :, total: total + cs]
            total += cs
            yield chunk, np.asarray([requested] * B), total >= requested

    emissions = list(incremental_vocode_stream_batch(
        WG, mel_stream(), vocode, 0.8, seed, cs))
    assert widths[0] == cs + ov, widths
    assert set(widths[1:]) == {cs + 2 * ov}, widths
    parts = engine_noise(seed, B, requested // cs, cs)
    widths_seen = list(widths)
    for b in range(B):
        got = torch.cat([ch for rr, ch in emissions if rr == b])
        ref = vocode(mel[b: b + 1], tuple(p[b: b + 1] for p in parts), 0.8)[0]
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)
    assert widths_seen[0] == cs + ov


@pytest.mark.parametrize("masked", [False, True])
def test_flush_band_rows_take_the_exact_pass(masked):
    """A row whose true length lands in [chunk + ov, chunk + 2 ov) emits
    ONE mid-stream window and then flushes shorter than a window.  The
    flush must take the exact pass and emit the suffix: a fixed-width
    window's zero tail inside the tensor is real frames to the flows, not
    conv padding.  A real WaveGlow with ``end`` convs that are not zero
    (else the couplings are the identity and hide the leak), over the
    whole band, the boundary and one length that takes windows.  float32
    against the single pass over the true frames: 1e-5.  ``masked``: the
    flush goes through ``WaveGlow.infer(length=...)`` at the fixed width."""
    model = small_waveglow(4)
    ov = receptive_overlap_frames(WG)
    cs = CHUNK
    W = cs + 2 * ov
    requested = 32
    masked_widths: list = []

    def vocode(mel, noise, sigma):
        return model.infer(mel, sigma, noise=noise)

    def vocode_masked(mel, noise, sigma, tl):
        masked_widths.append(mel.shape[-1])
        return model.infer(mel, sigma, noise=noise, length=tl)

    rs = np.random.RandomState(1)
    mel_true = torch.from_numpy(rs.randn(1, 8, requested).astype(np.float32))

    def run(true_len, seed=5, sigma=0.8):
        def mel_stream():
            total = 0
            while total < requested:
                chunk = mel_true[:, :, total: total + cs]
                total += cs
                yield (chunk, np.asarray([min(total, true_len)], np.int64),
                       total >= requested)

        with torch.no_grad():
            got = torch.cat(list(incremental_vocode_stream(
                WG, mel_stream(), vocode, sigma, seed, cs,
                vocode_masked_fn=vocode_masked if masked else None)))
            parts = engine_noise(seed, 1, requested // cs, cs)
            ref = vocode(mel_true[:, :, :true_len],
                         tuple(p[:, : true_len * GPF] for p in parts),
                         sigma)[0]
        assert got.shape == ref.shape, (true_len, got.shape, ref.shape)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                                   err_msg=f"true_len={true_len}")

    for tl in range(cs + ov, W + 1):
        run(tl)
    run(W + 3)
    if masked:
        assert masked_widths and set(masked_widths) == {W}


# --- the Synthesizer's streaming entry points ------------------------------


def stream_reference(tsyn, texts, seed, noise_fn):
    """Replay the mel stream and the noise stream -> (final mel, noise
    parts, true lengths)."""
    mels, parts, lens, ci = [], None, None, 0
    for mel_c, lens, _ in tsyn.text_to_mel_stream(
            texts, chunk_steps=CHUNK, seed=seed, max_steps=REQUESTED):
        mels.append(mel_c)
        B = mel_c.shape[0]
        nz = [torch.as_tensor(z) for z in
              noise_fn(ci, B, mel_c.shape[-1] * GPF)]
        ci += 1
        parts = (nz if parts is None
                 else [torch.cat([a, z], 1) for a, z in zip(parts, nz)])
    mel = torch.cat(mels, dim=-1)
    return mel, parts, np.minimum(lens, mel.shape[-1])


def port_noise_fn(seed):
    gen = torch.Generator().manual_seed(seed + 1)
    return lambda ci, B, n: draw_noise(WG, gen, B, n)


def test_synthesize_incremental_matches_single_pass(pair):
    """Streamed chunks, concatenated, equal ONE pass over the final mel
    with the engine's noise stream (a generator seeded seed + 1, one draw
    per mel chunk): float32, windows against the whole: 1e-5.  And the
    stream is deterministic."""
    *_, tsyn = pair
    kw = dict(sigma=0.8, seed=5, chunk_steps=CHUNK, max_steps=REQUESTED)
    chunks = list(tsyn.synthesize_incremental(TEXTS[0], **kw))
    assert len(chunks) >= 3
    assert all(isinstance(c, np.ndarray) and c.dtype == np.float32
               for c in chunks)
    got = np.concatenate(chunks)
    mel, parts, tl = stream_reference(tsyn, TEXTS[0], 5, port_noise_fn(5))
    n = int(tl[0])
    ref = tsyn.mel_to_audio(mel[:, :, :n], 0.8,
                            noise=tuple(p[:, : n * GPF] for p in parts))[0]
    assert got.shape == (n * HOP,)
    np.testing.assert_allclose(got, ref.numpy(), atol=1e-5)
    again = np.concatenate(list(tsyn.synthesize_incremental(TEXTS[0], **kw)))
    np.testing.assert_array_equal(got, again)


def test_synthesize_incremental_batch_matches_single_pass(pair):
    *_, tsyn = pair
    rows = {r: [] for r in range(len(TEXTS))}
    for r, ch in tsyn.synthesize_incremental_batch(
            TEXTS, sigma=0.8, seed=5, chunk_steps=CHUNK,
            max_steps=REQUESTED):
        rows[r].append(ch)
    mel, parts, tls = stream_reference(tsyn, TEXTS, 5, port_noise_fn(5))
    for r in rows:
        n = int(tls[r])
        ref = tsyn.mel_to_audio(
            mel[r: r + 1, :, :n], 0.8,
            noise=tuple(p[r: r + 1, : n * GPF] for p in parts))[0]
        got = np.concatenate(rows[r])
        assert got.shape == (n * HOP,)
        np.testing.assert_allclose(got, ref.numpy(), atol=1e-5,
                                   err_msg=f"row {r}")


def test_synthesize_incremental_batch_early_gate_rows_flush(pair):
    """Gates biased to fire: rows stop early at their own lengths, take the
    exact pass as soon as their frames have cleared the postnet, and equal
    their single passes."""
    *_, tsyn = pair
    bias = tsyn.taco.decoder.gate_proj.bias
    old = bias.detach().clone()
    texts = ["안녕하세요. 존경하는 사람.", "네."]
    try:
        with torch.no_grad():
            bias.add_(10.0)
        rows = {0: [], 1: []}
        for r, ch in tsyn.synthesize_incremental_batch(
                texts, sigma=0.8, seed=3, chunk_steps=4):
            rows[r].append(ch)
        mels, parts, lens, gen = [], None, None, port_noise_fn(3)
        for mel_c, lens, _ in tsyn.text_to_mel_stream(texts, chunk_steps=4,
                                                      seed=3):
            mels.append(mel_c)
            nz = list(gen(0, 2, mel_c.shape[-1] * GPF))
            parts = (nz if parts is None
                     else [torch.cat([a, z], 1) for a, z in zip(parts, nz)])
        mel = torch.cat(mels, dim=-1)
        assert (lens < HP.max_decoder_steps).all()
        for r in rows:
            n = int(min(lens[r], mel.shape[-1]))
            ref = tsyn.mel_to_audio(
                mel[r: r + 1, :, :n], 0.8,
                noise=tuple(p[r: r + 1, : n * GPF] for p in parts))[0]
            got = np.concatenate(rows[r])
            assert got.shape == (n * HOP,)
            np.testing.assert_allclose(got, ref.numpy(), atol=1e-5)
    finally:
        with torch.no_grad():
            bias.copy_(old)


def test_synthesize_incremental_matches_jax(pair):
    """The port's stream against the JAX Synthesizer's, handed the JAX
    package's masks and per-chunk noise: same number of chunks, same chunk
    sizes, float32 audio within 3e-4 (the JAX package's own bound for its
    stream against its single pass, ``tests/test_streaming.py:93``)."""
    taco, tvars, jsyn, tsyn = pair
    seed = 5
    want = [np.asarray(c) for c in jsyn.synthesize_incremental(
        TEXTS[0], sigma=0.8, seed=seed, chunk_steps=CHUNK,
        max_steps=REQUESTED)]
    got = list(tsyn.synthesize_incremental(
        TEXTS[0], sigma=0.8, seed=seed, chunk_steps=CHUNK,
        max_steps=REQUESTED,
        keep_masks=jax_keep_masks(taco, tvars, seed, LIMIT, 1),
        noise=jax_chunk_noise(seed)))
    assert [len(c) for c in got] == [len(c) for c in want]
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               atol=3e-4)


def test_synthesize_incremental_batch_matches_jax(pair):
    taco, tvars, jsyn, tsyn = pair
    seed = 6
    want = [(r, np.asarray(c)) for r, c in jsyn.synthesize_incremental_batch(
        TEXTS, sigma=0.8, seed=seed, chunk_steps=CHUNK, max_steps=REQUESTED)]
    got = list(tsyn.synthesize_incremental_batch(
        TEXTS, sigma=0.8, seed=seed, chunk_steps=CHUNK, max_steps=REQUESTED,
        keep_masks=jax_keep_masks(taco, tvars, seed, LIMIT, len(TEXTS)),
        noise=jax_chunk_noise(seed)))
    assert [(r, len(c)) for r, c in got] == [(r, len(c)) for r, c in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, atol=3e-4)


def test_fused_vocoders_stream_without_a_masked_program(pair):
    """The fused bf16 and int8 vocoders stream through the same engine;
    they hand it no masked program (their exact pass runs at the exact
    length).  Against the single pass: windows are other batch shapes to
    the same bf16 arithmetic, equal on the CPU."""
    *_, tsyn = pair
    assert tsyn._masked_vocode_handle() is not None
    for kw in ({"use_fused_vocoder": True}, {"int8_vocoder": True}):
        syn = dataclasses.replace(tsyn, **kw)
        assert syn._masked_vocode_handle() is None
        got = np.concatenate(list(syn.synthesize_incremental(
            TEXTS[0], sigma=0.8, seed=5, chunk_steps=CHUNK,
            max_steps=REQUESTED)))
        mel, parts, tl = stream_reference(syn, TEXTS[0], 5, port_noise_fn(5))
        n = int(tl[0])
        ref = syn.mel_to_audio(mel[:, :, :n], 0.8,
                               noise=tuple(p[:, : n * GPF] for p in parts))[0]
        np.testing.assert_allclose(got, ref.numpy(), atol=1e-5)


def test_synthesize_stream_yields_sentences_in_order(pair):
    *_, tsyn = pair
    text = "안녕하세요. 만나서 반갑습니다. 네."
    out = list(tsyn.synthesize_stream(text, max_batch=2, max_steps=6))
    assert [s for s, _ in out] == ["안녕하세요.", "만나서 반갑습니다.", "네."]
    assert all(w.dtype == np.float32 and w.shape == (6 * HOP,)
               for _, w in out)
