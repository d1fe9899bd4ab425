"""The port's continuous-batching server (``text2speech_tpu_torch.server``):
the scheduler's invariants, as ``tests/test_server.py`` holds them for the
JAX package, and served audio against the JAX ``make_server`` handed the
same weights, prenet masks and noise.

Contracts: a session's concatenated audio equals a single-pass vocode of
its final mel with its own noise; a session's output depends only on
``(text, seed, sigma, denoiser_strength)``, not on its slot, its round of
admission or its neighbours; more requests than slots all complete in
recycled slots; an early-gate session flushes and frees its slot while a
slow one still decodes; a session shorter than a window takes the exact
pass; every invalid input is rejected at ``submit``; ``load_weights``
shows on the next session.  Tolerances are stated at each comparison."""

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
from text2speech_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from text2speech_tpu.models.waveglow import WaveGlow as JaxWaveGlow
from text2speech_tpu.server import make_server as jax_make_server
from text2speech_tpu.text import N_SYMBOLS
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.config import HParams, WaveGlowConfig
from text2speech_tpu_torch.infer import Synthesizer, random_weights_
from text2speech_tpu_torch.models.chunked import (noise_schedule,
                                                  receptive_overlap_frames)
from text2speech_tpu_torch.models.waveglow import WaveGlow
from text2speech_tpu_torch.server import (ContinuousBatcher, StreamEvent,
                                          make_server)

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
CHUNK, LIMIT = 8, 48
HOP = WG.upsample_stride
GPF = HOP // WG.n_group
TEXTS = ["안녕하세요.", "존경하는 사람과 함께 갑니다.", "네.", "반갑습니다.",
         "오늘 날씨가 좋네요."]
SRV_KW = dict(chunk_steps=CHUNK, max_text_len=80)
DEN_KW = dict(filter_length=64, n_overlap=4, win_length=64, n_frames=12)


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
    return taco, tvars, wparams, jsyn, tsyn


@pytest.fixture(scope="module")
def tsyn(pair):
    return pair[4]


def single_pass(synth, srv, sid):
    """Reference: one vocode of the session's final mel with its own noise
    at its own sigma, the noise pre-scaled in f32 as the scheduler scales
    it (the bf16 vocoders round ``sigma * noise`` elsewhere when they are
    handed the sigma)."""
    s = srv.sessions[sid]
    tl = min(s.out_len, srv.requested)
    nz = tuple(s.sigma * c[None, : tl * GPF]
               for c in srv._sess_noise(s, tl))
    return synth.mel_to_audio(s.post_cat()[None, :, :tl], 1.0,
                              noise=nz)[0].numpy()


# --- against the JAX server -------------------------------------------------


def jax_key_fn(taco, tvars):
    """The port's ``key_fn`` from the JAX server's per-step, per-row keys:
    ``split(derive_rng(PRNGKey(seed)), limit)``, then per step the row's
    prenet key and per prenet layer a split and ``bernoulli(0.5)``
    (``tacotron2.py:82-91, 559-561``) -> bool [limit, 2, prenet_dim]."""
    def one_step(key):
        rng_pre = jax.random.split(key)[0]
        layers = []
        for _ in range(2):
            rng_pre, sub = jax.random.split(rng_pre)
            layers.append(jax.random.bernoulli(sub, 0.5, (HP.prenet_dim,)))
        return jnp.stack(layers)

    def key_fn(seed):
        base = taco.apply(tvars, method=JaxTacotron2.derive_rng,
                          rngs={"dropout": jax.random.PRNGKey(seed)})
        keys = jax.random.split(base, LIMIT)
        return torch.from_numpy(np.asarray(jax.vmap(one_step)(keys)))

    return key_fn


def jax_noise_fn(seed):
    """The JAX server's block stream: block j is ``draw_noise(fold_in(
    fold_in(PRNGKey(seed + 1), 0x5EED), j))`` (``server.py:550, 589``)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed + 1), 0x5EED)
    jwg = JaxWaveGlowConfig(**WG_KW)
    return lambda j: tuple(
        np.array(c[0]) for c in jax_draw_noise(
            jwg, jax.random.fold_in(key, j), 1, CHUNK * GPF))


def test_served_audio_matches_jax_server(pair):
    """Three sessions with their own seeds and sigmas through two slots of
    each package's server (the third joins a recycled slot).  The port is
    handed the masks and the noise blocks the JAX server draws.  float32
    against float32: 3e-4, the JAX package's bound for its server against
    its single pass."""
    taco, tvars, _, jsyn, tsyn = pair
    seeds, sigmas = [11, 22, 33], [0.8, 0.5, 1.0]
    jsrv = jax_make_server(jsyn, slots=2, sigma=0.8, **SRV_KW)
    want = jsrv.run(TEXTS[:3], seeds=seeds, sigmas=sigmas)
    tsrv = make_server(tsyn, slots=2, sigma=0.8, key_fn=jax_key_fn(taco, tvars),
                       noise_fn=jax_noise_fn, **SRV_KW)
    got = tsrv.run(TEXTS[:3], seeds=seeds, sigmas=sigmas)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for key in ("rounds", "admitted", "completed", "row_steps",
                "active_row_steps", "postnet_calls", "vocoder_calls",
                "emitted_samples", "first_audio_rounds_sum"):
        assert tsrv.stats[key] == jsrv.stats[key], key
    for sid in got:
        assert got[sid].shape == want[sid].shape == (44 * HOP,)
        np.testing.assert_allclose(got[sid], want[sid], atol=3e-4,
                                   err_msg=f"sid {sid}")


# --- the port's server on the real models -----------------------------------


def test_sessions_match_single_pass_and_slots_are_reused(tsyn):
    """More sessions than slots; every session's streamed audio equals a
    single-pass vocode of its own mel and noise (float32, windows against
    the whole: 1e-5)."""
    srv = make_server(tsyn, slots=2, sigma=0.8, retain_sessions=True,
                      **SRV_KW)
    wavs = srv.run(TEXTS)
    assert sorted(wavs) == list(range(len(TEXTS)))
    assert srv.stats["admitted"] == srv.stats["completed"] == len(TEXTS)
    assert srv.idle and srv.active_count == 0
    assert {srv.sessions[i].slot for i in range(5)} == {0, 1}
    for sid, wav in wavs.items():
        ref = single_pass(tsyn, srv, sid)
        assert wav.dtype == np.float32 and wav.shape == ref.shape
        np.testing.assert_allclose(wav, ref, atol=1e-5, err_msg=f"sid {sid}")
    st = srv.stats
    assert st["row_steps"] == st["rounds"] * 2 * CHUNK
    assert 0 < st["active_row_steps"] <= st["row_steps"]
    assert st["emitted_samples"] == sum(len(w) for w in wavs.values())


def test_join_independence(tsyn):
    """The same (text, seed) gives the same audio alone in a one-slot
    server and admitted mid-flight into a busy one.  The decode and the
    windows run at another batch size: float32 matmul rows, 1e-5."""
    srv = make_server(tsyn, slots=2, sigma=0.8, **SRV_KW)
    seeds = [11, 22, 33, 44, 55]
    # staggered joins: two sessions start, the others join as slots free
    sids = [srv.submit(t, seed=s) for t, s in zip(TEXTS[:2], seeds[:2])]
    parts = {}
    for _ in range(2):
        for ev in srv.step():
            if ev.audio is not None:
                parts.setdefault(ev.sid, []).append(ev.audio)
    sids += [srv.submit(t, seed=s) for t, s in zip(TEXTS[2:], seeds[2:])]
    while not srv.idle:
        for ev in srv.step():
            if ev.audio is not None:
                parts.setdefault(ev.sid, []).append(ev.audio)
    for i in (0, 2, 4):   # fresh slot, first recycled join, later join
        solo = make_server(tsyn, slots=1, sigma=0.8, **SRV_KW)
        ref = solo.run([TEXTS[i]], seeds=[seeds[i]])[0]
        np.testing.assert_allclose(np.concatenate(parts[sids[i]]), ref,
                                   atol=1e-5, err_msg=f"text {i}")


def test_default_masks_are_those_of_text_to_mel(tsyn):
    """The default ``key_fn``: a session's masks are the ones
    ``text_to_mel([text], seed)`` draws, whatever ``max_steps``; with the
    encoder at the text's own width the served mel is that call's: 1e-5.
    Not so the last postnet receptive field of a session that runs into
    the contract's end: its last window is zero-filled past ``requested``
    at the fixed width, which a postnet of several biased layers does not
    read as conv padding (the JAX server's windows do the same; the
    lockstep engine cuts its last window instead)."""
    from text2speech_tpu_torch.text import encode_batch

    width = encode_batch([TEXTS[1]])[0].shape[1]
    srv = make_server(tsyn, slots=3, retain_sessions=True, chunk_steps=CHUNK,
                      max_text_len=width)
    srv.run([TEXTS[1]], seeds=[9])
    gen = torch.Generator().manual_seed(9)
    want = tsyn.taco.decoder.draw_keep_masks(200, 1, gen, "cpu")[:LIMIT, :, 0]
    assert torch.equal(srv.sessions[0].masks, want)
    mel, lens = tsyn.text_to_mel([TEXTS[1]], seed=9)
    got = srv.sessions[0].post_cat()
    assert int(lens[0]) == 44 and got.shape == (HP.n_mel_channels, 44)
    np.testing.assert_allclose(got.numpy()[:, : 44 - srv.prf],
                               mel[0].numpy()[:, : 44 - srv.prf], atol=1e-5)


def test_mixed_sigma_rounds_share_one_call(tsyn):
    """Each session carries its own sigma; rows are pre-scaled, so a round
    is still ONE vocoder call; every session equals the single pass at ITS
    sigma, and differs from the one at the server's."""
    sigmas = [0.5, 0.8, 1.0]
    srv = make_server(tsyn, slots=3, sigma=0.8, retain_sessions=True,
                      **SRV_KW)
    calls = []
    inner = srv._vocode_fn
    srv._vocode_fn = lambda mel, nz, sg: (calls.append((mel.shape[0], sg)),
                                          inner(mel, nz, sg))[1]
    wavs = srv.run(TEXTS[:3], seeds=[1, 2, 3], sigmas=sigmas)
    assert all(sg == 1.0 and b == 3 for b, sg in calls)
    assert len(calls) == srv.stats["vocoder_calls"] == 6
    for sid, sg in enumerate(sigmas):
        assert srv.sessions[sid].sigma == sg
        np.testing.assert_allclose(wavs[sid], single_pass(tsyn, srv, sid),
                                   atol=1e-5)
    s = srv.sessions[0]
    nz = tuple(c[None, : 44 * GPF] for c in srv._sess_noise(s, 44))
    right = tsyn.mel_to_audio(s.post_cat()[None], 0.5, noise=nz)[0].numpy()
    wrong = tsyn.mel_to_audio(s.post_cat()[None], 0.8, noise=nz)[0].numpy()
    np.testing.assert_allclose(wavs[0], right, atol=1e-5)
    assert np.abs(wavs[0] - wrong).max() > 1e-3


def test_early_gate_sessions_flush_and_free_their_slots(tsyn):
    """The stop gate biased by +10: sessions stop early at their own
    lengths, flush through the exact pass as soon as their frames have
    cleared the postnet, and free their slots for the queue."""
    bias = tsyn.taco.decoder.gate_proj.bias
    old = bias.detach().clone()
    try:
        with torch.no_grad():
            bias.add_(10.0)
        srv = make_server(tsyn, slots=2, chunk_steps=4, max_text_len=80,
                          sigma=0.8, retain_sessions=True)
        wavs = srv.run(TEXTS[:4], seeds=[3, 4, 5, 6])
        for sid, wav in wavs.items():
            s = srv.sessions[sid]
            assert s.gate_fired and s.out_len < HP.max_decoder_steps
            assert s.t < srv.limit          # stopped decoding early
            assert wav.shape == (s.out_len * HOP,)
            np.testing.assert_allclose(wav, single_pass(tsyn, srv, sid),
                                       atol=1e-5)
        assert srv.stats["rounds"] < 4 * (srv.limit // 4)
    finally:
        with torch.no_grad():
            bias.copy_(old)


def test_fused_and_int8_vocoders_serve(tsyn):
    """The fused bf16 and the int8 vocoder behind the same scheduler (their
    plain versions here).  Windows are other batch shapes of the same bf16
    arithmetic, equal on the CPU: 1e-5 against the single pass."""
    for kw in ({"use_fused_vocoder": True}, {"int8_vocoder": True}):
        syn = dataclasses.replace(tsyn, **kw)
        srv = make_server(syn, slots=2, sigma=0.8, retain_sessions=True,
                          **SRV_KW)
        assert srv._vocode_masked_fn is None
        srv.warm_short_pass()                       # nothing to warm
        wavs = srv.run(TEXTS[:3], seeds=[1, 2, 3])
        for sid, wav in wavs.items():
            np.testing.assert_allclose(wav, single_pass(syn, srv, sid),
                                       atol=1e-5, err_msg=f"{kw} {sid}")


def test_quantized_decode_serves_behind_the_threshold(tsyn, monkeypatch):
    """``quantized_decode``: the int8 decoder serves only where the
    measured threshold says it pays; forced down to 1, sessions complete
    with finite audio of contract length, and the batch carries the
    attention's memory projection."""
    from text2speech_tpu_torch.models import tacotron_serve

    q = dataclasses.replace(tsyn, quantized_decode=True)
    plain = make_server(q, slots=2, **SRV_KW)
    assert "pmem" not in plain._batch        # threshold None: fp decode
    monkeypatch.setattr(tacotron_serve, "INT8_DECODE_MIN_BATCH", 1)
    srv = make_server(q, slots=2, **SRV_KW)
    assert "pmem" in srv._batch
    wavs = srv.run(TEXTS[:3])
    for wav in wavs.values():
        assert wav.shape == (44 * HOP,) and np.isfinite(wav).all()
        assert np.abs(wav).max() > 1e-3


def test_per_session_denoiser_matches_offline(pair):
    """Sessions with different strengths (one off) share the server's
    denoiser; each equals the offline denoiser over its raw audio (the
    windowed STFT is frame-local: 1e-5), and a raw session is untouched."""
    _, _, _, _, base = pair
    syn = dataclasses.replace(base, use_denoiser=True, denoiser_kwargs=DEN_KW)
    srv = make_server(syn, slots=2, sigma=0.8, retain_sessions=True,
                      **SRV_KW)
    strengths = [0.5, None, 0.1]
    wavs = srv.run(TEXTS[:3], seeds=[1, 2, 3], denoiser_strengths=strengths)
    assert srv.stats["denoiser_calls"] > 0
    for sid, st in enumerate(strengths):
        raw = torch.from_numpy(single_pass(syn, srv, sid))[None]
        if st is None:
            np.testing.assert_allclose(wavs[sid], raw[0].numpy(), atol=1e-5)
            continue
        ref = syn._denoise(raw, st)[0].numpy()
        assert wavs[sid].shape == ref.shape
        np.testing.assert_allclose(wavs[sid], ref, atol=1e-5)
        assert np.abs(ref - raw[0, : ref.shape[0]].numpy()).max() > 1e-4


def test_submit_rejects_every_invalid_input(tsyn):
    srv = make_server(tsyn, slots=1, chunk_steps=CHUNK, max_text_len=32)
    for bad in ("abc", 1.5, -1, 2**40, True):
        with pytest.raises(ValueError, match="seed"):
            srv.submit("네.", seed=bad)
    for bad in ("hot", float("nan"), -0.1, False):
        with pytest.raises(ValueError, match="sigma"):
            srv.submit("네.", sigma=bad)
    for bad in ("x", float("inf"), -1.0, True):
        with pytest.raises(ValueError, match="denoiser_strength"):
            srv.submit("네.", denoiser_strength=bad)
    with pytest.raises(ValueError, match="without a denoiser"):
        srv.submit("네.", denoiser_strength=0.1)
    with pytest.raises(ValueError, match="max_text_len"):
        srv.submit(TEXTS[1] * 2)
    with pytest.raises(ValueError, match="single-speaker"):
        srv.submit(("네.", 1))
    assert srv.idle and srv.queued_count == 0
    assert srv.step() == []          # the server is unaffected
    assert srv.submit("네.", seed=np.int64(3), sigma=1, denoiser_strength=0) == 0
    with pytest.raises(ValueError, match="receptive field"):
        make_server(tsyn, slots=1, chunk_steps=2, max_text_len=8)


def test_load_weights_shows_on_the_next_session(pair):
    """``Synthesizer.load_weights`` under a running server: the same
    (text, seed) then gives other audio, equal to a server built on the new
    weights; the live modules are updated in place and the derived serving
    weights rebuilt."""
    _, tvars, wparams, _, base = pair
    syn = Synthesizer(HP, convert.load_tacotron(tvars, HP, N_SYMBOLS), WG,
                      convert.load_waveglow({"params": wparams}, WG),
                      use_denoiser=True, int8_vocoder=True,
                      quantized_decode=True, denoiser_kwargs=DEN_KW)
    srv = make_server(syn, slots=1, **SRV_KW)
    w0 = srv.run([TEXTS[0]], seeds=[5])[0]
    taco_mod, wg_mod, fused0 = syn.taco, syn.waveglow, syn.fused
    bias0, dpq0 = syn._denoise_bias.clone(), syn._dp_q
    prng = np.random.RandomState(3)
    perturb = lambda tree: jax.tree.map(  # noqa: E731
        lambda x: np.asarray(x) + (0.03 * prng.randn(*np.shape(x))).astype(
            np.float32) if np.asarray(x).dtype.kind == "f" else x, tree)
    new_t, new_w = perturb(tvars), {"params": perturb(wparams)}
    syn.load_weights(new_t, new_w)
    assert syn.taco is taco_mod and syn.waveglow is wg_mod
    assert syn.fused is not fused0 and syn.vocoder is syn.fused
    assert syn._dp_q is not dpq0
    assert not torch.equal(syn._denoise_bias, bias0)
    w1 = srv.run([TEXTS[0]], seeds=[5])[1]
    assert np.abs(w1 - w0).max() > 1e-3
    fresh = Synthesizer(HP, convert.load_tacotron(new_t, HP, N_SYMBOLS), WG,
                        convert.load_waveglow(new_w, WG), use_denoiser=True,
                        int8_vocoder=True, quantized_decode=True,
                        denoiser_kwargs=DEN_KW)
    ref = make_server(fresh, slots=1, **SRV_KW).run([TEXTS[0]], seeds=[5])[0]
    np.testing.assert_array_equal(w1, ref)
    # one model alone
    syn.load_weights(wg_variables={"params": wparams})
    assert np.abs(srv.run([TEXTS[0]], seeds=[5])[2] - w1).max() > 1e-3


def test_load_checkpoints_reads_a_training_checkpoint(pair, tmp_path):
    """A WaveGlow training checkpoint directory (the newest step) and the
    Tacotron ``.npz`` of the exporter swap in through
    ``load_checkpoints``."""
    from text2speech_tpu_torch.models.waveglow import TrainableWaveGlow
    from text2speech_tpu_torch.train.checkpoint import CheckpointManager
    from text2speech_tpu_torch.train.state import create_train_state

    _, tvars, wparams, _, _ = pair
    syn = Synthesizer(HP, convert.load_tacotron(tvars, HP, N_SYMBOLS), WG,
                      convert.load_waveglow({"params": wparams}, WG),
                      use_denoiser=False, use_fused_vocoder=True)
    trainable = TrainableWaveGlow(
        WG, generator=torch.Generator().manual_seed(4))
    mgr = CheckpointManager(str(tmp_path / "wg"))
    mgr.save(3, create_train_state(trainable, 1e-4))
    with torch.no_grad():
        for k in range(WG.n_flows):
            trainable.params[f"wn{k}/end/kernel"].fill_(0.01 * (k + 1))
    mgr.save(7, create_train_state(trainable, 1e-4))
    prng = np.random.RandomState(5)
    new_t = jax.tree.map(
        lambda x: np.asarray(x) + (0.03 * prng.randn(*np.shape(x))).astype(
            np.float32) if np.asarray(x).dtype.kind == "f" else x, tvars)
    convert.save_npz(str(tmp_path / "t.npz"),
                     convert.flatten_tree({"tacotron": new_t}))
    fused0 = syn.fused
    syn.load_checkpoints(taco_npz=str(tmp_path / "t.npz"),
                         wg_ckpt_dir=str(tmp_path / "wg"))
    want_w = convert.load_waveglow(
        convert.variables_from_trainable(trainable), WG)
    for (n, a), (_, b) in zip(syn.waveglow.named_parameters(),
                              want_w.named_parameters()):
        assert torch.equal(a, b), n
    want_t = convert.load_tacotron(new_t, HP, N_SYMBOLS)
    for (n, a), (_, b) in zip(syn.taco.named_parameters(),
                              want_t.named_parameters()):
        assert torch.equal(a, b), n
    assert syn.fused is not fused0
    with pytest.raises(FileNotFoundError):
        syn.load_checkpoints(wg_ckpt_dir=str(tmp_path / "empty"))


# --- toy-driven scheduler tests (exact arithmetic, no models) ---------------


def toy_batcher(slots, stop_at_by_req, cs=4, requested=16):
    """ContinuousBatcher over deterministic toy callables.

    A request is an integer uid; its decode emits ``mel[c, k] = uid * 1000
    + step + c / 10`` and its gate fires after ``stop_at_by_req[uid]``
    frames.  The postnet residual is zero; the toy vocoder is local:
    ``audio[2k : 2k + 2] = mel[0, k] + noise[k]``.  prf = ov = 1 keep the
    window machinery engaged while every value stays exactly
    reconstructable."""
    n_mel, prf, ov, gpf, hop = 2, 1, 1, 1, 2
    limit = -(-requested // cs) * cs

    def admit_fn(uid, seed):
        return {"uid": torch.tensor(float(uid)), "t0": torch.tensor(0.0),
                "stop": torch.tensor(float(stop_at_by_req[uid])),
                "done": torch.tensor(False)}

    def init_batch_fn():
        z = torch.zeros((slots,))
        return {"uid": z.clone(), "t0": z.clone(), "stop": z + 10_000.0,
                "done": torch.zeros((slots,), dtype=torch.bool)}

    def decode_fn(batch, masks):
        n = masks.shape[0]
        steps = batch["t0"][:, None] + torch.arange(n)[None, :]
        mel = (batch["uid"][:, None, None] * 1000.0 + steps[:, None, :]
               + torch.arange(n_mel)[None, :, None] / 10.0)
        # active marks frames at or before the stop frame, like the model
        active = (steps <= batch["stop"][:, None]) & ~batch["done"][:, None]
        done = batch["done"] | (steps[:, -1] >= batch["stop"])
        new = dict(batch, t0=batch["t0"] + n, done=done)
        return new, mel, active, done

    def vocode_fn(mel, noise, sigma):
        return (mel[:, 0, :].repeat_interleave(hop, dim=-1)
                + noise[0][..., 0].repeat_interleave(hop // gpf, dim=-1))

    def noise_fn(seed):
        rng = np.random.RandomState(seed)
        blocks = {}

        def draw(j):
            while len(blocks) <= j:
                blocks[len(blocks)] = rng.randn(cs * gpf, 1).astype(np.float32)
            return (blocks[j],)

        return draw

    return ContinuousBatcher(
        slots=slots, chunk_steps=cs, requested=requested, prf=prf, ov=ov,
        n_mel=n_mel, gpf=gpf, hop=hop, noise_widths=(1,), sigma=1.0,
        device="cpu", admit_fn=admit_fn, init_batch_fn=init_batch_fn,
        decode_fn=decode_fn, postnet_fn=torch.zeros_like,
        vocode_fn=vocode_fn,
        key_fn=lambda seed: torch.zeros((limit, 2, 1), dtype=torch.bool),
        noise_fn=noise_fn, retain_sessions=True)


def toy_expected(srv, uid, sid):
    """Exact expected audio: ``mel[0, k] = uid * 1000 + k`` over the true
    length, plus the session's own noise at its own sigma."""
    s = srv.sessions[sid]
    tl = min(s.out_len, srv.requested)
    mel0 = uid * 1000.0 + np.arange(tl)
    noise = srv._sess_noise(s, tl)[0][:tl, 0].numpy()
    return np.repeat(mel0 + np.float32(s.sigma) * noise, srv.hop), tl


def drain(srv, parts=None, finals=None):
    rounds = 0
    while not srv.idle:
        rounds += 1
        assert rounds < 500, "server did not converge"
        for ev in srv.step():
            assert isinstance(ev, StreamEvent)
            if ev.final:
                if finals is not None:
                    finals[ev.sid] = srv.stats["rounds"]
            elif parts is not None:
                parts.setdefault(ev.sid, []).append(ev.audio)
    return parts


def test_toy_staggered_gates_and_slot_reuse():
    # uid 0 stops fast, uid 1 runs to the contract, uid 2 queues behind
    # both and must take uid 0's freed slot
    stop = {0: 2, 1: 99, 2: 5}
    srv = toy_batcher(slots=2, stop_at_by_req=stop)
    sids = {uid: srv.submit(uid) for uid in (0, 1, 2)}
    finals: dict = {}
    parts = drain(srv, {}, finals)
    assert finals[sids[0]] < finals[sids[1]]
    assert srv.sessions[sids[2]].slot == srv.sessions[sids[0]].slot
    assert sids[2] in finals
    for uid, sid in sids.items():
        want, tl = toy_expected(srv, uid, sid)
        assert tl == min(stop[uid] + 1, srv.requested)  # post-stop excluded
        np.testing.assert_allclose(np.concatenate(parts[sid]), want,
                                   atol=1e-4, err_msg=f"uid {uid}")


def test_toy_idle_slots_are_harmless():
    stop = {0: 6, 1: 6, 2: 6, 3: 6}
    alone = toy_batcher(slots=4, stop_at_by_req=stop).run([0])
    full = toy_batcher(slots=4, stop_at_by_req=stop).run([0, 1, 2, 3])
    np.testing.assert_array_equal(alone[0], full[0])


def test_toy_cancel():
    """Cancel drops a queued session and frees an active session's slot;
    the freed slot admits the next queued request; a cancelled session
    emits nothing more."""
    stop = {0: 99, 1: 99, 2: 4, 3: 99}
    srv = toy_batcher(slots=1, stop_at_by_req=stop)
    s0, s1, s2 = srv.submit(0), srv.submit(1), srv.submit(2)
    srv.step()
    assert srv.active_count == 1 and srv.queued_count == 2
    assert srv.cancel(s1)          # queued: dropped
    assert srv.cancel(s0)          # active: slot freed
    assert not srv.cancel(s1)      # already gone
    seen = set()
    while not srv.idle:
        seen |= {ev.sid for ev in srv.step()}
    assert seen == {s2}
    assert srv.stats["cancelled"] == 2 and srv.stats["completed"] == 1


def test_toy_soak_randomized():
    """60 sessions with random stop frames, their own sigmas and random
    mid-flight cancels through 4 slots: no event after a cancel or a final;
    every completed session's audio is EXACTLY the toy single pass at its
    own sigma; every session ends completed or cancelled; the accounts
    balance."""
    rng = np.random.RandomState(0)
    n = 60
    stop = {uid: int(rng.randint(1, 20)) for uid in range(n)}
    srv = toy_batcher(slots=4, stop_at_by_req=stop)
    sigmas = {uid: float(rng.choice([0.5, 1.0, 2.0])) for uid in range(n)}
    sids = {uid: srv.submit(uid, sigma=sigmas[uid]) for uid in range(n)}
    cancelled, finals, parts = set(), set(), {}
    rounds = 0
    while not srv.idle:
        rounds += 1
        assert rounds < 500
        if rng.rand() < 0.4:
            victim = sids[int(rng.randint(0, n))]
            if (victim not in finals and victim not in cancelled
                    and srv.cancel(victim)):
                cancelled.add(victim)
        for ev in srv.step():
            assert ev.sid not in cancelled, "event after cancel"
            assert ev.sid not in finals, "event after final"
            if ev.final:
                finals.add(ev.sid)
            else:
                parts.setdefault(ev.sid, []).append(ev.audio)
    assert len(finals) + len(cancelled) == n
    assert srv.stats["completed"] == len(finals)
    assert srv.stats["cancelled"] == len(cancelled)
    uid_of = {v: k for k, v in sids.items()}
    for sid in finals:
        want, tl = toy_expected(srv, uid_of[sid], sid)
        assert tl == min(stop[uid_of[sid]] + 1, srv.requested)
        np.testing.assert_allclose(np.concatenate(parts[sid]), want,
                                   atol=1e-4, err_msg=f"sid {sid}")


def test_toy_first_window_fast_path_and_warm_widths():
    """A wave of simultaneous admissions vocodes its first round at ``Wv1
    = chunk + ov``; a round that mixes a joining session's first window
    with mid-stream windows stays at ``Wv``; ``warm_window_widths`` calls
    the vocoder once at each width at the full slot batch."""
    stop = {0: 7, 1: 99, 2: 99}   # uid 0 frees its slot; uid 2 joins late
    srv = toy_batcher(slots=2, stop_at_by_req=stop)
    assert (srv.Wv1, srv.Wv) == (srv.cs + srv.ov, srv.cs + 2 * srv.ov)
    calls = []
    inner = srv._vocode_fn
    srv._vocode_fn = lambda mel, nz, sg: (
        calls.append((mel.shape[0], mel.shape[-1],
                      tuple(z.shape for z in nz))), inner(mel, nz, sg))[1]
    sids = {uid: srv.submit(uid) for uid in (0, 1, 2)}
    parts = drain(srv, {})
    widths = [w for _, w, _ in calls]
    assert widths[0] == srv.Wv1 and srv.Wv in widths
    assert set(widths) <= {srv.Wv1, srv.Wv}
    for uid, sid in sids.items():
        want, _ = toy_expected(srv, uid, sid)
        np.testing.assert_allclose(np.concatenate(parts[sid]), want,
                                   atol=1e-4)
    calls.clear()
    srv.warm_window_widths()
    assert calls == [(2, srv.Wv1, ((2, srv.Wv1, 1),)),
                     (2, srv.Wv, ((2, srv.Wv, 1),))]


@pytest.mark.parametrize("masked", [False, True])
def test_flush_band_sessions_take_the_exact_pass(masked):
    """A session that emitted ONE mid-stream window and then stops shorter
    than a full vocoder window must flush through the exact-length pass;
    so must a tiny one.  Toy decode (controlled lengths) through a REAL
    WaveGlow (a linear toy vocoder cannot see the zero-tail leak).  With
    ``vocode_masked_fn`` both short sessions ride ONE call shape, the
    fixed width ``Wv``.  float32, windows against the whole: 1e-5."""
    cfg = WaveGlowConfig(n_mel_channels=8, n_flows=2, n_group=4,
                         n_early_every=4, wn_n_layers=2, wn_n_channels=16,
                         upsample_kernel=64, upsample_stride=16)
    ov = receptive_overlap_frames(cfg)
    cs, prf, requested = 6, 1, 24
    hop, gpf, n_mel = 16, 4, 8
    assert cs + ov <= 12 < cs + 2 * ov   # stop = 12 flushes inside the band
    model = WaveGlow(cfg)
    random_weights_(model, torch.Generator().manual_seed(0), out_first=False)
    with torch.no_grad():
        for wn in model.wn:
            wn.end_w.mul_(0.3)
    masked_calls = []

    def vocode_masked_fn(mel, nz, sg, tl):
        masked_calls.append((mel.shape[-1], tl))
        return model.infer(mel, sg, noise=nz, length=tl)

    stop_by_uid = {0: 12, 1: 2, 2: 99}   # band / tiny / the whole contract

    def decode_fn(batch, masks):
        n = masks.shape[0]
        steps = batch["t0"][:, None] + torch.arange(n)[None, :]
        mel = (batch["uid"][:, None, None] + steps[:, None, :] / 10.0
               + torch.arange(n_mel)[None, :, None] / 100.0)
        active = (steps <= batch["stop"][:, None]) & ~batch["done"][:, None]
        done = batch["done"] | (steps[:, -1] >= batch["stop"])
        return dict(batch, t0=batch["t0"] + n, done=done), mel, active, done

    def noise_fn(seed):
        gen = torch.Generator().manual_seed(seed)
        return lambda j: tuple(torch.randn(cs * gpf, w, generator=gen)
                               for w in noise_schedule(cfg))

    srv = ContinuousBatcher(
        slots=2, chunk_steps=cs, requested=requested, prf=prf, ov=ov,
        n_mel=n_mel, gpf=gpf, hop=hop,
        noise_widths=tuple(noise_schedule(cfg)), sigma=0.8, device="cpu",
        admit_fn=lambda uid, seed: {
            "uid": torch.tensor(float(uid)), "t0": torch.tensor(0.0),
            "stop": torch.tensor(float(stop_by_uid[uid])),
            "done": torch.tensor(False)},
        init_batch_fn=lambda: {
            "uid": torch.zeros(2), "t0": torch.zeros(2),
            "stop": torch.zeros(2) + 10_000.0,
            "done": torch.zeros(2, dtype=torch.bool)},
        decode_fn=decode_fn, postnet_fn=torch.zeros_like,
        vocode_fn=lambda mel, nz, sg: model.infer(mel, sg, noise=nz),
        vocode_masked_fn=vocode_masked_fn if masked else None,
        key_fn=lambda seed: torch.zeros((requested, 2, 1), dtype=torch.bool),
        noise_fn=noise_fn, retain_sessions=True)
    wavs = srv.run([0, 1, 2])
    if masked:
        assert sorted(masked_calls) == [(srv.Wv, 3), (srv.Wv, 13)]
    for sid, uid in enumerate(stop_by_uid):
        s = srv.sessions[sid]
        tl = min(s.out_len, requested)
        assert tl == min(stop_by_uid[uid] + 1, requested)
        nz = tuple(c[None, : tl * gpf] for c in srv._sess_noise(s, tl))
        ref = model.infer(s.post_cat()[None, :, :tl], 0.8, noise=nz)[0]
        assert wavs[sid].shape == tuple(ref.shape)
        np.testing.assert_allclose(wavs[sid], ref.numpy(), atol=1e-5,
                                   err_msg=f"uid {uid} (tl={tl})")
    # the band session really took the mid-stream-then-exact route
    assert srv.sessions[0].E == 13 and srv.stats["vocoder_calls"] >= 3
