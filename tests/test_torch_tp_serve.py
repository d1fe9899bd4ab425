"""The port's full-chain tensor-parallel serving
(``text2speech_tpu_torch.parallel.serve.TPSynthesizer``,
``server.make_server_tp``) against the JAX package's
(``text2speech_tpu.parallel.serve``, ``server.make_server_tp`` on a
two-device CPU mesh of the model axis) handed the same weights, prenet
masks and noise, and against the port's single-device ``Synthesizer`` and
``make_server`` (``tests/test_tp_serve.py``'s twelve contracts,
``tests/test_server.py:405-480``, ``tests/test_http_serve.py:413-446``).

Tolerances: against the JAX package, the JAX tests' own (2e-4 on the mel,
2e-3 on audio; 2e-6 / 2e-5 for a denoised stream against the offline
denoiser).  Against the port's single device: both run the same float32
operations in the same order except the vocoder's per-layer sum over ranks
and the per-slice LSTM products, 1e-5.

Four processes, one rank each over gloo (spawned once for the file, at its
first test, and killed after 150 s), run on seeded random weights: the
server in lockstep over a model group of two, bit-equal to the
one-process two-shard server; a rank submitting another seed, which raises
on both ranks instead of hanging; the server on a 2 x 2 data x model grid;
a model-only mesh of four (no data axis); and with the stop gate biased
on, the short rows of a batch stream and a batch-1 stream on the grid,
which go to the model-only endpoints."""

import os
import socket
import subprocess
import sys
import textwrap
import threading
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from tests.test_torch_server import (HP_KW, WG_KW, jax_key_fn,
                                     jax_noise_fn)
from tests.test_torch_streaming import jax_chunk_noise, jax_keep_masks
from text2speech_tpu.config import HParams as JaxHParams
from text2speech_tpu.config import WaveGlowConfig as JaxWaveGlowConfig
from text2speech_tpu.models.chunked import draw_noise as jax_draw_noise
from text2speech_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from text2speech_tpu.models.waveglow import WaveGlow as JaxWaveGlow
from text2speech_tpu.parallel.serve import TPSynthesizer as JaxTPSynthesizer
from text2speech_tpu.server import make_server_tp as jax_make_server_tp
from text2speech_tpu.text import N_SYMBOLS
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.config import HParams, WaveGlowConfig
from text2speech_tpu_torch.http_serve import (float_to_pcm16,
                                              make_http_server,
                                              wav_stream_header)
from text2speech_tpu_torch.infer import Synthesizer, random_synthesizer
from text2speech_tpu_torch.models.chunked import receptive_overlap_frames
from text2speech_tpu_torch.models.denoiser import make_denoiser
from text2speech_tpu_torch.parallel.serve import TPSynthesizer
from text2speech_tpu_torch.server import make_server, make_server_tp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP, WG = HParams(**HP_KW), WaveGlowConfig(**WG_KW)
CHUNK, LIMIT, REQUESTED = 8, 48, 44
HOP = WG.upsample_stride
GPF = HOP // WG.n_group
TEXTS = ["안녕하세요.", "존경하는 사람과 함께 갑니다.", "네.", "반갑습니다."]
SIGMA = 0.8
SRV_KW = dict(chunk_steps=CHUNK, max_text_len=80, sigma=SIGMA)
DKW = dict(filter_length=64, n_overlap=4, win_length=64, n_frames=16)
JAX_MEL, JAX_AUDIO, PORT = 2e-4, 2e-3, 1e-5

# --- four processes, started at the file's first test -----------------------

_WORKER = """
import json
import sys
import numpy as np
import torch
from text2speech_tpu_torch.config import HParams, WaveGlowConfig
from text2speech_tpu_torch.infer import random_synthesizer
from text2speech_tpu_torch.parallel import mesh as pm
from text2speech_tpu_torch.parallel.serve import TPSynthesizer
from text2speech_tpu_torch.server import make_server_tp

port, rank, inp, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
assert pm.initialize_distributed(f"tcp://localhost:{port}", 4, rank,
                                 device="cpu")
try:
    d = json.load(open(inp))
    hp, wg = HParams(**d["hp"]), WaveGlowConfig(**d["wg"])
    synth = random_synthesizer(hp, wg, seed=0, device="cpu",
                               use_fused_vocoder=False, use_denoiser=False)
    texts, seeds, kw = d["texts"], d["seeds"], d["srv"]
    grid = pm.make_mesh((2, 2), (pm.DATA_AXIS, pm.MODEL_AXIS))
    flat = pm.make_mesh((4,), (pm.MODEL_AXIS,))
    res = {}

    def tps(**where):
        return TPSynthesizer(hp, synth.taco, wg, synth.waveglow,
                             chunk_steps=kw["chunk_steps"], **where)

    # the server in lockstep over this data line's model group of two
    pair = tps(group=grid.group(pm.MODEL_AXIS))
    res["groups"] = len(pair.lockstep_groups)
    res["server"] = make_server_tp(pair, slots=2, **kw).run(
        texts[:3], seeds=seeds[:3])
    # out of lockstep: the second model rank submits another seed
    try:
        make_server_tp(pair, slots=2, **kw).run(
            texts[:1], seeds=[seeds[0] + rank % 2])
        res["disagree"] = None
    except RuntimeError as e:
        res["disagree"] = str(e)
    # the data x model grid: a data rank decodes and vocodes its slot
    on_grid = tps(mesh=grid)
    res["grid_groups"] = len(on_grid.lockstep_groups)
    res["grid_server"] = make_server_tp(on_grid, slots=2, **kw).run(
        texts[:3], seeds=seeds[:3])
    # a model-only mesh (no data axis)
    res["flat"] = tps(mesh=flat).synthesize(texts[:2], sigma=kw["sigma"],
                                            seed=3)
    # the stop gate biased on: short rows and a batch-1 stream on the grid
    with torch.no_grad():
        synth.taco.decoder.gate_proj.bias.fill_(10.0)
    short = tps(mesh=grid)
    rows = {}
    for r, ch in short.synthesize_incremental_batch(
            texts[:2], sigma=kw["sigma"], seed=3):
        rows.setdefault(r, []).append(ch)
    res["short_rows"] = {r: np.concatenate(c) for r, c in rows.items()}
    res["short_endpoints"] = sorted(short._vocoders)
    res["b1"] = np.concatenate(list(short.synthesize_incremental(
        texts[0], sigma=kw["sigma"], seed=3)))
    torch.save(res, out)
finally:
    pm.destroy_distributed()
"""

WORKER_SEEDS = [7, 8, 9]


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Start the four ranks; ``ranks`` collects them."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    (tmp / "inputs.json").write_text(json.dumps({
        "hp": HP_KW, "wg": WG_KW, "texts": TEXTS, "seeds": WORKER_SEEDS,
        "srv": SRV_KW}))
    script = tmp / "worker.py"
    script.write_text(textwrap.dedent(_WORKER))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(port), str(r),
         str(tmp / "inputs.json"), str(tmp / f"out{r}.pt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    yield tmp, procs
    for pr in procs:
        if pr.poll() is None:
            pr.kill()
            pr.wait(timeout=10)


# --- the JAX pair -------------------------------------------------------------


@pytest.fixture(scope="module")
def pair(workers):
    """The JAX TPSynthesizer (model axis of two CPU devices) and the port's
    TPSynthesizer (two shards in this process) and Synthesizer (plain f32
    vocoder, no denoiser) on the same weights, the WaveGlow's perturbed so
    that its ``end`` convs are not zero."""
    jhp, jwg = JaxHParams(**HP_KW), JaxWaveGlowConfig(**WG_KW)
    rng = jax.random.PRNGKey(0)
    taco = JaxTacotron2(jhp, n_vocab=N_SYMBOLS)
    tvars = jax.jit(taco.init)(
        {"params": rng, "dropout": rng}, jnp.zeros((1, 8), jnp.int32),
        jnp.asarray([8]), jnp.zeros((1, HP.n_mel_channels, 8)),
        jnp.asarray([8]))
    tvars = jax.tree.map(np.array, tvars)
    wg = JaxWaveGlow(jwg)
    wvars = jax.jit(wg.init)(rng, jnp.zeros((1, WG.n_mel_channels, 16)),
                             jnp.zeros((1, 16 * HOP)))
    prng = np.random.RandomState(1)
    wparams = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * prng.randn(*x.shape).astype(
            np.float32), wvars["params"])
    mesh = Mesh(np.asarray(jax.devices("cpu")[:2]), ("model",))

    def jax_tps(tv):
        return JaxTPSynthesizer(
            hp=jhp, taco=taco, taco_variables=tv, wg_cfg=jwg, waveglow=wg,
            wg_variables={"params": wparams}, mesh=mesh, data_axis=None,
            chunk_steps=CHUNK)

    tsyn = Synthesizer(HP, convert.load_tacotron(tvars, HP, N_SYMBOLS), WG,
                       convert.load_waveglow({"params": wparams}, WG),
                       use_denoiser=False)
    ttps = TPSynthesizer(HP, tsyn.taco, WG, tsyn.waveglow, n_model=2,
                         chunk_steps=CHUNK)
    return dict(taco=taco, tvars=tvars, jax_tps=jax_tps, jtps=jax_tps(tvars),
                tsyn=tsyn, ttps=ttps, wg_params=wparams, jwg=jwg)


def jax_vocoder_noise(jwg, seed, B, frames):
    """The JAX TP vocoder's draws: ``draw_noise(PRNGKey(seed + 1), B,
    frames * gpf)``."""
    return tuple(torch.from_numpy(np.array(z)) for z in jax_draw_noise(
        jwg, jax.random.PRNGKey(seed + 1), B, frames * GPF, jnp.float32))


def test_text_to_mel_matches_jax_and_the_synthesizer(pair):
    jmel, jlen = pair["jtps"].text_to_mel(TEXTS[:2], seed=0)
    keep = jax_keep_masks(pair["taco"], pair["tvars"], 0, LIMIT, 2)
    tmel, tlen = pair["ttps"].text_to_mel(TEXTS[:2], seed=0, keep_masks=keep)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert tmel.shape == (2, HP.n_mel_channels, REQUESTED)
    np.testing.assert_allclose(tmel.numpy(), np.asarray(jmel), atol=JAX_MEL)
    smel, slen = pair["tsyn"].text_to_mel(TEXTS[:2], seed=0)
    tmel, tlen = pair["ttps"].text_to_mel(TEXTS[:2], seed=0)
    assert torch.equal(tlen, slen)
    torch.testing.assert_close(tmel, smel, atol=PORT, rtol=0)


def test_synthesize_matches_jax_and_the_synthesizer(pair):
    jwav = pair["jtps"].synthesize(TEXTS[:2], sigma=SIGMA, seed=0)
    keep = jax_keep_masks(pair["taco"], pair["tvars"], 0, LIMIT, 2)
    frames = max(len(w) for w in jwav) // HOP
    got = pair["ttps"].synthesize(
        TEXTS[:2], sigma=SIGMA, seed=0, keep_masks=keep,
        noise=jax_vocoder_noise(pair["jwg"], 0, 2, frames))
    for g, w in zip(got, jwav):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), atol=JAX_AUDIO)
    got = pair["ttps"].synthesize(TEXTS[:2], sigma=SIGMA, seed=0)
    want = pair["tsyn"].synthesize(TEXTS[:2], sigma=SIGMA, seed=0)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (REQUESTED * HOP,)
        np.testing.assert_allclose(g, w, atol=PORT)


def _biased(tvars, bump: float = 10.0):
    tv = jax.tree.map(np.array, tvars)
    tv["params"]["decoder"]["gate_proj"]["bias"] += bump
    return tv


def test_early_gate_exit_matches_jax_and_the_synthesizer(pair):
    """Every gate fires early: the chunked decode exits early, decodes the
    postnet's tail, zeroes past each stop and pads to ``requested``."""
    tv = _biased(pair["tvars"])
    jtps = pair["jax_tps"](tv)
    taco = convert.load_tacotron(tv, HP, N_SYMBOLS)
    ttps = TPSynthesizer(HP, taco, WG, pair["tsyn"].waveglow, n_model=2,
                         chunk_steps=CHUNK)
    jmel, jlen = jtps.text_to_mel(TEXTS[:2], seed=0)
    keep = jax_keep_masks(pair["taco"], tv, 0, LIMIT, 2)
    tmel, tlen = ttps.text_to_mel(TEXTS[:2], seed=0, keep_masks=keep)
    assert (tlen.numpy() < REQUESTED).all(), tlen
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert tmel.shape == (2, HP.n_mel_channels, REQUESTED)
    np.testing.assert_allclose(tmel.numpy(), np.asarray(jmel), atol=JAX_MEL)
    single = Synthesizer(HP, taco, WG, pair["tsyn"].waveglow,
                         use_denoiser=False)
    smel, slen = single.text_to_mel(TEXTS[:2], seed=0)
    tmel, tlen = ttps.text_to_mel(TEXTS[:2], seed=0)
    assert torch.equal(tlen, slen)
    torch.testing.assert_close(tmel, smel, atol=PORT, rtol=0)

    jwav = jtps.synthesize(TEXTS[:2], sigma=SIGMA, seed=0)
    frames = max(len(w) for w in jwav) // HOP
    got = ttps.synthesize(TEXTS[:2], sigma=SIGMA, seed=0, keep_masks=keep,
                          noise=jax_vocoder_noise(pair["jwg"], 0, 2, frames))
    for g, w in zip(got, jwav):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), atol=JAX_AUDIO)


def test_synthesize_incremental_matches_jax_and_the_synthesizer(pair):
    kw = dict(sigma=SIGMA, seed=0, chunk_steps=CHUNK)
    want = [np.asarray(c) for c in pair["jtps"].synthesize_incremental(
        TEXTS[0], **kw)]
    got = list(pair["ttps"].synthesize_incremental(
        TEXTS[0], keep_masks=jax_keep_masks(pair["taco"], pair["tvars"], 0,
                                            LIMIT, 1),
        noise=jax_chunk_noise(0), **kw))
    assert [len(c) for c in got] == [len(c) for c in want]
    assert all(c.dtype == np.float32 for c in got)
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               atol=JAX_AUDIO)
    got = np.concatenate(list(pair["ttps"].synthesize_incremental(
        TEXTS[0], **kw)))
    ref = np.concatenate(list(pair["tsyn"].synthesize_incremental(
        TEXTS[0], **kw)))
    assert got.shape == ref.shape == (REQUESTED * HOP,)
    np.testing.assert_allclose(got, ref, atol=PORT)


def test_synthesize_incremental_denoised(pair):
    """The denoised stream equals the offline denoiser over the raw stream
    (2e-6 / 2e-5, ``tests/test_tp_serve.py:219``) and the JAX package's
    denoised stream."""
    kw = dict(sigma=SIGMA, seed=0, chunk_steps=CHUNK)
    ttps = pair["ttps"]
    raw = np.concatenate(list(ttps.synthesize_incremental(TEXTS[0], **kw)))
    den = np.concatenate(list(ttps.synthesize_incremental(
        TEXTS[0], denoiser_strength=0.07, denoiser_kwargs=DKW, **kw)))
    _, denoise = make_denoiser(ttps.waveglow, **DKW)
    ref = denoise(torch.from_numpy(raw[None]), 0.07)[0].numpy()
    assert den.shape == ref.shape
    np.testing.assert_allclose(den, ref, atol=2e-6, rtol=2e-5)
    want = np.concatenate([np.asarray(c) for c in pair[
        "jtps"].synthesize_incremental(TEXTS[0], denoiser_strength=0.07,
                                       denoiser_kwargs=DKW, **kw)])
    got = np.concatenate(list(ttps.synthesize_incremental(
        TEXTS[0], denoiser_strength=0.07, denoiser_kwargs=DKW,
        keep_masks=jax_keep_masks(pair["taco"], pair["tvars"], 0, LIMIT, 1),
        noise=jax_chunk_noise(0), **kw)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=JAX_AUDIO)


def _rows(stream) -> dict:
    rows: dict = {}
    for r, ch in stream:
        rows.setdefault(r, []).append(ch)
    return rows


def test_synthesize_incremental_batch_matches_jax_and_the_synthesizer(pair):
    kw = dict(sigma=SIGMA, seed=0, chunk_steps=CHUNK)
    want = _rows(pair["jtps"].synthesize_incremental_batch(TEXTS[:2], **kw))
    got = _rows(pair["ttps"].synthesize_incremental_batch(
        TEXTS[:2], keep_masks=jax_keep_masks(pair["taco"], pair["tvars"], 0,
                                             LIMIT, 2),
        noise=jax_chunk_noise(0), **kw))
    ref = _rows(pair["tsyn"].synthesize_incremental_batch(TEXTS[:2], **kw))
    mine = _rows(pair["ttps"].synthesize_incremental_batch(TEXTS[:2], **kw))
    for r in range(2):
        assert [len(c) for c in got[r]] == [len(np.asarray(c))
                                            for c in want[r]]
        np.testing.assert_allclose(
            np.concatenate(got[r]),
            np.concatenate([np.asarray(c) for c in want[r]]),
            atol=JAX_AUDIO, err_msg=f"row {r}")
        np.testing.assert_allclose(np.concatenate(mine[r]),
                                   np.concatenate(ref[r]), atol=PORT,
                                   err_msg=f"row {r}")


def test_placement_arguments_and_the_default_type(pair):
    """One of ``n_model``, ``group`` and ``mesh``; f32 on the CPU, bf16 on
    a GPU; one decoder and one vocoder per batch placement."""
    tsyn = pair["tsyn"]
    with pytest.raises(ValueError, match="one of"):
        TPSynthesizer(HP, tsyn.taco, WG, tsyn.waveglow)
    with pytest.raises(ValueError, match="one of"):
        TPSynthesizer(HP, tsyn.taco, WG, tsyn.waveglow, n_model=2,
                      group=object())
    ttps = pair["ttps"]
    assert ttps.compute_dtype == torch.float32
    assert ttps.lockstep_groups == []
    dec, voc = ttps._endpoints(2)
    assert ttps._endpoints(2) == (dec, voc)
    assert dec.n_model == voc.n_model == 2 and dec.ranks == [0, 1]
    assert ttps._endpoints(1)[1] is voc         # no data axis: one placement


def test_bf16_compute_dtype_runs(pair):
    """bf16, the default on a GPU, through the whole chain on the CPU's
    plain versions: finite audio of the contract's length, near f32."""
    tsyn = pair["tsyn"]
    tps = TPSynthesizer(HP, tsyn.taco, WG, tsyn.waveglow, n_model=2,
                        chunk_steps=CHUNK, compute_dtype=torch.bfloat16)
    dec, _ = tps._endpoints(1)
    assert dec.dtype == torch.bfloat16
    wav = tps.synthesize([TEXTS[0]], sigma=SIGMA, seed=0)[0]
    assert wav.shape == (REQUESTED * HOP,) and np.isfinite(wav).all()
    ref = pair["ttps"].synthesize([TEXTS[0]], sigma=SIGMA, seed=0)[0]
    assert np.linalg.norm(wav - ref) / np.linalg.norm(ref) < 0.5


def test_int8_tracks_fp(pair, monkeypatch):
    """``int8=True`` with the int8 decoder engaged at this tiny batch:
    within the JAX package's band of floating point on the shared prefix
    (mean error over mean magnitude under 0.5,
    ``tests/test_tp_serve.py:90-124``)."""
    monkeypatch.setattr(
        "text2speech_tpu_torch.models.tacotron_serve.INT8_DECODE_MIN_BATCH",
        1)
    tsyn = pair["tsyn"]
    tps = TPSynthesizer(HP, tsyn.taco, WG, tsyn.waveglow, n_model=2,
                        chunk_steps=CHUNK, int8=True)
    dec, voc = tps._endpoints(2)
    assert dec.int8 and voc.int8
    wav_q = tps.synthesize(TEXTS[:2], sigma=SIGMA, seed=0)
    wav_fp = pair["ttps"].synthesize(TEXTS[:2], sigma=SIGMA, seed=0)
    for a, b in zip(wav_q, wav_fp):
        assert np.isfinite(a).all()
        n = min(len(a), len(b))
        assert n > 0
        err = np.abs(a[:n] - b[:n]).mean() / (np.abs(b[:n]).mean() + 1e-6)
        assert 0 < err < 0.5, err


# --- the server ---------------------------------------------------------------


def test_server_tp_matches_jax_and_make_server(pair):
    """Three sessions through two slots (the third joins a recycled slot):
    against the JAX ``make_server_tp`` handed its masks and noise blocks
    (2e-3, ``tests/test_server.py:418-420``), the same scheduling stats,
    and against the port's ``make_server`` with its own draws."""
    taco, tvars, ttps = pair["taco"], pair["tvars"], pair["ttps"]
    seeds = [7, 8, 9]
    jsrv = jax_make_server_tp(pair["jtps"], slots=2, **SRV_KW)
    want = jsrv.run(TEXTS[:3], seeds=seeds)
    tsrv = make_server_tp(ttps, slots=2, key_fn=jax_key_fn(taco, tvars),
                          noise_fn=jax_noise_fn, **SRV_KW)
    got = tsrv.run(TEXTS[:3], seeds=seeds)
    for key in ("rounds", "admitted", "completed", "row_steps",
                "active_row_steps", "postnet_calls", "vocoder_calls",
                "emitted_samples"):
        assert tsrv.stats[key] == jsrv.stats[key], key
    for sid in want:
        assert got[sid].shape == want[sid].shape == (REQUESTED * HOP,)
        np.testing.assert_allclose(got[sid], want[sid], atol=JAX_AUDIO,
                                   err_msg=f"sid {sid}")
    mine = make_server_tp(ttps, slots=2, **SRV_KW).run(TEXTS[:3],
                                                       seeds=seeds)
    ref = make_server(pair["tsyn"], slots=2, **SRV_KW).run(TEXTS[:3],
                                                           seeds=seeds)
    for sid in ref:
        np.testing.assert_allclose(mine[sid], ref[sid], atol=PORT)


def test_server_tp_per_request_denoiser(pair):
    """``use_denoiser=True`` serves per-request strengths: a raw session
    is the raw server's, a denoised one the offline denoiser over it."""
    ttps = pair["ttps"]

    def srv():
        return make_server_tp(ttps, slots=2, use_denoiser=True,
                              denoiser_kwargs=DKW, **SRV_KW)

    seeds = [7, 8]
    wavs = srv().run(TEXTS[:2], seeds=seeds, denoiser_strengths=[0.0, 0.08])
    raw = srv().run(TEXTS[:2], seeds=seeds)
    np.testing.assert_array_equal(wavs[0], raw[0])
    _, denoise = make_denoiser(ttps.waveglow, **DKW)
    ref = denoise(torch.from_numpy(raw[1][None]), 0.08)[0].numpy()
    np.testing.assert_allclose(wavs[1], ref, atol=2e-6, rtol=2e-5)
    with pytest.raises(ValueError, match="without a denoiser"):
        make_server_tp(ttps, slots=2, **SRV_KW).submit(
            TEXTS[0], denoiser_strength=0.1)


def test_server_tp_denoiser_configs_coexist(pair):
    """The server's denoiser and the same synthesizer's streaming denoiser
    with another STFT size at once: the biases are cached per
    configuration, so each keeps its own."""
    ttps = pair["ttps"]
    dkw_stream = dict(filter_length=32, n_overlap=4, win_length=32,
                      n_frames=8)
    srv = make_server_tp(ttps, slots=2, use_denoiser=True,
                         denoiser_kwargs=DKW, **SRV_KW)
    stream = np.concatenate(list(ttps.synthesize_incremental(
        TEXTS[0], sigma=SIGMA, seed=3, chunk_steps=CHUNK,
        denoiser_strength=0.05, denoiser_kwargs=dkw_stream)))
    assert stream.size > 0 and np.isfinite(stream).all()
    assert len(ttps._denoise_biases) >= 2
    wavs = srv.run([TEXTS[0]], seeds=[7], denoiser_strengths=[0.05])
    raw = make_server_tp(ttps, slots=1, **SRV_KW).run([TEXTS[0]], seeds=[7])
    _, denoise = make_denoiser(ttps.waveglow, **DKW)
    ref = denoise(torch.from_numpy(raw[0][None]), 0.05)[0].numpy()
    np.testing.assert_allclose(wavs[0], ref, atol=2e-6, rtol=2e-5)


def test_http_over_the_tp_server(pair):
    """The HTTP front end serves ``make_server_tp`` (two shards in this
    process): the client's PCM is the direct run's, byte for byte."""
    import http.client

    ttps = pair["ttps"]
    httpd, runner = make_http_server(make_server_tp(ttps, slots=2, **SRV_KW),
                                     port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection(
            "127.0.0.1", httpd.server_address[1], timeout=120)
        conn.request("POST", "/synthesize",
                     body=json.dumps({"text": TEXTS[0], "seed": 11}))
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        assert resp.status == 200
        ref = make_server_tp(ttps, slots=2, **SRV_KW).run(
            [TEXTS[0]], seeds=[11])[0]
        header = wav_stream_header(WG.sampling_rate)
        assert body[:len(header)] == header
        assert body[len(header):] == float_to_pcm16(ref)
    finally:
        httpd.shutdown()
        httpd.server_close()
        runner.shutdown()
        thread.join(timeout=30)


# --- the four ranks -----------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(workers):
    """The ranks' results and the one-process references on the same
    seeded weights."""
    tmp, procs = workers
    synth = random_synthesizer(HP, WG, seed=0, device="cpu",
                               use_fused_vocoder=False, use_denoiser=False)

    def tps(n):
        return TPSynthesizer(HP, synth.taco, WG, synth.waveglow, n_model=n,
                             chunk_steps=CHUNK)

    ref = {"server": make_server_tp(tps(2), slots=2, **SRV_KW).run(
        TEXTS[:3], seeds=WORKER_SEEDS),
        "flat": tps(4).synthesize(TEXTS[:2], sigma=SIGMA, seed=3)}
    with torch.no_grad():
        synth.taco.decoder.gate_proj.bias.fill_(10.0)
    short = tps(2)
    ref["short_rows"] = {r: np.concatenate(c) for r, c in _rows(
        short.synthesize_incremental_batch(TEXTS[:2], sigma=SIGMA,
                                           seed=3)).items()}
    ref["b1"] = np.concatenate(list(short.synthesize_incremental(
        TEXTS[0], sigma=SIGMA, seed=3)))
    logs = []
    for pr in procs:
        out, _ = pr.communicate(timeout=150)
        logs.append(out)
    assert [pr.returncode for pr in procs] == [0] * 4, "\n".join(logs)
    return [torch.load(tmp / f"out{r}.pt", weights_only=False)
            for r in range(4)], ref


def test_lockstep_server_over_two_ranks_equals_one_process(ranks):
    """Each data line's model group of two runs the batcher in lockstep:
    every session bit-equal to the one-process two-shard server (at p = 2
    the sum over ranks is a + b = b + a, the column gather adds zeros)."""
    res, ref = ranks
    for r in range(4):
        assert res[r]["groups"] == 1
        assert sorted(res[r]["server"]) == [0, 1, 2]
        for sid, wav in ref["server"].items():
            np.testing.assert_array_equal(res[r]["server"][sid], wav)


def test_lockstep_disagreement_raises_on_every_rank(ranks):
    res, _ = ranks
    for r in range(4):
        msg = res[r]["disagree"]
        assert msg is not None and "out of lockstep" in msg, (r, msg)
        assert "slots [0]" in msg


def test_server_on_a_data_by_model_grid(ranks):
    """Slots split over the data axis: the decode rows and the window
    vocodes a data rank's own, gathered; every rank returns every
    session, within float tolerance of the one-process server (a rank's
    products run on its row block)."""
    res, ref = ranks
    for r in range(4):
        assert res[r]["grid_groups"] == 2
        for sid, wav in ref["server"].items():
            np.testing.assert_allclose(res[r]["grid_server"][sid], wav,
                                       atol=PORT)


def test_model_only_mesh_has_no_data_axis(ranks):
    """A mesh of four model ranks and no data axis: the one-process
    four-shard synthesis (the sum over four ranks in gloo's order)."""
    res, ref = ranks
    for r in range(4):
        for got, want in zip(res[r]["flat"], ref["flat"]):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=PORT)


def test_short_rows_and_batch_one_streams_on_the_grid(ranks):
    """Gates biased on: every row is shorter than one vocoder window, so
    the batch stream's exact passes (batch 1) and the batch-1 stream go to
    the model-only endpoints beside the data-sharded ones."""
    res, ref = ranks
    ov = receptive_overlap_frames(WG)
    for r in range(4):
        assert res[r]["short_endpoints"] == [False, True]
        for row, want in ref["short_rows"].items():
            assert want.size <= (CHUNK + 2 * ov) * HOP
            np.testing.assert_allclose(res[r]["short_rows"][row], want,
                                       atol=PORT)
        np.testing.assert_allclose(res[r]["b1"], ref["b1"], atol=PORT)
