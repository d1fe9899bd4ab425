"""The port's HTTP front end (``text2speech_tpu_torch.http_serve``): the wire
contract of ``tests/test_http_serve.py``.

* the stream header and the PCM conversion are the JAX module's, byte for
  byte;
* the PCM a client receives equals the int16 conversion of the same
  ``(text, seed)`` session run directly through a ``ContinuousBatcher`` of
  the same slot count (same batch shapes, so the same floats: the
  transport adds nothing and drops nothing);
* simultaneous POSTs stream independent sessions through one slot batch;
* invalid input is a 400 at submission, a full queue or a dead scheduler a
  503; a disconnect cancels the session; a scheduler that dies mid-stream
  ABORTS open responses without the chunked terminator; ``/reload`` runs
  on the scheduler thread and honours its token."""

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from text2speech_tpu import http_serve as jax_http
from text2speech_tpu_torch.config import HParams, WaveGlowConfig
from text2speech_tpu_torch.http_serve import (float_to_pcm16,
                                              make_http_server,
                                              wav_stream_header)
from text2speech_tpu_torch.infer import random_synthesizer
from text2speech_tpu_torch.server import make_server

torch.set_num_threads(1)

HP = HParams(
    sample_rate=22050, embedding_size=16, enc_conv_num_layers=1,
    enc_conv_channels=16, attention_rnn_dim=16, decoder_rnn_dim=16,
    attention_dim=8, attention_location_n_filters=4,
    attention_location_kernel_size=7, prenet_dim=8, n_mel_channels=8,
    postnet_embedding_dim=8, postnet_n_convolutions=2, max_decoder_steps=44)
WG = WaveGlowConfig(
    n_mel_channels=8, n_flows=2, n_group=8, n_early_every=4, n_early_size=2,
    wn_n_layers=2, wn_n_channels=16, upsample_kernel=64, upsample_stride=16,
    sampling_rate=22050, hop_length=16)
DEN_KW = dict(filter_length=64, n_overlap=4, win_length=64, n_frames=12)
SIGMA = 0.8
TEXTS = ["안녕하세요.", "존경하는 사람과 함께 갑니다.", "네."]
SRV_KW = dict(chunk_steps=8, max_text_len=80, sigma=SIGMA)
HEADER = wav_stream_header(22050)


def make_synth(seed=0, **kw):
    return random_synthesizer(HP, WG, seed=seed, device="cpu",
                              use_fused_vocoder=False,
                              denoiser_kwargs=DEN_KW, **kw)


@pytest.fixture(scope="module")
def synth():
    return make_synth(use_denoiser=False)


def serve(batcher, **kw):
    httpd, runner = make_http_server(batcher, port=0, **kw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, runner, thread


def stop(httpd, runner, thread):
    httpd.shutdown()
    httpd.server_close()
    runner.shutdown()
    thread.join(timeout=30)
    assert not thread.is_alive() and not runner.alive


@pytest.fixture(scope="module")
def http_srv(synth):
    served = serve(make_server(synth, slots=2, **SRV_KW), max_pending=4)
    yield served[0].server_address[1], served[1]
    stop(*served)


def solo_pcm(synth, text, seed, **run_kw):
    """Reference bytes: the same (text, seed) through a direct batcher of
    the same slot count."""
    srv = make_server(synth, slots=2, **SRV_KW)
    return float_to_pcm16(srv.run([text], seeds=[seed], **run_kw)[0])


def post(port, payload, path="/synthesize", headers=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    body = payload if isinstance(payload, bytes) else json.dumps(payload)
    conn.request("POST", path, body=body, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp, data


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


# --- the wire format ---------------------------------------------------------


@pytest.mark.parametrize("args", [(22050,), (16000, 2), (8000, 1, 8)])
def test_stream_header_is_the_jax_modules(args):
    got = wav_stream_header(*args)
    assert got == jax_http.wav_stream_header(*args)
    assert len(got) == 44 and got[:4] == b"RIFF" and got[8:12] == b"WAVE"
    assert got[4:8] == got[40:44] == b"\xff\xff\xff\xff"


def test_pcm16_conversion_is_the_jax_modules():
    x = np.array([0.0, 1.0, -1.0, 2.0, -2.0, 0.5], np.float32)
    out = np.frombuffer(float_to_pcm16(x), "<i2")
    np.testing.assert_array_equal(
        out, np.array([0, 32767, -32767, 32767, -32767, 16383], np.int16))
    y = np.random.RandomState(0).randn(4096).astype(np.float32)
    assert float_to_pcm16(y) == jax_http.float_to_pcm16(y)
    assert float_to_pcm16(torch.from_numpy(y).numpy()[:0]) == b""


# --- serving -------------------------------------------------------------------


def test_stream_matches_direct_run(synth, http_srv):
    port, _ = http_srv
    resp, body = post(port, {"text": TEXTS[0], "seed": 11})
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "audio/wav"
    assert resp.getheader("Transfer-Encoding") == "chunked"
    assert int(resp.getheader("X-Session-Id")) >= 0
    assert body[:44] == HEADER
    assert body[44:] == solo_pcm(synth, TEXTS[0], 11)
    assert len(body) - 44 == 44 * WG.upsample_stride * 2


def test_concurrent_sessions(synth, http_srv):
    port, _ = http_srv
    results = {}

    def worker(i):
        results[i] = post(port, {"text": TEXTS[i], "seed": 100 + i})[1][44:]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for i in range(3):
        assert results[i] == solo_pcm(synth, TEXTS[i], 100 + i), i


def test_per_request_sigma_and_denoiser():
    syn = make_synth(use_denoiser=True)
    served = serve(make_server(syn, slots=2, **SRV_KW))
    try:
        port = served[0].server_address[1]
        resp, body = post(port, {"text": TEXTS[2], "seed": 5, "sigma": 0.4})
        assert resp.status == 200
        assert body[44:] == solo_pcm(syn, TEXTS[2], 5, sigmas=[0.4])
        assert body[44:] != solo_pcm(syn, TEXTS[2], 5)
        resp, body = post(port, {"text": TEXTS[0], "seed": 9,
                                 "denoiser_strength": 0.05})
        assert resp.status == 200
        assert body[44:] == solo_pcm(syn, TEXTS[0], 9,
                                     denoiser_strengths=[0.05])
    finally:
        stop(*served)


def test_invalid_input_is_400(http_srv):
    port, runner = http_srv
    for payload, word in (
            ({"text": TEXTS[2], "denoiser_strength": 0.1}, b"denoiser"),
            ({"text": "아주 " * 200 + "긴 문장입니다."}, b"max_text_len"),
            ({"text": TEXTS[2], "seed": "abc"}, b"seed"),
            ({"text": TEXTS[2], "sigma": "hot"}, b"sigma"),
            ({"text": TEXTS[2], "speaker_id": 1}, b"single-speaker"),
            ({"seed": 1}, b"bad request"),
            (b"not json", b"bad request"), (b"[1, 2]", b"bad request"),
            (b"123", b"bad request")):
        resp, body = post(port, payload)
        assert resp.status == 400 and word in body, (payload, body)
    assert post(port, b"{}", path="/nope")[0].status == 404
    assert get(port, "/nope")[0] == 404
    assert post(port, b"{}", path="/reload")[0].status == 404  # no reload_fn
    assert runner.alive and get(port, "/healthz") == (200, {"ok": True})


def test_stats_and_health(http_srv):
    port, _ = http_srv
    post(port, {"text": TEXTS[2], "seed": 3})
    status, stats = get(port, "/stats")
    assert status == 200
    assert stats["slots"] == 2 and stats["completed"] >= 1
    assert stats["open_streams"] == 0 and stats["queued"] == 0
    assert stats["active_slots"] == 0 and "error" not in stats
    # the windowed vocoder's frames run against the frames it kept
    assert stats["frames_vocoded"] >= stats["frames_emitted"] > 0


def test_disconnect_cancels(synth, http_srv):
    """Closing the connection mid-stream frees the session's slot."""
    port, runner = http_srv
    cancelled = runner.stats()["cancelled"]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/synthesize",
                 body=json.dumps({"text": TEXTS[1], "seed": 7}))
    resp = conn.getresponse()
    assert resp.status == 200
    resp.read(46)                  # the header and the first bytes arrived
    conn.close()                   # hang up mid-stream
    # the server keeps serving: a fresh request still matches its solo run
    resp2, body2 = post(port, {"text": TEXTS[2], "seed": 8})
    assert resp2.status == 200
    assert body2[44:] == solo_pcm(synth, TEXTS[2], 8)
    deadline = time.monotonic() + 30
    while (runner.stats()["active_slots"] or runner.stats()["open_streams"]) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    st = runner.stats()
    assert st["active_slots"] == 0 and st["open_streams"] == 0
    # cancelled, unless the short session had already completed
    assert st["cancelled"] + st["completed"] > cancelled


def test_full_queue_is_503(synth):
    served = serve(make_server(synth, slots=1, **SRV_KW), max_pending=0)
    try:
        resp, body = post(served[0].server_address[1], {"text": TEXTS[2]})
        assert resp.status == 503 and b"queue full" in body
    finally:
        stop(*served)


def test_dead_scheduler_aborts_streams_and_answers_503(synth):
    """``step()`` raises in its third round: the open response is aborted
    WITHOUT the chunked terminator (the client sees a transfer error, never
    a complete WAV that is silently short), ``/healthz`` flips to 503 and a
    new request gets 503."""
    batcher = make_server(synth, slots=1, **SRV_KW)
    inner, rounds = batcher.step, []

    def failing_step():
        rounds.append(1)
        if len(rounds) == 3:
            raise RuntimeError("device fault (injected)")
        return inner()

    batcher.step = failing_step
    httpd, runner, thread = serve(batcher)
    try:
        port = httpd.server_address[1]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/synthesize",
                     body=json.dumps({"text": TEXTS[0], "seed": 1}))
        resp = conn.getresponse()
        assert resp.status == 200
        with pytest.raises(http.client.IncompleteRead) as err:
            resp.read()
        assert err.value.partial[:44] == HEADER
        conn.close()
        thread_gone = time.monotonic() + 30
        while runner.alive and time.monotonic() < thread_gone:
            time.sleep(0.05)
        assert not runner.alive
        assert isinstance(runner.error, RuntimeError)
        status, body = get(port, "/healthz")
        assert status == 503 and body == {"ok": False}
        assert "error" in get(port, "/stats")[1]
        resp, body = post(port, {"text": TEXTS[2]})
        assert resp.status == 503 and b"shut down" in body
    finally:
        httpd.shutdown()
        httpd.server_close()
        runner.shutdown()
        thread.join(timeout=30)


def test_reload_swaps_weights_on_the_scheduler_thread():
    """``POST /reload`` runs ``reload_fn(**body)`` between two rounds on the
    scheduler thread; the same (text, seed) then reproduces a direct run
    over the NEW weights.  A token, when set, is required."""
    syn = make_synth(seed=0, use_denoiser=False)
    new = make_synth(seed=1, use_denoiser=False)
    called_on = []

    def reload_fn(which):
        called_on.append(threading.current_thread().name)
        if which != "new":
            raise ValueError(f"unknown weights {which!r}")
        syn.taco.load_state_dict(new.taco.state_dict())
        syn.waveglow.load_state_dict(new.waveglow.state_dict())

    served = serve(make_server(syn, slots=2, **SRV_KW), reload_fn=reload_fn,
                   reload_token="s3cret")
    try:
        port = served[0].server_address[1]
        before = post(port, {"text": TEXTS[0], "seed": 9})[1]
        ok = {"X-Reload-Token": "s3cret"}
        assert post(port, {"which": "new"}, "/reload")[0].status == 403
        assert post(port, {"which": "new"}, "/reload",
                    {"X-Reload-Token": "nope"})[0].status == 403
        assert called_on == []
        assert post(port, {"nope": 1}, "/reload", ok)[0].status == 400
        assert post(port, {"which": "old"}, "/reload", ok)[0].status == 400
        assert post(port, b"[1]", "/reload", ok)[0].status == 400
        resp, body = post(port, {"which": "new"}, "/reload", ok)
        assert resp.status == 200 and json.loads(body) == {"ok": True}
        assert called_on == ["tts-scheduler"] * 2
        after = post(port, {"text": TEXTS[0], "seed": 9})[1]
        assert after != before                     # the weights are live
        assert after[44:] == solo_pcm(new, TEXTS[0], 9)
    finally:
        stop(*served)
