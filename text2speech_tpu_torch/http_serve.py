"""HTTP streaming front end of the continuous-batching TTS server (the
port's own copy of ``text2speech_tpu/http_serve.py``: standard library and
numpy only, the wire format byte for byte).

* **One scheduler thread owns the batcher and the CUDA device.**  Every
  kernel launch, admission (``submit``) and cancellation happens on that
  thread; HTTP handler threads talk to it only through queues
  (``ContinuousBatcher`` is not thread-safe, and two threads launching on
  one device would serialize anyway).  While sessions are active the thread
  runs ``step()`` back to back: each round is one batched decode, postnet
  and vocode, so the device stays busy; when idle it parks on an event
  until the next submission.
* **Chunked-transfer WAV streaming.**  ``POST /synthesize`` answers with
  ``Transfer-Encoding: chunked`` ``audio/wav``: a RIFF header whose sizes
  are the unknown-length placeholder (players read 0xFFFFFFFF as "until
  EOF", the convention for live WAV streams), then one chunk per
  :class:`.server.StreamEvent` as int16 PCM.  The first audio reaches the
  client after a few chunks of decoder steps, not after the whole
  utterance.
* **Disconnect == cancel.**  A client that closes its connection mid-stream
  frees its session's slot for the next queued request (any OSError on a
  chunk write enqueues a cancel to the scheduler thread).
* **Truncation is detectable.**  If the scheduler dies mid-stream, open
  responses are ABORTED without the chunked terminator (clients see a
  transfer error, never a "complete" WAV that is silently short);
  ``/healthz`` flips to 503 and new requests get 503.
* **Admission control.**  Invalid texts, seeds and sigmas are rejected with
  400 at submit time (``ContinuousBatcher.submit`` validates before it
  queues); a full queue returns 503, so load is shed at the edge instead
  of growing an unbounded backlog.

Endpoints::

    POST /synthesize   {"text": "...", "seed": 123?, "sigma": 0.6?,
                        "denoiser_strength": 0.01?, "speaker_id": 0?}
                       -> chunked audio/wav; X-Session-Id response header
    POST /reload       {"taco_ckpt_dir": ...?, "wg_ckpt_dir": ...?} (or
                       "taco_npz" in place of "taco_ckpt_dir")
                       live weight swap through the configured reload_fn
                       (``Synthesizer.load_checkpoints``), run between two
                       rounds; guarded by X-Reload-Token when a token is set
    GET  /stats        scheduler counters and live queue and slot occupancy
                       (frames_vocoded / frames_emitted: the windowed
                       vocoder's frames run per frame kept)
    GET  /healthz      200 while the scheduler thread is alive

The int16 conversion is the CLI's wav write: clip to [-1, 1], scale by
32767.
"""

from __future__ import annotations

import json
import queue
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

# stream-queue sentinel: scheduler died / server shut down with the stream
# open — the handler must ABORT (no chunked terminator), unlike the normal
# end-of-session None
_ABORT = object()


def wav_stream_header(sample_rate: int, channels: int = 1,
                      bits: int = 16) -> bytes:
    """RIFF/WAVE header for a stream of unknown length: RIFF and data chunk
    sizes are the 0xFFFFFFFF placeholder, which players read as
    "until EOF" (the live-streaming WAV convention)."""
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    return b"".join([
        b"RIFF", struct.pack("<I", 0xFFFFFFFF), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                             byte_rate, block_align, bits),
        b"data", struct.pack("<I", 0xFFFFFFFF),
    ])


def float_to_pcm16(wav) -> bytes:
    """[-1, 1] float audio -> little-endian int16 PCM bytes (clip, then
    scale by 32767)."""
    import numpy as np

    x = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    return (x * 32767.0).astype("<i2").tobytes()


class ServerRunner:
    """Owns a :class:`.server.ContinuousBatcher` on a dedicated scheduler
    thread (the only thread that touches the device); thread-safe
    ``open_stream`` / ``cancel`` / ``call`` for handler
    threads.

    ``open_stream(text, seed, sigma)`` returns ``(sid, q)`` where ``q``
    yields ``np.ndarray`` audio chunks, then ``None`` on normal completion
    or the abort sentinel if the scheduler died.  The call blocks only for
    admission-queue handoff (one scheduler-loop iteration), not for
    synthesis."""

    def __init__(self, batcher, *, max_pending: int | None = None):
        self._srv = batcher
        self.max_pending = max_pending
        self._inbox: queue.Queue = queue.Queue()
        self._streams: dict[int, queue.Queue] = {}
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._lock = threading.Lock()          # guards _streams + _pending
        self._pending = 0                      # submits in flight to inbox
        self.error: BaseException | None = None
        self._thread = threading.Thread(
            target=self._loop, name="tts-scheduler", daemon=True)
        self._thread.start()

    # --- handler-thread API -------------------------------------------------

    def _rpc(self, kind: str, payload):
        """Hand a message to the scheduler thread and wait for its reply
        (polling so a scheduler death can't strand the caller)."""
        if self._stop.is_set():
            raise RuntimeError("server is shut down")
        reply: queue.Queue = queue.Queue()
        self._inbox.put((kind, payload, None, reply))
        self._wake.set()
        while True:
            try:
                k, val = reply.get(timeout=1.0)
                break
            except queue.Empty:
                if self._stop.is_set():     # scheduler died under us
                    raise RuntimeError("server is shut down") from self.error
        if k == "error":
            raise val
        return val

    def open_stream(self, text: str, seed: int | None = None,
                    sigma: float | None = None,
                    denoiser_strength: float | None = None):
        if self.max_pending is not None:
            # count submits still in the inbox too, or a concurrent burst
            # of handler threads bypasses the load shed
            with self._lock:
                if (self._srv.queued_count + self._pending
                        >= self.max_pending):
                    raise OverflowError(
                        f"admission queue full ({self.max_pending} pending)")
                self._pending += 1
        # the scheduler replies with the stream queue object itself — the
        # session may complete (and be deregistered) before this thread
        # runs again
        return self._rpc("submit", (text, seed, sigma, denoiser_strength))

    def cancel(self, sid: int) -> None:
        self._inbox.put(("cancel", sid, None, None))
        self._wake.set()

    def call(self, fn):
        """Run ``fn()`` ON the scheduler thread (between rounds) and return
        its result — the admin path for operations that touch the batcher
        or the synthesizer (e.g. a live checkpoint swap)."""
        return self._rpc("call", fn)

    def stats(self) -> dict:
        """Monitoring snapshot (counters are ints mutated on the scheduler
        thread; a torn read is at worst one round stale)."""
        d = dict(self._srv.stats)
        d["active_slots"] = self._srv.active_count
        d["slots"] = self._srv.slots
        d["queued"] = self._srv.queued_count
        d["open_streams"] = len(self._streams)
        if self.error is not None:
            d["error"] = repr(self.error)
        return d

    @property
    def alive(self) -> bool:
        return self._thread.is_alive() and not self._stop.is_set()

    def shutdown(self, join: bool = True) -> None:
        self._stop.set()
        self._wake.set()
        if join:
            self._thread.join(timeout=30)

    # --- scheduler thread ----------------------------------------------------

    def _drain_inbox(self) -> None:
        while True:
            try:
                msg = self._inbox.get_nowait()
            except queue.Empty:
                return
            kind, a, _b, reply = msg
            if kind == "submit":
                sid = err = None
                # queue mutation and the _pending decrement happen under
                # ONE lock acquisition, so open_stream's load-shed check
                # never sees the same request counted twice
                with self._lock:
                    try:
                        sid = self._srv.submit(*a)
                    except Exception as e:      # validation -> caller
                        err = e
                    finally:
                        if self.max_pending is not None:
                            self._pending -= 1
                if err is not None:
                    reply.put(("error", err))
                    continue
                q: queue.Queue = queue.Queue()
                with self._lock:
                    self._streams[sid] = q
                reply.put(("ok", (sid, q)))
            elif kind == "cancel":
                self._srv.cancel(a)
                with self._lock:
                    q = self._streams.pop(a, None)
                if q is not None:
                    q.put(None)
            elif kind == "call":
                try:
                    reply.put(("ok", a()))
                except Exception as e:
                    reply.put(("error", e))

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                self._drain_inbox()
                if self._srv.idle:
                    self._wake.wait(timeout=0.25)
                    self._wake.clear()
                    continue
                for ev in self._srv.step():
                    with self._lock:
                        q = self._streams.get(ev.sid)
                    if q is None:               # cancelled / disconnected
                        continue
                    if ev.final:
                        q.put(None)
                        with self._lock:
                            self._streams.pop(ev.sid, None)
                    elif ev.audio is not None:
                        q.put(ev.audio)
        except BaseException as e:
            # a step() failure (device fault, scheduler bug) must not
            # strand blocked readers — record it, shut down, unblock
            self.error = e
            import traceback
            traceback.print_exc()
        finally:
            self._stop.set()
            # fail any submits/calls still in the inbox
            while True:
                try:
                    msg = self._inbox.get_nowait()
                except queue.Empty:
                    break
                if msg[0] in ("submit", "call") and msg[3] is not None:
                    msg[3].put(("error",
                                RuntimeError("server is shut down")))
            # ABORT (not cleanly end) streams still open: their audio is
            # incomplete, and a clean chunked terminator would make the
            # truncation invisible to clients
            with self._lock:
                for q in self._streams.values():
                    q.put(_ABORT)
                self._streams.clear()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # set by make_http_server:
    runner: ServerRunner
    sample_rate: int
    reload_fn = None
    reload_token: str | None = None
    log_requests = False

    def log_message(self, fmt, *args):          # quiet by default
        if self.log_requests:
            super().log_message(fmt, *args)

    # --- helpers -------------------------------------------------------------

    def _send_json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")

    def _read_json_object(self):
        n = int(self.headers.get("Content-Length", "0"))
        req = json.loads(self.rfile.read(n) or b"{}")
        if not isinstance(req, dict):
            raise ValueError(f"body must be a JSON object, "
                             f"got {type(req).__name__}")
        return req

    # --- endpoints -----------------------------------------------------------

    def do_GET(self):
        if self.path == "/healthz":
            self._send_json(
                200 if self.runner.alive else 503,
                {"ok": self.runner.alive})
        elif self.path == "/stats":
            self._send_json(200, self.runner.stats())
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path == "/reload":
            self._do_reload()
            return
        if self.path != "/synthesize":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        try:
            req = self._read_json_object()
            text = req["text"]
            seed = req.get("seed")
            sigma = req.get("sigma")
            denoiser_strength = req.get("denoiser_strength")
            speaker = req.get("speaker_id")
            if speaker is not None:
                # multi-speaker voice selection rides inside the request
                # (validated at submit; bad ids are 400s)
                text = (text, speaker)
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(400, {"error": f"bad request: {e!r}"})
            return
        try:
            sid, q = self.runner.open_stream(text, seed, sigma,
                                             denoiser_strength)
        except OverflowError as e:              # queue full
            self._send_json(503, {"error": str(e)})
            return
        except RuntimeError as e:               # scheduler down, not caller
            self._send_json(503, {"error": str(e)})
            return
        except Exception as e:                  # validation (overlong text…)
            self._send_json(400, {"error": str(e)})
            return

        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("X-Session-Id", str(sid))
        self.end_headers()
        try:
            self._write_chunk(wav_stream_header(self.sample_rate))
            while True:
                chunk = q.get()
                if chunk is None:               # clean end of session
                    break
                if chunk is _ABORT:             # scheduler died: abort the
                    self.close_connection = True  # transfer, NO terminator —
                    return                      # truncation stays visible
                self._write_chunk(float_to_pcm16(chunk))
            self.wfile.write(b"0\r\n\r\n")
        except OSError:                         # any disconnect flavor
            self.runner.cancel(sid)             # free the slot now
            self.close_connection = True

    def _do_reload(self):
        """Live weight swap: runs ``reload_fn(**body)`` on the scheduler
        thread, between two rounds; the next round serves the new weights
        (sessions in flight see them mid-utterance: drain first if that
        matters)."""
        if self.reload_fn is None:
            self._send_json(404, {"error": "no reload_fn configured"})
            return
        if (self.reload_token is not None
                and self.headers.get("X-Reload-Token") != self.reload_token):
            self._send_json(403, {"error": "bad or missing X-Reload-Token"})
            return
        try:
            req = self._read_json_object()
        except (ValueError, TypeError) as e:
            self._send_json(400, {"error": f"bad request: {e!r}"})
            return
        try:
            self.runner.call(lambda: self.reload_fn(**req))
        except RuntimeError as e:               # scheduler down
            self._send_json(503, {"error": str(e)})
            return
        except (TypeError, ValueError, FileNotFoundError) as e:
            self._send_json(400, {"error": str(e)})
            return
        except Exception as e:
            self._send_json(500, {"error": repr(e)})
            return
        self._send_json(200, {"ok": True})


def make_http_server(batcher, *, host: str = "127.0.0.1", port: int = 0,
                     sample_rate: int = 22050,
                     max_pending: int | None = 128,
                     reload_fn=None, reload_token: str | None = None,
                     log_requests: bool = False):
    """Wrap a :class:`.server.ContinuousBatcher` (``server.make_server``)
    in a threaded HTTP server.  Returns ``(httpd, runner)``; call
    ``httpd.serve_forever()`` (blocking) and on teardown ``httpd.shutdown();
    runner.shutdown()``.  ``port=0`` binds an ephemeral port
    (``httpd.server_address[1]``).  ``reload_fn(**body)`` (optional) enables
    ``POST /reload``; it runs on the scheduler thread, for example
    ``Synthesizer.load_checkpoints`` for a live weight swap; set
    ``reload_token`` to require the X-Reload-Token header on that (admin)
    endpoint when binding beyond localhost."""
    runner = ServerRunner(batcher, max_pending=max_pending)
    handler = type("Handler", (_Handler,), {
        "runner": runner,
        "sample_rate": sample_rate,
        "reload_fn": staticmethod(reload_fn) if reload_fn else None,
        "reload_token": reload_token,
        "log_requests": log_requests,
    })
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    return httpd, runner
