"""Continuous-batching streaming TTS server (counterpart of
``text2speech_tpu/server.py``).

The autoregressive Tacotron decode is bound by its per-step launches and
weight reads, not by the batch: extra rows in the batched decode are nearly
free.  So the server keeps ONE fixed-shape ``slots``-row decode batch
running and admits queued sessions into freed slots mid-flight (continuous
batching, as LLM serving engines schedule, applied to TTS):

* **Session independence.**  Decode runs with PER-ROW prenet keep-masks, so
  a session's mel depends only on its own ``(text, seed)``, never on the
  slot it landed in, the round it joined or its neighbours.  The vocoder's
  noise is a per-session block stream, position-consistent across windows:
  a session's concatenated audio equals a single-pass vocode of its final
  mel with its own noise to float tolerance (the invariant of
  ``infer.incremental_vocode_stream_batch``).
* **Per-slot frontiers.**  Every slot carries its own decode, postnet and
  vocode frontiers, so sessions at different progress share one batch.  A
  slot frees as soon as its session's audio is flushed; the next queued
  request is admitted at the start of the following round.
* **Tensors stay on the device.**  The slot batch is a dict of device
  tensors and admission is an index assignment into slot ``i``; a session's
  mel, postnet output, noise and denoise buffer are device tensors.  One
  host read per round (each row's active-frame count and stop flag) drives
  the bookkeeping, which is host integers; audio crosses to the host only
  as the numpy array of a :class:`StreamEvent`.

One ``step()`` round:

1. admit queued sessions into free slots;
2. one batched decode of ``chunk_steps`` frames for ALL slots (free slots
   decode garbage: they ride the same launches);
3. the postnet over fixed-width windows (``chunk + 2 prf`` frames) of each
   advancing slot, batched into one call;
4. the vocoder over fixed-width receptive-field windows (``chunk + 2 ov``
   frames; ``chunk + ov`` when every window of the round starts its
   session) of each slot's postnet output with its own noise, batched into
   one call; an early-gate slot flushes without waiting for anyone; a
   session shorter than one window vocodes its exact length in one pass;
5. the windowed denoiser over the raw audio of sessions that asked for it;
6. one ``StreamEvent(sid, audio)`` per ready chunk, and a final event when a
   session completes.

Stages 1-5 and the host read are spans of ``utils/profiling.py``
(``serve.admit``, ``serve.decode``, ``serve.read``, ``serve.postnet``,
``serve.vocode``, ``serve.denoise``); ``stats["frames_vocoded"]`` and
``stats["frames_emitted"]`` count the frames the vocoder ran and the
frames it kept.

The window rules (start pinning, bounding by the true length, zero fill
only where it is the conv's padding) are the streaming engine's: see
``infer.incremental_vocode_stream_batch``.

Randomness.  ``key_fn(seed)`` returns a session's prenet keep-masks for its
whole decode, bool ``[limit, 2, prenet_dim]``; ``noise_fn(seed)`` returns
the session's block drawer ``draw(j) -> tuple of [chunk * gpf, width]``
standard-normal tensors, block ``j`` depending on ``(seed, j)`` only.
:func:`make_server`'s defaults: the masks are those ``Synthesizer.
text_to_mel([text], seed)`` draws for that one utterance (fixed blocks from
a generator seeded ``seed``, so they do not depend on ``max_steps`` either);
the noise blocks come in order from one generator seeded ``seed + 1``, each
``chunk_steps`` frames long.  Both are injectable, so a
test can hand in the draws of another package.  Whatever the functions, a
session's audio is a function of ``(request, seed, sigma,
denoiser_strength)`` alone.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .utils.profiling import annotate


@dataclass
class StreamEvent:
    """One server emission: an audio chunk (float32 numpy) for session
    ``sid``, or, with ``audio=None, final=True``, the session-complete
    marker."""

    sid: int
    audio: np.ndarray | None
    final: bool = False


@dataclass
class _Session:
    sid: int
    slot: int
    masks: torch.Tensor         # [limit, 2, prenet_dim] keep-masks
    draw_noise: object          # block index -> tuple of [cs * gpf, width]
    sigma: float = 0.666        # per-session flow temperature
    den_strength: float = 0.0   # per-session denoiser strength (0 = off)
    # decode-side frontiers
    t: int = 0                  # decoded frames
    out_len: int = 0            # active frames within the contract
    gate_fired: bool = False
    cap: int = 0                # min(t, requested): real decoded frames
    mel_final: bool = False
    # postnet-side
    mel_parts: list = field(default_factory=list)    # raw decode chunks
    post_parts: list = field(default_factory=list)   # postnet output
    emitted: int = 0            # postnet frames emitted
    # vocoder-side
    E: int = 0                  # frames vocoded and emitted
    flushed: bool = False
    noise_parts: list = field(default_factory=list)  # per component
    noise_blocks: int = 0
    noise_frames: int = 0
    # denoiser-side (only when den_strength > 0: raw vocoder audio waits in
    # a bounded DenoiseBuffer and the denoise stage emits with fewer than
    # n_fft samples of hold-back)
    den_buf: object = None
    den_emitted: int = 0
    # accounting
    admit_round: int = 0        # stats["rounds"] when admitted
    first_emit_round: int | None = None
    emitted_samples: int = 0

    @staticmethod
    def _cat(parts: list, dim: int) -> torch.Tensor:
        if len(parts) > 1:
            parts[:] = [torch.cat(parts, dim=dim)]
        return parts[0]

    def mel_cat(self) -> torch.Tensor:
        return self._cat(self.mel_parts, -1)

    def post_cat(self) -> torch.Tensor:
        return self._cat(self.post_parts, -1)


def _place(batch: dict, row: dict, slot: int) -> None:
    """Admission: write a session's row into slot ``slot`` of every batch
    tensor (a value may be a tuple of tensors, as the decoder state is)."""
    for name, value in row.items():
        if isinstance(value, tuple):
            for dst, src in zip(batch[name], value):
                dst[slot] = src
        else:
            batch[name][slot] = value


class ContinuousBatcher:
    """Slot scheduler over injected device callables (pure scheduling here;
    :func:`make_server` wires it to a :class:`..infer.Synthesizer`).  Not
    thread-safe: one thread owns it (``http_serve.ServerRunner``'s).

    Callables:

    * ``admit_fn(request, seed) -> row`` : one session's batch row, a dict
      of tensors (or tuples of tensors) without the slot axis;
    * ``validate_fn(request) -> canonical | None`` (optional): raises on an
      invalid request at ``submit`` time; a non-None return replaces the
      request (the encoded text, say) before it reaches ``admit_fn``;
    * ``init_batch_fn() -> batch``: the ``slots``-row dict, same keys;
    * ``decode_fn(batch, keep_masks [chunk, 2, slots, prenet_dim]) ->
      (batch, mel [slots, n_mel, chunk], active bool [slots, chunk],
      finished bool [slots])``;
    * ``postnet_fn(wins [slots, n_mel, chunk + 2 prf]) -> residual`` (same
      shape; output mel = window + residual);
    * ``vocode_fn(mel [B, n_mel, W], noise_tuple, sigma) -> [B, W * hop]``:
      the scheduler pre-scales each row's noise by its session's sigma and
      always passes ``sigma=1.0`` (sigma enters the flows only as ``sigma *
      noise``, so this is exact and keeps mixed-sigma rounds in ONE call);
    * ``vocode_masked_fn(mel, noise, sigma, length)`` (optional): the exact
      pass of a session shorter than one window as ONE call at the fixed
      window width; without it that pass runs at the session's exact length
      through ``vocode_exact_fn`` (default ``vocode_fn``);
    * ``key_fn(seed)``, ``noise_fn(seed)``: the session's randomness, see
      the module docstring;
    * ``denoiser``: a ``models.denoiser.StreamingDenoiser`` or None."""

    def __init__(self, *, slots: int, chunk_steps: int, requested: int,
                 prf: int, ov: int, n_mel: int, gpf: int, hop: int,
                 noise_widths: tuple, sigma: float, device,
                 admit_fn, init_batch_fn, decode_fn, postnet_fn, vocode_fn,
                 key_fn, noise_fn, vocode_exact_fn=None,
                 vocode_masked_fn=None, validate_fn=None,
                 retain_sessions: bool = False, denoiser=None):
        if chunk_steps < prf:
            raise ValueError(
                "chunk_steps must cover the postnet receptive field "
                f"({chunk_steps} < {prf}) so that the emission frontier "
                "advances every round")
        self.slots = slots
        self.cs = chunk_steps
        self.requested = requested
        self.limit = -(-requested // chunk_steps) * chunk_steps
        self.prf = prf
        self.ov = ov
        self.n_mel = n_mel
        self.gpf = gpf
        self.hop = hop
        self.noise_widths = tuple(noise_widths)
        self.sigma = sigma
        self.device = torch.device(device)
        self.Wp = chunk_steps + 2 * prf     # postnet window, frames
        self.Wv = chunk_steps + 2 * ov      # vocoder window, frames
        self.Wv1 = chunk_steps + ov         # first-window width (ws = 0)

        self._admit_fn = admit_fn
        self._decode_fn = decode_fn
        self._postnet_fn = postnet_fn
        self._vocode_fn = vocode_fn
        self._vocode_exact_fn = vocode_exact_fn or vocode_fn
        self._vocode_masked_fn = vocode_masked_fn
        self._key_fn = key_fn
        self._noise_fn = noise_fn
        self._validate_fn = validate_fn
        self._denoiser = denoiser

        self._batch = init_batch_fn()
        self._queue: deque = deque()
        self._slots: list = [None] * slots
        self._next_sid = 0
        self._retain = retain_sessions
        # completed sessions are dropped unless retain_sessions (their mel
        # and noise buffers are utterance-sized; a long-lived server must
        # not keep them); tests retain them to check the invariants
        self.sessions: dict = {}
        self.stats = {"rounds": 0, "row_steps": 0, "active_row_steps": 0,
                      "postnet_calls": 0, "vocoder_calls": 0,
                      "denoiser_calls": 0,
                      "admitted": 0, "completed": 0, "cancelled": 0,
                      "first_audio_rounds_sum": 0, "emitted_samples": 0,
                      # frames the vocoder ran (window widths) and the
                      # frames of those windows it kept: their ratio is
                      # the windowed vocoder's work per kept frame
                      "frames_vocoded": 0, "frames_emitted": 0}

    # --- public API --------------------------------------------------------

    def submit(self, request, seed: int | None = None,
               sigma: float | None = None,
               denoiser_strength: float | None = None) -> int:
        """Queue a synthesis request; returns its session id.  ``seed``
        defaults to the session id; ``sigma`` (flow sampling temperature)
        to the server's; ``denoiser_strength`` > 0 streams bias-subtracted
        audio equal to the offline denoiser over the session's raw audio.
        EVERY invalid input (overlong text, malformed seed, sigma or
        strength) raises HERE, at submission, never inside :meth:`step`,
        which must stay up for the other sessions.  If ``validate_fn``
        returns non-None, that canonical form is what ``admit_fn`` later
        receives: validation work is not redone at admission."""
        if seed is not None:
            if isinstance(seed, bool) or not isinstance(
                    seed, (int, np.integer)):
                raise ValueError(f"seed must be an int, got {type(seed)}")
            if not 0 <= seed < 2**31 - 1:
                raise ValueError(f"seed out of range [0, 2**31-1): {seed}")
            seed = int(seed)
        if sigma is not None:
            if isinstance(sigma, bool) or not isinstance(
                    sigma, (int, float, np.floating, np.integer)):
                raise ValueError(f"sigma must be a number, got {type(sigma)}")
            sigma = float(sigma)
            if not np.isfinite(sigma) or sigma < 0:
                raise ValueError(f"sigma must be finite and >= 0: {sigma}")
        if denoiser_strength is not None:
            if isinstance(denoiser_strength, bool) or not isinstance(
                    denoiser_strength, (int, float, np.floating, np.integer)):
                raise ValueError("denoiser_strength must be a number, got "
                                 f"{type(denoiser_strength)}")
            denoiser_strength = float(denoiser_strength)
            if not np.isfinite(denoiser_strength) or denoiser_strength < 0:
                raise ValueError("denoiser_strength must be finite and "
                                 f">= 0: {denoiser_strength}")
            if denoiser_strength > 0 and self._denoiser is None:
                raise ValueError(
                    "denoiser_strength > 0 but the server was built without "
                    "a denoiser (make_server over a Synthesizer with "
                    "use_denoiser=False)")
        if self._validate_fn is not None:
            canonical = self._validate_fn(request)
            if canonical is not None:
                request = canonical
        sid = self._next_sid
        self._next_sid += 1
        self._queue.append((sid, request, sid if seed is None else seed,
                            self.sigma if sigma is None else sigma,
                            denoiser_strength or 0.0))
        return sid

    def cancel(self, sid: int) -> bool:
        """Cancel a session: drop it from the queue, or free its slot at
        once (the row decodes garbage until the next admission).  Returns
        whether anything was cancelled; no further events are emitted for
        the session."""
        for item in self._queue:
            if item[0] == sid:
                self._queue.remove(item)
                self.stats["cancelled"] += 1
                return True
        for slot, s in enumerate(self._slots):
            if s is not None and s.sid == sid:
                self._slots[slot] = None
                if not self._retain:
                    self.sessions.pop(sid, None)
                self.stats["cancelled"] += 1
                return True
        return False

    @property
    def idle(self) -> bool:
        return not self._queue and all(s is None for s in self._slots)

    @property
    def active_count(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def queued_count(self) -> int:
        return len(self._queue)

    @torch.inference_mode()
    def step(self) -> list:
        """One scheduling round: admit, decode one chunk for every slot,
        emit every audio chunk that became ready.  Returns the round's
        events (possibly none while a session's pipeline fills)."""
        with annotate("serve.admit"):
            self._admit()
        live = [s for s in self._slots if s is not None]
        if not live:
            return []
        self.stats["rounds"] += 1
        self.stats["row_steps"] += self.slots * self.cs
        self.stats["active_row_steps"] += len(live) * self.cs

        # --- decode one chunk for all slots (per-row masks) ----------------
        with annotate("serve.decode"):
            d_pre = live[0].masks.shape[-1]
            masks = torch.zeros((self.cs, 2, self.slots, d_pre),
                                dtype=torch.bool, device=self.device)
            for s in live:
                masks[:, :, s.slot] = s.masks[s.t: s.t + self.cs]
            self._batch, mel_c, active, finished = self._decode_fn(
                self._batch, masks)
        # the round's one host read: per-row active counts within the
        # contract of each row, and the stop flags
        with annotate("serve.read"):
            counts = torch.zeros((self.slots,), dtype=torch.long,
                                 device=active.device)
            for s in live:
                n = max(0, min(self.cs, self.requested - s.t))
                counts[s.slot] = active[s.slot, :n].sum()
            read = torch.cat([counts, finished.long()]).cpu().numpy()

        post_tasks: list = []
        for s in live:
            r = s.slot
            s.mel_parts.append(mel_c[r].to(torch.float32))
            s.t += self.cs
            s.out_len += int(read[r])
            s.gate_fired = bool(read[self.slots + r])
            s.cap = min(s.t, self.requested)
            if not s.mel_final:
                # all valid frames can be emitted once the decode frontier
                # covers the last valid frame's postnet context (or the
                # contract ends: context past ``requested`` is the conv's
                # zero padding in the whole-utterance path too)
                ctx_end = min(s.out_len + self.prf, self.requested)
                s.mel_final = s.t >= self.limit or (
                    s.gate_fired and s.cap >= ctx_end)
            tl = min(s.out_len, self.requested)
            upto = (max(s.emitted, tl) if s.mel_final
                    else max(s.emitted, s.cap - self.prf))
            if upto > s.emitted:
                post_tasks.append((s, max(0, s.emitted - self.prf),
                                   s.emitted, upto))

        if post_tasks:
            with annotate("serve.postnet"):
                self._run_postnet(post_tasks)

        # --- vocoder windows over the advanced postnet frontiers ----------
        events: list = []
        voc_tasks: list = []
        shorts: list = []
        for s in live:
            if s.flushed:
                continue
            tl = min(s.out_len, s.emitted, self.requested)
            while not s.mel_final and tl >= s.E + self.cs + self.ov:
                voc_tasks.append((s, max(s.E - self.ov, 0), s.E,
                                  s.E + self.cs, tl))
                s.E += self.cs
            if s.mel_final:
                # the postnet has emitted >= tl frames by construction of
                # ``upto``.  A session no longer than one window flushes
                # through the EXACT-length pass, even after mid-stream
                # emissions: a fixed window would zero-fill [tl, Wv) in
                # the tensor, which is NOT conv padding to the flows and
                # corrupts the last ~ov frames
                if tl <= self.Wv:
                    if tl > s.E:
                        shorts.append((s, s.E, tl))
                        s.E = tl
                else:
                    while s.E < tl:
                        kt = min(s.E + self.cs, tl)
                        ws = max(0, min(s.E - self.ov, tl - self.Wv))
                        voc_tasks.append((s, ws, s.E, kt, tl))
                        s.E = kt
                s.flushed = True

        with annotate("serve.vocode"):
            for s, chunk in self._run_vocoder(voc_tasks):
                self._emit(events, s, chunk)
            for s, e0, tl in shorts:
                self._emit(events, s,
                           self._vocode_short(s, tl)[e0 * self.hop:])

        with annotate("serve.denoise"):
            self._run_denoise(live, events)

        # --- free completed slots ------------------------------------------
        for s in live:
            if s.flushed and s.mel_final:
                events.append(StreamEvent(s.sid, None, final=True))
                self.stats["completed"] += 1
                if s.first_emit_round is not None:
                    self.stats["first_audio_rounds_sum"] += (
                        s.first_emit_round - s.admit_round)
                self._slots[s.slot] = None
                if not self._retain:
                    self.sessions.pop(s.sid, None)
        return events

    def run(self, requests, seeds=None, sigmas=None,
            denoiser_strengths=None) -> dict:
        """Convenience loop: submit everything, step until idle, return
        ``{sid: concatenated audio}`` (streaming callers use :meth:`step`
        directly)."""
        sids = [self.submit(r, None if seeds is None else seeds[i],
                            None if sigmas is None else sigmas[i],
                            None if denoiser_strengths is None
                            else denoiser_strengths[i])
                for i, r in enumerate(requests)]
        parts: dict = {sid: [] for sid in sids}
        while not self.idle:
            for ev in self.step():
                if ev.audio is not None:
                    parts[ev.sid].append(ev.audio)
        return {sid: (np.concatenate(chunks) if chunks
                      else np.zeros((0,), np.float32))
                for sid, chunks in parts.items()}

    # --- internals ----------------------------------------------------------

    def _emit(self, events, s: _Session, chunk: torch.Tensor):
        """Emit a raw vocoder chunk or, for a denoising session, buffer it
        for the windowed denoise stage."""
        self.stats["frames_emitted"] += chunk.shape[-1] // self.hop
        if s.den_strength > 0.0:
            if s.den_buf is None:
                from .models.denoiser import DenoiseBuffer

                s.den_buf = DenoiseBuffer(self._denoiser)
            s.den_buf.append(chunk)
            return
        self._post_event(events, s, chunk)

    def _post_event(self, events, s: _Session, chunk: torch.Tensor):
        audio = chunk.detach().to("cpu", torch.float32).numpy()
        events.append(StreamEvent(s.sid, audio))
        s.emitted_samples += audio.size
        self.stats["emitted_samples"] += audio.size
        if s.first_emit_round is None:
            # decode rounds from this session's admission to its first
            # audio: the streaming latency capacity planners read off stats
            s.first_emit_round = self.stats["rounds"]

    def _run_denoise(self, live, events):
        """Batched windowed denoise (``models.denoiser.denoise_windows``)
        advancing every denoising session's emit frontier as far as its
        buffered raw audio allows; per-row strengths keep mixed-strength
        rounds in ONE call.  The emitted samples equal the offline denoise
        of the session's whole raw audio."""
        den = self._denoiser
        if den is None:
            return
        tasks: list = []   # (session, window, n_valid, e0, e1, f0)
        for s in live:
            if s.den_strength <= 0.0 or s.den_buf is None:
                continue
            for f0, nv, e0, e1 in den.plan(
                    s.den_buf.total, s.den_emitted, s.flushed):
                tasks.append(
                    (s, s.den_buf.window(f0, nv, s.flushed), nv, e0, e1, f0))
        B = self.slots
        pad, dhop = den.pad, den.params.hop_length
        for g0 in range(0, len(tasks), B):
            group = tasks[g0: g0 + B]
            rows = group + [group[0]] * (B - len(group))
            x = torch.zeros((B, den.l_pad), device=self.device)
            corr = torch.ones((B, den.l_pad))
            nval = [t[2] for t in rows]
            stren = [t[0].den_strength for t in rows]
            for j, (_s, win, nv, _e0, _e1, _f0) in enumerate(rows):
                den.fill_row(x[j], corr[j], win, nv)
            out = den(x, stren, nval, corr)
            self.stats["denoiser_calls"] += 1
            for j, (s, _win, _nv, e0, e1, f0) in enumerate(group):
                s.den_emitted = e1
                s.den_buf.trim(e1)
                self._post_event(
                    events, s,
                    out[j, e0 + pad - f0 * dhop: e1 + pad - f0 * dhop])

    def _admit(self):
        for slot in range(self.slots):
            if self._slots[slot] is not None or not self._queue:
                continue
            sid, request, seed, sigma, den_strength = self._queue.popleft()
            _place(self._batch, self._admit_fn(request, seed), slot)
            s = _Session(
                sid=sid, slot=slot,
                masks=torch.as_tensor(self._key_fn(seed)).to(self.device),
                draw_noise=self._noise_fn(seed), sigma=sigma,
                den_strength=den_strength, admit_round=self.stats["rounds"])
            if s.masks.shape[0] < self.limit:
                raise ValueError(f"key_fn gave {s.masks.shape[0]} steps of "
                                 f"keep-masks, a session decodes {self.limit}")
            self._slots[slot] = s
            self.sessions[sid] = s
            self.stats["admitted"] += 1

    def _run_postnet(self, tasks):
        """Batched postnet over fixed-width windows; a window holds real
        decoded frames on ``[ws, min(ws + Wp, cap))`` and zero beyond,
        exactly the conv padding the whole-sequence postnet sees (frames
        past ``cap`` either do not exist yet and lie outside every emitted
        frame's receptive field, or lie past ``requested``, where the
        whole-utterance path pads with zeros)."""
        B = self.slots
        for g0 in range(0, len(tasks), B):
            group = tasks[g0: g0 + B]
            rows = group + [group[0]] * (B - len(group))
            wins = torch.zeros((B, self.n_mel, self.Wp), device=self.device)
            for j, (s, ws, _kf, _kt) in enumerate(rows):
                e = min(ws + self.Wp, s.cap)
                wins[j, :, : e - ws] = s.mel_cat()[:, ws:e]
            out = wins + self._postnet_fn(wins).to(torch.float32)
            self.stats["postnet_calls"] += 1
            for j, (s, ws, kf, kt) in enumerate(group):
                s.post_parts.append(out[j, :, kf - ws: kt - ws].clone())
                s.emitted = kt

    def _sess_noise(self, s: _Session, frames: int) -> list:
        """The session's noise components covering ``frames`` mel frames,
        extended block by block so that any window slices the same
        position-consistent stream."""
        while s.noise_frames < frames:
            block = s.draw_noise(s.noise_blocks)
            block = [torch.as_tensor(c, dtype=torch.float32).to(self.device)
                     for c in block]
            if not s.noise_parts:
                s.noise_parts = [[c] for c in block]
            else:
                for parts, c in zip(s.noise_parts, block):
                    parts.append(c)
            s.noise_blocks += 1
            s.noise_frames += self.cs
        return [s._cat(parts, 0) for parts in s.noise_parts]

    def _run_vocoder(self, tasks):
        """Batched vocode over fixed receptive-field windows of each slot's
        postnet output with its own noise stream, by the lockstep engine's
        pinning rules (a window's real content is bounded by the row's true
        length, its start clamps to 0, flush windows stay inside the
        utterance).

        First-window fast path: a round whose windows are ALL pinned at
        their session's start (``ws = 0``, ``kt <= chunk``) runs at width
        ``Wv1 = chunk + ov``: the trailing ``ov`` frames of the fixed
        ``Wv`` window lie outside every emitted sample's receptive field.
        Mixed rounds (a join sharing a round with mid-stream windows) stay
        at ``Wv``, so they still batch into the fewest calls."""
        if not tasks:
            return
        width = (self.Wv1
                 if all(t[1] == 0 and t[3] <= self.cs for t in tasks)
                 else self.Wv)
        B = self.slots
        for g0 in range(0, len(tasks), B):
            group = tasks[g0: g0 + B]
            rows = group + [group[0]] * (B - len(group))
            wmel = torch.zeros((B, self.n_mel, width), device=self.device)
            wnoise = [torch.zeros((B, width * self.gpf, w),
                                  device=self.device)
                      for w in self.noise_widths]
            for j, (s, ws, _kf, _kt, fl) in enumerate(rows):
                lo, e = max(ws, 0), min(ws + width, fl)
                wmel[j, :, lo - ws: e - ws] = s.post_cat()[:, lo:e]
                comps = self._sess_noise(s, e)
                # sigma enters the flows ONLY as sigma * noise: scale the
                # row's noise here and vocode at sigma = 1
                for z, comp in zip(wnoise, comps):
                    z[j, (lo - ws) * self.gpf: (e - ws) * self.gpf] = (
                        s.sigma * comp[lo * self.gpf: e * self.gpf])
            audio = self._vocode_fn(wmel, tuple(wnoise), 1.0)
            self.stats["vocoder_calls"] += 1
            self.stats["frames_vocoded"] += width * len(group)
            for j, (s, ws, kf, kt, _fl) in enumerate(group):
                yield s, audio[j, (kf - ws) * self.hop: (kt - ws) * self.hop]

    @torch.inference_mode()
    def warm_window_widths(self) -> None:
        """One throwaway full-batch vocode at each of the two window widths
        (``Wv1`` and ``Wv``): builds the vocoder's kernels if they are not
        built yet and pays the libraries' first-call costs at both shapes,
        so that neither lands inside :meth:`step` on the first real
        request.  (A warm-up session whose text gates early only ever runs
        ``Wv1`` rounds.)"""
        for width in sorted({self.Wv1, self.Wv}):
            wmel = torch.zeros((self.slots, self.n_mel, width),
                               device=self.device)
            nz = tuple(torch.zeros((self.slots, width * self.gpf, w),
                                   device=self.device)
                       for w in self.noise_widths)
            self._vocode_fn(wmel, nz, 1.0)

    @torch.inference_mode()
    def warm_short_pass(self) -> None:
        """One throwaway call of the masked exact pass, where there is one
        (the plain vocoder).  The fused and int8 vocoders vocode a short
        session at its exact length, with the true length a runtime
        argument of the kernels: there is nothing per length to warm, and
        this is a no-op."""
        if self._vocode_masked_fn is None:
            return
        wmel = torch.zeros((1, self.n_mel, self.Wv), device=self.device)
        nz = tuple(torch.zeros((1, self.Wv * self.gpf, w),
                               device=self.device)
                   for w in self.noise_widths)
        self._vocode_masked_fn(wmel, nz, 1.0, 1)

    def _vocode_short(self, s: _Session, tl: int) -> torch.Tensor:
        """A session shorter than one window vocodes its exact length in
        one pass (zero-filling the window's tail is NOT conv padding to the
        flows: zero noise gives bias-driven hidden values that would leak
        back into the valid frames)."""
        post = s.post_cat()[:, :tl]
        comps = self._sess_noise(s, tl)
        self.stats["vocoder_calls"] += 1
        self.stats["frames_vocoded"] += (tl if self._vocode_masked_fn is None
                                         else self.Wv)
        if self._vocode_masked_fn is not None:
            # pad to the fixed width Wv and pass the true length: one call
            # shape covers every short length
            wmel = torch.zeros((1, self.n_mel, self.Wv), device=self.device)
            wmel[0, :, :tl] = post
            nz = []
            for c, w in zip(comps, self.noise_widths):
                z = torch.zeros((1, self.Wv * self.gpf, w),
                                device=self.device)
                z[0, : tl * self.gpf] = s.sigma * c[: tl * self.gpf]
                nz.append(z)
            audio = self._vocode_masked_fn(wmel, tuple(nz), 1.0, tl)
        else:
            nz = tuple((s.sigma * c[None, : tl * self.gpf]).contiguous()
                       for c in comps)
            audio = self._vocode_exact_fn(post[None].contiguous(), nz, 1.0)
        return audio[0, : tl * self.hop]


def _tts_batcher(taco, cfg, dev, *, slots: int, chunk_steps: int,
                 max_text_len: int, max_steps: int | None, sigma: float,
                 retain_sessions: bool, key_fn, noise_fn,
                 **device_fns) -> ContinuousBatcher:
    """A :class:`ContinuousBatcher` over a Tacotron-2 ``taco`` and a
    vocoder of configuration ``cfg`` on ``dev``: the sizes, the request
    validation (a text, or ``(text, speaker_id)`` on a multi-speaker
    model; longer than ``max_text_len`` symbols is rejected at ``submit``),
    the postnet and the default draws that :func:`make_server` and
    :func:`make_server_tp` share.  ``device_fns``: the batcher's
    ``admit_fn``, ``init_batch_fn``, ``decode_fn``, ``vocode_fn``, its
    optional exact or masked pass and ``denoiser``."""
    from .infer import speaker_ids_array
    from .models.chunked import (draw_noise, noise_schedule,
                                 receptive_overlap_frames)
    from .text import encode_batch

    hp = taco.hp
    requested = max_steps or hp.max_decoder_steps
    gpf = cfg.upsample_stride // cfg.n_group
    limit = -(-requested // chunk_steps) * chunk_steps

    def validate_fn(request):
        text, speaker = (request if isinstance(request, tuple)
                         else (request, None))
        ids_np, lens_np = encode_batch([text])
        if ids_np.shape[1] > max_text_len:
            raise ValueError(
                f"text encodes to {ids_np.shape[1]} symbols > server "
                f"max_text_len={max_text_len}")
        sid = speaker_ids_array(speaker, 1, taco.num_speakers)
        return ids_np, lens_np, sid     # canonical: encoded once, at submit

    def default_key_fn(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return taco.decoder.draw_keep_masks(limit, 1, gen, dev)[:, :, 0]

    def default_noise_fn(seed):
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        return lambda j: tuple(
            c[0] for c in draw_noise(cfg, gen, 1, chunk_steps * gpf))

    return ContinuousBatcher(
        slots=slots, chunk_steps=chunk_steps, requested=requested,
        prf=(hp.postnet_kernel_size // 2) * hp.postnet_n_convolutions,
        ov=receptive_overlap_frames(cfg), n_mel=hp.n_mel_channels, gpf=gpf,
        hop=cfg.upsample_stride, noise_widths=tuple(noise_schedule(cfg)),
        sigma=sigma, device=dev,
        postnet_fn=lambda wins: taco.postnet_residual(wins),
        key_fn=key_fn or default_key_fn,
        noise_fn=noise_fn or default_noise_fn,
        validate_fn=validate_fn, retain_sessions=retain_sessions,
        **device_fns)


def _encode_request(taco, request, max_text_len: int, dev):
    """A validated request -> (memory [1, max_text_len, E], lengths [1]),
    the text zero-padded to the server's encoder width."""
    ids_np, lens_np, sid = request
    ids = np.zeros((1, max_text_len), np.int64)
    ids[:, : ids_np.shape[1]] = ids_np
    lengths = torch.from_numpy(np.asarray(lens_np)).long().to(dev)
    mem = taco.encode(
        torch.from_numpy(ids).to(dev),
        speaker_ids=(None if sid is None
                     else torch.from_numpy(sid).long().to(dev)),
        text_lengths=lengths)
    return mem, lengths


def make_server(synth, *, slots: int = 8, chunk_steps: int = 64,
                max_text_len: int = 256, max_steps: int | None = None,
                sigma: float = 0.666, retain_sessions: bool = False,
                key_fn=None, noise_fn=None) -> ContinuousBatcher:
    """Build a :class:`ContinuousBatcher` over a :class:`..infer.
    Synthesizer` (the decode, postnet and vocoder of the lockstep streaming
    path; honours the synthesizer's ``quantized_decode`` and its plain,
    fused or int8 vocoder).

    ``max_text_len`` is the encoder width every session pads to; a longer
    text is rejected at ``submit``.  The weights are read through ``synth``
    at CALL time, so ``Synthesizer.load_weights`` takes effect on the next
    round; sessions in flight see the new weights mid-utterance, so drain
    first if that matters.  ``key_fn`` / ``noise_fn`` replace the default
    draws (module docstring)."""
    from .models.tacotron2 import DecoderState
    from .models.tacotron_serve import (decode_chunk_serve,
                                        int8_decode_worthwhile)

    hp, cfg, dev = synth.hp, synth.wg_cfg, synth.device
    # the server's decode batch IS the slot count: int8 decoder weights
    # serve only where the measured threshold says they pay
    quantized = synth.quantized_decode and int8_decode_worthwhile(slots)

    def init_batch_fn():
        dt = synth.taco.embedding.weight.dtype
        memory = torch.zeros((slots, max_text_len, hp.enc_conv_channels),
                             dtype=dt, device=dev)
        state, frame, finished = synth.taco.decoder.initial_carry(memory)
        batch = {"memory": memory,
                 "lengths": torch.ones((slots,), dtype=torch.long,
                                       device=dev),
                 "state": tuple(state), "frame": frame,
                 "finished": finished}
        if quantized:
            with torch.no_grad():
                batch["pmem"] = synth.taco.process_memory(memory)
        return batch

    def admit_fn(request, seed):
        mem, lengths = _encode_request(synth.taco, request, max_text_len,
                                       dev)
        state, frame, finished = synth.taco.decoder.initial_carry(mem)
        row = {"memory": mem[0], "lengths": lengths[0],
               "state": tuple(t[0] for t in state), "frame": frame[0],
               "finished": finished[0]}
        if quantized:
            row["pmem"] = synth.taco.process_memory(mem)[0]
        return row

    def decode_fn(batch, masks):
        state = DecoderState(*batch["state"])
        if quantized:
            carry, mel_c, _, _, active = decode_chunk_serve(
                synth._dp_q, hp, batch["memory"], batch["pmem"], state,
                batch["frame"], batch["finished"], masks, batch["lengths"],
                dtype=batch["memory"].dtype)
        else:
            carry, mel_c, _, _, active = synth.taco.decode_chunk(
                batch["memory"], state, batch["frame"], batch["finished"],
                masks, batch["lengths"])
        new = dict(batch)
        new["state"], new["frame"], new["finished"] = (
            tuple(carry[0]), carry[1], carry[2])
        return new, mel_c, active, carry[2]

    denoiser = None
    if getattr(synth, "_denoise_bias", None) is not None:
        from .models.denoiser import serving_denoiser

        # the bias is read through the synthesizer at every call, so a
        # weight swap replaces it too
        denoiser = serving_denoiser(
            lambda: synth._denoise_bias, synth._denoise_params,
            chunk_steps, cfg.upsample_stride)

    return _tts_batcher(
        synth.taco, cfg, dev, slots=slots, chunk_steps=chunk_steps,
        max_text_len=max_text_len, max_steps=max_steps, sigma=sigma,
        retain_sessions=retain_sessions, key_fn=key_fn, noise_fn=noise_fn,
        admit_fn=admit_fn, init_batch_fn=init_batch_fn, decode_fn=decode_fn,
        vocode_fn=lambda mel, nz, sg: synth._vocode_window(mel, nz, sg),
        vocode_masked_fn=synth._masked_vocode_handle(), denoiser=denoiser)


def _lockstep_check(groups: list, finished: torch.Tensor,
                    masks: torch.Tensor) -> None:
    """Raise unless every rank of ``groups`` holds the same stop flags and
    keep-masks this round.  One ``all_reduce`` (MAX) a group of each slot's
    flag and a checksum of its masks, beside their negations: the ranks
    agree exactly when the maximum equals the minimum, and every rank
    reads the same maximum and minimum, so either all ranks raise or none
    does (none is left waiting in the next collective)."""
    import torch.distributed as dist

    w = torch.arange(1, masks[:, :, 0].numel() + 1, device=masks.device,
                     dtype=torch.long).reshape(masks.shape[0], 2, 1, -1)
    sums = (masks.long() * w).sum(dim=(0, 1, 3))
    v = torch.cat([finished.long(), sums])
    both = torch.cat([v, -v])
    for g in groups:
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=g)
    hi, neg_lo = both.chunk(2)
    if not torch.equal(hi, -neg_lo):
        n = finished.shape[0]
        odd = sorted({i % n for i in torch.nonzero(hi != -neg_lo)
                      .flatten().tolist()})
        raise RuntimeError(
            f"tensor-parallel server ranks out of lockstep: slots {odd} "
            f"differ in their stop flags or keep-masks (every rank must "
            f"submit the same requests with the same seeds and step "
            f"together)")


def make_server_tp(tps, *, slots: int = 8, chunk_steps: int = 64,
                   max_text_len: int = 256, max_steps: int | None = None,
                   sigma: float = 0.666, retain_sessions: bool = False,
                   use_denoiser: bool = False,
                   denoiser_kwargs: dict | None = None, key_fn=None,
                   noise_fn=None) -> ContinuousBatcher:
    """Continuous batching over a :class:`..parallel.serve.TPSynthesizer`
    (``server.py:892 make_server_tp``): :func:`make_server`'s scheduler,
    with each round's decode through the tensor-parallel decoder of
    ``tps._endpoints(slots)`` (each slot's own keep-masks) and the window
    vocodes through its vocoder; a session shorter than one window
    vocodes its exact length through ``tps._endpoints(1)``'s.  A session's
    audio matches :func:`make_server`'s for the same ``(text, seed)`` to
    float tolerance.  ``key_fn`` / ``noise_fn``: as :func:`make_server`.

    Under a process group every rank runs this batcher in lockstep: the
    same ``submit`` calls with the same seeds, and ``step`` (or ``run``) on
    every rank.  The scheduler branches on each slot's stop flag, a device
    value that identical kernels on gathered inputs make equal on every
    rank; each round checks that it is (:func:`_lockstep_check`) and raises
    on every rank when the ranks disagree.  A rank that stops stepping
    while another steps is not detected: the others wait in the decode's
    collective until the process group's timeout."""
    from .models.tacotron2 import DecoderState

    hp, cfg, dev, taco = tps.hp, tps.wg_cfg, tps.device, tps.taco
    decoder, vocoder = tps._endpoints(slots)
    _, vocoder1 = tps._endpoints(1)
    groups = tps.lockstep_groups

    def init_batch_fn():
        dt = taco.embedding.weight.dtype
        memory = torch.zeros((slots, max_text_len, hp.enc_conv_channels),
                             dtype=dt, device=dev)
        state, frame, finished = decoder.initial_carry(memory)
        with torch.no_grad():
            pmem = taco.process_memory(memory)
        return {"memory": memory, "pmem": pmem,
                "lengths": torch.ones((slots,), dtype=torch.long,
                                      device=dev),
                "state": tuple(state), "frame": frame, "finished": finished}

    def admit_fn(request, seed):
        mem, lengths = _encode_request(taco, request, max_text_len, dev)
        state, frame, finished = decoder.initial_carry(mem)
        return {"memory": mem[0], "pmem": taco.process_memory(mem)[0],
                "lengths": lengths[0], "state": tuple(t[0] for t in state),
                "frame": frame[0], "finished": finished[0]}

    def decode_fn(batch, masks):
        carry, mel_c, _, _, active = decoder(
            batch["memory"], batch["pmem"], DecoderState(*batch["state"]),
            batch["frame"], batch["finished"], masks, batch["lengths"])
        if groups:
            _lockstep_check(groups, carry[2], masks)
        new = dict(batch)
        new["state"], new["frame"], new["finished"] = (
            tuple(carry[0]), carry[1], carry[2])
        return new, mel_c, active, carry[2]

    denoiser = None
    if use_denoiser:
        from .models.denoiser import denoiser_stft_params, serving_denoiser

        kw = denoiser_kwargs or {}
        # cached per configuration on the synthesizer: its streaming path
        # may denoise with another STFT size at the same time
        bkey = tps.denoise_bias(kw)
        denoiser = serving_denoiser(
            lambda: tps._denoise_biases[bkey], denoiser_stft_params(**kw),
            chunk_steps, cfg.upsample_stride)

    return _tts_batcher(
        taco, cfg, dev, slots=slots, chunk_steps=chunk_steps,
        max_text_len=max_text_len, max_steps=max_steps, sigma=sigma,
        retain_sessions=retain_sessions, key_fn=key_fn, noise_fn=noise_fn,
        admit_fn=admit_fn, init_batch_fn=init_batch_fn, decode_fn=decode_fn,
        vocode_fn=lambda mel, nz, sg: vocoder(mel, sg, noise=nz),
        vocode_exact_fn=lambda mel, nz, sg: vocoder1(mel, sg, noise=nz),
        denoiser=denoiser)
