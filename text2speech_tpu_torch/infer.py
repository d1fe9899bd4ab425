"""End-to-end synthesis: text -> mel (Tacotron-2) -> waveform (WaveGlow) ->
denoiser -> PCM16 WAV (counterpart of ``text2speech_tpu/infer.py``): the
offline path (single-pass and chunked long-form vocoding over the plain,
fused bf16 and fused int8 vocoders) and the streaming path (chunked decode,
windowed vocoding, streaming denoiser), which emits audio before the decode
ends.

Streaming keeps its tensors on the model's device: the window bookkeeping
(frames emitted per row, flushed rows, window tasks) is host integers; mel,
noise and windows are device tensors; only the per-chunk stop-gate reads
and the emitted chunks cross to the host.

Seeds: ``text_to_mel`` draws the prenet dropout masks from a
``torch.Generator`` seeded with ``seed``, ``mel_to_audio`` the vocoder noise
from one seeded with ``seed + 1`` (the JAX package's key convention; the
numbers differ from ``jax.random``'s).  Both also take the draws
explicitly, so a test can hand them the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .config import HParams, WaveGlowConfig
from .text import N_SYMBOLS, encode_batch

from .dsp.audio import save_wav
from .models.chunked import (draw_noise, infer_long,
                             receptive_overlap_frames)
from .models.denoiser import (cached_stream_denoiser, denoise_stream,
                              make_denoiser_programs)
from .models.tacotron2 import Tacotron2
from .models.tacotron_serve import (decode_chunk_serve,
                                    extract_decoder_params,
                                    int8_decode_worthwhile,
                                    quantize_decoder_params)
from .models.waveglow import WaveGlow
from .models.waveglow_fused import prepare_fused, prepare_fused_int8


def speaker_ids_array(speaker_id, batch: int, num_speakers: int):
    """None, an int for every row, or a length-``batch`` int sequence ->
    np.int32 [batch] or None; raises ValueError on anything else (as
    ``text2speech_tpu/models/tacotron_serve.py:67``)."""
    if speaker_id is None:
        return None
    if isinstance(speaker_id, bool):
        raise ValueError("speaker_id must be an int, got bool")
    ids = (np.full((batch,), speaker_id, np.int32)
           if isinstance(speaker_id, (int, np.integer))
           else np.asarray(speaker_id))
    if ids.dtype.kind not in "iu" or ids.shape != (batch,):
        raise ValueError(f"speaker_id must be an int or length-{batch} "
                         f"int sequence, got {speaker_id!r}")
    if num_speakers <= 1:
        raise ValueError("speaker_id given but the model is single-speaker "
                         "(build/load with num_speakers > 1)")
    if ids.min() < 0 or ids.max() >= num_speakers:
        raise ValueError(f"speaker_id out of range [0, {num_speakers}): {ids}")
    return ids.astype(np.int32)


def chunked_mel_stream(hp, carry, decode_fn, postnet_fn, requested: int,
                       chunk_steps: int, all_masks: torch.Tensor):
    """Chunked decode with a windowed postnet (``infer.py:28
    chunked_mel_stream``).

    Drives ``decode_fn(carry, keep_masks [chunk_steps, 2, B, D]) -> (carry,
    mel_chunk [B, n_mel, chunk_steps], active bool [B, chunk_steps])`` in
    whole chunks and yields ``(mel_post_chunk [B, n_mel, n] on the device,
    out_lengths_so_far np.int64 [B], final)``.

    Emitted frames equal the whole-utterance path (``Tacotron2.inference``)
    on every VALID frame: a window that is not the last emits only frames a
    full postnet receptive field away from the decoded frontier, and when
    every row's gate has fired the loop decodes ``ceil(prf / chunk_steps)``
    more chunks before it declares the end, because the whole-utterance
    postnet reads REAL decoded context past the last stop frame (its decode
    always runs all ``requested`` steps).  The decode runs ``limit =
    ceil(requested / chunk_steps) * chunk_steps`` steps, but frames past
    ``requested`` are never emitted, counted or shown to the postnet.
    Frames beyond a row's stop are not masked: consumers cut at
    ``out_lengths``.  One host read per chunk (the rows' active counts and
    whether all have stopped)."""
    prf = (hp.postnet_kernel_size // 2) * hp.postnet_n_convolutions
    limit = -(-requested // chunk_steps) * chunk_steps
    if all_masks.shape[0] < limit:
        raise ValueError(f"{all_masks.shape[0]} steps of keep-masks, the "
                         f"chunked decode runs {limit}")
    tail_chunks = -(-prf // chunk_steps)
    B = carry[2].shape[0]
    chunks: list = []
    total = emitted = 0
    out_len = np.zeros((B,), np.int64)
    tail = None
    while total < limit:
        carry, mel_c, active = decode_fn(
            carry, all_masks[total: total + chunk_steps])
        chunks.append(mel_c)
        n_in_contract = max(0, min(chunk_steps, requested - total))
        total += chunk_steps
        read = torch.cat([active[:, :n_in_contract].sum(1),
                          carry[2].all()[None].long()]).cpu().numpy()
        out_len += read[:B]
        if tail is None:
            if read[B]:
                tail = tail_chunks
        else:
            tail -= 1
        cap = min(total, requested)
        final = total >= limit or tail == 0
        upto = cap if final else max(emitted, cap - prf)
        if upto > emitted:
            if len(chunks) > 1:
                chunks = [torch.cat(chunks, dim=-1)]
            ws = max(0, emitted - prf)
            # the window never reads past ``cap``: past ``requested`` the
            # whole-utterance postnet sees conv zero padding
            win = chunks[0][:, :, ws:cap]
            post = win + postnet_fn(win)
            yield post[:, :, emitted - ws: upto - ws], out_len.copy(), final
            emitted = upto
        if final:
            return


def _chunk_noise(cfg, noise, seed: int, device):
    """``draw(ci, B, n_groups) -> tuple`` of one decoded chunk's noise for
    all rows.  ``noise``: None (a generator on ``device`` seeded ``seed +
    1``, drawn chunk after chunk) or a callable of that signature (so a
    test can feed another package's draws)."""
    if noise is not None:
        return noise
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return lambda ci, B, n: draw_noise(cfg, gen, B, n)


def incremental_vocode_stream_batch(cfg, mel_stream, vocode_fn, sigma: float,
                                    seed: int, chunk_steps: int,
                                    vocode_masked_fn=None, noise=None):
    """Streaming vocode of a BATCHED chunked mel stream (B utterances
    decoded in lockstep): yields ``(row, chunk)`` pairs, each chunk a 1-D
    f32 tensor on the mel's device (``infer.py:97
    incremental_vocode_stream_batch``).

    ``mel_stream`` yields ``(mel_chunk [B, n_mel, n], out_len [B], final)``
    (:func:`chunked_mel_stream`); ``vocode_fn(mel, noise_tuple, sigma) ->
    [B, samples]`` vocodes a stack of windows; ``noise`` as
    :func:`_chunk_noise`.  The rules:

    * one noise draw per decoded chunk for all B rows; windows slice that
      one stream, so row r's audio equals a single pass over its final mel
      ``[:, :true_len_r]`` with ``noise[r]`` to float tolerance;
    * a mid-stream window emits a chunk once a full receptive field
      (``ov`` frames) of real right context exists.  Its left edge clamps
      to 0: early windows are PINNED to the utterance's start, where the
      window's edge is the true conv zero padding (zero-filled positions
      left of 0 would carry zero NOISE, which the flows turn into
      bias-driven values that leak into the first chunk);
    * windows are bounded by ``true_len_r = min(out_len_r, frames)``, not
      by the decoded frontier: frames after a row's stop exist only as
      postnet context and never enter a window;
    * a row whose gate has fired is flushed as soon as its real frames have
      cleared the mel stream, without waiting for the slowest row; flush
      windows stay INSIDE ``[0, true_len_r]``;
    * a row no longer than one window (``true_len <= W``) vocodes its exact
      length in one pass and emits the suffix not yet emitted: a
      fixed-width window would hold ``[true_len, W)`` as zeros IN the
      tensor, and zero mel and noise are real frames to the flows, not
      conv padding.  With ``vocode_masked_fn(mel, noise, sigma, length)``
      that pass is one masked call at the fixed width ``W``;
    * a round whose windows all start at 0 and end within the first chunk
      runs at width ``W1 = chunk + ov`` instead of ``W = chunk + 2 ov``:
      the trailing ``ov`` frames would be zero fill outside every emitted
      sample's receptive field.

    Each round stacks the ready rows' windows into ``[B, n_mel, width]``
    batches on the device (a short round repeats its first task; that
    output is dropped), so concurrent streams cost about one batched
    vocoder call per round."""
    hop = cfg.upsample_stride
    gpf = hop // cfg.n_group
    ov = receptive_overlap_frames(cfg)
    cs = chunk_steps
    W = cs + 2 * ov                    # vocoder window width, frames
    W1 = cs + ov                       # first-window width (start pinned)

    draw = None
    mel = None                         # [B, n_mel, F] postnet-done frames
    noise_all: list | None = None      # per draw [B, F * gpf, width]
    F = 0
    E: np.ndarray | None = None        # [B] frames vocoded and emitted
    flushed: np.ndarray | None = None  # [B] row fully emitted

    def run_windows(tasks, width):
        """tasks: (row, ws, keep_from, keep_to, f_lim); one batched vocode
        per group of B, window content zero outside [0, f_lim): the conv's
        zero padding."""
        B = mel.shape[0]
        for g0 in range(0, len(tasks), B):
            group = tasks[g0: g0 + B]
            rows = group + [group[0]] * (B - len(group))
            wmel = mel.new_zeros((B, mel.shape[1], width))
            wnoise = [z.new_zeros((B, width * gpf, z.shape[-1]))
                      for z in noise_all]
            for j, (r, ws, _kf, _kt, fl) in enumerate(rows):
                s, e = max(ws, 0), min(ws + width, fl)
                wmel[j, :, s - ws: e - ws] = mel[r, :, s:e]
                for wz, z in zip(wnoise, noise_all):
                    wz[j, (s - ws) * gpf: (e - ws) * gpf] = \
                        z[r, s * gpf: e * gpf]
            audio = vocode_fn(wmel, tuple(wnoise), sigma)
            for j, (r, ws, kf, kt, _fl) in enumerate(group):
                yield r, audio[j, (kf - ws) * hop: (kt - ws) * hop]

    def vocode_exact(r, tl):
        if vocode_masked_fn is not None:
            wmel = mel.new_zeros((1, mel.shape[1], W))
            wmel[0, :, :tl] = mel[r, :, :tl]
            nz = []
            for z in noise_all:
                wz = z.new_zeros((1, W * gpf, z.shape[-1]))
                wz[0, : tl * gpf] = z[r, : tl * gpf]
                nz.append(wz)
            return vocode_masked_fn(wmel, tuple(nz), sigma, tl)[0, : tl * hop]
        nz = tuple(z[r: r + 1, : tl * gpf] for z in noise_all)
        return vocode_fn(mel[r: r + 1, :, :tl].contiguous(), nz,
                         sigma)[0, : tl * hop]

    ci = 0
    for mel_chunk, out_len, final in mel_stream:
        mel_chunk = torch.as_tensor(mel_chunk, dtype=torch.float32)
        n_new = mel_chunk.shape[-1]
        B = mel_chunk.shape[0]
        if draw is None:
            draw = _chunk_noise(cfg, noise, seed, mel_chunk.device)
            E = np.zeros((B,), np.int64)
            flushed = np.zeros((B,), bool)
        new_noise = [torch.as_tensor(z, dtype=torch.float32,
                                     device=mel_chunk.device)
                     for z in draw(ci, B, n_new * gpf)]
        ci += 1
        if mel is None:
            mel, noise_all = mel_chunk, new_noise
        else:
            mel = torch.cat([mel, mel_chunk], dim=-1)
            noise_all = [torch.cat([a, z], dim=1)
                         for a, z in zip(noise_all, new_noise)]
        F += n_new
        out_len = np.asarray(out_len, np.int64)
        true_len = np.minimum(out_len, F)

        tasks: list = []
        shorts: list = []
        for r in range(B):
            if flushed[r]:
                continue
            tl = int(true_len[r])
            while not final and tl >= E[r] + cs + ov:
                tasks.append((r, max(int(E[r]) - ov, 0), int(E[r]),
                              int(E[r]) + cs, tl))
                E[r] += cs
            # the row is complete: the stream ended, or its gate fired and
            # all its real frames have cleared the postnet
            if final or int(out_len[r]) < F:
                if tl <= W:
                    if tl > int(E[r]):
                        shorts.append((r, int(E[r]), tl))
                        E[r] = tl
                else:
                    while E[r] < tl:
                        kt = min(int(E[r]) + cs, tl)
                        ws = max(0, min(int(E[r]) - ov, tl - W))
                        tasks.append((r, ws, int(E[r]), kt, tl))
                        E[r] = kt
                flushed[r] = True
        if tasks:
            first = all(t[1] == 0 and t[3] <= cs for t in tasks)
            yield from run_windows(tasks, W1 if first else W)
        for r, e0, tl in shorts:
            yield r, vocode_exact(r, tl)[e0 * hop:]


def incremental_vocode_stream(cfg, mel_stream, vocode_fn, sigma: float,
                              seed: int, chunk_steps: int,
                              vocode_masked_fn=None, noise=None):
    """Single-stream streaming vocode: the B = 1 case of
    :func:`incremental_vocode_stream_batch`, yielding the chunks alone."""
    for _row, chunk in incremental_vocode_stream_batch(
            cfg, mel_stream, vocode_fn, sigma, seed, chunk_steps,
            vocode_masked_fn=vocode_masked_fn, noise=noise):
        yield chunk


@dataclass
class Synthesizer:
    """Text-to-speech with a loaded Tacotron-2 and WaveGlow on one device.

    ``use_fused_vocoder`` vocodes through the fused WN-layer kernels in
    bf16 (:func:`..models.waveglow_fused.infer_fused`, weights prepared
    once into :attr:`fused`); ``int8_vocoder`` through the int8 WN-layer
    kernels (:func:`..models.waveglow_fused.infer_fused_int8`; it implies
    the fused path, and :attr:`fused` then holds the quantized weights);
    otherwise the plain f32 :meth:`WaveGlow.infer` runs.
    ``use_denoiser`` builds the bias-spectrum denoiser
    (``denoiser_kwargs`` override its STFT size).  ``quantized_decode``
    prepares int8 decoder weights for the streaming decode; they serve only
    at the batch sizes where :func:`..models.tacotron_serve.
    int8_decode_worthwhile` says int8 pays, floating point otherwise."""

    hp: HParams
    taco: Tacotron2
    wg_cfg: WaveGlowConfig
    waveglow: WaveGlow
    use_denoiser: bool = True
    use_fused_vocoder: bool = False
    int8_vocoder: bool = False
    quantized_decode: bool = False
    denoiser_kwargs: dict | None = None

    def __post_init__(self):
        self.device = self.waveglow.upsample_k.device
        self._denoise = None
        self._denoise_bias = None
        self._denoise_bias_fn = None
        self._denoise_params = None
        if self.use_denoiser:
            self._denoise_bias_fn, denoise, self._denoise_params = \
                make_denoiser_programs(self.waveglow,
                                       **(self.denoiser_kwargs or {}))
            # reads the CURRENT bias at call time, so a weight swap is live
            # wherever this handle is held
            self._denoise = lambda audio, strength: denoise(
                audio, self._denoise_bias, strength)
        self._derive_from_waveglow()
        self._derive_from_tacotron()

    def _derive_from_waveglow(self) -> None:
        """What depends on the WaveGlow weights: the prepared serving
        weights of the fused or int8 vocoder and the denoiser's bias."""
        if self.int8_vocoder:
            self.fused = prepare_fused_int8(self.waveglow, torch.bfloat16)
        elif self.use_fused_vocoder:
            self.fused = prepare_fused(self.waveglow, torch.bfloat16)
        else:
            self.fused = None
        # what vocodes: the three share ``cfg`` and ``infer``'s signature
        self.vocoder = self.waveglow if self.fused is None else self.fused
        if self._denoise_bias_fn is not None:
            self._denoise_bias = self._denoise_bias_fn()

    def _derive_from_tacotron(self) -> None:
        """What depends on the Tacotron weights: the int8 decoder weights."""
        self._dp_q = None
        if self.quantized_decode:
            self._dp_q = quantize_decoder_params(
                extract_decoder_params(self.taco))

    @torch.no_grad()
    def load_weights(self, taco_variables=None, wg_variables=None) -> None:
        """Swap checkpoints IN PLACE into the live modules
        (``infer.py:521 load_weights``): ``taco_variables`` /
        ``wg_variables`` are flax-layout variables (a nested tree or the
        flat ``params/...`` keys of ``export_torch_weights.py``), converted
        as :func:`..convert.load_tacotron` / ``load_waveglow`` convert
        them and copied into the existing parameters, so every holder of
        the modules sees them.  What ``__post_init__`` derives is rebuilt
        the same way: the fused or int8 serving weights, the int8 decoder
        weights, the denoiser's bias.  Shapes must match the live models'.
        A running continuous-batching server (``server.make_server``)
        reads everything through this object at call time and serves the
        new weights from its next round; sessions in flight see them
        mid-utterance, so drain first if that matters."""
        from .convert import tacotron_state_dict, waveglow_state_dict

        if taco_variables is not None:
            self.taco.load_state_dict(tacotron_state_dict(
                taco_variables, self.hp, self.taco.num_speakers))
            self._derive_from_tacotron()
        if wg_variables is not None:
            self.waveglow.load_state_dict(
                waveglow_state_dict(wg_variables, self.wg_cfg))
            self._derive_from_waveglow()

    def load_checkpoints(self, taco_ckpt_dir: str | None = None,
                         wg_ckpt_dir: str | None = None,
                         taco_npz: str | None = None) -> None:
        """Restore either or both models from disk and swap them in place
        (``infer.py:552 load_checkpoints``): the live-upgrade path of a
        running server (HTTP ``POST /reload``).  ``taco_ckpt_dir`` and
        ``wg_ckpt_dir`` are training checkpoint directories of this package
        (``train/checkpoint.py``; the newest step is read).  ``taco_npz``
        is the alternative for a JAX-trained Tacotron: the ``.npz`` that
        ``export_torch_weights.py`` writes (its ``tacotron/...`` keys)."""
        if taco_ckpt_dir is not None and taco_npz is not None:
            raise ValueError("give taco_ckpt_dir or taco_npz, not both")
        tv = None
        if taco_npz is not None:
            from .convert import load_npz, sub_tree

            tv = sub_tree(load_npz(taco_npz), "tacotron")
        wv = None if wg_ckpt_dir is None else waveglow_checkpoint(wg_ckpt_dir)
        if taco_ckpt_dir is not None:
            load_tacotron_checkpoint(self.taco, taco_ckpt_dir)
            self._derive_from_tacotron()
        self.load_weights(tv, wv)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    @torch.inference_mode()
    def text_to_mel(self, texts, seed: int = 0, max_steps: int | None = None,
                    speaker_id=None, keep_masks: torch.Tensor | None = None,
                    with_align: bool = False):
        """list[str] -> (mel_post [B, n_mel, T], out_lengths [B]).

        ``with_align=True`` also returns the attention alignment [B, T_dec,
        T_enc] f32, as the JAX ``Synthesizer.text_to_mel`` does."""
        ids, lengths = encode_batch(texts)
        sid = speaker_ids_array(speaker_id, ids.shape[0],
                                self.taco.num_speakers)
        _, mel_post, _, align, out_lengths = self.taco.inference(
            torch.from_numpy(ids).long().to(self.device),
            speaker_ids=(None if sid is None
                         else torch.from_numpy(sid).long().to(self.device)),
            text_lengths=torch.from_numpy(lengths).to(self.device),
            max_steps=max_steps, keep_masks=keep_masks,
            generator=self._generator(seed))
        if with_align:
            return mel_post, out_lengths, align
        return mel_post, out_lengths

    @torch.inference_mode()
    def mel_to_audio(self, mel: torch.Tensor, sigma: float = 0.666,
                     seed: int = 0, denoiser_strength: float = 0.0,
                     noise: tuple | None = None) -> torch.Tensor:
        """mel [B, n_mel, T] -> audio [B, T * upsample_stride] f32."""
        audio = self.vocoder.infer(mel, sigma, noise=noise,
                                   generator=self._generator(seed + 1))
        return self._denoised(audio, denoiser_strength)

    @torch.inference_mode()
    def mel_to_audio_long(self, mel: torch.Tensor, sigma: float = 0.666,
                          seed: int = 0, denoiser_strength: float = 0.0,
                          chunk_frames: int = 256,
                          overlap_frames: int | None = None,
                          noise: tuple | None = None) -> torch.Tensor:
        """Frame-axis chunked vocoding for arbitrarily long mels
        (:func:`..models.chunked.infer_long`): bounded activation memory
        per window, all windows in one batched pass through the configured
        vocoder.  The noise is drawn once at full length (from ``seed +
        1``, or given) and sliced per window."""
        if noise is None:
            gpf = self.wg_cfg.upsample_stride // self.wg_cfg.n_group
            noise = draw_noise(self.wg_cfg, self._generator(seed + 1),
                               mel.shape[0], mel.shape[2] * gpf)
        audio = infer_long(self.vocoder, mel, sigma, chunk_frames,
                           overlap_frames, noise=noise)
        return self._denoised(audio, denoiser_strength)

    def _denoised(self, audio, strength: float):
        if strength > 0 and self._denoise is not None:
            return self._denoise(audio, strength)
        return audio

    def _synthesize(self, vocode, texts, seed, max_steps, speaker_id,
                    keep_masks) -> list:
        """text -> mel -> ``vocode(mel [B, n_mel, T_max])`` -> float32 numpy
        waveforms, each cut to its utterance's length (out_length *
        upsample_stride samples)."""
        mel_post, out_lengths = self.text_to_mel(
            texts, seed, max_steps, speaker_id=speaker_id,
            keep_masks=keep_masks)
        lens = out_lengths.cpu().numpy()
        T = int(lens.max())
        audio = vocode(mel_post[:, :, :T].contiguous()).cpu().numpy()
        hop = self.wg_cfg.upsample_stride
        return [audio[i, : int(lens[i]) * hop] for i in range(len(lens))]

    def synthesize(self, texts, sigma: float = 0.666, seed: int = 0,
                   denoiser_strength: float = 0.0,
                   max_steps: int | None = None, speaker_id=None,
                   keep_masks: torch.Tensor | None = None,
                   noise: tuple | None = None) -> list:
        """list[str] -> list of float32 numpy waveforms, each cut to its
        utterance's length."""
        return self._synthesize(
            lambda mel: self.mel_to_audio(mel, sigma, seed, denoiser_strength,
                                          noise=noise),
            texts, seed, max_steps, speaker_id, keep_masks)

    def synthesize_long(self, texts, sigma: float = 0.666, seed: int = 0,
                        denoiser_strength: float = 0.0,
                        max_steps: int | None = None,
                        chunk_frames: int = 256,
                        overlap_frames: int | None = None, speaker_id=None,
                        keep_masks: torch.Tensor | None = None,
                        noise: tuple | None = None) -> list:
        """Like :meth:`synthesize`, vocoding through the chunked long-form
        path: for utterances whose mels exceed comfortable single-pass
        activation memory."""
        return self._synthesize(
            lambda mel: self.mel_to_audio_long(
                mel, sigma, seed, denoiser_strength, chunk_frames,
                overlap_frames, noise=noise),
            texts, seed, max_steps, speaker_id, keep_masks)

    def synthesize_stream(self, text: str, sigma: float = 0.666,
                          seed: int = 0, denoiser_strength: float = 0.0,
                          max_batch: int = 8, max_steps: int | None = None,
                          speaker_id: int | None = None):
        """Long-form text sentence by sentence: split into sentences,
        synthesize ``max_batch`` of them per call and yield ``(sentence,
        waveform)`` pairs in reading order, so the first audio is ready
        after one batch."""
        from .text import split_sentences

        sentences = split_sentences(text)
        for i in range(0, len(sentences), max_batch):
            chunk = sentences[i: i + max_batch]
            wavs = self.synthesize(
                chunk, sigma=sigma, seed=seed,
                denoiser_strength=denoiser_strength, max_steps=max_steps,
                speaker_id=speaker_id)
            yield from zip(chunk, wavs)

    @torch.inference_mode()
    def text_to_mel_stream(self, texts, chunk_steps: int = 64, seed: int = 0,
                           max_steps: int | None = None, speaker_id=None,
                           keep_masks: torch.Tensor | None = None):
        """Incremental text -> mel: yields ``(mel_post_chunk [B, n_mel, n]
        on the device, out_lengths_so_far np.int64 [B], final)`` as the
        decoder advances.

        The chunked decode equals :meth:`text_to_mel`'s bit for bit on every
        valid frame: same carry, and the same keep-masks, since they are
        drawn in fixed blocks (``Decoder.draw_keep_masks``) and so do not
        depend on the ``limit = ceil(requested / chunk_steps) *
        chunk_steps`` steps this decode runs.  The postnet runs over
        windows with its whole receptive field of context.  Frames beyond
        a row's stop frame are not masked: cut at ``out_lengths``.
        ``keep_masks`` [>= limit, 2, B, prenet_dim] replaces the draw."""
        texts = [texts] if isinstance(texts, str) else texts
        ids, lengths = encode_batch(texts)
        sid = speaker_ids_array(speaker_id, ids.shape[0],
                                self.taco.num_speakers)
        lengths_t = torch.from_numpy(lengths).to(self.device)
        memory = self.taco.encode(
            torch.from_numpy(ids).long().to(self.device),
            speaker_ids=(None if sid is None
                         else torch.from_numpy(sid).long().to(self.device)),
            text_lengths=lengths_t)
        B = memory.shape[0]
        requested = max_steps or self.hp.max_decoder_steps
        limit = -(-requested // chunk_steps) * chunk_steps
        if keep_masks is None:
            keep_masks = self.taco.decoder.draw_keep_masks(
                limit, B, self._generator(seed), self.device)
        if self._dp_q is not None and int8_decode_worthwhile(B):
            pmem = self.taco.process_memory(memory)

            def decode_fn(carry, masks):
                carry, mel_c, _, _, active = decode_chunk_serve(
                    self._dp_q, self.hp, memory, pmem, *carry, masks,
                    lengths_t, dtype=memory.dtype)
                return carry, mel_c, active
        else:
            def decode_fn(carry, masks):
                carry, mel_c, _, _, active = self.taco.decode_chunk(
                    memory, *carry, masks, lengths_t)
                return carry, mel_c, active

        yield from chunked_mel_stream(
            self.hp, self.taco.decoder.initial_carry(memory), decode_fn,
            self.taco.postnet_residual, requested, chunk_steps, keep_masks)

    def _vocode_window(self, mel, noise, sigma):
        return self.vocoder.infer(mel, sigma, noise=noise)

    def _masked_vocode_handle(self):
        """The masked exact pass of the streaming engine (``WaveGlow.infer``
        with ``length=``), for the plain vocoder.  None for the fused and
        int8 vocoders: nothing is compiled per shape here, so their exact
        pass runs at the exact length and needs no masked program."""
        if self.fused is not None:
            return None
        return lambda mel, nz, sg, tl: self.waveglow.infer(
            mel, sg, noise=nz, length=tl)

    @torch.inference_mode()
    def synthesize_incremental(self, text: str, sigma: float = 0.666,
                               seed: int = 0, chunk_steps: int = 64,
                               max_steps: int | None = None,
                               denoiser_strength: float = 0.0,
                               speaker_id: int | None = None,
                               keep_masks: torch.Tensor | None = None,
                               noise=None):
        """Stream ONE utterance's audio: yields float32 numpy chunks as
        soon as the decoded mel clears the vocoder's receptive field, the
        first after about ``chunk_steps + overlap`` decoder steps instead
        of the whole decode.

        The vocoder runs on fixed-width windows of the growing mel with
        ``receptive_overlap_frames`` of context on each side over one noise
        stream (one draw per decoded chunk from a generator seeded ``seed +
        1``, or ``noise``, see :func:`incremental_vocode_stream_batch`), so
        the audio equals a single pass over the final mel with that noise
        to float tolerance.  ``denoiser_strength > 0`` streams the
        bias-subtracted audio (:func:`..models.denoiser.denoise_stream`):
        fewer than ``n_fft`` samples of added latency, equal to the
        whole-utterance denoiser's output."""
        stream = self.text_to_mel_stream(
            text, chunk_steps=chunk_steps, seed=seed, max_steps=max_steps,
            speaker_id=speaker_id, keep_masks=keep_masks)
        audio = incremental_vocode_stream(
            self.wg_cfg, stream, self._vocode_window, sigma, seed,
            chunk_steps, vocode_masked_fn=self._masked_vocode_handle(),
            noise=noise)
        if denoiser_strength > 0:
            if self._denoise_bias is None:
                raise ValueError("denoiser_strength > 0 needs "
                                 "use_denoiser=True")
            den = cached_stream_denoiser(
                self, (self._denoise_params, chunk_steps),
                lambda: self._denoise_bias, self._denoise_params,
                chunk_steps, self.wg_cfg.upsample_stride)
            audio = denoise_stream(audio, den, denoiser_strength)
        for chunk in audio:
            yield chunk.cpu().numpy()

    @torch.inference_mode()
    def synthesize_incremental_batch(self, texts, sigma: float = 0.666,
                                     seed: int = 0, chunk_steps: int = 64,
                                     max_steps: int | None = None,
                                     speaker_id=None,
                                     keep_masks: torch.Tensor | None = None,
                                     noise=None):
        """Stream N utterances CONCURRENTLY: yields ``(row, float32 numpy
        chunk)`` pairs as each row's decoded mel clears the vocoder's
        receptive field.  One batched decode drives all rows in lockstep;
        each emission round is one batched vocoder call on the stacked
        windows.  A row whose gate fires early flushes at once.  Each row's
        concatenated chunks equal a single pass over that row's final mel
        with its slice of the batch's noise stream."""
        stream = self.text_to_mel_stream(
            texts, chunk_steps=chunk_steps, seed=seed, max_steps=max_steps,
            speaker_id=speaker_id, keep_masks=keep_masks)
        for row, chunk in incremental_vocode_stream_batch(
                self.wg_cfg, stream, self._vocode_window, sigma, seed,
                chunk_steps, vocode_masked_fn=self._masked_vocode_handle(),
                noise=noise):
            yield row, chunk.cpu().numpy()

    def synthesize_to_files(self, texts, paths, sample_rate=None, **kw):
        sr = sample_rate or self.wg_cfg.sampling_rate
        wavs = self.synthesize(texts, **kw)
        for wav, path in zip(wavs, paths):
            save_wav(wav, path, sr)
        return wavs


def waveglow_checkpoint(ckpt_dir: str) -> dict:
    """The newest WaveGlow training checkpoint of ``ckpt_dir`` as the flat
    flax variables ``load_waveglow`` reads (the trainer's state names its
    leaves ``params.<flax path>``)."""
    from .train.checkpoint import CheckpointManager

    return {f"params/{name.removeprefix('params.')}": t.numpy()
            for name, t in CheckpointManager(ckpt_dir).load_params().items()}


@torch.no_grad()
def load_tacotron_checkpoint(taco: Tacotron2, ckpt_dir: str) -> None:
    """Copy the newest Tacotron training checkpoint of ``ckpt_dir`` (its
    parameters and BatchNorm running statistics) into ``taco`` in place.
    Raises when the names differ from the model's."""
    from .train.checkpoint import CheckpointManager

    saved = CheckpointManager(ckpt_dir).load_variables()
    sd = taco.state_dict()
    want = {k for k in sd if not k.endswith("num_batches_tracked")}
    if set(saved) != want:
        odd = sorted(set(saved) ^ want)
        raise ValueError(f"Tacotron checkpoint in {ckpt_dir} does not match "
                         f"the model: {odd[:8]}")
    for k in want:
        sd[k].copy_(saved[k])


def load_synthesizer(hp: HParams, weights_npz: str | None,
                     wg_cfg: WaveGlowConfig, use_denoiser: bool = True,
                     num_speakers: int = 1,
                     use_fused_vocoder: bool = False,
                     int8_vocoder: bool = False,
                     device: str | torch.device = "cuda",
                     quantized_decode: bool = False,
                     taco_ckpt_dir: str | None = None,
                     wg_ckpt_dir: str | None = None) -> Synthesizer:
    """Build a Synthesizer from the ``.npz`` that ``export_torch_weights.py``
    writes (``tacotron/...`` and ``waveglow/...`` flax paths), or, with
    ``weights_npz=None``, from this package's two training checkpoint
    directories ``taco_ckpt_dir`` and ``wg_ckpt_dir`` (``infer.py:920
    load_synthesizer``)."""
    from .convert import load_npz, load_tacotron, load_waveglow, sub_tree

    if weights_npz is not None:
        flat = load_npz(weights_npz)
        taco = load_tacotron(sub_tree(flat, "tacotron"), hp, N_SYMBOLS,
                             num_speakers, device=device)
        wg = load_waveglow(sub_tree(flat, "waveglow"), wg_cfg, device=device)
    elif taco_ckpt_dir is None or wg_ckpt_dir is None:
        raise ValueError("load_synthesizer needs weights_npz, or "
                         "taco_ckpt_dir and wg_ckpt_dir")
    else:
        taco = Tacotron2(hp, N_SYMBOLS, num_speakers, device=device)
        load_tacotron_checkpoint(taco, taco_ckpt_dir)
        taco.eval()
        wg = load_waveglow(waveglow_checkpoint(wg_ckpt_dir), wg_cfg,
                           device=device)
    return Synthesizer(hp, taco, wg_cfg, wg, use_denoiser=use_denoiser,
                       use_fused_vocoder=use_fused_vocoder,
                       int8_vocoder=int8_vocoder,
                       quantized_decode=quantized_decode)


@torch.no_grad()
def random_weights_(module: torch.nn.Module, generator: torch.Generator,
                    out_first: bool) -> None:
    """Fill every parameter in place from ``generator``, in name order:
    matrices N(0, 1 / fan_in), vectors N(0, 0.1^2).  ``out_first``: torch
    layouts ([out, in, ...], fan_in = numel / shape[0]); otherwise the JAX
    package's kernel layouts ([..., in, out], fan_in = numel / shape[-1])."""
    for _, p in sorted(module.named_parameters()):
        z = torch.randn(p.shape, generator=generator,
                        device=generator.device)
        if p.dim() == 1:
            z = z * 0.1
        else:
            fan_in = p.numel() // (p.shape[0] if out_first else p.shape[-1])
            z = z / fan_in ** 0.5
        p.copy_(z.to(p.device))


def random_synthesizer(hp: HParams, wg_cfg: WaveGlowConfig, seed: int = 0,
                       device: str | torch.device = "cuda",
                       num_speakers: int = 1, use_denoiser: bool = True,
                       use_fused_vocoder: bool = True,
                       int8_vocoder: bool = False,
                       quantized_decode: bool = False,
                       denoiser_kwargs: dict | None = None) -> Synthesizer:
    """A Synthesizer on seeded random weights at any width (for runs when
    no checkpoint exists).  The WaveGlow ``end`` convs, zero at a real
    init, get small random values so the audio depends on the mel.  The
    decoder's stop gate is biased off (-10), so every utterance decodes
    ``max_steps`` frames, as an untrained model's does."""
    gen = torch.Generator(device=device).manual_seed(seed)
    taco = Tacotron2(hp, N_SYMBOLS, num_speakers, device=device)
    random_weights_(taco, gen, out_first=True)
    for m in taco.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    with torch.no_grad():
        taco.decoder.gate_proj.bias.fill_(-10.0)
    wg = WaveGlow(wg_cfg, device=device)
    random_weights_(wg, gen, out_first=False)
    with torch.no_grad():
        for w in wg.convinv:
            q, _ = torch.linalg.qr(torch.randn(
                w.shape, generator=gen, device=gen.device))
            if torch.linalg.det(q) < 0:
                q[:, 0] = -q[:, 0]
            w.copy_(q.to(w.device))
        for wn in wg.wn:
            wn.end_w.mul_(0.02)
            wn.end_b.mul_(0.02)
    return Synthesizer(hp, taco.eval(), wg_cfg, wg.eval(),
                       use_denoiser=use_denoiser,
                       use_fused_vocoder=use_fused_vocoder,
                       int8_vocoder=int8_vocoder,
                       quantized_decode=quantized_decode,
                       denoiser_kwargs=denoiser_kwargs)
