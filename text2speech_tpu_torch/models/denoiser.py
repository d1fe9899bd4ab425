"""WaveGlow bias-spectrum denoiser (counterpart of
``text2speech_tpu/models/denoiser.py``), whole-utterance and streaming.

The vocoder's bias is estimated once by synthesizing from an all-zero mel
at sigma=0 with the plain f32 :meth:`WaveGlow.infer`; at synthesis time
``strength * bias_spec`` is subtracted from the STFT magnitude and the
signal is re-synthesized with the original phases.

:func:`denoise_windows` is the streaming form: one fixed-shape batched
program that denoises a window of each stream's audio such that the
emitted interior samples equal the whole-utterance ``denoise`` output.  Why
it is exact: the STFT / ISTFT pair is frame-local (each output sample
depends only on the <= n_overlap frames covering it, each frame on
``filter_length`` input samples), so a window that (a) starts at a multiple
of ``hop_length`` of the full signal, (b) carries the frames covering the
emitted range plus ``filter_length`` of margin frames and (c) reproduces
the reflect padding at true signal edges gives frame-identical math; the
masked overlap-add and the window sum-square correction of the row's frame
count then reproduce the full-signal ISTFT at every emitted position, up
to the last bits of float32 products at another batch shape.  The products
are float32: keep TF32 off (``torch.backends.cuda.matmul.allow_tf32 =
False``, PyTorch's default).

Planning (:class:`StreamingDenoiser.plan`, :class:`DenoiseBuffer`'s
positions) is host integers; the audio, the windows and the program stay
on the audio's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..dsp.filters import window_sumsquare
from ..dsp.stft import (STFTParams, _forward_basis, _inverse_basis, istft,
                        stft_mag_phase)
from .waveglow import WaveGlow


def denoiser_stft_params(filter_length: int = 1024, n_overlap: int = 4,
                         win_length: int = 1024, **_ignored) -> STFTParams:
    """The STFT configuration :func:`make_denoiser` uses for these kwargs
    (defaults are the reference's)."""
    return STFTParams(filter_length, filter_length // n_overlap, win_length)


def make_denoiser_programs(model: WaveGlow, filter_length: int = 1024,
                           n_overlap: int = 4, win_length: int = 1024,
                           mode: str = "zeros", n_frames: int = 88):
    """``(compute_bias() -> bias_spec [1, cutoff, 1],
    denoise(audio, bias_spec, strength) -> audio', params)``."""
    if mode != "zeros":
        raise ValueError(f"unsupported denoiser mode {mode!r} (the port "
                         f"estimates the bias from an all-zero mel)")
    params = denoiser_stft_params(filter_length, n_overlap, win_length)

    @torch.inference_mode()
    def compute_bias() -> torch.Tensor:
        dev = model.upsample_k.device
        mel = torch.zeros((1, model.cfg.n_mel_channels, n_frames), device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        bias_audio = model.infer(mel, sigma=0.0, generator=gen)
        bias_spec, _ = stft_mag_phase(bias_audio, params)
        return bias_spec[:, :, 0:1]

    @torch.inference_mode()
    def denoise(audio: torch.Tensor, bias_spec: torch.Tensor,
                strength: float) -> torch.Tensor:
        """audio [B, T] -> [B, hop * (T // hop)]."""
        mag, phase = stft_mag_phase(audio, params)
        mag = torch.clamp_min(mag - bias_spec * strength, 0.0)
        return istft(mag, phase, params)

    return compute_bias, denoise, params


def make_denoiser(model: WaveGlow, filter_length: int = 1024,
                  n_overlap: int = 4, win_length: int = 1024,
                  mode: str = "zeros", n_frames: int = 88):
    """-> (bias_spec, denoise(audio, strength=0.1))."""
    compute_bias, denoise2, _ = make_denoiser_programs(
        model, filter_length, n_overlap, win_length, mode, n_frames)
    bias_spec = compute_bias()

    def denoise(audio: torch.Tensor, strength: float = 0.1) -> torch.Tensor:
        return denoise2(audio, bias_spec, strength)

    return bias_spec, denoise


# ---------------------------------------------------------------------------
# streaming (windowed) denoiser
# ---------------------------------------------------------------------------


@torch.inference_mode()
def denoise_windows(x_pad: torch.Tensor, bias_spec: torch.Tensor,
                    strengths: torch.Tensor, n_valid: torch.Tensor,
                    correction: torch.Tensor,
                    params: STFTParams) -> torch.Tensor:
    """Fixed-shape batched windowed denoise -> the ISTFT overlap-add of the
    denoised frames over window-local positions [0, L_pad).

    ``x_pad`` [B, L_pad]: a window of the reflect-PADDED full signal that
    starts at a frame boundary, zero past its valid extent.  ``bias_spec``
    [1, cutoff, 1].  ``strengths`` [B]: per-row strength, so mixed strengths
    batch into one call.  ``n_valid`` [B]: the count of REAL frames in the
    window; frames at or past it straddle or lie in the zero fill, do not
    exist in the full-signal computation and are masked to exact zeros.
    ``correction`` [B, L_pad]: 1 / window_sumsquare over exactly the
    ``n_valid`` real frames (:func:`_window_correction`), so every sample
    whose covering frames are all real reproduces the full-signal ISTFT.
    The caller slices out the emitted range."""
    n_fft, hop = params.filter_length, params.hop_length
    if n_fft % hop:
        raise ValueError("the windowed overlap-add needs hop | n_fft")
    B, L_pad = x_pad.shape
    if (L_pad - n_fft) % hop:
        raise ValueError(f"L_pad {L_pad} is no whole number of frames")
    n_frames = 1 + (L_pad - n_fft) // hop
    dev = x_pad.device
    basis = torch.from_numpy(_forward_basis(n_fft, params.win_length)).to(dev)
    frames = x_pad.float().unfold(1, n_fft, hop)          # [B, F, n_fft]
    spec = (frames @ basis).transpose(1, 2)               # [B, 2*cutoff, F]
    re, im = spec[:, : params.cutoff], spec[:, params.cutoff:]
    mag = torch.sqrt(re * re + im * im)
    phase = torch.atan2(im, re)
    mag = torch.clamp_min(
        mag - bias_spec * strengths.to(dev, torch.float32)[:, None, None],
        0.0)
    re_im = torch.cat([mag * torch.cos(phase), mag * torch.sin(phase)], dim=1)
    inv_basis = torch.from_numpy(
        _inverse_basis(n_fft, params.win_length, hop)).to(dev)
    out_frames = re_im.transpose(1, 2) @ inv_basis        # [B, F, n_fft]
    mask = (torch.arange(n_frames, device=dev)[None, :]
            < n_valid.to(dev)[:, None])
    out_frames = out_frames * mask[:, :, None]
    r = n_fft // hop
    chunks = out_frames.reshape(B, n_frames, r, hop)
    signal = out_frames.new_zeros((B, n_frames + r - 1, hop))
    for j in range(r):
        signal[:, j: j + n_frames] += chunks[:, :, j]
    return (signal.reshape(B, L_pad) * correction.to(dev)
            * (float(n_fft) / hop))


@functools.lru_cache(maxsize=256)
def _window_correction(n_valid: int, params: STFTParams,
                       l_pad: int) -> np.ndarray:
    """1 / window_sumsquare over ``n_valid`` frames, padded to ``l_pad``
    with 1.0: the correction :func:`..dsp.stft.istft` applies to a signal
    of that frame count (same f64 accumulation, same tiny-guard)."""
    wss = window_sumsquare(n_valid, params.hop_length, params.win_length,
                           params.filter_length)
    tiny = np.finfo(np.float32).tiny
    corr = np.where(wss > tiny, 1.0 / np.maximum(wss, tiny), 1.0)
    out = np.ones((l_pad,), np.float32)
    out[: corr.shape[0]] = corr[:l_pad]
    return out


class StreamingDenoiser:
    """Window planner and fixed-shape program for streamed denoising.

    One instance can serve every stream of a server (pending windows of
    all streams batch into shared :func:`denoise_windows` calls).
    ``bias_fn`` is read at every call, so a new bias spectrum takes effect
    at once.

    Frame bookkeeping (positions in SAMPLES of the raw vocoded signal;
    ``pad = n_fft // 2`` is the centred STFT's reflect padding):

    * frame ``f`` of the padded signal reads padded samples ``[f * hop,
      f * hop + n_fft)``, that is raw samples from ``f * hop - pad``;
    * mid-stream (right reflect edge unknown) frame ``f`` is computable iff
      ``f * hop + n_fft <= A + pad`` for ``A`` raw samples buffered;
    * denoised sample ``P`` can be emitted once all frames covering padded
      position ``P + pad`` are computable, so fewer than ``n_fft`` samples
      are held back until the stream flushes;
    * the denoised stream ends at ``hop * (T // hop)`` samples, the
      whole-utterance denoiser's output length."""

    def __init__(self, bias_fn, params: STFTParams | None = None,
                 f_win: int = 72):
        self.params = params or denoiser_stft_params()
        n_fft, hop = self.params.filter_length, self.params.hop_length
        if n_fft % hop:
            raise ValueError("the streaming denoiser needs hop | n_fft")
        self.r = n_fft // hop
        if f_win < self.r + 1:
            raise ValueError("the window must out-span the frame overlap")
        self.f_win = f_win
        self.l_pad = n_fft + hop * (f_win - 1)
        self.pad = n_fft // 2
        self._bias_fn = bias_fn

    # --- host planning ----------------------------------------------------

    def emit_bound(self, a: int, flushed: bool) -> int:
        """The largest denoised-sample frontier reachable with ``a`` raw
        samples buffered (the full output length once ``flushed``)."""
        n_fft, hop, pad = (self.params.filter_length, self.params.hop_length,
                           self.pad)
        if flushed:
            return hop * (a // hop)
        f_max = (a + pad - n_fft) // hop
        return max(0, (f_max + 1) * hop - pad)

    def plan(self, a: int, emitted: int, flushed: bool) -> list:
        """Window specs ``(f0, n_valid, e0, e1)`` that advance the denoised
        frontier from ``emitted`` to :meth:`emit_bound`: window frames
        ``[f0, f0 + n_valid)`` of the padded signal, emitting denoised
        samples ``[e0, e1)``.  Every emitted sample's covering frames are
        inside the window; the final flush window ends at the signal's
        true last frame, so the right window-sum-square decay is the full
        signal's."""
        n_fft, hop, pad = (self.params.filter_length, self.params.hop_length,
                           self.pad)
        bound = self.emit_bound(a, flushed)
        f_last = a // hop if flushed else (a + pad - n_fft) // hop
        specs = []
        d = emitted
        while d < bound:
            f0 = max(0, (d + pad - n_fft) // hop + 1)
            f_hi = min(f0 + self.f_win - 1, f_last)
            e1 = bound if (flushed and f_hi == f_last) else min(
                (f_hi + 1) * hop - pad, bound)
            if e1 <= d:
                raise RuntimeError("window does not advance (f_win too "
                                   "small)")
            specs.append((f0, f_hi - f0 + 1, d, e1))
            d = e1
        return specs

    def fill_row(self, x_pad_row: torch.Tensor, corr_row: torch.Tensor,
                 window: torch.Tensor, n_valid: int) -> None:
        """Write one window's samples and correction into pre-zeroed batch
        rows (``window``: the ``n_fft + hop * (n_valid - 1)`` padded-signal
        samples that the plan's ``f0`` selects, :meth:`DenoiseBuffer.
        window`)."""
        hop, n_fft = self.params.hop_length, self.params.filter_length
        need = n_fft + hop * (n_valid - 1)
        if tuple(window.shape) != (need,):
            raise ValueError(f"window {tuple(window.shape)}, want ({need},)")
        x_pad_row[:need] = window
        corr_row.copy_(torch.from_numpy(
            _window_correction(n_valid, self.params, self.l_pad)))

    # --- device call ------------------------------------------------------

    def __call__(self, x_pad: torch.Tensor, strengths, n_valid,
                 correction: torch.Tensor) -> torch.Tensor:
        dev = x_pad.device
        return denoise_windows(
            x_pad, self._bias_fn().to(dev),
            torch.as_tensor(strengths, dtype=torch.float32, device=dev),
            torch.as_tensor(n_valid, dtype=torch.int32, device=dev),
            correction, self.params)


def serving_denoiser(bias_fn, params: STFTParams, chunk_steps: int,
                     upsample_stride: int) -> StreamingDenoiser:
    """The one window-sizing rule of every serving surface: the window
    spans one scheduling round's audio intake plus both frame margins."""
    r = params.filter_length // params.hop_length
    f_win = max(r + 2, -(-chunk_steps * upsample_stride
                         // params.hop_length) + 2 * r)
    return StreamingDenoiser(bias_fn, params, f_win=f_win)


def cached_stream_denoiser(holder, key, bias_fn, params: STFTParams,
                           chunk_steps: int,
                           upsample_stride: int) -> StreamingDenoiser:
    """Per-``holder`` cache of a :func:`serving_denoiser`, rebuilt only
    when ``key`` (the holder's STFT configuration and ``chunk_steps``)
    changes.  ``bias_fn`` is read when denoising, so a new bias never
    invalidates the cache."""
    if getattr(holder, "_stream_den_key", None) != key:
        holder._stream_den = serving_denoiser(bias_fn, params, chunk_steps,
                                              upsample_stride)
        holder._stream_den_key = key
    return holder._stream_den


def _reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """numpy's ``mode="reflect"`` padding of a 1-D tensor: the periodic
    mirror image (period ``2 (n - 1)``), which also holds for pads longer
    than the signal."""
    n = x.shape[0]
    if n == 1:
        return x.expand(left + 1 + right)
    p = torch.arange(-left, n + right, device=x.device) % (2 * (n - 1))
    return x[torch.where(p < n, p, 2 * (n - 1) - p)]


class DenoiseBuffer:
    """Bounded raw-audio buffer of ONE denoised stream, on the audio's
    device.

    Holds the raw vocoder samples a stream has produced but not yet
    denoise-emitted, plus the window margin.  Once the emit frontier has
    reached ``D`` no later window reads raw positions below ``D - n_fft``
    (the plan's ``f0`` never decreases), so the emitted prefix is dropped
    and a long stream never pins its whole waveform.  Reflect edges are
    built only for windows that touch a true signal edge (the left edge
    exists only before any trim, the right only on flush)."""

    def __init__(self, den: StreamingDenoiser):
        self.den = den
        self._parts: list = []
        self.start = 0          # absolute raw index of the buffer's head
        self.total = 0          # absolute raw samples appended so far

    def append(self, chunk) -> None:
        c = torch.as_tensor(chunk, dtype=torch.float32).reshape(-1)
        if c.numel():
            self._parts.append(c)
            self.total += c.numel()

    def _buf(self) -> torch.Tensor:
        if len(self._parts) != 1:
            self._parts = [torch.cat(self._parts) if self._parts
                           else torch.zeros((0,))]
        return self._parts[0]

    def window(self, f0: int, n_valid: int, flushed: bool) -> torch.Tensor:
        """Padded-signal samples ``[f0 * hop, f0 * hop + n_fft + hop *
        (n_valid - 1))``: what :meth:`StreamingDenoiser.fill_row` takes."""
        p = self.den.params
        hop, pad, n_fft = p.hop_length, self.den.pad, p.filter_length
        need = n_fft + hop * (n_valid - 1)
        lo = f0 * hop - pad                 # absolute raw coordinates
        hi = lo + need
        buf = self._buf()
        lpad = pad if lo < 0 else 0
        rpad = pad if (flushed and hi > self.total) else 0
        if lpad or rpad:
            # a true edge: trimming leaves the signal's head in the buffer
            # for the left one; the mirror image holds for any length
            if lpad and self.start:
                raise RuntimeError("the signal's head was trimmed")
            ext = _reflect_pad(buf, lpad, rpad)
            off = self.start - lpad
        else:
            ext, off = buf, self.start
        a = lo - off
        if not (0 <= a and a + need <= ext.shape[0]):
            raise RuntimeError(f"window [{lo}, {hi}) outside the buffer "
                               f"(start {self.start}, total {self.total})")
        return ext[a: a + need]

    def trim(self, emitted: int) -> None:
        """Drop samples no later window can read (with a hysteresis of a
        few windows, so the copy amortises)."""
        p = self.den.params
        keep_from = emitted - p.filter_length - p.hop_length
        if keep_from - self.start < 4 * self.den.l_pad:
            return
        self._parts = [self._buf()[keep_from - self.start:].clone()]
        self.start = keep_from


def denoise_stream(chunks, den: StreamingDenoiser, strength: float):
    """Wrap an iterator of audio chunks (1-D tensors on one device) with
    windowed denoising: yields bias-subtracted chunks whose concatenation
    equals the whole-utterance denoise of the concatenated input (fewer
    than ``n_fft`` samples of added latency mid-stream; the output ends at
    ``hop * (T // hop)`` like the offline ISTFT)."""
    hop, pad = den.params.hop_length, den.pad
    buf = DenoiseBuffer(den)
    emitted = 0

    def emit(flushed):
        nonlocal emitted
        outs = []
        for f0, nv, e0, e1 in den.plan(buf.total, emitted, flushed):
            win = buf.window(f0, nv, flushed)
            x = win.new_zeros((1, den.l_pad))
            corr = torch.ones((1, den.l_pad))
            den.fill_row(x[0], corr[0], win, nv)
            o = den(x, [strength], [nv], corr)
            outs.append(o[0, e0 + pad - f0 * hop: e1 + pad - f0 * hop])
            emitted = e1
        buf.trim(emitted)
        return torch.cat(outs) if outs else None

    for c in chunks:
        buf.append(c)
        out = emit(False)
        if out is not None and out.numel():
            yield out
    if buf.total:
        out = emit(True)
        if out is not None and out.numel():
            yield out
