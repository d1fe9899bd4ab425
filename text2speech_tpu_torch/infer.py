"""End-to-end synthesis: text -> mel (Tacotron-2) -> waveform (WaveGlow) ->
denoiser -> PCM16 WAV (counterpart of ``text2speech_tpu/infer.py:325-700``,
the offline path).

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

from text2speech_tpu.config import HParams, WaveGlowConfig
from text2speech_tpu.text import N_SYMBOLS, encode_batch

from .dsp.audio import save_wav
from .models.denoiser import make_denoiser_programs
from .models.tacotron2 import Tacotron2
from .models.waveglow import WaveGlow
from .models.waveglow_fused import infer_fused, prepare_fused


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


@dataclass
class Synthesizer:
    """Text-to-speech with a loaded Tacotron-2 and WaveGlow on one device.

    ``use_fused_vocoder`` vocodes through the fused WN-layer kernels in
    bf16 (:func:`..models.waveglow_fused.infer_fused`, weights prepared
    once into :attr:`fused`); otherwise through the plain f32
    :meth:`WaveGlow.infer`.
    ``use_denoiser`` builds the bias-spectrum denoiser
    (``denoiser_kwargs`` override its STFT size)."""

    hp: HParams
    taco: Tacotron2
    wg_cfg: WaveGlowConfig
    waveglow: WaveGlow
    use_denoiser: bool = True
    use_fused_vocoder: bool = False
    denoiser_kwargs: dict | None = None

    def __post_init__(self):
        self.device = self.waveglow.upsample_k.device
        self.fused = (prepare_fused(self.waveglow, torch.bfloat16)
                      if self.use_fused_vocoder else None)
        self._denoise = None
        if self.use_denoiser:
            bias_fn, denoise, _ = make_denoiser_programs(
                self.waveglow, **(self.denoiser_kwargs or {}))
            self._denoise_bias = bias_fn()
            self._denoise = lambda audio, strength: denoise(
                audio, self._denoise_bias, strength)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    @torch.inference_mode()
    def text_to_mel(self, texts, seed: int = 0, max_steps: int | None = None,
                    speaker_id=None, keep_masks: torch.Tensor | None = None):
        """list[str] -> (mel_post [B, n_mel, T], out_lengths [B])."""
        ids, lengths = encode_batch(texts)
        sid = speaker_ids_array(speaker_id, ids.shape[0],
                                self.taco.num_speakers)
        _, mel_post, _, _, out_lengths = self.taco.inference(
            torch.from_numpy(ids).long().to(self.device),
            speaker_ids=(None if sid is None
                         else torch.from_numpy(sid).long().to(self.device)),
            text_lengths=torch.from_numpy(lengths).to(self.device),
            max_steps=max_steps, keep_masks=keep_masks,
            generator=self._generator(seed))
        return mel_post, out_lengths

    @torch.inference_mode()
    def mel_to_audio(self, mel: torch.Tensor, sigma: float = 0.666,
                     seed: int = 0, denoiser_strength: float = 0.0,
                     noise: tuple | None = None) -> torch.Tensor:
        """mel [B, n_mel, T] -> audio [B, T * upsample_stride] f32."""
        gen = self._generator(seed + 1)
        if self.fused is not None:
            audio = infer_fused(self.fused, mel, sigma, noise=noise,
                                generator=gen)
        else:
            audio = self.waveglow.infer(mel, sigma, noise=noise,
                                        generator=gen)
        if denoiser_strength > 0 and self._denoise is not None:
            audio = self._denoise(audio, denoiser_strength)
        return audio

    def synthesize(self, texts, sigma: float = 0.666, seed: int = 0,
                   denoiser_strength: float = 0.0,
                   max_steps: int | None = None, speaker_id=None,
                   keep_masks: torch.Tensor | None = None,
                   noise: tuple | None = None) -> list:
        """list[str] -> list of float32 numpy waveforms, each cut to its
        utterance's length (out_length * upsample_stride samples)."""
        mel_post, out_lengths = self.text_to_mel(
            texts, seed, max_steps, speaker_id=speaker_id,
            keep_masks=keep_masks)
        lens = out_lengths.cpu().numpy()
        T = int(lens.max())
        audio = self.mel_to_audio(mel_post[:, :, :T].contiguous(), sigma,
                                  seed, denoiser_strength, noise=noise)
        audio = audio.cpu().numpy()
        hop = self.wg_cfg.upsample_stride
        return [audio[i, : int(lens[i]) * hop] for i in range(len(lens))]

    def synthesize_to_files(self, texts, paths, sample_rate=None, **kw):
        sr = sample_rate or self.wg_cfg.sampling_rate
        wavs = self.synthesize(texts, **kw)
        for wav, path in zip(wavs, paths):
            save_wav(wav, path, sr)
        return wavs


def load_synthesizer(hp: HParams, weights_npz: str, wg_cfg: WaveGlowConfig,
                     use_denoiser: bool = True, num_speakers: int = 1,
                     use_fused_vocoder: bool = False,
                     device: str | torch.device = "cuda") -> Synthesizer:
    """Build a Synthesizer from the ``.npz`` that ``export_torch_weights.py``
    writes (``tacotron/...`` and ``waveglow/...`` flax paths)."""
    from .convert import load_npz, load_tacotron, load_waveglow, sub_tree

    flat = load_npz(weights_npz)
    taco = load_tacotron(sub_tree(flat, "tacotron"), hp, N_SYMBOLS,
                         num_speakers, device=device)
    wg = load_waveglow(sub_tree(flat, "waveglow"), wg_cfg, device=device)
    return Synthesizer(hp, taco, wg_cfg, wg, use_denoiser=use_denoiser,
                       use_fused_vocoder=use_fused_vocoder)


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
                       use_fused_vocoder: bool = True) -> Synthesizer:
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
                       use_fused_vocoder=use_fused_vocoder)
