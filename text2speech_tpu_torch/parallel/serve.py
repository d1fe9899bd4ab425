"""Full-chain tensor-parallel serving: text -> mel -> waveform (counterpart
of ``text2speech_tpu/parallel/serve.py``).

The two tensor-parallel endpoints over one placement of the ranks:

* the encoder, the memory projection and the postnet are replicated (small
  conv and LSTM stacks; sharding them would add collectives for nothing);
* the autoregressive decode runs through :class:`.tp_tacotron.
  TPTacotronDecoder` (LSTM kernels split by hidden unit, two hidden-state
  gathers a step);
* the vocoder through :class:`.tp.TPWaveGlowServer`'s fused path (the
  partial WN-layer kernels, one sum over ranks a layer).

The ranks live as the two endpoints place them: ``n_model`` shards in one
process, a ``torch.distributed`` group of model ranks, or a data x model
:class:`.mesh.Mesh`.  Under a group every rank calls the same methods with
the same arguments and gets the same results.

Randomness is the port's ``Synthesizer``'s: the prenet keep-masks are drawn
at the GLOBAL batch shape from a generator seeded ``seed``
(``Decoder.draw_keep_masks``), and a rank of a data axis takes its rows of
them, so a row's mel does not depend on how many data ranks there are; the
vocoder noise comes from a generator seeded ``seed + 1``.  Both are
injectable (``keep_masks=``, ``noise=``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import HParams, WaveGlowConfig
from ..models.tacotron2 import Tacotron2
from ..models.tacotron_serve import extract_decoder_params
from ..models.waveglow import WaveGlow
from ..text import encode_batch
from .mesh import DATA_AXIS, MODEL_AXIS
from .tp import TPWaveGlowServer
from .tp_tacotron import TPTacotronDecoder


@dataclass
class TPSynthesizer:
    """Tensor-parallel text-to-speech over a loaded Tacotron-2 and WaveGlow
    (``serve.py:40 TPSynthesizer``).

    Give ``n_model`` (every shard in this process, on the models' device),
    ``group`` (a process group of model ranks) or ``mesh`` (a
    :class:`.mesh.Mesh` with a ``model`` axis and maybe a ``data`` axis).
    ``int8`` serves the vocoder's layers 1..L-1 through the int8 partial
    kernel, and the decoder in int8 where
    :func:`..models.tacotron_serve.int8_decode_worthwhile` says it pays.
    ``compute_dtype`` is both stages' product type: default bf16 on a GPU
    and f32 on the CPU."""

    hp: HParams
    taco: Tacotron2
    wg_cfg: WaveGlowConfig
    waveglow: WaveGlow
    n_model: int | None = None
    group: object = None
    mesh: object = None
    int8: bool = False
    chunk_steps: int = 64
    compute_dtype: torch.dtype | None = None

    def __post_init__(self):
        if sum(x is not None for x in (self.n_model, self.group,
                                       self.mesh)) != 1:
            raise ValueError("give one of n_model, group and mesh")
        self.device = self.waveglow.upsample_k.device
        if self.compute_dtype is None:
            self.compute_dtype = (torch.bfloat16 if self.device.type == "cuda"
                                  else torch.float32)
        self._dp = extract_decoder_params(self.taco)
        # endpoints keyed by (data axis used, int8 decode) and built on
        # first use: a batch the data axis does not split (B = 1 streaming
        # on a data x model mesh) gets model-only endpoints
        self._decoders: dict = {}
        self._vocoders: dict = {}
        self._denoise_biases: dict = {}

    @property
    def lockstep_groups(self) -> list:
        """The process groups whose ranks must run every call together."""
        if self.mesh is not None:
            return [self.mesh.group(ax) for ax in self.mesh.axis_names
                    if self.mesh.size(ax) > 1]
        return [] if self.group is None else [self.group]

    def _placement(self, data: bool) -> dict:
        if data:
            return {"mesh": self.mesh}
        if self.mesh is not None:
            return {"group": self.mesh.group(MODEL_AXIS)}
        if self.group is not None:
            return {"group": self.group}
        return {"n_model": self.n_model}

    def _endpoints(self, B: int):
        """(decoder, vocoder) for a batch of ``B``: data-sharded when the
        mesh's data axis has more than one rank and divides ``B``, else
        model-only (every data rank runs the whole batch with its model
        group).  With ``int8`` the vocoder is always int8; the decoder
        follows :func:`..models.tacotron_serve.int8_decode_worthwhile`."""
        from ..models.tacotron_serve import int8_decode_worthwhile

        nd = self.mesh.size(DATA_AXIS) if self.mesh is not None else 1
        data = nd > 1 and B % nd == 0
        int8_dec = self.int8 and int8_decode_worthwhile(B)
        if (data, int8_dec) not in self._decoders:
            self._decoders[data, int8_dec] = TPTacotronDecoder(
                self._dp, self.hp, int8=int8_dec, dtype=self.compute_dtype,
                **self._placement(data))
        if data not in self._vocoders:
            self._vocoders[data] = TPWaveGlowServer(
                self.waveglow, fused=True, int8=self.int8,
                compute_dtype=self.compute_dtype, **self._placement(data))
        return self._decoders[data, int8_dec], self._vocoders[data]

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def denoise_bias(self, denoiser_kwargs: dict | None = None):
        """The denoiser's bias spectrum for one configuration, computed
        once and cached BY CONFIGURATION (the streaming path and
        ``make_server_tp`` may use different STFT sizes at once).  Returns
        the cache key; the bias is ``self._denoise_biases[key]``."""
        from ..models.denoiser import make_denoiser

        kw = denoiser_kwargs or {}
        key = tuple(sorted(kw.items()))
        if key not in self._denoise_biases:
            self._denoise_biases[key] = make_denoiser(self.waveglow, **kw)[0]
        return key

    def _mel_stream(self, texts, seed: int, max_steps: int | None,
                    chunk_steps: int | None = None, speaker_id=None,
                    keep_masks: torch.Tensor | None = None):
        """The chunked decode through the tensor-parallel decoder
        (:func:`..infer.chunked_mel_stream`) -> (generator, requested,
        B)."""
        from ..infer import chunked_mel_stream, speaker_ids_array

        texts = [texts] if isinstance(texts, str) else texts
        ids, lengths = encode_batch(texts)
        sid = speaker_ids_array(speaker_id, ids.shape[0],
                                self.taco.num_speakers)
        dev = self.device
        lengths_t = torch.from_numpy(lengths).to(dev)
        memory = self.taco.encode(
            torch.from_numpy(ids).long().to(dev),
            speaker_ids=(None if sid is None
                         else torch.from_numpy(sid).long().to(dev)),
            text_lengths=lengths_t)
        pmem = self.taco.process_memory(memory)
        B = memory.shape[0]
        decoder, _ = self._endpoints(B)
        requested = max_steps or self.hp.max_decoder_steps
        cs = chunk_steps or self.chunk_steps
        limit = -(-requested // cs) * cs
        if keep_masks is None:
            keep_masks = self.taco.decoder.draw_keep_masks(
                limit, B, self._generator(seed), dev)

        def decode_fn(carry, masks):
            carry, mel_c, _, _, active = decoder(memory, pmem, *carry, masks,
                                                 lengths_t)
            return carry, mel_c, active

        gen = chunked_mel_stream(
            self.hp, decoder.initial_carry(memory), decode_fn,
            self.taco.postnet_residual, requested, cs, keep_masks)
        return gen, requested, B

    @torch.inference_mode()
    def text_to_mel_stream(self, texts, chunk_steps: int | None = None,
                           seed: int = 0, max_steps: int | None = None,
                           speaker_id=None,
                           keep_masks: torch.Tensor | None = None):
        """Incremental text -> mel: yields ``(mel_post_chunk [B, n_mel, n],
        out_lengths_so_far np.int64 [B], final)`` as the decoder advances
        (``Synthesizer.text_to_mel_stream``'s contract)."""
        gen, _, _ = self._mel_stream(texts, seed, max_steps, chunk_steps,
                                     speaker_id, keep_masks)
        yield from gen

    @torch.inference_mode()
    def synthesize_incremental(self, text: str, sigma: float = 0.666,
                               seed: int = 0, chunk_steps: int | None = None,
                               max_steps: int | None = None,
                               denoiser_strength: float = 0.0,
                               denoiser_kwargs: dict | None = None,
                               speaker_id: int | None = None,
                               keep_masks: torch.Tensor | None = None,
                               noise=None):
        """Stream ONE utterance's audio through both tensor-parallel stages:
        the chunked decode feeding receptive-field vocoder windows over one
        noise stream (:func:`..infer.incremental_vocode_stream`).  Yields
        float32 numpy chunks.  ``denoiser_strength > 0`` streams the
        bias-subtracted audio (the bias cached per ``denoiser_kwargs``)."""
        from ..infer import incremental_vocode_stream
        from ..models.denoiser import (cached_stream_denoiser,
                                       denoise_stream, denoiser_stft_params)

        cs = chunk_steps or self.chunk_steps
        gen, _, _ = self._mel_stream(text, seed, max_steps, cs, speaker_id,
                                     keep_masks)
        _, vocoder = self._endpoints(1)
        audio = incremental_vocode_stream(
            self.wg_cfg, gen, lambda mel, nz, sg: vocoder(mel, sg, noise=nz),
            sigma, seed, cs, noise=noise)
        if denoiser_strength > 0:
            kw = denoiser_kwargs or {}
            bkey = self.denoise_bias(kw)
            den = cached_stream_denoiser(
                self, (bkey, cs), lambda: self._denoise_biases[bkey],
                denoiser_stft_params(**kw), cs, self.wg_cfg.upsample_stride)
            audio = denoise_stream(audio, den, denoiser_strength)
        for chunk in audio:
            yield chunk.cpu().numpy()

    @torch.inference_mode()
    def synthesize_incremental_batch(self, texts, sigma: float = 0.666,
                                     seed: int = 0,
                                     chunk_steps: int | None = None,
                                     max_steps: int | None = None,
                                     speaker_id=None,
                                     keep_masks: torch.Tensor | None = None,
                                     noise=None):
        """N concurrent streams, yielding ``(row, float32 numpy chunk)``
        pairs (:func:`..infer.incremental_vocode_stream_batch`): one
        lockstep decode drives every row, each emission round is one
        vocoder call on the stacked windows.  The engine's exact pass of a
        row shorter than one window is a batch of one, which a data axis
        cannot split: it goes to the model-only vocoder."""
        from ..infer import incremental_vocode_stream_batch

        cs = chunk_steps or self.chunk_steps
        gen, _, B = self._mel_stream(texts, seed, max_steps, cs, speaker_id,
                                     keep_masks)
        _, vocoder = self._endpoints(B)
        _, vocoder1 = self._endpoints(1)

        def vocode(mel, nz, sg):
            return (vocoder1 if mel.shape[0] == 1 else vocoder)(
                mel, sg, noise=nz)

        for row, chunk in incremental_vocode_stream_batch(
                self.wg_cfg, gen, vocode, sigma, seed, cs, noise=noise):
            yield row, chunk.cpu().numpy()

    @torch.inference_mode()
    def text_to_mel(self, texts, seed: int = 0, max_steps: int | None = None,
                    speaker_id=None, keep_masks: torch.Tensor | None = None):
        """list[str] -> (mel_post [B, n_mel, requested], out_lengths [B]):
        the chunked decode with its early exit, frames past each row's stop
        zeroed and the mel padded to ``requested`` frames, as
        ``Synthesizer.text_to_mel`` returns it."""
        gen, requested, B = self._mel_stream(texts, seed, max_steps,
                                             speaker_id=speaker_id,
                                             keep_masks=keep_masks)
        chunks, out_len = [], np.zeros((B,), np.int64)
        for post_c, out_len, _final in gen:
            chunks.append(post_c)
        mel = torch.cat(chunks, dim=-1)
        if mel.shape[-1] < requested:           # every gate fired early
            mel = torch.nn.functional.pad(
                mel, (0, requested - mel.shape[-1]))
        lengths = torch.from_numpy(out_len.astype(np.int32)).to(mel.device)
        valid = torch.arange(requested, device=mel.device)[None, :] \
            < lengths[:, None]
        return torch.where(valid[:, None, :], mel, 0.0), lengths

    @torch.inference_mode()
    def mel_to_audio(self, mel: torch.Tensor, sigma: float = 0.666,
                     seed: int = 0,
                     noise: tuple | None = None) -> torch.Tensor:
        """mel [B, n_mel, T] -> audio [B, T * upsample_stride] f32, the
        noise from a generator seeded ``seed + 1`` unless given."""
        _, vocoder = self._endpoints(mel.shape[0])
        return vocoder(mel.to(self.device), sigma, noise=noise,
                       generator=self._generator(seed + 1))

    def synthesize(self, texts, sigma: float = 0.666, seed: int = 0,
                   max_steps: int | None = None, speaker_id=None,
                   keep_masks: torch.Tensor | None = None,
                   noise: tuple | None = None) -> list:
        """list[str] -> list of float32 numpy waveforms, each cut to its
        utterance's length (``Synthesizer.synthesize`` without the
        denoiser, as the JAX package's)."""
        mel, lengths = self.text_to_mel(texts, seed, max_steps,
                                        speaker_id=speaker_id,
                                        keep_masks=keep_masks)
        lens = lengths.cpu().numpy()
        T = int(lens.max()) or 1
        audio = self.mel_to_audio(mel[:, :, :T].contiguous(), sigma, seed,
                                  noise=noise).cpu().numpy()
        hop = self.wg_cfg.upsample_stride
        return [audio[i, : int(lens[i]) * hop] for i in range(len(lens))]
