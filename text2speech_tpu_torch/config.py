"""Typed, frozen hyper-parameter configuration.

The reference keeps one global mutable dict of ~120 keys (``hparams.py:2-172`` in
the reference repository) that mixes live keys, dead WaveNet-era keys, and keys the DSP code
expects under *different names* (``fft_size``/``hop_size``/``win_size``/``num_mels`` read
by ``utils/audio.py:62,220-221`` but never defined).  Here the live keys become one
frozen dataclass; the legacy names are accepted as aliases so reference-style configs
load unchanged, and the missing-key crash is fixed by construction.

The port's own copy of the JAX package's ``config.py``: field names and
defaults are held equal by ``tests/test_torch_config_text.py``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Mapping


# Legacy key names (reference hparams.py / utils/audio.py) -> canonical field name.
_ALIASES = {
    "fft_size": "filter_length",
    "num_freq": None,          # derived: filter_length (as n_fft), ignore on load
    "hop_size": "hop_length",
    "win_size": "win_length",
    "num_mels": "n_mel_channels",
    "fmin": "mel_fmin",
    "fmax": "mel_fmax",
    "sampling_rate": "sample_rate",
}


@dataclass(frozen=True)
class HParams:
    """Union of the reference's *live* hyper-parameters (see SURVEY.md §2 #1).

    Field names follow ``reference/hparams.py``; audio-DSP aliases from
    ``reference/utils/audio.py`` are accepted via :meth:`from_dict`.
    """

    name: str = "Tacotron-WaveGlow-TPU"
    cleaners: str = "korean_cleaners"

    # --- optimizer (hparams.py:10-11, train.py:62-67) ---
    learning_rate: float = 1e-4
    weight_decay: float = 1e-6
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    warmup_steps: int = 4000          # Noam warmup (train.py:62-67)
    grad_clip_norm: float = 1.0       # train.py:228 clips at 1.0

    # --- audio (hparams.py:13-20) ---
    max_wav_value: float = 32768.0
    sample_rate: int = 44800
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0

    batch_size: int = 32

    # --- offline DSP chain (hparams.py:24-42, utils/audio.py) ---
    preemphasize: bool = False
    preemphasis: float = 0.97
    min_level_db: int = -100
    ref_level_db: int = 20
    signal_normalization: bool = False
    allow_clipping_in_normalization: bool = False
    symmetric_mels: bool = True
    max_abs_value: float = 4.0
    rescaling: bool = True
    rescaling_max: float = 1.0        # reference sets True (==1.0); numeric here
    trim_silence: bool = True
    trim_fft_size: int = 512
    trim_hop_size: int = 128
    trim_top_db: int = 23
    clip_mels_length: bool = True
    max_mel_frames: int = 1000
    input_type: str = "raw"           # raw | mulaw | mulaw-quantize
    quantize_channels: int = 256
    silence_threshold: int = 0
    griffin_lim_iters: int = 60
    power: float = 1.5

    # --- model: encoder (hparams.py:98-114) ---
    embedding_size: int = 512
    speaker_embedding_size: int = 16
    enc_conv_num_layers: int = 3
    enc_conv_kernel_size: int = 5
    enc_conv_channels: int = 512
    dropout_prob: float = 0.5

    # --- model: decoder (hparams.py:116-131) ---
    n_frames_per_step: int = 1
    decoder_rnn_dim: int = 1024
    prenet_dim: int = 256
    max_decoder_steps: int = 1000
    gate_threshold: float = 0.5
    p_attention_dropout: float = 0.1
    p_decoder_dropout: float = 0.1
    attention_rnn_dim: int = 1024
    attention_dim: int = 128
    attention_location_n_filters: int = 32
    attention_location_kernel_size: int = 31

    # --- model: postnet (hparams.py:146-148) ---
    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_n_convolutions: int = 5

    linear_dim: int = 1025            # filter_length // 2 + 1
    mask_padding: bool = True

    # --- runtime ---
    seed: int = 999                   # tacotron/tacotron.py:10
    checkpoint_interval: int = 2000
    compute_dtype: str = "bfloat16"   # MXU-native; fp32 islands where invertibility matters
    param_dtype: str = "float32"

    # ---- derived ----
    @property
    def n_fft(self) -> int:
        return self.filter_length

    @property
    def n_freq(self) -> int:
        return self.filter_length // 2 + 1

    @property
    def frame_shift_ms(self) -> float:
        return self.hop_length * 1000.0 / self.sample_rate

    @property
    def frame_length_ms(self) -> float:
        return self.win_length * 1000.0 / self.sample_rate

    # ---- serde ----
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> "HParams":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "HParams":
        fields = {f.name for f in dataclasses.fields(cls)}
        out: dict[str, Any] = {}
        for k, v in d.items():
            if k in _ALIASES:
                k2 = _ALIASES[k]
                if k2 is None:
                    continue
                k = k2
            if k in fields:
                if k == "rescaling_max" and isinstance(v, bool):
                    v = 1.0 if v else 0.0  # reference stores True (hparams.py:34)
                out[k] = v
        return cls(**out)

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2, ensure_ascii=False)

    @classmethod
    def load(cls, path: str) -> "HParams":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


@dataclass(frozen=True)
class WaveGlowConfig:
    """Vocoder architecture + training config (waveglow/config.json:1-39)."""

    n_mel_channels: int = 80
    n_flows: int = 12
    n_group: int = 8
    n_early_every: int = 4
    n_early_size: int = 2
    wn_n_layers: int = 8
    wn_n_channels: int = 512
    wn_kernel_size: int = 3

    # training (train_config block)
    learning_rate: float = 1e-4
    sigma: float = 1.0
    iters_per_checkpoint: int = 2000
    batch_size: int = 3
    seed: int = 1234
    epochs: int = 100000

    # data (data_config block)
    segment_length: int = 16000
    sampling_rate: int = 22050
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0

    upsample_kernel: int = 1024
    upsample_stride: int = 256

    @property
    def n_remaining_channels(self) -> int:
        n = self.n_group
        for k in range(self.n_flows):
            if k % self.n_early_every == 0 and k > 0:
                n -= self.n_early_size
        return n

    @classmethod
    def from_json(cls, path: str) -> "WaveGlowConfig":
        """Load a reference-style 4-block config.json (waveglow/train.py:147-157)."""
        with open(path, encoding="utf-8") as f:
            blocks = json.load(f)
        kw: dict[str, Any] = {}
        fields = {f.name for f in dataclasses.fields(cls)}
        for block in ("train_config", "data_config"):
            for k, v in blocks.get(block, {}).items():
                if k in fields:
                    kw[k] = v
        wg = blocks.get("waveglow_config", {})
        for k, v in wg.items():
            if k == "WN_config":
                kw["wn_n_layers"] = v.get("n_layers", 8)
                kw["wn_n_channels"] = v.get("n_channels", 512)
                kw["wn_kernel_size"] = v.get("kernel_size", 3)
            elif k in fields:
                kw[k] = v
        return cls(**kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


DEFAULT_HPARAMS = HParams()
