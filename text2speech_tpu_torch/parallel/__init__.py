"""Tensor parallelism over ``torch.distributed`` groups (counterpart of
``text2speech_tpu/parallel``; only the tensor-parallel vocoder is ported)."""
from .tp import (  # noqa: F401
    TPWaveGlowServer,
    infer_waveglow_tp,
    shard_waveglow_params,
)
