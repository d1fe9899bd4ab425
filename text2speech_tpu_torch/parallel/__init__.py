"""Data and tensor parallelism over ``torch.distributed`` groups
(counterpart of ``text2speech_tpu/parallel``)."""
from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    gather_cols,
    gather_rows,
    initialize_distributed,
    make_data_mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from .tp import (  # noqa: F401
    TPWaveGlowServer,
    infer_waveglow_tp,
    shard_waveglow_params,
)
from .serve import TPSynthesizer  # noqa: F401
from .tp_tacotron import (  # noqa: F401
    TPTacotronDecoder,
    shard_decoder_params,
)
