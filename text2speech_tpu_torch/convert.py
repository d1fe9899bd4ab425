"""Bridge from the JAX package's variables to the port's modules.

The JAX package keeps flax variable trees; the port reads them either as
that nested dict of numpy arrays or as a flat ``.npz`` whose keys are the
``'/'``-joined flax paths of every leaf, e.g.
``params/decoder/attention_rnn/ih/kernel`` or ``batch_stats/postnet/bn4/
mean``.  A file holding both models prefixes them: ``tacotron/params/...``,
``tacotron/batch_stats/...``, ``waveglow/params/...``
(``export_torch_weights.py`` writes it).

Layout rules (``text2speech_tpu/convert.py:9-18`` run in reverse):

* flax Dense kernel [in, out]      -> ``nn.Linear`` weight [out, in]
* flax Conv kernel [k, in, out]    -> ``nn.Conv1d`` weight [out, in, k]
* LSTM gates (i, f, g, o) unchanged; ``ih``/``hh`` kernels transposed
* BatchNorm scale/bias + batch_stats mean/var -> weight/bias/running stats
* WaveGlow weight norm ``(v, g)`` is folded once here, as
  ``waveglow_fused.py:89 _fold``; WN convs keep the ``[k, in, out]``
  layout, and each flow's fused cond kernel [1, M, 2C * L] is cut into
  contiguous per-layer [M, 2C] blocks (``waveglow_fused.py:488``).
* The int8 vocoder's weights derive from the same ``WaveGlow`` module
  (``models/waveglow_fused.py::prepare_fused_int8``), so the file carries
  nothing more for them.  :func:`fused_int8_from_qparams` takes the JAX
  package's already-quantized tree instead, for holding the two
  quantizers against each other on bit-identical weights.
* The trainable WaveGlow keeps the flax names and layouts, weight norm
  unfolded: :func:`trainable_waveglow_from_variables` copies a tree in,
  :func:`variables_from_trainable` writes the flat ``params/...`` keys that
  :func:`waveglow_state_dict` and :func:`load_waveglow` read.  Prefixed
  with ``waveglow/`` they are the vocoder half of the ``.npz`` that
  ``infer.load_synthesizer`` reads.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import HParams, WaveGlowConfig

from .models.tacotron2 import Tacotron2
from .models.waveglow import TrainableWaveGlow, WaveGlow, fold_weightnorm
from .models.waveglow_fused import FusedWaveGlowInt8
from .ops.wn_block import fold_end, fold_first_taps
from .ops.wn_block_int8 import to_output_major


def flatten_tree(tree: Mapping, prefix: str = "") -> dict:
    """Nested dict of arrays -> {'a/b/c': np.ndarray}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key + "/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def save_npz(path: str, flat: Mapping) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def load_npz(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def sub_tree(flat: Mapping, prefix: str) -> dict:
    """The entries under ``prefix/``, with the prefix removed."""
    p = prefix.rstrip("/") + "/"
    return {k[len(p):]: v for k, v in flat.items() if k.startswith(p)}


def _as_flat(variables: Mapping) -> dict:
    if any(isinstance(v, Mapping) for v in variables.values()):
        return flatten_tree(variables)
    return dict(variables)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def tacotron_state_dict(variables: Mapping, hp: HParams,
                        num_speakers: int = 1) -> dict:
    """Tacotron2 flax variables -> the port's ``state_dict``."""
    f = _as_flat(variables)
    P, S = "params/", "batch_stats/"
    sd = {}

    def dense(dst, src, bias=True):
        sd[f"{dst}.weight"] = _t(f[f"{P}{src}/kernel"]).T.contiguous()
        if bias:
            sd[f"{dst}.bias"] = _t(f[f"{P}{src}/bias"])

    def conv(dst, src, bias=True):
        sd[f"{dst}.weight"] = _t(
            f[f"{P}{src}/Conv_0/kernel"].transpose(2, 1, 0))
        if bias:
            sd[f"{dst}.bias"] = _t(f[f"{P}{src}/Conv_0/bias"])

    def bn(dst, src):
        sd[f"{dst}.weight"] = _t(f[f"{P}{src}/scale"])
        sd[f"{dst}.bias"] = _t(f[f"{P}{src}/bias"])
        sd[f"{dst}.running_mean"] = _t(f[f"{S}{src}/mean"])
        sd[f"{dst}.running_var"] = _t(f[f"{S}{src}/var"])
        sd[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    def lstm(dst, src):
        dense(f"{dst}.ih", f"{src}/ih")
        dense(f"{dst}.hh", f"{src}/hh")

    sd["embedding.weight"] = _t(f[f"{P}embedding/embedding"])
    if num_speakers > 1:
        sd["speaker_embedding.weight"] = _t(
            f[f"{P}speaker_embedding/embedding"])
        dense("speaker_proj", "speaker_proj")
    for i in range(hp.enc_conv_num_layers):
        conv(f"encoder.convs.{i}", f"encoder/conv{i}")
        bn(f"encoder.bns.{i}", f"encoder/bn{i}")
    for d in ("fwd", "bwd"):
        lstm(f"encoder.bilstm.{d}", f"encoder/bilstm/{d}/LSTMCell_0")
    dense("decoder.prenet.fc0", "decoder/prenet/fc0", bias=False)
    dense("decoder.prenet.fc1", "decoder/prenet/fc1", bias=False)
    lstm("decoder.attention_rnn", "decoder/attention_rnn")
    lstm("decoder.decoder_rnn", "decoder/decoder_rnn")
    for n in ("query", "memory", "v", "loc_dense"):
        dense(f"decoder.attention.{n}", f"decoder/attention/{n}", bias=False)
    conv("decoder.attention.loc_conv", "decoder/attention/loc_conv",
         bias=False)
    dense("decoder.mel_proj", "decoder/mel_proj")
    dense("decoder.gate_proj", "decoder/gate_proj")
    for i in range(hp.postnet_n_convolutions):
        conv(f"postnet.convs.{i}", f"postnet/conv{i}")
        bn(f"postnet.bns.{i}", f"postnet/bn{i}")
    return sd


def waveglow_state_dict(variables: Mapping, cfg: WaveGlowConfig) -> dict:
    """WaveGlow flax variables -> the port's ``state_dict`` (weight norm
    folded, cond blocks sliced per layer)."""
    f = _as_flat(variables)
    C, L = cfg.wn_n_channels, cfg.wn_n_layers

    def folded(src):
        kernel = fold_weightnorm(_t(f[f"params/{src}/v"]),
                                 _t(f[f"params/{src}/g"]))
        return kernel, _t(f[f"params/{src}/bias"])

    sd = {"upsample_k": _t(f["params/upsample/kernel"]),
          "upsample_b": _t(f["params/upsample/bias"])}
    for k in range(cfg.n_flows):
        sd[f"convinv.{k}"] = _t(f[f"params/convinv{k}/W"])
        w = f"wn.{k}"
        start_k, sd[f"{w}.start_b"] = folded(f"wn{k}/start")
        sd[f"{w}.start_k"] = start_k[0]
        cond_k, cond_b = folded(f"wn{k}/cond")
        for li in range(L):
            cols = slice(2 * C * li, 2 * C * (li + 1))
            sd[f"{w}.cond_w.{li}"] = cond_k[0, :, cols].contiguous()
            sd[f"{w}.cond_b.{li}"] = cond_b[cols].contiguous()
            sd[f"{w}.in_w.{li}"], sd[f"{w}.in_b.{li}"] = folded(
                f"wn{k}/in{li}")
            rs_k, sd[f"{w}.rs_b.{li}"] = folded(f"wn{k}/res_skip{li}")
            sd[f"{w}.rs_w.{li}"] = rs_k[0]
        sd[f"{w}.end_w"] = _t(f[f"params/wn{k}/end/kernel"][0])
        sd[f"{w}.end_b"] = _t(f[f"params/wn{k}/end/bias"])
    return sd


def load_tacotron(variables: Mapping, hp: HParams, n_vocab: int,
                  num_speakers: int = 1, device=None) -> Tacotron2:
    model = Tacotron2(hp, n_vocab=n_vocab, num_speakers=num_speakers,
                      device=device)
    model.load_state_dict(tacotron_state_dict(variables, hp, num_speakers))
    return model.eval()


def load_waveglow(variables: Mapping, cfg: WaveGlowConfig,
                  device=None) -> WaveGlow:
    model = WaveGlow(cfg, device=device)
    model.load_state_dict(waveglow_state_dict(variables, cfg))
    return model.eval()


def trainable_waveglow_from_variables(variables: Mapping,
                                      cfg: WaveGlowConfig, device=None,
                                      **model_kwargs) -> TrainableWaveGlow:
    """WaveGlow flax variables (nested tree or flat ``params/...`` keys) ->
    the trainable module, weight norm left unfolded.  ``model_kwargs`` go
    to :class:`TrainableWaveGlow` (``compute_dtype``, ``remat``,
    ``gated``).  Raises when the tree's names or shapes are not the
    model's."""
    f = sub_tree(_as_flat(variables), "params")
    model = TrainableWaveGlow(cfg, device=device, **model_kwargs)
    if set(f) != set(model.params.keys()):
        odd = sorted(set(f) ^ set(model.params.keys()))
        raise ValueError(f"variables do not match the model's parameters: "
                         f"{odd[:8]}")
    with torch.no_grad():
        for name, p in model.params.items():
            value = _t(f[name])
            if value.shape != p.shape:
                raise ValueError(f"{name}: shape {tuple(value.shape)}, the "
                                 f"model's is {tuple(p.shape)}")
            p.copy_(value)
    return model


def variables_from_trainable(model: TrainableWaveGlow) -> dict:
    """The trainable module's parameters as flat ``params/<flax path>``
    numpy arrays (f32)."""
    return {f"params/{name}": p.detach().to("cpu", torch.float32).numpy()
            for name, p in model.params.items()}


def fused_int8_from_qparams(qparams: Mapping, cfg: WaveGlowConfig,
                            dtype: torch.dtype = torch.bfloat16,
                            device=None) -> FusedWaveGlowInt8:
    """The JAX package's ``quantize_waveglow_int8`` tree (nested dict of
    numpy arrays; bf16 leaves as ``ml_dtypes`` bf16 or already f32) -> the
    port's prepared int8 weights: the same int8 payloads (transposed to
    output-major), scales and biases, with the first layer's taps and the
    end projection folded as ``prepare_fused_int8`` folds them."""
    f = _as_flat(qparams)
    L = cfg.wn_n_layers

    def cw(key):
        return _t(f[key]).to(device=device, dtype=dtype).contiguous()

    def cf(key):
        return _t(f[key]).to(device).contiguous()

    def triple(key):
        q = torch.from_numpy(np.array(f[f"{key}/q"], dtype=np.int8))
        return (to_output_major(q).to(device), cf(f"{key}/s"),
                cf(f"{key}/b"))

    flows = []
    for k in range(cfg.n_flows):
        w = f"wn{k}"
        start_k, start_b = cw(f"{w}/start_k"), cf(f"{w}/start_b")
        end_w = cw(f"{w}/end/w")
        flows.append({
            "start_k": start_k, "start_b": start_b,
            "first": fold_first_taps(start_k, start_b, cw(f"{w}/w_in0"),
                                     cf(f"{w}/b_in0")),
            "cond": [triple(f"{w}/cond{li}") for li in range(L)],
            "in": [None] + [triple(f"{w}/in{li}") for li in range(1, L)],
            "rs": [triple(f"{w}/rs{li}") for li in range(L - 1)],
            "final": fold_end(cw(f"{w}/rs_last/w"), cf(f"{w}/rs_last/b"),
                              end_w, cf(f"{w}/end/b")),
            "end_w": end_w,
            "w_inv": torch.linalg.inv(cf(f"convinv{k}/W")),
        })
    return FusedWaveGlowInt8(cfg, dtype, cw("upsample/kernel"),
                             cf("upsample/bias"), flows)
