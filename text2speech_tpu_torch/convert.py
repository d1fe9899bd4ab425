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
* A trainable Tacotron is the same module: :func:`trainable_tacotron_from_
  variables` reads a JAX ``{"params", "batch_stats"}`` tree into one, and
  :func:`variables_from_tacotron` writes a port model back into the flat
  flax keys (both through :func:`tacotron_layout`).
* WaveGlow weight norm ``(v, g)`` is folded once here, as
  ``waveglow_fused.py:89 _fold``; WN convs keep the ``[k, in, out]``
  layout, and each flow's fused cond kernel [1, M, 2C * L] is cut into
  contiguous per-layer [M, 2C] blocks (``waveglow_fused.py:488``).
* The int8 vocoder's weights derive from the same ``WaveGlow`` module
  (``models/waveglow_fused.py::prepare_fused_int8``), so the file carries
  nothing more for them.  :func:`fused_int8_from_qparams` takes the JAX
  package's already-quantized tree instead, for holding the two
  quantizers against each other on bit-identical weights.
* The composed-conditioning weights derive from the ``WaveGlow`` module
  too (``models/waveglow_fused.py::precompute_composed_cond``), in the JAX
  dict's own layout.
* The serving decoder's dict (``models/tacotron_serve.py``) holds the
  module's own parameters; :func:`decoder_params_from_jax` maps the JAX
  package's ``extract_decoder_params`` / ``quantize_decoder_params`` dict
  onto it instead (kernels transposed to ``[out, in]``, int8 payloads
  carried over bit for bit).
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


def tacotron_layout(hp: HParams, num_speakers: int = 1) -> list:
    """Every Tacotron leaf as (the port's ``state_dict`` key, the flat flax
    key, kind): kind ``dense`` (kernel [in, out] <-> weight [out, in]),
    ``conv`` ([k, in, out] <-> [out, in, k]) or ``copy``."""
    out = []

    def dense(dst, src, bias=True):
        out.append((f"{dst}.weight", f"params/{src}/kernel", "dense"))
        if bias:
            out.append((f"{dst}.bias", f"params/{src}/bias", "copy"))

    def conv(dst, src, bias=True):
        out.append((f"{dst}.weight", f"params/{src}/Conv_0/kernel", "conv"))
        if bias:
            out.append((f"{dst}.bias", f"params/{src}/Conv_0/bias", "copy"))

    def bn(dst, src):
        out.extend([(f"{dst}.weight", f"params/{src}/scale", "copy"),
                    (f"{dst}.bias", f"params/{src}/bias", "copy"),
                    (f"{dst}.running_mean", f"batch_stats/{src}/mean", "copy"),
                    (f"{dst}.running_var", f"batch_stats/{src}/var", "copy")])

    def lstm(dst, src):
        dense(f"{dst}.ih", f"{src}/ih")
        dense(f"{dst}.hh", f"{src}/hh")

    out.append(("embedding.weight", "params/embedding/embedding", "copy"))
    if num_speakers > 1:
        out.append(("speaker_embedding.weight",
                    "params/speaker_embedding/embedding", "copy"))
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
    return out


def to_port_layout(a, kind: str) -> torch.Tensor:
    """One flax leaf -> the port's tensor (f32)."""
    t = _t(a)
    if kind == "dense":
        return t.T.contiguous()
    if kind == "conv":
        return t.permute(2, 1, 0).contiguous()
    return t


def to_flax_layout(t: torch.Tensor, kind: str) -> np.ndarray:
    """One port tensor -> the flax leaf (f32 numpy)."""
    a = t.detach().to("cpu", torch.float32)
    if kind == "dense":
        a = a.T
    elif kind == "conv":
        a = a.permute(2, 1, 0)
    return np.ascontiguousarray(a.numpy())


def tacotron_state_dict(variables: Mapping, hp: HParams,
                        num_speakers: int = 1) -> dict:
    """Tacotron2 flax variables -> the port's ``state_dict``."""
    f = _as_flat(variables)
    sd = {}
    for dst, src, kind in tacotron_layout(hp, num_speakers):
        sd[dst] = to_port_layout(f[src], kind)
        if dst.endswith(".running_mean"):
            sd[dst.replace("running_mean", "num_batches_tracked")] = \
                torch.tensor(0)
    return sd


def variables_from_tacotron(model: Tacotron2) -> dict:
    """A port Tacotron's parameters and running statistics as flat flax
    variables (``params/...`` and ``batch_stats/...`` f32 numpy arrays):
    what :func:`load_tacotron` and the JAX package read."""
    sd = model.state_dict()
    return {src: to_flax_layout(sd[dst], kind) for dst, src, kind in
            tacotron_layout(model.hp, model.num_speakers)}


def trainable_tacotron_from_variables(variables: Mapping, hp: HParams,
                                      n_vocab: int, num_speakers: int = 1,
                                      device=None,
                                      **model_kwargs) -> Tacotron2:
    """JAX ``{"params", "batch_stats"}`` (nested or flat) -> a port
    Tacotron to train (``model_kwargs``: ``compute_dtype``,
    ``decoder_remat``)."""
    model = Tacotron2(hp, n_vocab=n_vocab, num_speakers=num_speakers,
                      device=device, **model_kwargs)
    model.load_state_dict(tacotron_state_dict(variables, hp, num_speakers))
    return model


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


def decoder_params_from_jax(dp: Mapping, device=None) -> dict:
    """The JAX package's serving-decoder dict (``tacotron_serve.py``:
    ``extract_decoder_params``, optionally through
    ``quantize_decoder_params``; numpy leaves) -> the port's
    (``models/tacotron_serve.py``): dense kernels [in, out] -> [out, in],
    the location conv [k, in, out] -> [out, in, k], biases as they are; a
    quantized kernel ``{"q" int8 [in, out], "s" [out]}`` keeps its payload
    and scales, transposed."""
    def dense(w):
        w = np.asarray(w)
        if w.ndim == 3:
            return _t(w.transpose(2, 1, 0)).to(device).contiguous()
        return _t(w.T if w.ndim == 2 else w).to(device).contiguous()

    out = {}
    for k, v in dp.items():
        if isinstance(v, Mapping):
            q = torch.from_numpy(np.array(v["q"], dtype=np.int8))
            out[k] = {"q": q.T.contiguous().to(device),
                      "s": _t(v["s"]).to(device)}
        else:
            out[k] = dense(v)
    return out
