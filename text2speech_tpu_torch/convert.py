"""Bridges into the port's modules: from the JAX package's variables, and
from reference PyTorch checkpoints (below).

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

Reference checkpoints (``text2speech_tpu/convert.py``'s loaders, kept here
as the port's own copy): a torch ``state_dict`` of the reference Tacotron
(``train.py:69-75`` format) or WaveGlow (``waveglow/train.py:52-60``) maps
weight for weight onto the same flax-layout trees of numpy arrays, which
the bridges above take into the port's modules.

* torch Linear  [out, in]        -> flax Dense kernel [in, out]
* torch Conv1d  [out, in, k]     -> flax Conv kernel  [k, in, out]
* torch ConvT1d [in, out, k]     -> SubpixelUpsample  [k, in, out]
* torch LSTM(Cell) gates (i, f, g, o) as they are; ``weight_ih`` [4H, in]
  -> ``ih/kernel`` transposed
* torch weight_norm (``weight_g`` [out, 1, 1], ``weight_v`` [out, in, k])
  -> (g [out], v [k, in, out]); a plain ``weight`` (after
  ``remove_weightnorm``) folds to v = weight, g = ||v||, so the kernel is
  the weight again
* pre-fusion WaveGlow checkpoints (separate res / skip convs) are fused by
  a channel concat, as the reference's ``convert_model.update_model``
  (``convert_model.py:11-38``).

VITS checkpoints (jaywalnut310/vits ``SynthesizerTrn``) go straight into
the port's module (:func:`vits_module_from_torch`), which has no JAX
counterpart: q, k and v concatenated, 1x1 kernels as [out, in], weight
norm folded over every dimension but the first (a transposed conv's
input channels), the training-only leaves skipped.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping

import numpy as np
import torch

from .config import HParams, VitsConfig, WaveGlowConfig

from .models.tacotron2 import Tacotron2
from .models.vits import GENERATOR_DTYPE, Vits
from .models.waveglow import TrainableWaveGlow, WaveGlow, fold_weightnorm
from .models.waveglow_fused import FusedWaveGlowInt8
from .ops.wn_block import fold_end, fold_first_taps
from .ops.wn_block_int8 import to_output_major
from .text import N_SYMBOLS
from .utils.profiling import annotate


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
    with annotate("convert.tacotron"):
        model = Tacotron2(hp, n_vocab=n_vocab, num_speakers=num_speakers,
                          device=device)
        model.load_state_dict(tacotron_state_dict(variables, hp,
                                                  num_speakers))
        return model.eval()


def load_waveglow(variables: Mapping, cfg: WaveGlowConfig,
                  device=None) -> WaveGlow:
    with annotate("convert.waveglow"):
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


# --- reference (PyTorch) checkpoints -> flax-layout trees ------------------

def _np(t) -> np.ndarray:
    """A tensor (any float dtype, bf16 and f16 too) or an array -> f32
    numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _dense(sd, name):
    out = {"kernel": _np(sd[f"{name}.weight"]).T}
    if f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def _conv1d(sd, name):
    out = {"Conv_0": {"kernel": _np(sd[f"{name}.weight"]).transpose(2, 1, 0)}}
    if f"{name}.bias" in sd:
        out["Conv_0"]["bias"] = _np(sd[f"{name}.bias"])
    return out


def _lstm_gates(w_ih, w_hh, b_ih, b_hh):
    return {
        "ih": {"kernel": _np(w_ih).T, "bias": _np(b_ih)},
        "hh": {"kernel": _np(w_hh).T, "bias": _np(b_hh)},
    }


def _bn(sd, name):
    scale_bias = {"scale": _np(sd[f"{name}.weight"]),
                  "bias": _np(sd[f"{name}.bias"])}
    stats = {"mean": _np(sd[f"{name}.running_mean"]),
             "var": _np(sd[f"{name}.running_var"])}
    return scale_bias, stats


def _wnconv(sd, name):
    """Weight-normalized conv -> (v [k, in, out], g [out])."""
    if f"{name}.weight_v" in sd:
        v = _np(sd[f"{name}.weight_v"]).transpose(2, 1, 0)
        g = _np(sd[f"{name}.weight_g"]).reshape(-1)
    else:  # weight norm removed: fold so that the kernel is the weight
        v = _np(sd[f"{name}.weight"]).transpose(2, 1, 0)
        g = np.sqrt((v * v).sum(axis=(0, 1)) + 1e-12)
    out = {"v": v, "g": g}
    if f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def tacotron_from_torch(state_dict: Mapping[str, Any],
                        hp: HParams) -> tuple[dict, dict]:
    """Reference Tacotron ``state_dict`` -> (params, batch_stats), nested
    dicts of f32 numpy arrays in the JAX package's layout."""
    sd = state_dict
    params: dict = {"embedding": {"embedding": _np(sd["embedding.weight"])}}
    stats: dict = {}

    enc: dict = {}
    enc_stats: dict = {}
    for i in range(hp.enc_conv_num_layers):
        enc[f"conv{i}"] = _conv1d(sd, f"encoder.convolutions.{i}.0.conv")
        enc[f"bn{i}"], enc_stats[f"bn{i}"] = _bn(
            sd, f"encoder.convolutions.{i}.1")
    enc["bilstm"] = {
        d: {"LSTMCell_0": _lstm_gates(
            *(sd[f"encoder.lstm.{w}_l0{sfx}"]
              for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))}
        for d, sfx in (("fwd", ""), ("bwd", "_reverse"))}
    params["encoder"] = enc
    stats["encoder"] = enc_stats

    def rnn(name):
        return _lstm_gates(*(sd[f"decoder.{name}.{w}"] for w in (
            "weight_ih", "weight_hh", "bias_ih", "bias_hh")))

    att = "decoder.attention_layer"
    params["decoder"] = {
        "prenet": {
            "fc0": _dense(sd, "decoder.prenet.layers.0.linear_layer"),
            "fc1": _dense(sd, "decoder.prenet.layers.1.linear_layer"),
        },
        "attention_rnn": rnn("attention_rnn"),
        "decoder_rnn": rnn("decoder_rnn"),
        "attention": {
            "query": _dense(sd, f"{att}.query_layer.linear_layer"),
            "memory": _dense(sd, f"{att}.memory_layer.linear_layer"),
            "v": _dense(sd, f"{att}.v.linear_layer"),
            "loc_conv": _conv1d(
                sd, f"{att}.location_layer.location_conv.conv"),
            "loc_dense": _dense(
                sd, f"{att}.location_layer.location_dense.linear_layer"),
        },
        "mel_proj": _dense(sd, "decoder.linear_projection.linear_layer"),
        "gate_proj": _dense(sd, "decoder.gate_layer.linear_layer"),
    }

    post: dict = {}
    post_stats: dict = {}
    for i in range(hp.postnet_n_convolutions):
        post[f"conv{i}"] = _conv1d(sd, f"postnet.convolutions.{i}.0.conv")
        post[f"bn{i}"], post_stats[f"bn{i}"] = _bn(
            sd, f"postnet.convolutions.{i}.1")
    params["postnet"] = post
    stats["postnet"] = post_stats
    return params, stats


def _fuse_res_skip(sd: Mapping[str, Any]) -> dict:
    """Fuse a pre-fusion checkpoint's separate res / skip convs
    (``convert_model.py:11-38``) into ``res_skip_layers`` keys (f32 numpy,
    res rows first); a fused checkpoint comes back as a plain copy.

    The pre-fusion WN has no res conv after its last layer: that layer's
    skip conv alone becomes its ``res_skip_layers`` entry, as the
    reference's ``update_model`` makes it.  (The JAX package's copy fuses
    only the layers that have both, so it refuses such a checkpoint with a
    ``KeyError`` for the last layer.)"""
    if not any("res_layers" in k for k in sd):
        return dict(sd)
    out = {k: v for k, v in sd.items()
           if "res_layers" not in k and "skip_layers" not in k}
    idx = sorted({(m.group(1), int(m.group(2))) for k in sd for m in [
        re.match(r"WN\.(\d+)\.(?:res|skip)_layers\.(\d+)\.", k)] if m})
    for flow, layer in idx:
        for suffix in ("weight_g", "weight_v", "bias", "weight"):
            rk = f"WN.{flow}.res_layers.{layer}.{suffix}"
            skk = f"WN.{flow}.skip_layers.{layer}.{suffix}"
            if skk not in sd:
                continue
            parts = [sd[rk], sd[skk]] if rk in sd else [sd[skk]]
            out[f"WN.{flow}.res_skip_layers.{layer}.{suffix}"] = \
                np.concatenate([_np(t) for t in parts], axis=0)
    return out


def waveglow_from_torch(state_dict: Mapping[str, Any],
                        cfg: WaveGlowConfig) -> dict:
    """Reference WaveGlow ``state_dict`` (fused or pre-fusion layout) ->
    params, a nested dict of f32 numpy arrays in the JAX package's
    layout."""
    sd = _fuse_res_skip(state_dict)
    params: dict = {"upsample": {
        "kernel": _np(sd["upsample.weight"]).transpose(2, 0, 1),
        "bias": _np(sd["upsample.bias"]),
    }}
    L = cfg.wn_n_layers
    for k in range(cfg.n_flows):
        params[f"convinv{k}"] = {
            "W": _np(sd[f"convinv.{k}.conv.weight"])[:, :, 0]}
        wn: dict = {"start": _wnconv(sd, f"WN.{k}.start")}
        # the reference's cond_layers are per layer; the flax tree holds one
        # conv over the layer axis: output channels concatenated in layer
        # order, a missing bias as zeros
        conds = [_wnconv(sd, f"WN.{k}.cond_layers.{i}") for i in range(L)]
        wn["cond"] = {
            "v": np.concatenate([c["v"] for c in conds], axis=-1),
            "g": np.concatenate([c["g"] for c in conds], axis=-1),
            "bias": np.concatenate(
                [c.get("bias", np.zeros(c["g"].shape, np.float32))
                 for c in conds], axis=-1),
        }
        for i in range(L):
            wn[f"in{i}"] = _wnconv(sd, f"WN.{k}.in_layers.{i}")
            wn[f"res_skip{i}"] = _wnconv(sd, f"WN.{k}.res_skip_layers.{i}")
        wn["end"] = {
            "kernel": _np(sd[f"WN.{k}.end.weight"]).transpose(2, 1, 0),
            "bias": _np(sd[f"WN.{k}.end.bias"]),
        }
        params[f"wn{k}"] = wn
    return params


def load_torch_checkpoint(path: str) -> dict:
    """A reference checkpoint file -> its flat ``state_dict``.

    Takes the Tacotron format (a dict with ``"state_dict"``,
    ``train.py:72``), the WaveGlow whole-model pickle (a dict with
    ``"model"``, ``waveglow/train.py:55``), VITS's (a dict whose
    ``"model"`` is the state dict) or a bare ``state_dict``, and
    raises ``ValueError`` on anything else.  The file is read with
    ``weights_only=False``, as the whole-model pickle needs: unpickling it
    RUNS CODE, and needs the model's class importable, so load only files
    you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        if "state_dict" in ckpt:
            return ckpt["state_dict"]
        if isinstance(ckpt.get("model"), dict):     # VITS's utils.py
            return ckpt["model"]
        if "model" in ckpt and hasattr(ckpt["model"], "state_dict"):
            return ckpt["model"].state_dict()
        if all(hasattr(v, "shape") for v in ckpt.values()):
            return ckpt
    if hasattr(ckpt, "state_dict"):
        return ckpt.state_dict()
    raise ValueError(f"unrecognized checkpoint format: {path}")


def tacotron_module_from_torch(state_dict: Mapping[str, Any], hp: HParams,
                               device=None) -> Tacotron2:
    """A reference Tacotron ``state_dict`` -> the port's module in eval mode
    (as many symbols as its embedding has rows)."""
    with annotate("convert.tacotron"):
        params, stats = tacotron_from_torch(state_dict, hp)
        return load_tacotron({"params": params, "batch_stats": stats}, hp,
                             params["embedding"]["embedding"].shape[0],
                             device=device)


def waveglow_module_from_torch(state_dict: Mapping[str, Any],
                               cfg: WaveGlowConfig, device=None) -> WaveGlow:
    """A reference WaveGlow ``state_dict`` -> the port's inference module
    (weight norm folded)."""
    with annotate("convert.waveglow"):
        return load_waveglow({"params": waveglow_from_torch(state_dict,
                                                            cfg)},
                             cfg, device=device)


# --- VITS (upstream ``SynthesizerTrn`` state dicts) --------------------------

# training-only modules: the posterior encoder, the duration predictor's
# posterior flows, and ConvFlow_1, which upstream drops at inference
VITS_SKIPPED = ("enc_q.", "dp.post_", "dp.flows.1.")


def _folded(sd, name) -> torch.Tensor:
    """A weight-normalized (or plain) conv of the upstream layout -> its
    torch-layout kernel, ``g v / ||v||`` over every dimension but the
    first (``weight_norm``'s dim 0: output channels of a Conv1d, input
    channels of a ConvTranspose1d)."""
    c = _wnconv(sd, name)
    k = fold_weightnorm(torch.from_numpy(c["v"]), torch.from_numpy(c["g"]))
    return k.permute(2, 1, 0).contiguous()


def vits_state_dict(state_dict: Mapping[str, Any], cfg: VitsConfig) -> dict:
    """An upstream VITS ``state_dict`` (``enc_p.*``, ``dp.*``, ``flow.*``,
    ``dec.*``) -> the state dict of :class:`..models.vits.Vits`, f32 on
    the CPU, weight norm folded.  The training-only keys
    (:data:`VITS_SKIPPED`) are skipped; any other key the model does not
    read raises, as does a missing one."""
    sd = state_dict
    read: set = set()

    def t(name) -> torch.Tensor:
        read.add(name)
        return torch.from_numpy(_np(sd[name]))

    def fold(name) -> torch.Tensor:
        read.update(k for k in (f"{name}.weight", f"{name}.weight_v",
                                f"{name}.weight_g") if k in sd)
        return _folded(sd, name)

    out: dict = {"enc.emb": t("enc_p.emb.weight")}
    for i in range(cfg.n_layers):
        a, p = f"enc_p.encoder.attn_layers.{i}", f"enc.layers.{i}"
        out[f"{p}.qkv_w"] = torch.cat([t(f"{a}.conv_{c}.weight")[:, :, 0]
                                       for c in "qkv"])
        out[f"{p}.qkv_b"] = torch.cat([t(f"{a}.conv_{c}.bias")
                                       for c in "qkv"])
        out[f"{p}.o_w"] = t(f"{a}.conv_o.weight")[:, :, 0]
        out[f"{p}.o_b"] = t(f"{a}.conv_o.bias")
        out[f"{p}.rel_k"] = t(f"{a}.emb_rel_k")[0]
        out[f"{p}.rel_v"] = t(f"{a}.emb_rel_v")[0]
        for j in (1, 2):
            n = f"enc_p.encoder.norm_layers_{j}.{i}"
            out[f"{p}.ln{j}_g"] = t(f"{n}.gamma")
            out[f"{p}.ln{j}_b"] = t(f"{n}.beta")
            f = f"enc_p.encoder.ffn_layers.{i}.conv_{j}"
            out[f"{p}.ffn{j}_w"] = t(f"{f}.weight")
            out[f"{p}.ffn{j}_b"] = t(f"{f}.bias")
    out["enc.proj_w"] = t("enc_p.proj.weight")[:, :, 0]
    out["enc.proj_b"] = t("enc_p.proj.bias")

    def dds(src, dst):
        n = cfg.dp_n_layers
        out[f"{dst}.sep_w"] = torch.stack(
            [t(f"{src}.convs_sep.{i}.weight") for i in range(n)])
        out[f"{dst}.sep_b"] = torch.stack(
            [t(f"{src}.convs_sep.{i}.bias") for i in range(n)])
        out[f"{dst}.pw_w"] = torch.stack(
            [t(f"{src}.convs_1x1.{i}.weight")[:, :, 0] for i in range(n)])
        out[f"{dst}.pw_b"] = torch.stack(
            [t(f"{src}.convs_1x1.{i}.bias") for i in range(n)])
        for key, leaf in (("ln_g", "gamma"), ("ln_b", "beta")):
            out[f"{dst}.{key}"] = torch.stack([torch.stack(
                [t(f"{src}.norms_{j}.{i}.{leaf}") for j in (1, 2)])
                for i in range(n)])

    def conv1x1(src, dst):
        out[f"{dst}_w"] = t(f"{src}.weight")[:, :, 0]
        out[f"{dst}_b"] = t(f"{src}.bias")

    conv1x1("dp.pre", "dp.pre")
    dds("dp.convs", "dp.convs")
    conv1x1("dp.proj", "dp.proj")
    out["dp.ea_m"] = t("dp.flows.0.m")[:, 0]
    out["dp.ea_logs"] = t("dp.flows.0.logs")[:, 0]
    for j in range(cfg.dp_n_flows - 1):
        # upstream's flows: [ElementwiseAffine, (ConvFlow, Flip) x n];
        # ConvFlow_(j + 2) sits at 2 (j + 2) - 1
        src, dst = f"dp.flows.{2 * j + 3}", f"dp.flows.{j}"
        conv1x1(f"{src}.pre", f"{dst}.pre")
        dds(f"{src}.convs", f"{dst}.convs")
        conv1x1(f"{src}.proj", f"{dst}.proj")

    L = cfg.flow_n_layers
    for j in range(cfg.flow_n_flows):
        src, dst = f"flow.flows.{2 * j}", f"flows.{j}"
        conv1x1(f"{src}.pre", f"{dst}.pre")
        conv1x1(f"{src}.post", f"{dst}.post")
        out[f"{dst}.in_b"] = torch.stack(
            [t(f"{src}.enc.in_layers.{i}.bias") for i in range(L)])
        for i in range(L):
            out[f"{dst}.in_w.{i}"] = fold(f"{src}.enc.in_layers.{i}")
            out[f"{dst}.rs_w.{i}"] = fold(
                f"{src}.enc.res_skip_layers.{i}")[:, :, 0]
            out[f"{dst}.rs_b.{i}"] = t(f"{src}.enc.res_skip_layers.{i}.bias")

    out["dec.pre_w"] = t("dec.conv_pre.weight")
    out["dec.pre_b"] = t("dec.conv_pre.bias")
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        out[f"dec.up_w.{i}"] = fold(f"dec.ups.{i}")
        out[f"dec.up_b.{i}"] = t(f"dec.ups.{i}.bias")
        for j, dils in enumerate(cfg.resblock_dilation_sizes):
            r = f"dec.resblocks.{i * nk + j}"
            convs = [f"{r}.convs{c}.{d}" for c in (1, 2)
                     for d in range(len(dils))]
            out[f"dec.res_w.{i * nk + j}"] = torch.stack(
                [fold(c) for c in convs])
            out[f"dec.res_b.{i * nk + j}"] = torch.stack(
                [t(f"{c}.bias") for c in convs])
    out["dec.post_w"] = t("dec.conv_post.weight")
    odd = sorted(k for k in sd if k not in read
                 and not k.startswith(VITS_SKIPPED))
    if odd:
        raise ValueError(f"VITS state dict holds keys the inference model "
                         f"does not read: {odd[:8]}")
    return out


def vits_module_from_torch(state_dict: Mapping[str, Any], cfg: VitsConfig,
                           device=None) -> Vits:
    """An upstream VITS ``state_dict`` -> the port's inference module
    (weight norm folded); the generator's weights in
    :data:`..models.vits.GENERATOR_DTYPE`, everything else float32.

    Only a model trained on this package's symbol table (``text/``, whose
    ids ``text.encode_batch`` gives) loads: its ``n_vocab`` is read from
    the text embedding and must be ``N_SYMBOLS``.  A published checkpoint
    (LJSpeech's 178 symbols, or a multi-speaker one) raises."""
    emb = state_dict.get("enc_p.emb.weight")
    if emb is not None:
        if emb.shape[0] != N_SYMBOLS:
            raise ValueError(
                f"the VITS checkpoint's text embedding has {emb.shape[0]} "
                f"symbols, this package's symbol table (text/symbols.py) "
                f"{N_SYMBOLS}: only a model trained on that table loads")
        cfg = dataclasses.replace(cfg, n_vocab=N_SYMBOLS)
    if "emb_g.weight" in state_dict:
        raise ValueError("a multi-speaker VITS checkpoint (emb_g): only "
                         "the one-speaker model is ported")
    with annotate("convert.vits"):
        model = Vits(cfg, device=device)
        model.load_state_dict(vits_state_dict(state_dict, cfg))
        model.dec.to(GENERATOR_DTYPE)
        if model.dec.pre_w.is_cuda:    # the kernels' weight images, once
            model.dec.pack()
        return model.eval()
