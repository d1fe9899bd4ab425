"""Weight-quantized Tacotron decode (counterpart of
``text2speech_tpu/models/tacotron_serve.py``).

* :func:`extract_decoder_params`: the decoder's weights as a plain dict;
* :func:`quantize_decoder_params`: per-output-channel symmetric int8 for
  the large matmul kernels (the two LSTM ``ih``/``hh`` pairs at full size);
* :func:`decode_chunk_serve`: a functional twin of
  ``Tacotron2.decode_chunk`` over that dict: same carry, same keep-masks,
  equal bit for bit in floating point.  A quantized kernel runs a true
  s8 x s8 -> s32 product (:func:`_qdot`): the activations are quantized per
  row on the fly and the weight stays int8 all the way into the product, so
  a step reads the int8 bytes only.  The weight is never dequantized.

Layouts are PyTorch's: a dense kernel is ``[out, in]`` (``nn.Linear``'s
weight, the JAX kernel transposed), the location conv ``[out, in, k]``; an
int8 kernel is ``{"q": int8 [out, in], "s": f32 [out]}``, which is also the
operand order the card's int8 product wants (k contiguous on both sides).
``convert.decoder_params_from_jax`` maps the JAX package's dict, quantized
or not, onto this one.

Whether int8 decode pays on a given card is a measurement:
:func:`int8_decode_worthwhile` holds the port's, taken on an H100.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import HParams
from ..ops.wn_block_int8 import rowquant_f32
from .tacotron2 import DecoderState, Tacotron2, sequence_mask

F32 = torch.float32

# quantize 2-D kernels of at least this many elements (the two LSTM ih/hh
# pairs at full size; small projections stay exact)
QUANT_MIN_ELEMS = 1 << 20

# The decode batch from which int8 decoder weights beat floating point.
# Measured by ``chip_smoke.py`` (64 steps of ``decode_chunk_serve`` at full
# width, floating point against int8, best of two runs each) on "NVIDIA H100
# 80GB HBM3, 700.00 W", in two runs of the script: int8 ran at 0.49x and 0.56x
# the floating-point steps per second at batch 1, 0.54x and 0.43x at batch 8,
# 0.71x and 0.80x at batch 32.  The decode is bound by the host
# launching ~70 small kernels a step, not by the weights' bytes, and the int8
# route adds launches (row quantization, padding, rescale) to each of the
# four large products.  None: int8 wins nowhere measured, and the
# floating-point path serves at every batch.
INT8_DECODE_MIN_BATCH: int | None = None

# torch._int_mm on CUDA wants more than 16 rows and sizes that are multiples
# of 8: decode batches of 1..32 are zero-padded to this many rows
_INT_MM_ROWS = 32


def int8_decode_worthwhile(batch: int) -> bool:
    """Whether int8 decoder weights beat floating point at this decode
    batch on the measured card (:data:`INT8_DECODE_MIN_BATCH`; the
    activation quantization also adds noise on the recurrent path, so int8
    must pay in throughput to be worth serving).  With
    ``quantized_decode=True`` the same (text, seed) therefore decodes in
    floating point below the threshold and in int8 from it on."""
    return (INT8_DECODE_MIN_BATCH is not None
            and batch >= INT8_DECODE_MIN_BATCH)


def extract_decoder_params(taco: Tacotron2) -> dict:
    """The decoder's weights as a plain serving dict (views of the module's
    parameters, nothing copied)."""
    dec = taco.decoder
    att = dec.attention
    return {
        "prenet_fc0": dec.prenet.fc0.weight,
        "prenet_fc1": dec.prenet.fc1.weight,
        "att_ih_w": dec.attention_rnn.ih.weight,
        "att_ih_b": dec.attention_rnn.ih.bias,
        "att_hh_w": dec.attention_rnn.hh.weight,
        "att_hh_b": dec.attention_rnn.hh.bias,
        "dec_ih_w": dec.decoder_rnn.ih.weight,
        "dec_ih_b": dec.decoder_rnn.ih.bias,
        "dec_hh_w": dec.decoder_rnn.hh.weight,
        "dec_hh_b": dec.decoder_rnn.hh.bias,
        "query_w": att.query.weight,
        "v_w": att.v.weight,
        "loc_conv_w": att.loc_conv.weight,
        "loc_dense_w": att.loc_dense.weight,
        "mel_w": dec.mel_proj.weight,
        "mel_b": dec.mel_proj.bias,
        "gate_w": dec.gate_proj.weight,
        "gate_b": dec.gate_proj.bias,
    }


def quantize_kernel_int8(w: torch.Tensor) -> dict:
    """Per-output-channel symmetric int8 for one kernel [out, in]:
    ``w[j] ~= q[j] * s[j]``, s = max|w[j]| / 127.  An all-zero output
    channel quantizes to exact zeros with a unit scale."""
    s = w.detach().abs().amax(dim=1) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(w.detach() / s[:, None]), -127, 127)
    return {"q": q.to(torch.int8).contiguous(), "s": s.to(F32)}


def quantize_decoder_params(dp: dict, min_elems: int | None = None) -> dict:
    """:func:`quantize_kernel_int8` for the 2-D kernels of at least
    ``min_elems`` elements (default :data:`QUANT_MIN_ELEMS`, read at call
    time); small projections stay exact."""
    if min_elems is None:
        min_elems = QUANT_MIN_ELEMS
    return {k: (quantize_kernel_int8(w)
                if w.dim() == 2 and w.numel() >= min_elems else w)
            for k, w in dp.items()}


def _qdot(x: torch.Tensor, entry, dtype) -> torch.Tensor:
    """``x @ W^T`` for a kernel [out, in] that may be quantized.

    A quantized kernel runs an s8 x s8 -> s32 product: the rows of ``x``
    are quantized on the fly (amax / 127) and both scales, separable from
    the contraction, are applied to the int32 sums.  On a CUDA device the
    product is ``torch._int_mm``, with the rows zero-padded to what it
    takes; the weight stays int8."""
    if not isinstance(entry, dict):
        return F.linear(x, entry.to(dtype))
    q, s = entry["q"], entry["s"]
    qx, sx = rowquant_f32(x.to(F32))
    lead = qx.shape[:-1]
    qx = qx.reshape(-1, qx.shape[-1])
    n = qx.shape[0]
    if qx.is_cuda:
        rows = max(_INT_MM_ROWS, -(-n // 8) * 8)
        if q.shape[0] % 8 or q.shape[1] % 8:
            raise ValueError(f"int8 kernel {tuple(q.shape)}: both sizes "
                             f"must be multiples of 8")
        pad = qx.new_zeros((rows, qx.shape[1]))
        pad[:n] = qx
        acc = torch._int_mm(pad, q.t())[:n]
    else:
        acc = qx.to(torch.int32) @ q.t().to(torch.int32)
    acc = acc.reshape(*lead, q.shape[0])
    return (acc.to(F32) * sx * s).to(dtype)


def _dense(x, w, b, dtype) -> torch.Tensor:
    """``x @ W^T + b`` with the bias added as the module's ``nn.Linear``
    adds it when the kernel is not quantized."""
    if isinstance(w, dict):
        return _qdot(x, w, dtype) + b.to(dtype)
    return F.linear(x, w.to(dtype), b.to(dtype))


def lstm_cell_update(gates: torch.Tensor, c: torch.Tensor):
    """Gate split (i, f, g, o) and the cell update shared by every LSTM
    cell variant: -> (h_new, c_new)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def decode_chunk_serve(dp: dict, hp: HParams, memory: torch.Tensor,
                       processed_memory: torch.Tensor, state: DecoderState,
                       frame: torch.Tensor, finished: torch.Tensor,
                       keep_masks: torch.Tensor,
                       text_lengths: torch.Tensor | None = None,
                       dtype: torch.dtype = F32, lstm_fn=None):
    """Functional twin of ``Tacotron2.decode_chunk`` over a serving dict:
    same carry, same keep-masks bool [n_steps, 2, B, prenet_dim], so the
    floating-point path equals the module's bit for bit; with
    :func:`quantize_decoder_params` weights the large kernels run int8
    products (:func:`_qdot`).  Returns ``((state, frame, finished), mel
    [B, n_mel, n], gate, align, active)``.

    ``lstm_fn(kind, h, c, x) -> (h_new, c_new)`` (kind "att" or "dec")
    overrides the two LSTM cells: the hook a tensor-parallel decoder hangs
    its column-sharded cell on."""
    if lstm_fn is None:
        def lstm_fn(kind, h, c, x):
            # the module's cell computes ih(x) + hh(h), that is (x W_ih +
            # b_ih) + (h W_hh + b_hh): keep exactly that grouping (float
            # addition is not associative; a gate energy one ulp from the
            # threshold must not flip between the two paths)
            pre = kind + "_"
            gates = (_dense(x, dp[pre + "ih_w"], dp[pre + "ih_b"], dtype)
                     + _dense(h, dp[pre + "hh_w"], dp[pre + "hh_b"], dtype))
            return lstm_cell_update(gates, c)

    T_in = memory.shape[1]
    mask = (sequence_mask(text_lengths.to(memory.device), T_in)
            if text_lengths is not None else None)
    mem = memory.to(dtype)
    pmem = processed_memory.to(dtype)
    loc_k = dp["loc_conv_w"].to(dtype)                 # [n_filters, 2, k]
    pad = (loc_k.shape[-1] - 1) // 2
    st = DecoderState(*(s.to(dtype) for s in state))
    frame = frame.to(dtype)
    mels, gates, aligns, actives = [], [], [], []
    for t in range(keep_masks.shape[0]):
        x = frame
        for i, name in enumerate(("prenet_fc0", "prenet_fc1")):
            x = torch.relu(_qdot(x, dp[name], dtype))
            x = torch.where(keep_masks[t, i], x / 0.5, 0.0)
        att_h, att_c = lstm_fn(
            "att", st.attention_h, st.attention_c,
            torch.cat([x, st.attention_context], -1))

        wcat = torch.stack([st.attention_weights,
                            st.attention_weights_cum], dim=-1)
        loc = F.conv1d(wcat.transpose(1, 2), loc_k,
                       padding=pad).transpose(1, 2)
        ploc = _qdot(loc, dp["loc_dense_w"], dtype)
        pq = _qdot(att_h, dp["query_w"], dtype)[:, None, :]
        energies = _qdot(torch.tanh(pq + ploc + pmem), dp["v_w"],
                         dtype)[..., 0].float()
        if mask is not None:
            energies = energies.masked_fill(~mask, float("-inf"))
        weights = torch.softmax(energies, dim=1).to(dtype)
        context = torch.einsum("bt,bte->be", weights, mem)
        weights_cum = st.attention_weights_cum + weights

        dec_h, dec_c = lstm_fn(
            "dec", st.decoder_h, st.decoder_c, torch.cat([att_h, context], -1))
        proj_in = torch.cat([dec_h, context], -1)
        frame = _dense(proj_in, dp["mel_w"], dp["mel_b"], dtype)
        gate = _dense(proj_in, dp["gate_w"], dp["gate_b"], dtype)[..., 0]

        actives.append(~finished)
        finished = finished | (torch.sigmoid(gate.float())
                               > hp.gate_threshold)
        st = DecoderState(att_h, att_c, dec_h, dec_c, weights, weights_cum,
                          context)
        mels.append(frame)
        gates.append(gate)
        aligns.append(weights)
    return ((st, frame, finished), torch.stack(mels, 2).float(),
            torch.stack(gates, 1).float(), torch.stack(aligns, 1).float(),
            torch.stack(actives, 1))
