"""Int8 fused WN-layer kernels of the quantized WaveGlow serving path, and
their plain PyTorch versions.

Counterpart of ``text2speech_tpu/ops/pallas/wn_block_int8.py``'s three
serving kernels (``wn_layer_stream2_first_int8``, ``wn_layer_stream2_int8``,
``wn_layer_stream2_final_int8``), its tensor-parallel partial layer
(``wn_layer_stream2_partial_int8``) and its quantizers.  The scheme:

* hidden state and grouped conditioning: int8 with one dynamic f32 scale per
  row (:func:`rowquant_f32`: amax / 127, floored at 1e-12 / 127), carried
  beside the payload as ``[B, T, 1]``;
* weights: int8 with one static f32 scale per output column
  (:func:`quantize_cols`; the three taps share one);
* gated activations: fixed scale 127 (tanh * sigmoid lies in (-1, 1));
* skip sum bf16, biases f32; the first layer's composed taps and the final
  layer's folded end projection stay bf16 (:mod:`.wn_block`'s folds).

Weight layout.  The kernels take int8 weights OUTPUT-MAJOR, ``[N, K]`` with
the contraction axis contiguous (``qw_in`` [3, 2C, C], ``qw_cond`` [2C, M],
``qw_rs`` [2C, C]): the s8 ``wgmma`` takes B K-major only.
:func:`quantize_cols` itself keeps the JAX package's ``[..., K, N]``
layout; :func:`to_output_major` transposes once, when the weights are
prepared.  The plain versions take the same output-major
tensors as the kernels.

Each role has a plain version (``*_plain``), used for CPU tensors and as the
reference the CUDA kernels are checked against, and a wrapper that launches
the kernel for CUDA tensors or raises; nothing falls back.  Every wrapper
launches a role of ``csrc/wn_block_int8_sm90.cu`` (s8 ``wgmma``, TMA, two
warpgroups on a 64-row tile; :func:`int8_sm90_plan` picks the tile per
role).  The plain versions are EXACT in their integer products without an
integer matmul: s8 values cast to f32 multiply and add exactly while every
partial sum stays below 2^24, which holds for K <= 1040 (K * 127 * 127 <
2^24).  So each tap and the conditioning are separate f32 products (TF32
off on a GPU), never one merged K = 3C + M product.

Each wrapper counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaLibrary
from .wn_block import (F32, SM90_SMEM_LIMIT, _check, _check_dims,
                       _edge_bias_suppress, _end_projection, _gate, _on_cpu,
                       _run, _shift, _taps, _valid_rows, check_partial_dims)

_P = ctypes.c_void_p
_I = ctypes.c_int
LIB_SM90 = CudaLibrary("wn_block_int8_sm90", {
    "t2s_wn_layer_int8_sm90": [_P] * 17 + [_I] * 8 + [_P],
    "t2s_wn_layer_partial_int8_sm90": [_P] * 13 + [_I] * 10 + [_P],
    "t2s_wn_layer_final_int8_sm90": [_P] * 15 + [_I] * 9 + [_P],
    "t2s_wn_layer_first_int8_sm90": [_P] * 18 + [_I] * 9 + [_P],
    "t2s_wn_int8_sm90_smem_bytes": [_I] * 4,
})

I8 = torch.int8
EPS = 1e-12
MAX_EXACT_K = (2 ** 24) // (127 * 127)     # 1040


# ---------------------------------------------------------------------------
# quantizers (wn_block_int8.py:103-133)
# ---------------------------------------------------------------------------


def rowquant_f32(xf: torch.Tensor, eps: float = EPS):
    """Per-row dynamic int8 quantization: [..., C] f32 -> (int8, [..., 1]
    f32 scale), scale = max(amax, eps) / 127, q = round-half-even(x /
    scale).  An all-zero row gives q = 0."""
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp_min(amax, eps) * (1.0 / 127.0)
    return torch.round(xf / s).to(I8), s


def quantize_rows(x: torch.Tensor, eps: float = EPS):
    """:func:`rowquant_f32` of a kernel input in any float dtype (the
    grouped conditioning, once per call)."""
    return rowquant_f32(x.to(F32), eps)


def quantize_cols(w: torch.Tensor, eps: float = EPS):
    """Static per-output-column weight quantization of ``w`` [..., K, N]:
    one scale per last-axis index over every other axis (so the three taps
    of a [3, C, 2C] conv share a column's scale) -> (int8 like ``w``, [N]
    f32)."""
    wf = w.to(F32)
    amax = wf.abs().amax(dim=tuple(range(wf.dim() - 1)))
    s = torch.clamp_min(amax, eps) * (1.0 / 127.0)
    return torch.round(wf / s).to(I8), s


def to_output_major(q: torch.Tensor) -> torch.Tensor:
    """int8 weights [..., K, N] -> [..., N, K] contiguous (the kernels'
    layout)."""
    return q.transpose(-1, -2).contiguous()


# ---------------------------------------------------------------------------
# plain versions (the Pallas kernels' arithmetic, wn_block_int8.py:62-255)
# ---------------------------------------------------------------------------


def _qdot(q: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """[B, T, K] s8 . [N, K] s8 -> [B, T, N], the exact s32 sums held in
    f32."""
    if q.shape[-1] > MAX_EXACT_K:
        raise ValueError(f"plain int8 product is exact in f32 only for K <= "
                         f"{MAX_EXACT_K}, got {q.shape[-1]}")
    return q.to(F32) @ qw.to(F32).T


def _taps_q(qx, sx, qw_in, sw_in, d: int, n_valid: int) -> torch.Tensor:
    """Three dilated taps: each tap's integer sums times the scale of its
    own shifted row, added in f32, times the shared column scale.  Rows
    outside [0, n_valid) read as zero, whatever their scale."""
    valid = _valid_rows(qx.shape[1], n_valid, qx.device)
    qf = torch.where(valid, qx, 0).to(F32)
    sf = torch.where(valid, sx, 0.0)
    acc = None
    for t in range(3):
        s = (t - 1) * d
        term = _qdot(_shift(qf, s), qw_in[t]) * _shift(sf, s)
        acc = term if acc is None else acc + term
    return acc * sw_in


def _cond_q(qspect, sspect, qw_cond, sw_cond, b_cond) -> torch.Tensor:
    return _qdot(qspect, qw_cond) * sspect * sw_cond + b_cond


def _gate_q(in_act: torch.Tensor) -> torch.Tensor:
    """tanh * sigmoid in f32, quantized at the fixed scale 127."""
    return torch.round(_gate(in_act, F32) * 127.0).to(I8)


def _rs_q(qacts, qw_rs, sw_rs, b_rs) -> torch.Tensor:
    return _qdot(qacts, qw_rs) * (sw_rs * (1.0 / 127.0)) + b_rs


def _requant(x_new: torch.Tensor, n_valid: int):
    """Zero the rows at or past n_valid, then quantize per row: those rows
    store q = 0 with the floor scale."""
    valid = _valid_rows(x_new.shape[1], n_valid, x_new.device)
    return rowquant_f32(torch.where(valid, x_new, 0.0))


def wn_layer_int8_plain(qx, sx, qspect, sspect, qw_in, sw_in, b_in, qw_cond,
                        sw_cond, b_cond, qw_rs, sw_rs, b_rs, skip_acc,
                        dilation: int, n_valid: int | None = None):
    """Standard int8 layer -> (qx_new, sx_new, skip_acc + skip)."""
    T, C = qx.shape[1], qx.shape[2]
    n_valid = T if n_valid is None else n_valid
    in_act = (_taps_q(qx, sx, qw_in, sw_in, dilation, n_valid) + b_in
              + _cond_q(qspect, sspect, qw_cond, sw_cond, b_cond))
    rs = _rs_q(_gate_q(in_act), qw_rs, sw_rs, b_rs)
    qx_new, sx_new = _requant(qx.to(F32) * sx + rs[..., :C], n_valid)
    return qx_new, sx_new, skip_acc + rs[..., C:].to(skip_acc.dtype)


def wn_layer_first_int8_plain(x0, qspect, sspect, start_k, start_b, wp,
                              b_all, b_edge, qw_cond, sw_cond, b_cond, qw_rs,
                              sw_rs, b_rs, dilation: int,
                              n_valid: int | None = None):
    """Start projection + layer 0, int8 conditioning and res/skip ->
    (qx_hidden, sx_hidden, skip in ``x0``'s dtype).  The composed taps stay
    in ``x0``'s dtype with f32 sums; ``wp``, ``b_all``, ``b_edge`` come from
    :func:`.wn_block.fold_first_taps`."""
    T, C = x0.shape[1], start_k.shape[-1]
    n_valid = T if n_valid is None else n_valid
    in_act = (_taps(x0, wp, dilation, n_valid) + b_all
              + _cond_q(qspect, sspect, qw_cond, sw_cond, b_cond))
    in_act = _edge_bias_suppress(in_act, b_edge, dilation, n_valid)
    rs = _rs_q(_gate_q(in_act), qw_rs, sw_rs, b_rs)
    xh = x0.to(F32) @ start_k.to(F32) + start_b
    qx_new, sx_new = _requant(xh + rs[..., :C], n_valid)
    return qx_new, sx_new, rs[..., C:].to(x0.dtype)


def wn_layer_final_int8_plain(qx, sx, qspect, sspect, qw_in, sw_in, b_in,
                              qw_cond, sw_cond, b_cond, w_eff, skip_acc,
                              w_end, b_eff, dilation: int,
                              n_valid: int | None = None):
    """Last int8 layer + folded end projection -> [B, T, E] f32.  The gate
    is cast to ``w_eff``'s dtype, not quantized; ``w_eff``, ``b_eff`` come
    from :func:`.wn_block.fold_end`."""
    n_valid = qx.shape[1] if n_valid is None else n_valid
    in_act = (_taps_q(qx, sx, qw_in, sw_in, dilation, n_valid) + b_in
              + _cond_q(qspect, sspect, qw_cond, sw_cond, b_cond))
    return _end_projection(_gate(in_act, w_eff.dtype), w_eff, skip_acc, w_end,
                           b_eff)


def wn_layer_partial_int8_plain(qx, sx, qspect, sspect, qw_in, sw_in, b_in,
                                qw_cond, sw_cond, b_cond, qw_rs, sw_rs,
                                dilation: int, n_valid: int | None = None):
    """One rank's share of an int8 WN layer under tensor parallelism -> its
    partial res/skip product [B, T, rs_out] f32 (``wn_block_int8.py:410
    _kernel_stream2_partial_q``): int8 taps and conditioning on the rank's
    gate-paired columns (``qw_in`` [3, 2Cp, C], ``qw_cond`` [2Cp, M],
    output-major, with the rank's column scales), the gate quantized at
    scale 127, then its res/skip rows ``qw_rs`` [rs_out, Cp], dequantized
    by the rank's own ``sw_rs`` / 127 so that the ranks' partials add on one
    f32 scale.  Rows at or past ``n_valid`` are zero; no bias, residual,
    skip sum or requantization."""
    T = qx.shape[1]
    n_valid = T if n_valid is None else n_valid
    in_act = (_taps_q(qx, sx, qw_in, sw_in, dilation, n_valid) + b_in
              + _cond_q(qspect, sspect, qw_cond, sw_cond, b_cond))
    rs = _qdot(_gate_q(in_act), qw_rs) * (sw_rs * (1.0 / 127.0))
    return torch.where(_valid_rows(T, n_valid, qx.device), rs, 0.0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _cond_checks(B, T, C, M, qspect, sspect, qw_cond, sw_cond, b_cond):
    return (("qspect", qspect, (B, T, M), I8),
            ("sspect", sspect, (B, T, 1), F32),
            ("qw_cond", qw_cond, (2 * C, M), I8),
            ("sw_cond", sw_cond, (2 * C,), F32),
            ("b_cond", b_cond, (2 * C,), F32))


def _tap_checks(B, T, C, qx, sx, qw_in, sw_in, b_in):
    return (("qx", qx, (B, T, C), I8), ("sx", sx, (B, T, 1), F32),
            ("qw_in", qw_in, (3, 2 * C, C), I8),
            ("sw_in", sw_in, (2 * C,), F32), ("b_in", b_in, (2 * C,), F32))


def _rs_checks(C, qw_rs, sw_rs, b_rs):
    return (("qw_rs", qw_rs, (2 * C, C), I8), ("sw_rs", sw_rs, (2 * C,), F32),
            ("b_rs", b_rs, (2 * C,), F32))


# The launch plan of ``csrc/wn_block_int8_sm90.cu`` (its constants,
# restated): a block is 64 rows, ``nc`` consumer warpgroups (column groups)
# and one producer warpgroup; a ring stage holds ``nc`` [128, 128] int8
# weight tiles and the [64, 128] int8 activation tile (K = 128 bytes, one
# swizzled row); beside the ring, the gated tile [64, C] int8 in whole
# 128-column panels (the first role adds the block's x0 tap rows, [64, 3,
# 4] f32), or in the final role the end projection's two [C, 8] bf16
# tables and the two column groups' [64, 8] f32 sums; 1 KB aligns the
# ring, and 608 bytes of static shared memory hold its mbarriers (six
# stages at most) and the two column groups' row maxima.
INT8_SM90_K = 128
INT8_SM90_MAX_STAGES = 6
INT8_SM90_STATIC_SMEM = 608
# the kernel's roles (its ``enum Role``)
INT8_SM90_ROLES = {"std": 0, "part": 1, "final": 2, "first": 3}


def _int8_sm90_stage_bytes(nc: int) -> int:
    return nc * 128 * INT8_SM90_K + 64 * INT8_SM90_K


def int8_sm90_smem_bytes(nc: int, C: int, stages: int,
                         role: str = "std") -> int:
    """Dynamic shared memory of one block (the kernel's ``smem_bytes``)."""
    ring = 1024 + stages * _int8_sm90_stage_bytes(nc)
    if role == "final":
        return ring + C * 8 * 2 * 2 + 2 * 64 * 8 * 4
    gated = 64 * -(-C // INT8_SM90_K) * INT8_SM90_K
    return ring + gated + (64 * 3 * 4 * 4 if role == "first" else 0)


def _int8_sm90_stages(nc: int, C: int, role: str = "std") -> int:
    free = (SM90_SMEM_LIMIT - INT8_SM90_STATIC_SMEM
            - int8_sm90_smem_bytes(nc, C, 0, role))
    return min(INT8_SM90_MAX_STAGES,
               max(free, 0) // _int8_sm90_stage_bytes(nc))


def int8_sm90_tile(C: int, nc: int, T: int = 1, B: int = 1,
                   role: str = "std") -> dict:
    """The tile of ``csrc/wn_block_int8_sm90.cu``'s ``role`` ("std",
    "part", "final" or "first") with ``nc`` column groups on 64-row blocks,
    its ring as deep as fits (up to six stages).  Raises ValueError where
    fewer than two stages fit."""
    if role not in INT8_SM90_ROLES:
        raise ValueError(f"no role {role!r} of the sm90 int8 kernel")
    stages = _int8_sm90_stages(nc, C, role)
    if stages < 2:
        raise ValueError(f"no tile of the sm90 int8 WN-layer kernel fits "
                         f"C={C} in {SM90_SMEM_LIMIT} bytes of shared memory")
    return {"nc": nc, "bm": 64, "stages": stages, "threads": 128 * (nc + 1),
            "smem": int8_sm90_smem_bytes(nc, C, stages, role),
            "grid": (-(-T // 64), B)}


def int8_sm90_plan(C: int, T: int = 1, B: int = 1, role: str = "std") -> dict:
    """Tile of ``csrc/wn_block_int8_sm90.cu``'s ``role`` for width ``C``
    and ``B`` utterances of ``T`` rows: two column groups where three ring
    stages of them fit beside the gated tile (C <= 1664; the first layer
    adds 3 KB, C <= 1536), else one; the final layer keeps no gated tile,
    so two groups fit to C = 3200 and its ring is one stage deeper at
    C = 512.  The partial layer's ``C`` is the rank's gate width
    Cp (its gated tile and res/skip K; the taps' K is the hidden state's).
    At Cp = 64 (p = 8 at C = 512) a rank has one gate chunk, and the second
    group sits out the in-act product and shares the res/skip chunks: there
    one and two groups ran within 3% of each other, two ahead at batch 3
    (``chip_smoke.py``'s tile line, PERF.md), so the rule holds there too.
    Raises ValueError where no tile fits in shared memory."""
    nc = 2 if _int8_sm90_stages(2, C, role) >= 3 else 1
    return int8_sm90_tile(C, nc, T, B, role)


def wn_layer_first_int8(x0, qspect, sspect, start_k, start_b, wp, b_all,
                        b_edge, qw_cond, sw_cond, b_cond, qw_rs, sw_rs, b_rs,
                        dilation: int, n_valid: int | None = None):
    """Fused start projection + first WN layer, int8 conditioning and
    res/skip -> (qx_hidden int8, sx_hidden [B, T, 1] f32, skip bf16).

    CUDA: bf16 ``x0`` [B, T, n_half <= 4], ``start_k`` [n_half, C], ``wp``
    [3, n_half, 2C]; int8 ``qspect`` [B, T, M], ``qw_cond`` [2C, M],
    ``qw_rs`` [2C, C] (output-major); f32 scales and biases.  Launches the
    ``FIRST`` role of ``csrc/wn_block_int8_sm90.cu`` with
    :func:`int8_sm90_plan`."""
    if _on_cpu(x0, qspect, sspect, start_k, start_b, wp, b_all, b_edge,
               qw_cond, sw_cond, b_cond, qw_rs, sw_rs, b_rs):
        return wn_layer_first_int8_plain(
            x0, qspect, sspect, start_k, start_b, wp, b_all, b_edge, qw_cond,
            sw_cond, b_cond, qw_rs, sw_rs, b_rs, dilation, n_valid)
    B, T, n_half = x0.shape
    C, M = start_k.shape[-1], qspect.shape[-1]
    n_valid = T if n_valid is None else int(n_valid)
    _check_dims(C, M, T, n_valid, dilation, m_multiple=64)
    if not 1 <= n_half <= 4:
        raise ValueError(f"kernel takes n_half in [1, 4], got {n_half}")
    bf = torch.bfloat16
    for name, t, shape, dt in (
        ("x0", x0, (B, T, n_half), bf),
        ("start_k", start_k, (n_half, C), bf), ("start_b", start_b, (C,), F32),
        ("wp", wp, (3, n_half, 2 * C), bf), ("b_all", b_all, (2 * C,), F32),
        ("b_edge", b_edge, (2, 2 * C), F32),
        *_cond_checks(B, T, C, M, qspect, sspect, qw_cond, sw_cond, b_cond),
        *_rs_checks(C, qw_rs, sw_rs, b_rs),
    ):
        _check(name, t, shape, dt)
    plan = int8_sm90_plan(C, T, B, role="first")
    qx_out = torch.empty((B, T, C), dtype=I8, device=x0.device)
    sx_out = torch.empty((B, T, 1), dtype=F32, device=x0.device)
    skip = torch.empty((B, T, C), dtype=bf, device=x0.device)
    x_new = torch.empty((B, T, C), dtype=F32, device=x0.device)  # scratch
    wn_layer_first_int8.launches += 1
    _run(LIB_SM90.get().t2s_wn_layer_first_int8_sm90, x0.device,
         *[t.data_ptr() for t in (
             x0, qspect, sspect, wp, b_all, b_edge, qw_cond, sw_cond, b_cond,
             qw_rs, sw_rs, b_rs, start_k, start_b, x_new, qx_out, sx_out,
             skip)],
         B, T, n_valid, C, M, n_half, dilation, plan["nc"], plan["stages"])
    return qx_out, sx_out, skip


def wn_layer_int8(qx, sx, qspect, sspect, qw_in, sw_in, b_in, qw_cond,
                  sw_cond, b_cond, qw_rs, sw_rs, b_rs, skip_acc,
                  dilation: int, n_valid: int | None = None):
    """Standard fused int8 WN layer -> (qx_new, sx_new, skip_acc + skip).

    CUDA: int8 ``qx`` [B, T, C], ``qspect`` [B, T, M], ``qw_in`` [3, 2C, C],
    ``qw_cond`` [2C, M], ``qw_rs`` [2C, C] (output-major); f32 ``sx`` /
    ``sspect`` [B, T, 1], column scales and biases [2C]; bf16 ``skip_acc``
    [B, T, C], updated IN PLACE (the returned skip tensor is ``skip_acc``
    itself; the plain version returns a new tensor).  Launches
    ``csrc/wn_block_int8_sm90.cu`` with :func:`int8_sm90_plan`."""
    if _on_cpu(qx, sx, qspect, sspect, qw_in, sw_in, b_in, qw_cond, sw_cond,
               b_cond, qw_rs, sw_rs, b_rs, skip_acc):
        return wn_layer_int8_plain(qx, sx, qspect, sspect, qw_in, sw_in,
                                   b_in, qw_cond, sw_cond, b_cond, qw_rs,
                                   sw_rs, b_rs, skip_acc, dilation, n_valid)
    B, T, C = qx.shape
    M = qspect.shape[-1]
    n_valid = T if n_valid is None else int(n_valid)
    _check_dims(C, M, T, n_valid, dilation, m_multiple=64)
    for name, t, shape, dt in (
        *_tap_checks(B, T, C, qx, sx, qw_in, sw_in, b_in),
        *_cond_checks(B, T, C, M, qspect, sspect, qw_cond, sw_cond, b_cond),
        *_rs_checks(C, qw_rs, sw_rs, b_rs),
        ("skip_acc", skip_acc, (B, T, C), torch.bfloat16),
    ):
        _check(name, t, shape, dt)
    plan = int8_sm90_plan(C, T, B)
    qx_out = torch.empty_like(qx)
    sx_out = torch.empty_like(sx)
    x_new = torch.empty((B, T, C), dtype=F32, device=qx.device)  # scratch
    wn_layer_int8.launches += 1
    _run(LIB_SM90.get().t2s_wn_layer_int8_sm90, qx.device, qx.data_ptr(),
         sx.data_ptr(), qspect.data_ptr(), sspect.data_ptr(),
         qw_in.data_ptr(), sw_in.data_ptr(), b_in.data_ptr(),
         qw_cond.data_ptr(), sw_cond.data_ptr(), b_cond.data_ptr(),
         qw_rs.data_ptr(), sw_rs.data_ptr(), b_rs.data_ptr(),
         skip_acc.data_ptr(), x_new.data_ptr(), qx_out.data_ptr(),
         sx_out.data_ptr(), B, T, n_valid, C, M, dilation, plan["nc"],
         plan["stages"])
    return qx_out, sx_out, skip_acc


def wn_layer_final_int8(qx, sx, qspect, sspect, qw_in, sw_in, b_in, qw_cond,
                        sw_cond, b_cond, w_eff, skip_acc, w_end, b_eff,
                        dilation: int, n_valid: int | None = None):
    """Last int8 WN layer + folded end projection -> [B, T, E] f32.

    CUDA: taps and conditioning as :func:`wn_layer_int8`; ``w_eff`` and
    ``w_end`` [C, E <= 8] bf16, ``b_eff`` [E] f32, ``skip_acc`` bf16.
    Launches the ``FINAL`` role of ``csrc/wn_block_int8_sm90.cu`` with
    :func:`int8_sm90_plan`."""
    if _on_cpu(qx, sx, qspect, sspect, qw_in, sw_in, b_in, qw_cond, sw_cond,
               b_cond, w_eff, skip_acc, w_end, b_eff):
        return wn_layer_final_int8_plain(
            qx, sx, qspect, sspect, qw_in, sw_in, b_in, qw_cond, sw_cond,
            b_cond, w_eff, skip_acc, w_end, b_eff, dilation, n_valid)
    B, T, C = qx.shape
    M, E = qspect.shape[-1], w_end.shape[-1]
    n_valid = T if n_valid is None else int(n_valid)
    _check_dims(C, M, T, n_valid, dilation, m_multiple=64)
    if not 1 <= E <= 8:
        raise ValueError(f"kernel takes E in [1, 8], got {E}")
    bf = torch.bfloat16
    for name, t, shape, dt in (
        *_tap_checks(B, T, C, qx, sx, qw_in, sw_in, b_in),
        *_cond_checks(B, T, C, M, qspect, sspect, qw_cond, sw_cond, b_cond),
        ("w_eff", w_eff, (C, E), bf), ("skip_acc", skip_acc, (B, T, C), bf),
        ("w_end", w_end, (C, E), bf), ("b_eff", b_eff, (E,), F32),
    ):
        _check(name, t, shape, dt)
    plan = int8_sm90_plan(C, T, B, role="final")
    out = torch.empty((B, T, E), dtype=F32, device=qx.device)
    wn_layer_final_int8.launches += 1
    _run(LIB_SM90.get().t2s_wn_layer_final_int8_sm90, qx.device,
         qx.data_ptr(), sx.data_ptr(), qspect.data_ptr(), sspect.data_ptr(),
         qw_in.data_ptr(), sw_in.data_ptr(), b_in.data_ptr(),
         qw_cond.data_ptr(), sw_cond.data_ptr(), b_cond.data_ptr(),
         w_eff.data_ptr(), skip_acc.data_ptr(), w_end.data_ptr(),
         b_eff.data_ptr(), out.data_ptr(), B, T, n_valid, C, M, E, dilation,
         plan["nc"], plan["stages"])
    return out


def wn_layer_partial_int8(qx, sx, qspect, sspect, qw_in, sw_in, b_in,
                          qw_cond, sw_cond, b_cond, qw_rs, sw_rs,
                          dilation: int, n_valid: int | None = None):
    """One rank's share of a fused int8 WN layer -> partial res/skip
    [B, T, rs_out] f32, written whole (zero at rows >= ``n_valid``); sum
    the ranks' partials, then add the res/skip bias once.

    CUDA: int8 ``qx`` [B, T, C], ``qspect`` [B, T, M], ``qw_in`` [3, 2Cp,
    C], ``qw_cond`` [2Cp, M], ``qw_rs`` [rs_out, Cp] (output-major); f32
    ``sx`` / ``sspect`` [B, T, 1], ``sw_in`` / ``b_in`` / ``sw_cond`` /
    ``b_cond`` [2Cp], ``sw_rs`` [rs_out].  Launches the ``PART`` form of
    ``csrc/wn_block_int8_sm90.cu`` with :func:`int8_sm90_plan` of width Cp."""
    if _on_cpu(qx, sx, qspect, sspect, qw_in, sw_in, b_in, qw_cond, sw_cond,
               b_cond, qw_rs, sw_rs):
        return wn_layer_partial_int8_plain(
            qx, sx, qspect, sspect, qw_in, sw_in, b_in, qw_cond, sw_cond,
            b_cond, qw_rs, sw_rs, dilation, n_valid)
    B, T, C = qx.shape
    M = qspect.shape[-1]
    rs_out, Cp = qw_rs.shape
    n_valid = T if n_valid is None else int(n_valid)
    _check_dims(C, M, T, n_valid, dilation, m_multiple=64)
    check_partial_dims(Cp, rs_out)
    for name, t, shape, dt in (
        ("qx", qx, (B, T, C), I8), ("sx", sx, (B, T, 1), F32),
        ("qw_in", qw_in, (3, 2 * Cp, C), I8),
        ("sw_in", sw_in, (2 * Cp,), F32), ("b_in", b_in, (2 * Cp,), F32),
        *_cond_checks(B, T, Cp, M, qspect, sspect, qw_cond, sw_cond, b_cond),
        ("qw_rs", qw_rs, (rs_out, Cp), I8), ("sw_rs", sw_rs, (rs_out,), F32),
    ):
        _check(name, t, shape, dt)
    plan = int8_sm90_plan(Cp, T, B)
    out = torch.empty((B, T, rs_out), dtype=F32, device=qx.device)
    wn_layer_partial_int8.launches += 1
    _run(LIB_SM90.get().t2s_wn_layer_partial_int8_sm90, qx.device,
         qx.data_ptr(), sx.data_ptr(), qspect.data_ptr(), sspect.data_ptr(),
         qw_in.data_ptr(), sw_in.data_ptr(), b_in.data_ptr(),
         qw_cond.data_ptr(), sw_cond.data_ptr(), b_cond.data_ptr(),
         qw_rs.data_ptr(), sw_rs.data_ptr(), out.data_ptr(), B, T, n_valid,
         C, Cp, M, rs_out, dilation, plan["nc"], plan["stages"])
    return out


# counted with the tensor-parallel path (``parallel.tp.launch_counts``)
wn_layer_partial_int8.launches = 0
KERNELS = (wn_layer_first_int8, wn_layer_int8, wn_layer_final_int8)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
