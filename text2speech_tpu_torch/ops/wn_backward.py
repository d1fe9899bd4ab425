"""Backward of the WN layers' k=3 dilated SAME conv as one hand-written
kernel call, and its plain PyTorch version.

Counterpart of ``text2speech_tpu/ops/pallas/wn_backward.py``
(``conv_k3_bwd_pallas``).  As there, it stands beside the training path and
is not on it: the trainer's convs differentiate through the library, and
this kernel is held against autograd of that same conv.

Channels-last, zero padding, dilation d, per utterance:

    fwd:  y[t]  = x[t-d] W0 + x[t] W1 + x[t+d] W2
    bwd:  dx[t] = g[t+d] W0^T + g[t] W1^T + g[t-d] W2^T
          dW_j  = sum over (b, t) of x[t+(j-1)d]^T g[t]

Unlike the TPU kernel it takes the tensors unpadded.  ``dW`` is a split
reduction over rows into f32 partials that a second kernel adds in a fixed
order (no atomics), so the result is the same from run to run;
:func:`bwd_plan` sizes the split.

:func:`conv_k3_bwd` launches ``csrc/wn_backward_sm90.cu`` for CUDA tensors
(``wgmma`` and TMA for bf16 at C % 128 == 0, a register-tiled FMA GEMM for
f32 and for bf16 at other widths with C % 8 == 0) and takes
:func:`conv_k3_bwd_plain` only for CPU tensors; a CUDA tensor the kernels do
not take raises.  It counts its launches in ``launches``.
:func:`first_design` runs the first design (``csrc/wn_backward.cu``) on the
same arguments, for timing beside it.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaLibrary
from .wn_block import _check, _on_cpu, _run, _shift

_P = ctypes.c_void_p
_I = ctypes.c_int
LIB = CudaLibrary("wn_backward", {
    "t2s_conv_k3_bwd": [_P] * 6 + [_I] * 7 + [_P],
})
LIB_SM90 = CudaLibrary("wn_backward_sm90", {
    "t2s_conv_k3_bwd_sm90": [_P] * 6 + [_I] * 7 + [_P],
    "t2s_conv_k3_bwd_sm90_tile": [_I, _P],
})

F32 = torch.float32
MAX_DILATION = 128
# the first design's dW grid aims for four blocks per SM of an H100
_TARGET_BLOCKS = 4 * 132

# The tiles of ``csrc/wn_backward_sm90.cu`` by route: rows, columns, K per
# stage, blocks per SM.  Restated from the kernel, whose
# ``t2s_conv_k3_bwd_sm90_tile`` returns its own; the chip check holds the
# two equal.
BWD_TILES = {"wgmma": (128, 256, 64, 1), "fma": (128, 128, 16, 2)}
BWD_SMS = 132
BWD_MAX_SPLITS = 16


def bwd_plan(B: int, T: int, C: int, dtype) -> dict:
    """Route and dW split of ``csrc/wn_backward_sm90.cu`` for x [B, T, C]
    of ``dtype``: ``route`` ("wgmma" for bf16 at C % 128 == 0, else
    "fma"), ``splits``, ``dx_blocks``, ``dw_blocks``, ``dx_stages`` (per
    dx block) and ``row_stages`` (per dW tile, before the split).

    One launch holds the dx blocks and then the dW blocks, dealt to the
    card's block slots.  The split S is the least that makes no dW block
    longer than the longer of a dx block and one slot's share of all the
    stages; on the FMA route, whose blocks share an SM two by two, S is
    twice that.  Each further split costs the f32 partials' traffic and
    shortens no wave.  Raises ValueError for widths neither route takes
    (C % 8 != 0)."""
    if C % 8 or C < 8:
        raise ValueError(f"kernel needs C % 8 == 0, got C={C}")
    route = ("wgmma" if dtype == torch.bfloat16 and C % 128 == 0
             else "fma")
    bm, bn, bk, per_sm = BWD_TILES[route]
    n_dx = -(-T // bm) * -(-C // bn) * B
    dx_stages = 3 * 2 * C // bk
    tiles = 3 * -(-C // bm) * -(-2 * C // bn)
    rows = B * -(-T // bk)
    share = (n_dx * dx_stages + tiles * rows) / (BWD_SMS * per_sm)
    S = per_sm * -(-rows // max(dx_stages, share))
    S = int(max(1, min(BWD_MAX_SPLITS, rows, S)))
    return {"route": route, "splits": S, "dx_blocks": n_dx,
            "dw_blocks": tiles * S, "dx_stages": dx_stages,
            "row_stages": rows}


def conv_k3_bwd_plain(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                      dilation: int):
    """x [B, T, C], cotangent g [B, T, 2C], w [3, C, 2C] -> (dx [B, T, C] in
    x's dtype, dW [3, C, 2C] f32), as shifted products in f32."""
    d = dilation
    xf, gf, wf = x.to(F32), g.to(F32), w.to(F32)
    dx = (_shift(gf, d) @ wf[0].T + gf @ wf[1].T + _shift(gf, -d) @ wf[2].T)
    dw = torch.stack([
        torch.einsum("btc,bto->co", _shift(xf, (j - 1) * d), gf)
        for j in range(3)])
    return dx.to(x.dtype), dw


def conv_k3_bwd(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                dilation: int):
    """(dx, dW) of the k=3 dilated SAME conv.  CUDA: ``x``, ``g``, ``w``
    contiguous and all f32 or all bf16, dilation in [1, 128]."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, C], got {tuple(x.shape)}")
    B, T, C = x.shape
    d = int(dilation)
    if not 1 <= d <= MAX_DILATION:
        raise ValueError(f"dilation {d} outside [1, {MAX_DILATION}]")
    if x.dtype not in (F32, torch.bfloat16) or min(B, T, C) < 1:
        raise ValueError(f"x: {x.dtype} {tuple(x.shape)}; takes non-empty "
                         f"float32 or bfloat16")
    if _on_cpu(x, g, w):
        for name, t, shape in (("g", g, (B, T, 2 * C)),
                               ("w", w, (3, C, 2 * C))):
            if tuple(t.shape) != shape or t.dtype != x.dtype:
                raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, want "
                                 f"{shape} {x.dtype}")
        return conv_k3_bwd_plain(x, g, w, d)
    for name, t, shape in (("x", x, (B, T, C)), ("g", g, (B, T, 2 * C)),
                           ("w", w, (3, C, 2 * C))):
        _check(name, t, shape, x.dtype)
    plan = bwd_plan(B, T, C, x.dtype)
    S = plan["splits"]
    dx = torch.empty_like(x)
    dw = torch.empty((3, C, 2 * C), dtype=F32, device=x.device)
    partial = (dw if S == 1 else
               torch.empty((3 * S, C, 2 * C), dtype=F32, device=x.device))
    conv_k3_bwd.launches += 1
    _run(LIB_SM90.get().t2s_conv_k3_bwd_sm90, x.device, x.data_ptr(),
         g.data_ptr(), w.data_ptr(), dx.data_ptr(), dw.data_ptr(),
         partial.data_ptr(), B, T, C, d, S, int(x.dtype == torch.bfloat16),
         int(plan["route"] == "wgmma"))
    return dx, dw


def first_design(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                 dilation: int):
    """The first CUDA design of the conv backward (``csrc/wn_backward.cu``:
    ``mma.sync`` for bf16 at C % 128 == 0, else an FMA tile of 4 x 4
    outputs a thread), kept so that the sm90 kernels can be timed and
    checked beside it on the same inputs; no path calls it.  The arguments
    are :func:`conv_k3_bwd`'s (CUDA tensors, already checked by a call of
    the wrapper).  It counts no launch."""
    B, T, C = x.shape
    bf16 = x.dtype == torch.bfloat16
    use_mma = bf16 and C % 128 == 0
    if use_mma:
        tiles = 3 * (C // 64) * (2 * C // 128)
        chunks = B * -(-T // 32)
    else:
        tiles = 3 * -(-C // 64) * -(-2 * C // 64)
        chunks = -(-B * T // 16)
    splits = max(1, min(16, -(-_TARGET_BLOCKS // tiles), chunks))
    dx = torch.empty_like(x)
    dw = torch.empty((3, C, 2 * C), dtype=F32, device=x.device)
    partial = torch.empty((3 * splits, C, 2 * C), dtype=F32, device=x.device)
    _run(LIB.get().t2s_conv_k3_bwd, x.device, x.data_ptr(), g.data_ptr(),
         w.data_ptr(), dx.data_ptr(), dw.data_ptr(), partial.data_ptr(), B,
         T, C, int(dilation), splits, int(bf16), int(use_mma))
    return dx, dw


KERNELS = (conv_k3_bwd,)


def reset_launch_counts() -> None:
    conv_k3_bwd.launches = 0


def launch_counts() -> dict:
    return {"conv_k3_bwd": conv_k3_bwd.launches}


reset_launch_counts()
