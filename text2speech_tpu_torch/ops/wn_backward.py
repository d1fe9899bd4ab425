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
reduction over row blocks into f32 partials that a second kernel adds in a
fixed order (no atomics), so the result is the same from run to run.

:func:`conv_k3_bwd` launches ``csrc/wn_backward.cu`` for CUDA tensors (the
tensor-core path for bf16 at C % 128 == 0, the f32 FMA path otherwise) and
takes :func:`conv_k3_bwd_plain` only for CPU tensors; a CUDA tensor the
kernel does not take raises.  It counts its launches in ``launches``.
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

F32 = torch.float32
MAX_DILATION = 128
# blocks the dW grid aims for: four per SM of an H100
_TARGET_BLOCKS = 4 * 132


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
    conv_k3_bwd.launches += 1
    _run(LIB.get().t2s_conv_k3_bwd, x.device, x.data_ptr(), g.data_ptr(),
         w.data_ptr(), dx.data_ptr(), dw.data_ptr(), partial.data_ptr(), B,
         T, C, d, splits, int(bf16), int(use_mma))
    return dx, dw


KERNELS = (conv_k3_bwd,)


def reset_launch_counts() -> None:
    conv_k3_bwd.launches = 0


def launch_counts() -> dict:
    return {"conv_k3_bwd": conv_k3_bwd.launches}


reset_launch_counts()
