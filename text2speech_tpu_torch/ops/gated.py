"""The WN gated activation ``tanh((a + b)[..., :C]) * sigmoid((a + b)[...,
C:])`` with a hand-written forward and backward kernel.

Counterpart of ``text2speech_tpu/ops/pallas/gated.py``: its forward
(``_pallas_fwd``) and backward (``_pallas_bwd``) Pallas kernels and the
``custom_vjp`` around them.  Here

* :func:`gated_fwd` / :func:`gated_bwd` launch the kernels of
  ``csrc/gated.cu`` for CUDA tensors and take the plain versions
  (:func:`gated_plain`, :func:`gated_bwd_plain`) only for CPU tensors; a
  CUDA tensor the kernel does not take raises, nothing falls back.  Each
  counts its launches in its ``launches`` attribute;
* :class:`GatedActivation` is the ``torch.autograd.Function`` over the two,
  and :func:`gated_activation` the entry the WN layers call.

The sum ``a + b`` is rounded to the IO dtype (as the Pallas kernel adds its
two refs before widening), the rest of the math is float32 whatever the IO
dtype, and the sum is never stored: the backward recomputes tanh and
sigmoid from the saved ``a`` and ``b`` and writes one ``dx`` that is the
gradient of both inputs.

Inputs are ``[..., 2C]`` with a unit last stride whose leading dimensions
collapse into rows of one stride, so ``b`` can be a column slice of the
fused ``[B, T, 2C * L]`` conditioning projection without a copy.  Any other
layout is made contiguous first.  The JAX package's ``T2S_PALLAS_GATED``
switch is not carried over: eager PyTorch fuses nothing, so on a card the
kernel always runs.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaLibrary
from .wn_block import _on_cpu, _run

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
LIB = CudaLibrary("gated", {
    "t2s_gated_fwd": [_P, _P, _P, _L, _I, _L, _L, _I, _I, _P],
    "t2s_gated_bwd": [_P, _P, _P, _P, _L, _I, _L, _L, _L, _I, _I, _P],
})

F32 = torch.float32
DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# plain versions (the Pallas kernels' arithmetic, gated.py:32-49)
# ---------------------------------------------------------------------------


def gated_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 2C], [..., 2C] -> [..., C] in ``a``'s dtype.  Differentiable:
    autograd of this expression is the reference of :func:`gated_bwd`."""
    x = (a + b).to(F32)
    C = x.shape[-1] // 2
    return (torch.tanh(x[..., :C]) * torch.sigmoid(x[..., C:])).to(a.dtype)


def gated_bwd_plain(a: torch.Tensor, b: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """Cotangent ``g`` [..., C] -> dx [..., 2C] in ``a``'s dtype, with tanh
    and sigmoid recomputed from ``a`` and ``b``."""
    x = (a + b).to(F32)
    C = x.shape[-1] // 2
    t, s = torch.tanh(x[..., :C]), torch.sigmoid(x[..., C:])
    gf = g.to(F32)
    return torch.cat([gf * (1.0 - t * t) * s, gf * t * s * (1.0 - s)],
                     dim=-1).to(a.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _row_stride(t: torch.Tensor) -> int | None:
    """The one stride (in elements) that steps through ``t`` viewed as
    rows of its last dimension, or None when there is none."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        return None
    dims = [(n, s) for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n > 1]
    if not dims:
        return t.shape[-1]
    for (_, outer), (n, inner) in zip(dims[:-1], dims[1:]):
        if outer != n * inner:
            return None
    stride = dims[-1][1]
    return stride if stride >= t.shape[-1] else None


def _as_rows(t: torch.Tensor):
    """(tensor, row stride): ``t`` itself when its rows have one stride,
    else a contiguous copy."""
    stride = _row_stride(t)
    if stride is None:
        t = t.contiguous()
        stride = t.shape[-1]
    return t, stride


def _check_pair(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dim() < 2 or a.shape[-1] % 2 or a.numel() == 0:
        raise ValueError(f"gated activation takes two equal [..., 2C] "
                         f"tensors, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in DTYPES:
        raise ValueError(f"gated activation takes float32 or bfloat16 "
                         f"pairs, got {a.dtype} and {b.dtype}")
    return a.shape[-1] // 2


def _vec_ok(C: int, dtype, *ts_strides) -> int:
    """1 when every (tensor, row stride) allows 16-byte accesses at columns
    that are multiples of 16 / itemsize, and at column C."""
    size = torch.empty((), dtype=dtype).element_size()
    if (C * size) % 16:
        return 0
    for t, stride in ts_strides:
        if t.data_ptr() % 16 or (stride * size) % 16:
            return 0
    return 1


def gated_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward: [..., 2C] x 2 -> [..., C] (contiguous) in the inputs'
    dtype.  Launches ``t2s_gated_fwd`` on CUDA tensors."""
    C = _check_pair(a, b)
    if _on_cpu(a, b):
        return gated_plain(a, b)
    a, sa = _as_rows(a)
    b, sb = _as_rows(b)
    out = torch.empty((*a.shape[:-1], C), dtype=a.dtype, device=a.device)
    rows = out.numel() // C
    vec = _vec_ok(C, a.dtype, (a, sa), (b, sb), (out, C))
    gated_fwd.launches += 1
    _run(LIB.get().t2s_gated_fwd, a.device, a.data_ptr(), b.data_ptr(),
         out.data_ptr(), rows, C, sa, sb, int(a.dtype == torch.bfloat16), vec)
    return out


def gated_bwd(a: torch.Tensor, b: torch.Tensor,
              g: torch.Tensor) -> torch.Tensor:
    """Backward: saved inputs and the cotangent [..., C] -> dx [..., 2C]
    (contiguous), the gradient of ``a`` and of ``b``.  Launches
    ``t2s_gated_bwd`` on CUDA tensors."""
    C = _check_pair(a, b)
    if g.shape != (*a.shape[:-1], C) or g.dtype != a.dtype:
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype}, want "
                         f"{(*a.shape[:-1], C)} {a.dtype}")
    if _on_cpu(a, b, g):
        return gated_bwd_plain(a, b, g)
    a, sa = _as_rows(a)
    b, sb = _as_rows(b)
    g, sg = _as_rows(g)
    dx = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    rows = dx.numel() // (2 * C)
    vec = _vec_ok(C, a.dtype, (a, sa), (b, sb), (g, sg), (dx, 2 * C))
    gated_bwd.launches += 1
    _run(LIB.get().t2s_gated_bwd, a.device, a.data_ptr(), b.data_ptr(),
         g.data_ptr(), dx.data_ptr(), rows, C, sa, sb, sg,
         int(a.dtype == torch.bfloat16), vec)
    return dx


class GatedActivation(torch.autograd.Function):
    """``gated_fwd`` with ``gated_bwd`` as its backward (the counterpart of
    ``jax.custom_vjp`` on ``gated_activation_pallas``).  Saves ``a`` and
    ``b``, never their sum."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return gated_fwd(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        dx = gated_bwd(a, b, g)
        return (dx if ctx.needs_input_grad[0] else None,
                dx if ctx.needs_input_grad[1] else None)


def gated_activation(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The WN layers' gated activation, differentiable in both inputs."""
    return GatedActivation.apply(a, b)


KERNELS = (gated_fwd, gated_bwd)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
