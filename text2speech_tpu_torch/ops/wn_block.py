"""Fused WN-layer kernels of the WaveGlow serving path, and their plain
PyTorch versions.

Counterpart of ``text2speech_tpu/ops/pallas/wn_block.py``'s three shipping
kernels (``wn_layer_stream2_first``, ``wn_layer_stream2``,
``wn_layer_stream2_final``).  Each role has

* a plain PyTorch version (``*_plain``), the arithmetic of the Pallas
  kernel in float32 matmuls over the input dtype's values, used for CPU
  tensors and as the reference the CUDA kernels are checked against;
* a wrapper (:func:`wn_layer_first`, :func:`wn_layer`,
  :func:`wn_layer_final`) that launches the hand-written Hopper kernel of
  ``csrc/wn_block.cu`` for CUDA tensors, and takes the plain version only
  for CPU tensors.  A CUDA tensor the kernel does not take raises; nothing
  falls back.

Layout is channels-last ``[B, T, C]``.  Rows at or past ``n_valid`` read as
zero in every dilated tap (the conv's zero padding at the true length),
and the hidden-state output is zeroed there, so nothing past ``n_valid``
reaches a valid row.  ``n_valid`` and the dilation are runtime arguments.

Each wrapper counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaLibrary

_P = ctypes.c_void_p
_I = ctypes.c_int
LIB = CudaLibrary("wn_block", {
    "t2s_wn_layer_first": [_P] * 13 + [_I] * 7 + [_P],
    "t2s_wn_layer": [_P] * 11 + [_I] * 7 + [_P],
    "t2s_wn_layer_final": [_P] * 11 + [_I] * 7 + [_P],
})

F32 = torch.float32


# ---------------------------------------------------------------------------
# plain versions (the Pallas kernels' arithmetic, wn_block.py:52-158)
# ---------------------------------------------------------------------------


def _valid_rows(T: int, n_valid: int, device) -> torch.Tensor:
    return (torch.arange(T, device=device) < n_valid)[None, :, None]


def _shift(x: torch.Tensor, s: int) -> torch.Tensor:
    """y[:, t] = x[:, t + s], zero where t + s falls outside [0, T)."""
    T = x.shape[1]
    y = torch.zeros_like(x)
    if abs(s) < T:
        if s >= 0:
            y[:, : T - s] = x[:, s:]
        else:
            y[:, -s:] = x[:, : T + s]
    return y


def _taps(x, w, d: int, n_valid: int) -> torch.Tensor:
    """Three dilated k=3 taps in f32: x[t-d] w0 + x[t] w1 + x[t+d] w2 with
    rows outside [0, n_valid) read as zero."""
    xf = torch.where(_valid_rows(x.shape[1], n_valid, x.device), x, 0).to(F32)
    return (_shift(xf, -d) @ w[0].to(F32) + xf @ w[1].to(F32)
            + _shift(xf, d) @ w[2].to(F32))


def _cond(spect, w_cond, b_cond) -> torch.Tensor:
    return spect.to(F32) @ w_cond.to(F32) + b_cond.to(F32)


def _gate(in_act: torch.Tensor, dtype) -> torch.Tensor:
    """tanh(a[:, :C]) * sigmoid(a[:, C:]) in f32, cast to ``dtype``."""
    C = in_act.shape[-1] // 2
    return (torch.tanh(in_act[..., :C])
            * torch.sigmoid(in_act[..., C:])).to(dtype)


def fold_first_taps(start_k, start_b, w_in):
    """Compose the start 1x1 projection onto layer 0's taps (rank n_half),
    as ``wn_block.py:151 _fold_first_taps``:
    (wp [3, n_half, 2C], b_extra [2C], b_edge [2, 2C]), all f32."""
    wp = torch.einsum("nc,tco->tno", start_k.to(F32), w_in.to(F32))
    tap_bias = torch.einsum("c,tco->to", start_b.to(F32), w_in.to(F32))
    return wp, tap_bias.sum(0), torch.stack([tap_bias[0], tap_bias[2]])


def fold_end(w_rs, b_rs, w_end, b_end):
    """Fold the last res/skip matmul into the rank-E end projection, as
    ``wn_block.py:558-562``: (w_rs @ w_end in w_rs's dtype, f32 bias)."""
    w_eff = (w_rs.to(F32) @ w_end.to(F32)).to(w_rs.dtype)
    return w_eff, b_rs.to(F32) @ w_end.to(F32) + b_end.to(F32)


def wn_layer_plain(x, spect, w_in, b_in, w_cond, b_cond, w_rs, b_rs,
                   skip_acc, dilation: int, n_valid: int | None = None):
    """Standard layer -> (x_new, skip_acc + skip).  ``w_rs`` is [C, 2C]
    (residual + skip) or [C, C] (skip only, hidden state passes through)."""
    T, C = x.shape[1], x.shape[2]
    n_valid = T if n_valid is None else n_valid
    in_act = (_taps(x, w_in, dilation, n_valid) + b_in.to(F32)
              + _cond(spect, w_cond, b_cond))
    rs = _gate(in_act, w_in.dtype).to(F32) @ w_rs.to(F32) + b_rs.to(F32)
    valid = _valid_rows(T, n_valid, x.device)
    if w_rs.shape[-1] == 2 * C:
        x_out = torch.where(valid, (x.to(F32) + rs[..., :C]).to(x.dtype), 0)
        skip = rs[..., C:]
    else:
        x_out = torch.where(valid, x, 0)
        skip = rs
    return x_out, skip_acc + skip.to(skip_acc.dtype)


def wn_layer_first_plain(x0, spect, start_k, start_b, w_in, b_in, w_cond,
                         b_cond, w_rs, b_rs, dilation: int,
                         n_valid: int | None = None):
    """Start projection + layer 0 -> (x_hidden, skip), equal to
    ``wn_layer_plain(x0 @ start_k + start_b, ...)`` with a zero skip sum,
    at rank-n_half tap cost (``wn_block.py:281``)."""
    T, C = x0.shape[1], start_k.shape[-1]
    n_valid = T if n_valid is None else n_valid
    d = dilation
    wp, b_extra, b_edge = fold_first_taps(start_k, start_b, w_in)
    in_act = (_taps(x0, wp.to(x0.dtype), d, n_valid)
              + (b_in.to(F32) + b_extra) + _cond(spect, w_cond, b_cond))
    rows = torch.arange(T, device=x0.device)[None, :, None]
    in_act = in_act - torch.where(rows < d, b_edge[0], 0.0)
    in_act = in_act - torch.where(rows >= n_valid - d, b_edge[1], 0.0)
    rs = _gate(in_act, x0.dtype).to(F32) @ w_rs.to(F32) + b_rs.to(F32)
    xh = x0.to(F32) @ start_k.to(F32) + start_b.to(F32)
    x_out = torch.where(_valid_rows(T, n_valid, x0.device),
                        (xh + rs[..., :C]).to(spect.dtype), 0)
    return x_out, rs[..., C:].to(spect.dtype)


def wn_layer_final_plain(x, spect, w_in, b_in, w_cond, b_cond, w_rs, b_rs,
                         skip_acc, w_end, b_end, dilation: int,
                         n_valid: int | None = None):
    """Last layer + folded end projection -> (b, log_s) terms [B, T, E]
    f32 (``wn_block.py:325``, ``fold_rs=True``)."""
    n_valid = x.shape[1] if n_valid is None else n_valid
    w_eff, b_eff = fold_end(w_rs, b_rs, w_end, b_end)
    in_act = (_taps(x, w_in, dilation, n_valid) + b_in.to(F32)
              + _cond(spect, w_cond, b_cond))
    return (_gate(in_act, w_in.dtype).to(F32) @ w_eff.to(F32)
            + skip_acc.to(F32) @ w_end.to(F32) + b_eff)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*ts) -> bool:
    """True when every tensor lies on the CPU (take the plain version);
    False when every tensor lies on one CUDA device (launch the kernel).
    Anything else raises."""
    devs = {t.device for t in ts}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return False
    raise ValueError(f"tensors must all be on the CPU or all on one CUDA "
                     f"device, got {sorted(map(str, devs))}")


def _check(name: str, t: torch.Tensor, shape: tuple, dtype) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, want {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _check_dims(C: int, M: int, T: int, n_valid: int, d: int) -> None:
    if C % 128 or M % 32 or C <= 0 or M <= 0:
        raise ValueError(f"kernel needs C % 128 == 0 and M % 32 == 0, got "
                         f"C={C}, M={M}")
    if T < 1 or not 0 <= n_valid <= T or d < 0:
        raise ValueError(f"bad T={T}, n_valid={n_valid}, dilation={d}")


def _run(fn, device: torch.device, *args) -> None:
    """Launch on ``device`` (made current for the call, so a tensor on
    another card than the current one is not launched in the wrong
    context) and its current stream; raise on a CUDA error."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")


def wn_layer_first(x0, spect, start_k, start_b, w_in, b_in, w_cond, b_cond,
                   w_rs, b_rs, dilation: int, n_valid: int | None = None):
    """Fused start projection + first WN layer -> (x_hidden, skip).

    CUDA: bf16 ``x0`` [B, T, n_half <= 4], ``spect`` [B, T, M], ``start_k``
    [n_half, C], ``w_in`` [3, C, 2C], ``w_cond`` [M, 2C], ``w_rs`` [C, 2C];
    f32 biases.  The fold of the start projection onto the taps
    (:func:`fold_first_taps`) runs here, as it does in the JAX wrapper."""
    if _on_cpu(x0, spect, start_k, start_b, w_in, b_in, w_cond, b_cond,
               w_rs, b_rs):
        return wn_layer_first_plain(x0, spect, start_k, start_b, w_in, b_in,
                                    w_cond, b_cond, w_rs, b_rs, dilation,
                                    n_valid)
    B, T, n_half = x0.shape
    C, M = start_k.shape[-1], spect.shape[-1]
    n_valid = T if n_valid is None else int(n_valid)
    _check_dims(C, M, T, n_valid, dilation)
    if not 1 <= n_half <= 4:
        raise ValueError(f"kernel takes n_half in [1, 4], got {n_half}")
    bf = torch.bfloat16
    for name, t, shape, dt in (
        ("x0", x0, (B, T, n_half), bf), ("spect", spect, (B, T, M), bf),
        ("start_k", start_k, (n_half, C), bf), ("start_b", start_b, (C,), F32),
        ("w_in", w_in, (3, C, 2 * C), bf), ("b_in", b_in, (2 * C,), F32),
        ("w_cond", w_cond, (M, 2 * C), bf), ("b_cond", b_cond, (2 * C,), F32),
        ("w_rs", w_rs, (C, 2 * C), bf), ("b_rs", b_rs, (2 * C,), F32),
    ):
        _check(name, t, shape, dt)
    wp, b_extra, b_edge = fold_first_taps(start_k, start_b, w_in)
    wp = wp.to(bf).contiguous()
    b_all = (b_in.to(F32) + b_extra).contiguous()
    b_edge = b_edge.contiguous()
    x_out = torch.empty((B, T, C), dtype=bf, device=x0.device)
    skip = torch.empty((B, T, C), dtype=bf, device=x0.device)
    wn_layer_first.launches += 1
    _run(LIB.get().t2s_wn_layer_first, x0.device, x0.data_ptr(),
         spect.data_ptr(), wp.data_ptr(), b_all.data_ptr(),
         b_edge.data_ptr(), w_cond.data_ptr(), b_cond.data_ptr(),
         w_rs.data_ptr(), b_rs.data_ptr(), start_k.data_ptr(),
         start_b.data_ptr(), x_out.data_ptr(), skip.data_ptr(), B, T,
         n_valid, C, M, n_half, dilation)
    return x_out, skip


def wn_layer(x, spect, w_in, b_in, w_cond, b_cond, w_rs, b_rs, skip_acc,
             dilation: int, n_valid: int | None = None):
    """Standard fused WN layer -> (x_new, skip_acc + skip).

    CUDA: bf16 ``x``/``skip_acc`` [B, T, C], ``spect`` [B, T, M], ``w_in``
    [3, C, 2C], ``w_cond`` [M, 2C], ``w_rs`` [C, 2C] or [C, C]; f32 biases.
    The skip sum is updated IN PLACE on CUDA: the returned skip tensor is
    ``skip_acc`` itself (the JAX kernel aliases it the same way,
    ``wn_block.py:453``); the plain version returns a new tensor."""
    if _on_cpu(x, spect, w_in, b_in, w_cond, b_cond, w_rs, b_rs, skip_acc):
        return wn_layer_plain(x, spect, w_in, b_in, w_cond, b_cond, w_rs,
                              b_rs, skip_acc, dilation, n_valid)
    B, T, C = x.shape
    M, rs_out = spect.shape[-1], w_rs.shape[-1]
    n_valid = T if n_valid is None else int(n_valid)
    _check_dims(C, M, T, n_valid, dilation)
    if rs_out not in (C, 2 * C):
        raise ValueError(f"w_rs must be [C, 2C] or [C, C], got "
                         f"{tuple(w_rs.shape)}")
    bf = torch.bfloat16
    for name, t, shape, dt in (
        ("x", x, (B, T, C), bf), ("spect", spect, (B, T, M), bf),
        ("w_in", w_in, (3, C, 2 * C), bf), ("b_in", b_in, (2 * C,), F32),
        ("w_cond", w_cond, (M, 2 * C), bf), ("b_cond", b_cond, (2 * C,), F32),
        ("w_rs", w_rs, (C, rs_out), bf), ("b_rs", b_rs, (rs_out,), F32),
        ("skip_acc", skip_acc, (B, T, C), bf),
    ):
        _check(name, t, shape, dt)
    if skip_acc.untyped_storage().data_ptr() in (
            x.untyped_storage().data_ptr(),
            spect.untyped_storage().data_ptr()):
        raise ValueError("skip_acc is updated in place and must not share "
                         "memory with x or spect")
    x_out = torch.empty_like(x)
    wn_layer.launches += 1
    _run(LIB.get().t2s_wn_layer, x.device, x.data_ptr(), spect.data_ptr(),
         w_in.data_ptr(), b_in.data_ptr(), w_cond.data_ptr(),
         b_cond.data_ptr(), w_rs.data_ptr(), b_rs.data_ptr(),
         skip_acc.data_ptr(), x_out.data_ptr(), skip_acc.data_ptr(), B, T,
         n_valid, C, M, rs_out, dilation)
    return x_out, skip_acc


def wn_layer_final(x, spect, w_in, b_in, w_cond, b_cond, w_rs, b_rs,
                   skip_acc, w_end, b_end, dilation: int,
                   n_valid: int | None = None):
    """Last WN layer + folded end projection -> [B, T, E] f32.

    CUDA: as :func:`wn_layer` with ``w_rs`` [C, C], plus ``w_end`` [C, E <= 8]
    bf16 and ``b_end`` [E] f32.  The fold ``w_rs @ w_end``
    (:func:`fold_end`) runs here, as it does in the JAX wrapper."""
    if _on_cpu(x, spect, w_in, b_in, w_cond, b_cond, w_rs, b_rs, skip_acc,
               w_end, b_end):
        return wn_layer_final_plain(x, spect, w_in, b_in, w_cond, b_cond,
                                    w_rs, b_rs, skip_acc, w_end, b_end,
                                    dilation, n_valid)
    B, T, C = x.shape
    M, E = spect.shape[-1], w_end.shape[-1]
    n_valid = T if n_valid is None else int(n_valid)
    _check_dims(C, M, T, n_valid, dilation)
    if not 1 <= E <= 8:
        raise ValueError(f"kernel takes E in [1, 8], got {E}")
    bf = torch.bfloat16
    for name, t, shape, dt in (
        ("x", x, (B, T, C), bf), ("spect", spect, (B, T, M), bf),
        ("w_in", w_in, (3, C, 2 * C), bf), ("b_in", b_in, (2 * C,), F32),
        ("w_cond", w_cond, (M, 2 * C), bf), ("b_cond", b_cond, (2 * C,), F32),
        ("w_rs", w_rs, (C, C), bf), ("b_rs", b_rs, (C,), F32),
        ("skip_acc", skip_acc, (B, T, C), bf), ("w_end", w_end, (C, E), bf),
        ("b_end", b_end, (E,), F32),
    ):
        _check(name, t, shape, dt)
    w_eff, b_eff = fold_end(w_rs, b_rs, w_end, b_end)
    w_eff, b_eff = w_eff.contiguous(), b_eff.contiguous()
    out = torch.empty((B, T, E), dtype=F32, device=x.device)
    wn_layer_final.launches += 1
    _run(LIB.get().t2s_wn_layer_final, x.device, x.data_ptr(),
         spect.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
         w_cond.data_ptr(), b_cond.data_ptr(), w_eff.data_ptr(),
         skip_acc.data_ptr(), w_end.data_ptr(), b_eff.data_ptr(),
         out.data_ptr(), B, T, n_valid, C, M, E, dilation)
    return out


KERNELS = (wn_layer_first, wn_layer, wn_layer_final)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
