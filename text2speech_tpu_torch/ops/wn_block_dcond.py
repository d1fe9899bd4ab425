"""Composed-conditioning (``dcond``) flavours of the fused WN-layer kernels,
and their plain PyTorch versions.

Counterpart of ``text2speech_tpu/ops/pallas/wn_block_dcond.py``
(``wn_layer_stream2_first_dcond``, ``wn_layer_stream2_dcond``,
``wn_layer_stream2_final_dcond``).  The three roles are those of
:mod:`.wn_block`, but the layer's conditioning is not ``spect @ w_cond +
b_cond`` inside the kernel: it is read from columns ``[2C * li, 2C * (li +
1))`` of a pre-materialised ``cond_all`` [B, T, 2C * L] (the first layer
reads slice 0), widened to f32 and added to the tap sums and ``b_in``.
``cond_all`` already holds the folded conditioning bias;
``models/waveglow_fused.py`` materialises it once per flow from the mel
frames and the phase-expanded weights of ``precompute_composed_cond``.

For CUDA tensors the standard layer launches the ``DCOND`` form of
``csrc/wn_block_sm90.cu`` (wgmma, TMA, 128-row tiles; ``sm90_plan`` picks the
tile, as for the standard layer) and the first and final layers the ``DCOND``
instantiations of ``csrc/wn_block.cu``; the plain versions run only for CPU
tensors.  The slice is read in place through a row stride and a column
offset, never copied.  Each wrapper counts its kernel launches in
``launches``.
"""

from __future__ import annotations

import torch

from .wn_block import (F32, LIB, LIB_SM90, _check, _on_cpu, _run,
                       final_body, first_body, sm90_plan, std_body)


def _cond_slice(cond_all, cond_index: int, C: int) -> torch.Tensor:
    """Layer ``cond_index``'s [B, T, 2C] columns of ``cond_all``, widened to
    f32 as the kernel widens them (``wn_block.py:227``): ``cond_all`` was
    rounded to its dtype when it was materialised, and nowhere after."""
    return cond_all[..., 2 * C * cond_index: 2 * C * (cond_index + 1)].to(F32)


def wn_layer_dcond_plain(x, cond_all, cond_index: int, w_in, b_in, w_rs,
                         b_rs, skip_acc, dilation: int,
                         n_valid: int | None = None):
    """:func:`.wn_block.wn_layer_plain` with the conditioning read from
    slice ``cond_index`` of ``cond_all`` [B, T, 2C * L] (bias already
    folded in)."""
    return std_body(x, _cond_slice(cond_all, cond_index, x.shape[2]), w_in,
                    b_in, w_rs, b_rs, skip_acc, dilation, n_valid)


def wn_layer_first_dcond_plain(x0, cond_all, start_k, start_b, wp, b_all,
                               b_edge, w_rs, b_rs, dilation: int,
                               n_valid: int | None = None):
    """:func:`.wn_block.wn_layer_first_plain` with the conditioning read
    from slice 0 of ``cond_all``; outputs in ``cond_all``'s dtype."""
    return first_body(x0, _cond_slice(cond_all, 0, start_k.shape[-1]),
                      cond_all.dtype, start_k, start_b, wp, b_all, b_edge,
                      w_rs, b_rs, dilation, n_valid)


def wn_layer_final_dcond_plain(x, cond_all, cond_index: int, w_in, b_in,
                               w_eff, skip_acc, w_end, b_eff, dilation: int,
                               n_valid: int | None = None):
    """:func:`.wn_block.wn_layer_final_plain` with the conditioning read
    from slice ``cond_index`` of ``cond_all``."""
    return final_body(x, _cond_slice(cond_all, cond_index, x.shape[2]), w_in,
                      b_in, w_eff, skip_acc, w_end, b_eff, dilation, n_valid)


def _check_cond_all(cond_all, cond_index: int, B: int, T: int, C: int,
                    n_valid: int, d: int) -> tuple:
    """Checks shared by the ``dcond`` wrappers -> (row stride, column offset)
    of the layer's slice, in elements."""
    if C % 128 or C <= 0:
        raise ValueError(f"kernel needs C % 128 == 0, got C={C}")
    if T < 1 or not 0 <= n_valid <= T or d < 0:
        raise ValueError(f"bad T={T}, n_valid={n_valid}, dilation={d}")
    ld = cond_all.shape[-1] if cond_all.dim() == 3 else 0
    if ld % (2 * C) or not 0 <= cond_index < max(ld // (2 * C), 1):
        raise ValueError(f"cond_all {tuple(cond_all.shape)}: want [B, T, "
                         f"2C * L] with cond_index {cond_index} < L")
    _check("cond_all", cond_all, (B, T, ld), torch.bfloat16)
    return ld, 2 * C * cond_index


def wn_layer_first_dcond(x0, cond_all, start_k, start_b, wp, b_all, b_edge,
                         w_rs, b_rs, dilation: int,
                         n_valid: int | None = None):
    """:func:`wn_layer_first` with pre-materialised conditioning: slice 0 of
    ``cond_all`` [B, T, 2C * L] bf16, read in place (row stride 2C * L), in
    place of ``spect``, ``w_cond`` and ``b_cond``."""
    if _on_cpu(x0, cond_all, start_k, start_b, wp, b_all, b_edge, w_rs, b_rs):
        return wn_layer_first_dcond_plain(x0, cond_all, start_k, start_b, wp,
                                          b_all, b_edge, w_rs, b_rs,
                                          dilation, n_valid)
    B, T, n_half = x0.shape
    C = start_k.shape[-1]
    n_valid = T if n_valid is None else int(n_valid)
    ld, off = _check_cond_all(cond_all, 0, B, T, C, n_valid, dilation)
    if not 1 <= n_half <= 4:
        raise ValueError(f"kernel takes n_half in [1, 4], got {n_half}")
    bf = torch.bfloat16
    for name, t, shape, dt in (
        ("x0", x0, (B, T, n_half), bf),
        ("start_k", start_k, (n_half, C), bf), ("start_b", start_b, (C,), F32),
        ("wp", wp, (3, n_half, 2 * C), bf), ("b_all", b_all, (2 * C,), F32),
        ("b_edge", b_edge, (2, 2 * C), F32),
        ("w_rs", w_rs, (C, 2 * C), bf), ("b_rs", b_rs, (2 * C,), F32),
    ):
        _check(name, t, shape, dt)
    x_out = torch.empty((B, T, C), dtype=bf, device=x0.device)
    skip = torch.empty((B, T, C), dtype=bf, device=x0.device)
    wn_layer_first_dcond.launches += 1
    _run(LIB.get().t2s_wn_layer_first_dcond, x0.device, x0.data_ptr(),
         cond_all.data_ptr(), wp.data_ptr(), b_all.data_ptr(),
         b_edge.data_ptr(), w_rs.data_ptr(), b_rs.data_ptr(),
         start_k.data_ptr(), start_b.data_ptr(), x_out.data_ptr(),
         skip.data_ptr(), B, T, n_valid, C, ld, off, n_half, dilation)
    return x_out, skip


def wn_layer_dcond(x, cond_all, cond_index: int, w_in, b_in, w_rs, b_rs,
                   skip_acc, dilation: int, n_valid: int | None = None):
    """:func:`wn_layer` with pre-materialised conditioning: slice
    ``cond_index`` of ``cond_all`` [B, T, 2C * L] bf16, read in place.  The
    skip sum is updated IN PLACE on CUDA, as in :func:`wn_layer`
    (``wn_block_dcond.py:94`` aliases it the same way).  CUDA: the sm90
    kernel; ``wn_block.first_design("wn_layer_dcond", ...)`` runs the first
    design on the same arguments."""
    if _on_cpu(x, cond_all, w_in, b_in, w_rs, b_rs, skip_acc):
        return wn_layer_dcond_plain(x, cond_all, cond_index, w_in, b_in, w_rs,
                                    b_rs, skip_acc, dilation, n_valid)
    B, T, C = x.shape
    rs_out = w_rs.shape[-1]
    n_valid = T if n_valid is None else int(n_valid)
    ld, off = _check_cond_all(cond_all, cond_index, B, T, C, n_valid,
                              dilation)
    if rs_out not in (C, 2 * C):
        raise ValueError(f"w_rs must be [C, 2C] or [C, C], got "
                         f"{tuple(w_rs.shape)}")
    bf = torch.bfloat16
    for name, t, shape, dt in (
        ("x", x, (B, T, C), bf),
        ("w_in", w_in, (3, C, 2 * C), bf), ("b_in", b_in, (2 * C,), F32),
        ("w_rs", w_rs, (C, rs_out), bf), ("b_rs", b_rs, (rs_out,), F32),
        ("skip_acc", skip_acc, (B, T, C), bf),
    ):
        _check(name, t, shape, dt)
    if skip_acc.untyped_storage().data_ptr() in (
            x.untyped_storage().data_ptr(),
            cond_all.untyped_storage().data_ptr()):
        raise ValueError("skip_acc is updated in place and must not share "
                         "memory with x or cond_all")
    plan = sm90_plan(C, T, B)
    x_out = torch.empty_like(x)
    wn_layer_dcond.launches += 1
    _run(LIB_SM90.get().t2s_wn_layer_dcond_sm90, x.device, x.data_ptr(),
         cond_all.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
         w_rs.data_ptr(), b_rs.data_ptr(), skip_acc.data_ptr(),
         x_out.data_ptr(), B, T, n_valid, C, ld, off, rs_out, dilation,
         plan["nwg"], plan["bk"], plan["stages"])
    return x_out, skip_acc


def wn_layer_final_dcond(x, cond_all, cond_index: int, w_in, b_in, w_eff,
                         skip_acc, w_end, b_eff, dilation: int,
                         n_valid: int | None = None):
    """:func:`wn_layer_final` with pre-materialised conditioning: slice
    ``cond_index`` of ``cond_all`` [B, T, 2C * L] bf16, read in place."""
    if _on_cpu(x, cond_all, w_in, b_in, w_eff, skip_acc, w_end, b_eff):
        return wn_layer_final_dcond_plain(x, cond_all, cond_index, w_in, b_in,
                                          w_eff, skip_acc, w_end, b_eff,
                                          dilation, n_valid)
    B, T, C = x.shape
    E = w_end.shape[-1]
    n_valid = T if n_valid is None else int(n_valid)
    ld, off = _check_cond_all(cond_all, cond_index, B, T, C, n_valid,
                              dilation)
    if not 1 <= E <= 8:
        raise ValueError(f"kernel takes E in [1, 8], got {E}")
    bf = torch.bfloat16
    for name, t, shape, dt in (
        ("x", x, (B, T, C), bf),
        ("w_in", w_in, (3, C, 2 * C), bf), ("b_in", b_in, (2 * C,), F32),
        ("w_eff", w_eff, (C, E), bf), ("skip_acc", skip_acc, (B, T, C), bf),
        ("w_end", w_end, (C, E), bf), ("b_eff", b_eff, (E,), F32),
    ):
        _check(name, t, shape, dt)
    out = torch.empty((B, T, E), dtype=F32, device=x.device)
    wn_layer_final_dcond.launches += 1
    _run(LIB.get().t2s_wn_layer_final_dcond, x.device, x.data_ptr(),
         cond_all.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
         w_eff.data_ptr(), skip_acc.data_ptr(), w_end.data_ptr(),
         b_eff.data_ptr(), out.data_ptr(), B, T, n_valid, C, ld, off, E,
         dilation)
    return out


KERNELS = (wn_layer_first_dcond, wn_layer_dcond, wn_layer_final_dcond)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
