"""Fused WN-layer kernels of the WaveGlow serving path, and their plain
PyTorch versions.

Counterpart of ``text2speech_tpu/ops/pallas/wn_block.py``'s three shipping
kernels (``wn_layer_stream2_first``, ``wn_layer_stream2``,
``wn_layer_stream2_final``) and of its tensor-parallel partial layer
(``wn_layer_stream2_partial``: one rank's share of a layer, for
:mod:`..parallel.tp`); the composed-conditioning flavours of the three
roles are in :mod:`.wn_block_dcond`.  Each role has

* a plain PyTorch version (``*_plain``), the arithmetic of the Pallas
  kernel in float32 matmuls over the input dtype's values, used for CPU
  tensors and as the reference the CUDA kernels are checked against;
* a wrapper (:func:`wn_layer_first`, :func:`wn_layer`,
  :func:`wn_layer_final`, :func:`wn_layer_partial`) that launches a
  hand-written Hopper kernel for CUDA tensors, and takes the plain version
  only for CPU tensors.  The first, standard, final and partial layers
  launch ``csrc/wn_block_sm90.cu`` (wgmma, TMA, 128-row tiles;
  :func:`sm90_plan` picks the tile), the partial layer's layer-0 form
  too, as the kernel's ``PART_FIRST`` role.  A CUDA tensor the kernel does
  not take raises; nothing falls back.

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
LIB_SM90 = CudaLibrary("wn_block_sm90", {
    "t2s_wn_layer_sm90": [_P] * 10 + [_I] * 10 + [_P],
    "t2s_wn_layer_final_sm90": [_P] * 11 + [_I] * 10 + [_P],
    "t2s_wn_layer_dcond_sm90": [_P] * 8 + [_I] * 11 + [_P],
    "t2s_wn_layer_final_dcond_sm90": [_P] * 9 + [_I] * 11 + [_P],
    "t2s_wn_layer_partial_sm90": [_P] * 8 + [_I] * 11 + [_P],
    "t2s_wn_layer_partial_first_sm90": [_P] * 9 + [_I] * 11 + [_P],
    "t2s_wn_layer_first_sm90": [_P] * 13 + [_I] * 10 + [_P],
    "t2s_wn_layer_first_dcond_sm90": [_P] * 11 + [_I] * 11 + [_P],
    "t2s_wn_sm90_smem_bytes": [_I] * 5,
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


def _edge_bias_suppress(in_act, b_edge, d: int, n_valid: int):
    """Take the folded start bias back where the left (t < d) or right
    (t >= n_valid - d) tap reads the conv's zero padding."""
    rows = torch.arange(in_act.shape[1], device=in_act.device)[None, :, None]
    in_act = in_act - torch.where(rows < d, b_edge[0], 0.0)
    return in_act - torch.where(rows >= n_valid - d, b_edge[1], 0.0)


def _end_projection(acts, w_eff, skip_acc, w_end, b_eff):
    """acts @ w_eff + skip_acc @ w_end + b_eff in f32."""
    return (acts.to(F32) @ w_eff.to(F32) + skip_acc.to(F32) @ w_end.to(F32)
            + b_eff)


def fold_first_taps(start_k, start_b, w_in, b_in):
    """Compose the start 1x1 projection onto layer 0's taps (rank n_half),
    as ``wn_block.py:151 _fold_first_taps`` and the wrapper lines after it:
    (wp [3, n_half, 2C] in ``start_k``'s dtype, b_all = b_in + folded tap
    bias [2C] f32, b_edge [2, 2C] f32: the tap bias to take back where the
    left or right tap reads past an edge).  Done once per checkpoint."""
    wp = torch.einsum("nc,tco->tno", start_k.to(F32), w_in.to(F32))
    tap_bias = torch.einsum("c,tco->to", start_b.to(F32), w_in.to(F32))
    return (wp.to(start_k.dtype).contiguous(),
            (b_in.to(F32) + tap_bias.sum(0)).contiguous(),
            torch.stack([tap_bias[0], tap_bias[2]]).contiguous())


def fold_end(w_rs, b_rs, w_end, b_end):
    """Fold the last res/skip matmul into the rank-E end projection, as
    ``wn_block.py:558-562``: (w_eff = w_rs @ w_end in w_rs's dtype, b_eff =
    b_rs @ w_end + b_end in f32).  Done once per checkpoint."""
    w_eff = (w_rs.to(F32) @ w_end.to(F32)).to(w_rs.dtype)
    b_eff = b_rs.to(F32) @ w_end.to(F32) + b_end.to(F32)
    return w_eff.contiguous(), b_eff.contiguous()


def std_body(x, cond, w_in, b_in, w_rs, b_rs, skip_acc, dilation: int,
             n_valid: int | None):
    """The standard layer on its conditioning ``cond`` [B, T, 2C] f32,
    wherever that comes from -> (x_new, skip_acc + skip)."""
    T, C = x.shape[1], x.shape[2]
    n_valid = T if n_valid is None else n_valid
    in_act = _taps(x, w_in, dilation, n_valid) + b_in.to(F32) + cond
    rs = _gate(in_act, w_in.dtype).to(F32) @ w_rs.to(F32) + b_rs.to(F32)
    valid = _valid_rows(T, n_valid, x.device)
    if w_rs.shape[-1] == 2 * C:
        x_out = torch.where(valid, (x.to(F32) + rs[..., :C]).to(x.dtype), 0)
        skip = rs[..., C:]
    else:
        x_out = torch.where(valid, x, 0)
        skip = rs
    return x_out, skip_acc + skip.to(skip_acc.dtype)


def first_body(x0, cond, out_dtype, start_k, start_b, wp, b_all, b_edge,
               w_rs, b_rs, dilation: int, n_valid: int | None):
    """The first layer on its conditioning ``cond`` [B, T, 2C] f32 ->
    (x_hidden, skip) in ``out_dtype``."""
    T, C = x0.shape[1], start_k.shape[-1]
    n_valid = T if n_valid is None else n_valid
    d = dilation
    in_act = _taps(x0, wp, d, n_valid) + b_all + cond
    in_act = _edge_bias_suppress(in_act, b_edge, d, n_valid)
    rs = _gate(in_act, x0.dtype).to(F32) @ w_rs.to(F32) + b_rs.to(F32)
    xh = x0.to(F32) @ start_k.to(F32) + start_b.to(F32)
    x_out = torch.where(_valid_rows(T, n_valid, x0.device),
                        (xh + rs[..., :C]).to(out_dtype), 0)
    return x_out, rs[..., C:].to(out_dtype)


def final_body(x, cond, w_in, b_in, w_eff, skip_acc, w_end, b_eff,
               dilation: int, n_valid: int | None):
    """The final layer on its conditioning ``cond`` [B, T, 2C] f32 ->
    [B, T, E] f32."""
    n_valid = x.shape[1] if n_valid is None else n_valid
    in_act = _taps(x, w_in, dilation, n_valid) + b_in.to(F32) + cond
    return _end_projection(_gate(in_act, w_in.dtype), w_eff, skip_acc, w_end,
                           b_eff)


def wn_layer_plain(x, spect, w_in, b_in, w_cond, b_cond, w_rs, b_rs,
                   skip_acc, dilation: int, n_valid: int | None = None):
    """Standard layer -> (x_new, skip_acc + skip).  ``w_rs`` is [C, 2C]
    (residual + skip) or [C, C] (skip only, hidden state passes through)."""
    return std_body(x, _cond(spect, w_cond, b_cond), w_in, b_in, w_rs, b_rs,
                    skip_acc, dilation, n_valid)


def wn_layer_first_plain(x0, spect, start_k, start_b, wp, b_all, b_edge,
                         w_cond, b_cond, w_rs, b_rs, dilation: int,
                         n_valid: int | None = None):
    """Start projection + layer 0 -> (x_hidden, skip), equal to
    ``wn_layer_plain(x0 @ start_k + start_b, ...)`` with a zero skip sum,
    at rank-n_half tap cost (``wn_block.py:281``).  ``wp``, ``b_all``,
    ``b_edge`` come from :func:`fold_first_taps`."""
    return first_body(x0, _cond(spect, w_cond, b_cond), spect.dtype, start_k,
                      start_b, wp, b_all, b_edge, w_rs, b_rs, dilation,
                      n_valid)


def wn_layer_final_plain(x, spect, w_in, b_in, w_cond, b_cond, w_eff,
                         skip_acc, w_end, b_eff, dilation: int,
                         n_valid: int | None = None):
    """Last layer + folded end projection -> (b, log_s) terms [B, T, E]
    f32 (``wn_block.py:325``, ``fold_rs=True``).  ``w_eff``, ``b_eff``
    come from :func:`fold_end`."""
    return final_body(x, _cond(spect, w_cond, b_cond), w_in, b_in, w_eff,
                      skip_acc, w_end, b_eff, dilation, n_valid)


def wn_layer_partial_plain(x, spect, w_in, b_in, w_cond, b_cond, w_rs,
                           dilation: int, b_edge=None,
                           n_valid: int | None = None):
    """One rank's share of a WN layer under tensor parallelism -> its
    partial res/skip product [B, T, rs_out] f32 (``wn_block.py:612
    _kernel_stream2_partial``): taps and conditioning on the rank's
    gate-paired columns ``w_in`` [3, K, 2Cp] / ``w_cond`` [M, 2Cp], the gate
    in f32 cast to ``w_in``'s dtype, then its rows ``w_rs`` [Cp, rs_out].
    Rows at or past ``n_valid`` are zero.  No res/skip bias, residual or
    skip sum: they need the sum over ranks.  With ``b_edge`` [2, 2Cp] it is
    the layer-0 form: ``x`` is the audio half [B, T, n_half] under the
    composed taps, and the folded start bias is taken back at the edges."""
    T = x.shape[1]
    n_valid = T if n_valid is None else n_valid
    in_act = (_taps(x, w_in, dilation, n_valid) + b_in.to(F32)
              + _cond(spect, w_cond, b_cond))
    if b_edge is not None:
        in_act = _edge_bias_suppress(in_act, b_edge, dilation, n_valid)
    rs = _gate(in_act, w_in.dtype).to(F32) @ w_rs.to(F32)
    return torch.where(_valid_rows(T, n_valid, x.device), rs, 0.0)


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


def _check_dims(C: int, M: int, T: int, n_valid: int, d: int,
                m_multiple: int = 32) -> None:
    if C % 128 or M % m_multiple or C <= 0 or M <= 0:
        raise ValueError(f"kernel needs C % 128 == 0 and M % {m_multiple} "
                         f"== 0, got C={C}, M={M}")
    if T < 1 or not 0 <= n_valid <= T or d < 0:
        raise ValueError(f"bad T={T}, n_valid={n_valid}, dilation={d}")


# The launch plan of ``csrc/wn_block_sm90.cu`` (its constants, restated):
# a block is ``nwg`` consumer warpgroups of 64 rows and one producer
# warpgroup; a ring stage holds a [bk, 256] bf16 weight tile and a
# [64 nwg, bk] bf16 activation tile; the gated tile is [64 nwg, C] bf16;
# the tap stage of the first layer and of the partial layer's layer-0
# form has its own [64 nwg, bk] bf16 activation tile after it; 1 KB
# aligns the ring, and 64 bytes of static shared memory hold its
# mbarriers.
SM90_SMEM_LIMIT = 232448       # shared memory a block may use on an H100
SM90_STATIC_SMEM = 64
SM90_MAX_STAGES = 4
SM90_SMS = 132                 # streaming multiprocessors of an H100 SXM
# the kernel's roles (its ``enum Role``); the ``dcond`` forms share them
SM90_ROLES = {"std": 0, "final": 1, "part": 2, "first": 3, "part_first": 4}
# the roles with a tap stage (and its tile)
SM90_TAP_ROLES = ("first", "part_first")


def _sm90_stage_bytes(nwg: int, bk: int) -> int:
    return bk * 256 * 2 + nwg * 64 * bk * 2


def sm90_smem_bytes(nwg: int, bk: int, C: int, stages: int,
                    role: str = "std") -> int:
    """Dynamic shared memory of one block (the kernel's ``smem_bytes``)."""
    taps = nwg * 64 * bk * 2 if role in SM90_TAP_ROLES else 0
    return (1024 + stages * _sm90_stage_bytes(nwg, bk) + nwg * 64 * C * 2
            + taps)


def _sm90_stages(nwg: int, bk: int, C: int, role: str) -> int:
    free = (SM90_SMEM_LIMIT - SM90_STATIC_SMEM
            - sm90_smem_bytes(nwg, bk, C, 0, role))
    return min(SM90_MAX_STAGES, max(free, 0) // _sm90_stage_bytes(nwg, bk))


def sm90_plan(C: int, T: int = 1, B: int = 1, role: str = "std") -> dict:
    """Tile of ``csrc/wn_block_sm90.cu``'s ``role`` (a key of
    :data:`SM90_ROLES`) for gate width ``C`` and ``B`` utterances of ``T``
    rows (the ``dcond`` layers' ring stage is the in-kernel projection's;
    only their K, 3C in place of 3C + M, is shorter; the partial layer's
    ``C`` is the rank's width Cp, its taps' K the hidden state's, and its
    layer-0 form, ``"part_first"``, has the first layer's tap tile).  Rows:
    128-row blocks (two consumer warpgroups) where the gated tile fits (C
    <= 512) and the grid fills the card's SMs at least once, else 64-row
    blocks, twice as many.  K per stage: 64 where three or more such
    stages fit beside the gated tile (and the tap tile), else 32; the
    ring is as deep as fits, up to four stages.  Raises ValueError where
    no tile fits in shared memory."""
    if role not in SM90_ROLES:
        raise ValueError(f"no role {role!r} of the sm90 WN-layer kernel")
    nwg = 2 if C <= 512 and B * -(-T // 128) >= SM90_SMS else 1
    bk = 64 if _sm90_stages(nwg, 64, C, role) >= 3 else 32
    stages = _sm90_stages(nwg, bk, C, role)
    if stages >= 2:
        bm = 64 * nwg
        return {"nwg": nwg, "bm": bm, "bk": bk, "stages": stages,
                "threads": 128 * (nwg + 1),
                "smem": sm90_smem_bytes(nwg, bk, C, stages, role),
                "grid": (-(-T // bm), B)}
    raise ValueError(f"no tile of the sm90 WN-layer kernel fits C={C} in "
                     f"{SM90_SMEM_LIMIT} bytes of shared memory")


def _run(fn, device: torch.device, *args) -> None:
    """Launch on ``device`` (made current for the call, so a tensor on
    another card than the current one is not launched in the wrong
    context) and its current stream; raise on a CUDA error."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")


def wn_layer_first(x0, spect, start_k, start_b, wp, b_all, b_edge, w_cond,
                   b_cond, w_rs, b_rs, dilation: int,
                   n_valid: int | None = None):
    """Fused start projection + first WN layer -> (x_hidden, skip).

    CUDA: bf16 ``x0`` [B, T, n_half <= 4], ``spect`` [B, T, M], ``start_k``
    [n_half, C], ``wp`` [3, n_half, 2C], ``w_cond`` [M, 2C], ``w_rs``
    [C, 2C]; f32 biases, ``b_edge`` [2, 2C].  ``wp``, ``b_all``, ``b_edge``
    are :func:`fold_first_taps` of the layer's weights, folded once per
    checkpoint by the caller.  CUDA: the ``FIRST`` role of
    ``csrc/wn_block_sm90.cu`` with :func:`sm90_plan` ``(role="first")``."""
    if _on_cpu(x0, spect, start_k, start_b, wp, b_all, b_edge, w_cond,
               b_cond, w_rs, b_rs):
        return wn_layer_first_plain(x0, spect, start_k, start_b, wp, b_all,
                                    b_edge, w_cond, b_cond, w_rs, b_rs,
                                    dilation, n_valid)
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
        ("wp", wp, (3, n_half, 2 * C), bf), ("b_all", b_all, (2 * C,), F32),
        ("b_edge", b_edge, (2, 2 * C), F32),
        ("w_cond", w_cond, (M, 2 * C), bf), ("b_cond", b_cond, (2 * C,), F32),
        ("w_rs", w_rs, (C, 2 * C), bf), ("b_rs", b_rs, (2 * C,), F32),
    ):
        _check(name, t, shape, dt)
    plan = sm90_plan(C, T, B, role="first")
    x_out = torch.empty((B, T, C), dtype=bf, device=x0.device)
    skip = torch.empty((B, T, C), dtype=bf, device=x0.device)
    wn_layer_first.launches += 1
    _run(LIB_SM90.get().t2s_wn_layer_first_sm90, x0.device, x0.data_ptr(),
         spect.data_ptr(), wp.data_ptr(), b_all.data_ptr(),
         b_edge.data_ptr(), w_cond.data_ptr(), b_cond.data_ptr(),
         w_rs.data_ptr(), b_rs.data_ptr(), start_k.data_ptr(),
         start_b.data_ptr(), x_out.data_ptr(), skip.data_ptr(), B, T,
         n_valid, C, M, n_half, dilation, plan["nwg"], plan["bk"],
         plan["stages"])
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
    plan = sm90_plan(C, T, B)
    x_out = torch.empty_like(x)
    wn_layer.launches += 1
    _run(LIB_SM90.get().t2s_wn_layer_sm90, x.device, x.data_ptr(),
         spect.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
         w_cond.data_ptr(), b_cond.data_ptr(), w_rs.data_ptr(),
         b_rs.data_ptr(), skip_acc.data_ptr(), x_out.data_ptr(), B, T,
         n_valid, C, M, rs_out, dilation, plan["nwg"], plan["bk"],
         plan["stages"])
    return x_out, skip_acc


def wn_layer_final(x, spect, w_in, b_in, w_cond, b_cond, w_eff, skip_acc,
                   w_end, b_eff, dilation: int, n_valid: int | None = None):
    """Last WN layer + folded end projection -> [B, T, E] f32.

    CUDA: as :func:`wn_layer`, with ``w_eff`` [C, E <= 8] bf16 and
    ``b_eff`` [E] f32 in place of the res/skip weights (:func:`fold_end`,
    folded once per checkpoint by the caller) and ``w_end`` [C, E] bf16."""
    if _on_cpu(x, spect, w_in, b_in, w_cond, b_cond, w_eff, skip_acc, w_end,
               b_eff):
        return wn_layer_final_plain(x, spect, w_in, b_in, w_cond, b_cond,
                                    w_eff, skip_acc, w_end, b_eff, dilation,
                                    n_valid)
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
        ("w_eff", w_eff, (C, E), bf), ("skip_acc", skip_acc, (B, T, C), bf),
        ("w_end", w_end, (C, E), bf), ("b_eff", b_eff, (E,), F32),
    ):
        _check(name, t, shape, dt)
    plan = sm90_plan(C, T, B)
    out = torch.empty((B, T, E), dtype=F32, device=x.device)
    wn_layer_final.launches += 1
    _run(LIB_SM90.get().t2s_wn_layer_final_sm90, x.device, x.data_ptr(),
         spect.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
         w_cond.data_ptr(), b_cond.data_ptr(), w_eff.data_ptr(),
         skip_acc.data_ptr(), w_end.data_ptr(), b_eff.data_ptr(),
         out.data_ptr(), B, T, n_valid, C, M, E, dilation, plan["nwg"],
         plan["bk"], plan["stages"])
    return out


def check_partial_dims(Cp: int, rs_out: int) -> None:
    """What the partial kernels need of a rank's share: whole gate-pair
    chunks of 64 columns, whole res/skip chunks of 128."""
    if Cp < 64 or Cp % 64 or rs_out < 128 or rs_out % 128:
        raise ValueError(f"kernel needs Cp % 64 == 0 and rs_out % 128 == 0, "
                         f"got Cp={Cp}, rs_out={rs_out}")


def wn_layer_partial(x, spect, w_in, b_in, w_cond, b_cond, w_rs,
                     dilation: int, b_edge=None, n_valid: int | None = None):
    """One rank's share of a fused WN layer -> partial res/skip [B, T,
    rs_out] f32, written whole (zero at rows >= ``n_valid``); sum the
    ranks' partials, then add the res/skip bias once.

    CUDA: bf16 ``x`` [B, T, C] (or, with ``b_edge`` [2, 2Cp] f32, the audio
    half [B, T, n_half <= 4] under ``w_in`` = this rank's columns of the
    composed taps), ``spect`` [B, T, M], ``w_in`` [3, K, 2Cp], ``w_cond``
    [M, 2Cp], ``w_rs`` [Cp, rs_out]; f32 ``b_in``, ``b_cond`` [2Cp].  The
    layers 1..L-1 launch ``csrc/wn_block_sm90.cu``'s ``PART`` form with
    :func:`sm90_plan` of width Cp; the layer-0 form (``b_edge``; ``w_in``
    and ``b_in`` are then :func:`fold_first_taps`'s wp and b_all of the
    rank's columns) its ``PART_FIRST`` role with ``sm90_plan(Cp, T, B,
    role="part_first")``: the rank-n_half taps as one K = 16 stage of the
    in-act product."""
    ts = [x, spect, w_in, b_in, w_cond, b_cond, w_rs]
    if b_edge is not None:
        ts.append(b_edge)
    if _on_cpu(*ts):
        return wn_layer_partial_plain(x, spect, w_in, b_in, w_cond, b_cond,
                                      w_rs, dilation, b_edge, n_valid)
    B, T, K = x.shape
    M = spect.shape[-1]
    Cp, rs_out = w_rs.shape
    n_valid = T if n_valid is None else int(n_valid)
    check_partial_dims(Cp, rs_out)
    if b_edge is None:
        _check_dims(K, M, T, n_valid, dilation)
    else:
        _check_dims(128, M, T, n_valid, dilation)
        if not 1 <= K <= 4:
            raise ValueError(f"layer-0 form takes n_half in [1, 4], got {K}")
        _check("b_edge", b_edge, (2, 2 * Cp), F32)
    bf = torch.bfloat16
    for name, t, shape, dt in (
        ("x", x, (B, T, K), bf), ("spect", spect, (B, T, M), bf),
        ("w_in", w_in, (3, K, 2 * Cp), bf), ("b_in", b_in, (2 * Cp,), F32),
        ("w_cond", w_cond, (M, 2 * Cp), bf),
        ("b_cond", b_cond, (2 * Cp,), F32), ("w_rs", w_rs, (Cp, rs_out), bf),
    ):
        _check(name, t, shape, dt)
    plan = sm90_plan(Cp, T, B, role="part" if b_edge is None
                     else "part_first")
    out = torch.empty((B, T, rs_out), dtype=F32, device=x.device)
    wn_layer_partial.launches += 1
    if b_edge is None:
        _run(LIB_SM90.get().t2s_wn_layer_partial_sm90, x.device,
             x.data_ptr(), spect.data_ptr(), w_in.data_ptr(),
             b_in.data_ptr(), w_cond.data_ptr(), b_cond.data_ptr(),
             w_rs.data_ptr(), out.data_ptr(), B, T, n_valid, K, Cp, M,
             rs_out, dilation, plan["nwg"], plan["bk"], plan["stages"])
    else:
        _run(LIB_SM90.get().t2s_wn_layer_partial_first_sm90, x.device,
             x.data_ptr(), spect.data_ptr(), w_in.data_ptr(),
             b_in.data_ptr(), b_edge.data_ptr(), w_cond.data_ptr(),
             b_cond.data_ptr(), w_rs.data_ptr(), out.data_ptr(), B, T,
             n_valid, K, Cp, M, rs_out, dilation, plan["nwg"], plan["bk"],
             plan["stages"])
    return out


# the partial layer's launches are counted with the tensor-parallel path
# (``parallel.tp.launch_counts``), not with the three whole-layer roles
wn_layer_partial.launches = 0
KERNELS = (wn_layer_first, wn_layer, wn_layer_final)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
