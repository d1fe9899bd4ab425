"""The padded-layout WN-layer family and its plain PyTorch versions: the
port's second, independent implementation of the WN layer, the oracle side
of the parity ladder (counterpart of ``text2speech_tpu/ops/pallas/
wn_block_padded.py``, which the JAX package keeps for the same purpose; no
serving or training path runs it).

Layout: ``[B, Tp, C]`` with ``Tp = T + 2 * BT_PAD``, one tile of
:data:`BT_PAD` zero rows on each side of the T real rows
(:func:`pad_tiles`).  The pad tiles give the dilated taps their edge zeros,
so a layer reads its halo rows ``t +- d`` without a bounds test as long as
``d <= BT_PAD``.  Every output is padded too and zero in the pad tiles.
Real rows at or past ``n_valid`` (a runtime argument) get a zero hidden
state; the skip outputs are not masked there.

Four roles, each with a plain version (``*_plain``, f32 matmuls over the
input dtype's values, used for CPU tensors and as the reference the CUDA
kernels are checked against) and a wrapper that launches a hand-written
Hopper kernel for CUDA tensors (a CUDA tensor the kernel does not take
raises; nothing falls back): ``csrc/wn_block_padded_tiles_sm90.cu``
(``wgmma``, TMA, the TPU kernel's three neighbour tiles as three boxes per
K chunk; its ``SPECT`` and ``PADDED`` roles, :func:`padded_tiles_plan`
picks the ring's depth) for the first two, ``csrc/wn_block_padded_sm90.cu``
(``wgmma``, TMA, one x window per K chunk; its ``STREAM`` and
``STREAM_FINAL`` roles, :func:`padded_sm90_plan` picks the ring depths) for
the stream pair:

* :func:`wn_layer_padded` (``:104 wn_layer_padded``): the layer's own 2C
  slice ``cond_index`` of a pre-materialized ``cond_p`` that already holds
  ``b_cond``; returns ``(x_new, skip)``, the skip not accumulated;
* :func:`wn_layer_spect` (``:165``): the conditioning projected in the
  layer, returns ``(x_new, skip_acc + skip)``;
* :func:`wn_layer_stream` (``:302``): the contract of ``wn_layer_spect``
  from another loop structure (the TPU kernel's one-tile-behind walk);
* :func:`wn_layer_stream_final` (``:353``): the last layer with the end
  projection folded in, ``wn_out = bf16(skip_acc + rs) @ w_end + b_end``
  [B, Tp, E] f32, not masked at ``n_valid``.

The JAX tile is 512 rows; the port's pad width is its own:
:data:`BT_PAD` = 128, the largest dilation of the reference config
(2^(L-1)), which also divides the smoke's T = 6400.  It is a layout
constant, not a CUDA block's row tile (a block of either Hopper kernel
covers 64 rows).

The plain versions of ``spect`` and ``stream`` are two implementations
too: whole-array shifted matmuls against a walk over the pad tiles with a
two-tile ring (``_ring_window_padded``, ``wn_block_padded.py:233``).

Each wrapper counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaLibrary
from .wn_block import _check, _gate, _on_cpu, _run

BT_PAD = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
LIB_SM90 = CudaLibrary("wn_block_padded_sm90", {
    "t2s_wn_stream_sm90": [_P] * 10 + [_I] * 10 + [_P],
    "t2s_wn_stream_final_sm90": [_P] * 12 + [_I] * 9 + [_P],
    "t2s_wn_padded_sm90_smem_bytes": [_I] * 5,
})
LIB_TILES = CudaLibrary("wn_block_padded_tiles_sm90", {
    "t2s_wn_spect_tiles_sm90": [_P] * 10 + [_I] * 9 + [_P],
    "t2s_wn_padded_tiles_sm90": [_P] * 8 + [_I] * 10 + [_P],
    "t2s_wn_padded_tiles_sm90_smem_bytes": [_I] * 3,
})

F32 = torch.float32


def pad_tiles(x: torch.Tensor, bt: int = BT_PAD) -> torch.Tensor:
    """[B, T, C] -> [B, T + 2 bt, C] with a zero tile on each side
    (T % bt == 0)."""
    B, T, C = x.shape
    if T % bt:
        raise ValueError(f"T={T} must be a multiple of the pad tile {bt}")
    z = x.new_zeros((B, bt, C))
    return torch.cat([z, x, z], dim=1)


def unpad_tiles(x: torch.Tensor, bt: int = BT_PAD) -> torch.Tensor:
    return x[:, bt:-bt]


# ---------------------------------------------------------------------------
# plain versions (wn_block_padded.py:67-281 and the helpers wn_block.py:52-138)
# ---------------------------------------------------------------------------


def _real_rows(Tp: int, bt: int, device) -> torch.Tensor:
    """bool [1, Tp, 1]: rows outside the two pad tiles."""
    t = torch.arange(Tp, device=device)
    return ((t >= bt) & (t < Tp - bt))[None, :, None]


def _valid_rows(Tp: int, bt: int, n_valid: int, device) -> torch.Tensor:
    """bool [1, Tp, 1]: real rows before ``n_valid``."""
    t = torch.arange(Tp, device=device)
    return ((t >= bt) & (t - bt < n_valid))[None, :, None]


def _shifted(xp: torch.Tensor, s: int) -> torch.Tensor:
    """y[:, t] = xp[:, t + s] (zero past the ends; the real rows never read
    there, since |s| <= bt)."""
    y = torch.zeros_like(xp)
    Tp = xp.shape[1]
    if s >= 0:
        y[:, : Tp - s] = xp[:, s:]
    else:
        y[:, -s:] = xp[:, : Tp + s]
    return y


def _taps_padded(xp, w_in, d: int) -> torch.Tensor:
    """x[t-d] w0 + x[t] w1 + x[t+d] w2 in f32 over the padded array: the
    three dots of ``_taps`` summed in the same order."""
    xf = xp.to(F32)
    return (_shifted(xf, -d) @ w_in[0].to(F32) + xf @ w_in[1].to(F32)
            + _shifted(xf, d) @ w_in[2].to(F32))


def _layer_out(xp, rs, skip_acc, bt: int, n_valid: int):
    """``_store_layer_out`` over the padded array, pad tiles zeroed:
    (x_new, skip) or, with ``skip_acc``, (x_new, skip_acc + skip)."""
    Tp, C = xp.shape[1], xp.shape[2]
    valid = _valid_rows(Tp, bt, n_valid, xp.device)
    real = _real_rows(Tp, bt, xp.device)
    if rs.shape[-1] == 2 * C:
        x_new = torch.where(valid, (xp.to(F32) + rs[..., :C]).to(xp.dtype), 0)
        skip = rs[..., C:]
    else:
        x_new = torch.where(valid, xp, 0)
        skip = rs
    skip = skip.to(xp.dtype if skip_acc is None else skip_acc.dtype)
    if skip_acc is not None:
        skip = skip_acc + skip
    return x_new, torch.where(real, skip, 0)


def _gate_rs(in_act, w_in_dtype, w_rs, b_rs) -> torch.Tensor:
    return _gate(in_act, w_in_dtype).to(F32) @ w_rs.to(F32) + b_rs.to(F32)


def _n_valid(xp, bt: int, n_valid) -> int:
    return xp.shape[1] - 2 * bt if n_valid is None else int(n_valid)


def wn_layer_padded_plain(xp, cond_p, w_in, b_in, w_rs, b_rs, dilation: int,
                          cond_index: int = 0, n_valid: int | None = None,
                          bt: int = BT_PAD):
    """Kernel 12's arithmetic -> (x_new, skip), both padded."""
    C = xp.shape[-1]
    cond = cond_p[..., 2 * C * cond_index: 2 * C * (cond_index + 1)]
    in_act = _taps_padded(xp, w_in, dilation) + b_in.to(F32) + cond.to(F32)
    rs = _gate_rs(in_act, w_in.dtype, w_rs, b_rs)
    return _layer_out(xp, rs, None, bt,
                      _n_valid(xp, bt, n_valid))


def wn_layer_spect_plain(xp, spect_p, w_in, b_in, w_cond, b_cond, w_rs, b_rs,
                         skip_acc, dilation: int, n_valid: int | None = None,
                         bt: int = BT_PAD):
    """Kernel 13's arithmetic over the whole padded array ->
    (x_new, skip_acc + skip)."""
    cond = spect_p.to(F32) @ w_cond.to(F32) + b_cond.to(F32)
    in_act = _taps_padded(xp, w_in, dilation) + b_in.to(F32) + cond
    rs = _gate_rs(in_act, w_in.dtype, w_rs, b_rs)
    return _layer_out(xp, rs, skip_acc, bt,
                      _n_valid(xp, bt, n_valid))


def _stream_walk(xp, spect_p, w_in, b_in, w_cond, b_cond, w_rs, b_rs,
                 dilation: int, bt: int, emit):
    """The one-tile-behind walk of ``_kernel_stream``: step s reads tile s
    and computes tile s - 1 from a two-slot ring of the tiles before it
    (``_ring_window_padded``); ``emit(j, mid, rs)`` stores output tile j's
    real rows.  Pad tiles are left to the caller."""
    n_tiles, d = xp.shape[1] // bt, dilation
    ring = [None, None]
    for s in range(n_tiles + 1):
        j = s - 1
        if 1 <= j <= n_tiles - 2:
            prev1, prev2 = ring[s % 2], ring[(s + 1) % 2]
            x0 = xp[:, s * bt:(s + 1) * bt]
            win = torch.cat([prev2[:, bt - d:], prev1, x0[:, :d]], 1).to(F32)
            rows = slice(j * bt, (j + 1) * bt)
            taps = (win[:, :bt] @ w_in[0].to(F32)
                    + win[:, d:d + bt] @ w_in[1].to(F32)
                    + win[:, 2 * d:2 * d + bt] @ w_in[2].to(F32))
            cond = spect_p[:, rows].to(F32) @ w_cond.to(F32) + b_cond.to(F32)
            emit(j, prev1, _gate_rs(taps + b_in.to(F32) + cond, w_in.dtype,
                                    w_rs, b_rs))
        if s <= n_tiles - 1:
            ring[(s + 1) % 2] = xp[:, s * bt:(s + 1) * bt]


def wn_layer_stream_plain(xp, spect_p, w_in, b_in, w_cond, b_cond, w_rs,
                          b_rs, skip_acc, dilation: int,
                          n_valid: int | None = None, bt: int = BT_PAD):
    """Kernel 14's arithmetic as the TPU kernel walks it -> (x_new,
    skip_acc + skip)."""
    C = xp.shape[-1]
    n_valid = _n_valid(xp, bt, n_valid)
    x_new, skip = torch.zeros_like(xp), torch.zeros_like(skip_acc)
    rows = torch.arange(bt, device=xp.device)[None, :, None]

    def emit(j, mid, rs):
        t = slice(j * bt, (j + 1) * bt)
        ok = (j - 1) * bt + rows < n_valid
        if rs.shape[-1] == 2 * C:
            x_new[:, t] = torch.where(
                ok, (mid.to(F32) + rs[..., :C]).to(xp.dtype), 0)
            sk = rs[..., C:]
        else:
            x_new[:, t] = torch.where(ok, mid, 0)
            sk = rs
        skip[:, t] = skip_acc[:, t] + sk.to(skip_acc.dtype)

    _stream_walk(xp, spect_p, w_in, b_in, w_cond, b_cond, w_rs, b_rs,
                 dilation, bt, emit)
    return x_new, skip


def wn_layer_stream_final_plain(xp, spect_p, w_in, b_in, w_cond, b_cond,
                                w_rs, b_rs, skip_acc, w_end, b_end,
                                dilation: int, n_valid: int | None = None,
                                bt: int = BT_PAD):
    """Kernel 15's arithmetic -> wn_out [B, Tp, E] f32 (``n_valid`` is
    accepted for a uniform signature and, as in the TPU kernel, not
    applied)."""
    B, Tp, _ = xp.shape
    out = xp.new_zeros((B, Tp, w_end.shape[-1]), dtype=F32)

    def emit(j, mid, rs):
        t = slice(j * bt, (j + 1) * bt)
        sk = (skip_acc[:, t].to(F32) + rs).to(w_in.dtype)
        out[:, t] = sk.to(F32) @ w_end.to(F32) + b_end.to(F32)

    _stream_walk(xp, spect_p, w_in, b_in, w_cond, b_cond, w_rs, b_rs,
                 dilation, bt, emit)
    return out


# ---------------------------------------------------------------------------
# the launch plan of csrc/wn_block_padded_sm90.cu (its constants, restated)
# ---------------------------------------------------------------------------

# A block is one consumer warpgroup of PADDED_SM90_BM = 64 rows and one
# producer warp (128-row blocks of two warpgroups were timed and lost,
# PERF.md).  Its dynamic shared memory: 1 KB of alignment, the gated tile
# [64, C] bf16, ``nwin`` window slots (``padded_window``: the rows [t0 - d,
# t0 + 64 + d) of a 64-channel K chunk, 128 bytes a row, in one or two TMA
# boxes of at most 256 rows), ``nwst`` weight slots of [64, 128] bf16 and,
# in the final role, w_end staged as [C, 8] bf16; twelve mbarriers are
# static.
PADDED_SM90_ROLES = {"stream": 0, "stream_final": 1}
PADDED_SM90_BM = 64
PADDED_SM90_SMEM_LIMIT = 232448     # shared memory a block may use, H100
PADDED_SM90_STATIC_SMEM = 96
PADDED_SM90_WSLOT = 2 * 64 * 64 * 2
PADDED_SM90_MAX_WST = 4


def padded_window(d: int) -> tuple:
    """(boxes, rows per box) of a window slot: 64 + 2d rows in one TMA box,
    or two where that passes 256; a box's rows are a multiple of 8."""
    rows = PADDED_SM90_BM + 2 * d
    nb = 2 if rows > 256 else 1
    return nb, (-(-rows // nb) + 7) // 8 * 8


def padded_sm90_smem_bytes(role: str, C: int, d: int, nwin: int,
                           nwst: int) -> int:
    """Dynamic shared memory of one block (the kernel's ``padded_smem``)."""
    nb, h = padded_window(d)
    return (1024 + PADDED_SM90_BM * C * 2 + nwin * nb * h * 128
            + nwst * PADDED_SM90_WSLOT
            + (C * 8 * 2 if role == "stream_final" else 0))


def padded_sm90_plan(C: int, T: int, B: int, d: int,
                     role: str = "stream") -> dict:
    """Ring depths of ``csrc/wn_block_padded_sm90.cu``'s ``role`` (a key of
    :data:`PADDED_SM90_ROLES`) for gate width ``C``, ``B`` utterances of
    ``T`` real rows and dilation ``d``: two window slots where they fit
    beside the gated tile and two weight slots, else one; the weight ring
    as deep as fits, up to four.  ``tiles`` is the count of 64-row tiles,
    which the persistent grid walks.  Raises ValueError where nothing fits
    in shared memory."""
    if role not in PADDED_SM90_ROLES:
        raise ValueError(f"no role {role!r} of the padded sm90 kernel")
    free = PADDED_SM90_SMEM_LIMIT - PADDED_SM90_STATIC_SMEM
    for nwin in (2, 1):
        nwst = min(PADDED_SM90_MAX_WST,
                   (free - padded_sm90_smem_bytes(role, C, d, nwin, 0))
                   // PADDED_SM90_WSLOT)
        if nwst >= 2:
            return {"bm": PADDED_SM90_BM, "nwin": nwin, "nwst": nwst,
                    "window": padded_window(d),
                    "smem": padded_sm90_smem_bytes(role, C, d, nwin, nwst),
                    "tiles": B * (T // PADDED_SM90_BM)}
    raise ValueError(f"the padded sm90 kernel ({role}) does not fit C={C} at "
                     f"dilation {d} in {PADDED_SM90_SMEM_LIMIT} bytes of "
                     f"shared memory")


# ---------------------------------------------------------------------------
# the launch plan of csrc/wn_block_padded_tiles_sm90.cu (its constants,
# restated)
# ---------------------------------------------------------------------------

# A block is one consumer warpgroup of PADDED_TILES_BM = 64 rows and one
# producer warp.  Its dynamic shared memory: 1 KB of alignment, the gated
# tile [64, C] bf16, in the PADDED role a cond slot (the gate chunk's 64
# tanh and 64 sigmoid columns of ``cond_p``, [64, 128] bf16), and ``nst``
# ring stages of PADDED_TILES_STAGE bytes (a tap's or a spect [64, 64] box
# and a [64, 128] weight tile); 2 MAX_ST + 2 mbarriers are static.
PADDED_TILES_ROLES = {"spect": 0, "padded": 1}
PADDED_TILES_BM = 64
PADDED_TILES_STAGE = 64 * 64 * 2 + 2 * 64 * 64 * 2
PADDED_TILES_CSLOT = 2 * 64 * 64 * 2
PADDED_TILES_MAX_ST = 8
PADDED_TILES_STATIC_SMEM = 8 * (2 * PADDED_TILES_MAX_ST + 2)


def padded_tiles_smem_bytes(role: str, C: int, nst: int) -> int:
    """Dynamic shared memory of one block (the kernel's ``tiles_smem``)."""
    return (1024 + PADDED_TILES_BM * C * 2
            + (PADDED_TILES_CSLOT if role == "padded" else 0)
            + nst * PADDED_TILES_STAGE)


def padded_tiles_plan(C: int, T: int, B: int, d: int,
                      role: str = "spect") -> dict:
    """The ring's depth of ``csrc/wn_block_padded_tiles_sm90.cu``'s ``role``
    (a key of :data:`PADDED_TILES_ROLES`) for gate width ``C``, ``B``
    utterances of ``T`` real rows and dilation ``d``: as many stages as fit
    beside the gated tile (and the cond slot), up to eight, at least two.
    The three tap boxes are 64 rows each at any ``d``, so the dilation
    moves nothing here.  ``tiles`` is the count of 64-row tiles, which the
    persistent grid walks.  Raises ValueError where two stages do not
    fit in shared memory."""
    if role not in PADDED_TILES_ROLES:
        raise ValueError(f"no role {role!r} of the padded tiles kernel")
    free = PADDED_SM90_SMEM_LIMIT - PADDED_TILES_STATIC_SMEM
    nst = min(PADDED_TILES_MAX_ST,
              (free - padded_tiles_smem_bytes(role, C, 0))
              // PADDED_TILES_STAGE)
    if nst < 2:
        raise ValueError(f"the padded tiles kernel ({role}) does not fit "
                         f"C={C} (dilation {d}) in {PADDED_SM90_SMEM_LIMIT} "
                         f"bytes of shared memory")
    return {"bm": PADDED_TILES_BM, "nst": nst,
            "smem": padded_tiles_smem_bytes(role, C, nst),
            "tiles": B * (T // PADDED_TILES_BM)}


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_layout(B: int, Tp: int, C: int, M: int, n_valid: int, d: int,
                  bt: int) -> None:
    if bt != BT_PAD:
        raise ValueError(f"the kernels take the pad tile {BT_PAD}, got {bt}")
    if Tp % bt or Tp < 3 * bt:
        raise ValueError(f"Tp={Tp} must be a multiple of {bt}, at least "
                         f"three tiles")
    if C % 64 or C <= 0 or M % 32 or M < 0:
        raise ValueError(f"kernel needs C % 64 == 0 and M % 32 == 0, got "
                         f"C={C}, M={M}")
    if not 0 <= d <= bt or not 0 <= n_valid <= Tp - 2 * bt or B < 1:
        raise ValueError(f"bad dilation={d} (<= {bt}), n_valid={n_valid} "
                         f"or B={B}")


def _check_rs(w_rs, C: int) -> int:
    rs_out = w_rs.shape[-1]
    if rs_out not in (C, 2 * C):
        raise ValueError(f"w_rs must be [C, 2C] or [C, C], got "
                         f"{tuple(w_rs.shape)}")
    return rs_out


def wn_layer_padded(xp, cond_p, w_in, b_in, w_rs, b_rs, dilation: int,
                    cond_index: int = 0, n_valid: int | None = None,
                    bt: int = BT_PAD):
    """One WN layer on the padded layout with the layer's slice of a
    pre-materialized conditioning -> (x_new, skip), padded.

    CUDA: bf16 ``xp`` [B, Tp, C], ``cond_p`` [B, Tp, 2C n_cond],
    ``w_in`` [3, C, 2C], ``w_rs`` [C, 2C] or [C, C]; f32 biases; the
    ``PADDED`` role of ``csrc/wn_block_padded_tiles_sm90.cu`` with
    :func:`padded_tiles_plan`."""
    if _on_cpu(xp, cond_p, w_in, b_in, w_rs, b_rs):
        return wn_layer_padded_plain(xp, cond_p, w_in, b_in, w_rs, b_rs,
                                     dilation, cond_index, n_valid, bt)
    B, Tp, C = xp.shape
    n_valid = _n_valid(xp, bt, n_valid)
    _check_layout(B, Tp, C, 0, n_valid, dilation, bt)
    rs_out = _check_rs(w_rs, C)
    n_cond = cond_p.shape[-1] // (2 * C)
    if cond_p.shape[-1] != 2 * C * n_cond or not 0 <= cond_index < n_cond:
        raise ValueError(f"cond_p width {cond_p.shape[-1]} is not a whole "
                         f"number of 2C slices, or cond_index {cond_index} "
                         f"is out of range")
    bf = torch.bfloat16
    for name, t, shape, dt in (
        ("xp", xp, (B, Tp, C), bf), ("cond_p", cond_p, (B, Tp, 2 * C * n_cond),
                                     bf),
        ("w_in", w_in, (3, C, 2 * C), bf), ("b_in", b_in, (2 * C,), F32),
        ("w_rs", w_rs, (C, rs_out), bf), ("b_rs", b_rs, (rs_out,), F32),
    ):
        _check(name, t, shape, dt)
    plan = padded_tiles_plan(C, Tp - 2 * bt, B, dilation, "padded")
    x_out, skip = torch.empty_like(xp), torch.empty_like(xp)
    wn_layer_padded.launches += 1
    _run(LIB_TILES.get().t2s_wn_padded_tiles_sm90, xp.device, xp.data_ptr(),
         cond_p.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
         w_rs.data_ptr(), b_rs.data_ptr(), x_out.data_ptr(), skip.data_ptr(),
         B, Tp, bt, n_valid, C, n_cond, cond_index, rs_out, dilation,
         plan["nst"])
    return x_out, skip


def _spect_args(name, xp, spect_p, w_in, b_in, w_cond, b_cond, w_rs, b_rs,
                skip_acc, dilation, n_valid, bt):
    """Checks shared by the spect and stream wrappers -> (B, Tp, C, M,
    rs_out, n_valid)."""
    B, Tp, C = xp.shape
    M = spect_p.shape[-1]
    n_valid = _n_valid(xp, bt, n_valid)
    _check_layout(B, Tp, C, M, n_valid, dilation, bt)
    if M == 0:
        raise ValueError(f"{name}: spect_p has no channels")
    rs_out = _check_rs(w_rs, C)
    bf = torch.bfloat16
    for n, t, shape, dt in (
        ("xp", xp, (B, Tp, C), bf), ("spect_p", spect_p, (B, Tp, M), bf),
        ("w_in", w_in, (3, C, 2 * C), bf), ("b_in", b_in, (2 * C,), F32),
        ("w_cond", w_cond, (M, 2 * C), bf), ("b_cond", b_cond, (2 * C,), F32),
        ("w_rs", w_rs, (C, rs_out), bf), ("b_rs", b_rs, (rs_out,), F32),
        ("skip_acc", skip_acc, (B, Tp, C), bf),
    ):
        _check(n, t, shape, dt)
    if skip_acc.untyped_storage().data_ptr() in (
            xp.untyped_storage().data_ptr(),
            spect_p.untyped_storage().data_ptr()):
        raise ValueError(f"{name}: skip_acc is updated in place and must not "
                         f"share memory with xp or spect_p")
    return B, Tp, C, M, rs_out, n_valid


def wn_layer_spect(xp, spect_p, w_in, b_in, w_cond, b_cond, w_rs, b_rs,
                   skip_acc, dilation: int, n_valid: int | None = None,
                   bt: int = BT_PAD):
    """One WN layer with the conditioning projected in the kernel ->
    (x_new, skip_acc + skip), padded.

    CUDA: bf16 ``xp`` / ``skip_acc`` [B, Tp, C], ``spect_p`` [B, Tp, M],
    ``w_in`` [3, C, 2C], ``w_cond`` [M, 2C], ``w_rs`` [C, 2C] or [C, C];
    f32 biases.  The skip sum is updated IN PLACE on CUDA (the returned
    skip tensor is ``skip_acc``, as the TPU kernel aliases it); the plain
    version returns a new tensor.  CUDA: the ``SPECT`` role of
    ``csrc/wn_block_padded_tiles_sm90.cu`` with :func:`padded_tiles_plan`."""
    if _on_cpu(xp, spect_p, w_in, b_in, w_cond, b_cond, w_rs, b_rs,
               skip_acc):
        return wn_layer_spect_plain(xp, spect_p, w_in, b_in, w_cond, b_cond,
                                    w_rs, b_rs, skip_acc, dilation, n_valid,
                                    bt)
    B, Tp, C, M, rs_out, n_valid = _spect_args(
        "wn_layer_spect", xp, spect_p, w_in, b_in, w_cond, b_cond, w_rs,
        b_rs, skip_acc, dilation, n_valid, bt)
    plan = padded_tiles_plan(C, Tp - 2 * bt, B, dilation, "spect")
    x_out = torch.empty_like(xp)
    wn_layer_spect.launches += 1
    _run(LIB_TILES.get().t2s_wn_spect_tiles_sm90, xp.device, xp.data_ptr(),
         spect_p.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
         w_cond.data_ptr(), b_cond.data_ptr(), w_rs.data_ptr(),
         b_rs.data_ptr(), skip_acc.data_ptr(), x_out.data_ptr(), B, Tp, bt,
         n_valid, C, M, rs_out, dilation, plan["nst"])
    return x_out, skip_acc


def wn_layer_stream(xp, spect_p, w_in, b_in, w_cond, b_cond, w_rs, b_rs,
                    skip_acc, dilation: int, n_valid: int | None = None,
                    bt: int = BT_PAD):
    """The contract of :func:`wn_layer_spect` from another implementation
    (skip sum in place on CUDA, as there): the plain version walks the TPU
    kernel's one-tile-behind ring; on CUDA ``csrc/wn_block_padded_sm90.cu``'s
    STREAM role reads each x window once per K chunk, on the tensor
    cores."""
    if _on_cpu(xp, spect_p, w_in, b_in, w_cond, b_cond, w_rs, b_rs,
               skip_acc):
        return wn_layer_stream_plain(xp, spect_p, w_in, b_in, w_cond, b_cond,
                                     w_rs, b_rs, skip_acc, dilation, n_valid,
                                     bt)
    B, Tp, C, M, rs_out, n_valid = _spect_args(
        "wn_layer_stream", xp, spect_p, w_in, b_in, w_cond, b_cond, w_rs,
        b_rs, skip_acc, dilation, n_valid, bt)
    plan = padded_sm90_plan(C, Tp - 2 * bt, B, dilation, "stream")
    x_out = torch.empty_like(xp)
    wn_layer_stream.launches += 1
    _run(LIB_SM90.get().t2s_wn_stream_sm90, xp.device, xp.data_ptr(),
         spect_p.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
         w_cond.data_ptr(), b_cond.data_ptr(), w_rs.data_ptr(),
         b_rs.data_ptr(), skip_acc.data_ptr(), x_out.data_ptr(), B, Tp, bt,
         n_valid, C, M, rs_out, dilation, plan["nwin"], plan["nwst"])
    return x_out, skip_acc


def wn_layer_stream_final(xp, spect_p, w_in, b_in, w_cond, b_cond, w_rs,
                          b_rs, skip_acc, w_end, b_end, dilation: int,
                          n_valid: int | None = None, bt: int = BT_PAD):
    """The last WN layer with the end projection folded in -> wn_out
    [B, Tp, E] f32, zero in the pad tiles.

    CUDA: as :func:`wn_layer_spect` with ``w_rs`` [C, C], ``b_rs`` [C],
    ``w_end`` [C, E <= 8] bf16 and ``b_end`` [E] f32."""
    if _on_cpu(xp, spect_p, w_in, b_in, w_cond, b_cond, w_rs, b_rs,
               skip_acc, w_end, b_end):
        return wn_layer_stream_final_plain(xp, spect_p, w_in, b_in, w_cond,
                                           b_cond, w_rs, b_rs, skip_acc,
                                           w_end, b_end, dilation, n_valid,
                                           bt)
    if w_rs.shape[-1] != xp.shape[-1]:
        raise ValueError("the final layer emits skip only: w_rs is [C, C]")
    B, Tp, C, M, _, _ = _spect_args(
        "wn_layer_stream_final", xp, spect_p, w_in, b_in, w_cond, b_cond,
        w_rs, b_rs, skip_acc, dilation, n_valid, bt)
    E = w_end.shape[-1]
    if not 1 <= E <= 8:
        raise ValueError(f"kernel takes E in [1, 8], got {E}")
    _check("w_end", w_end, (C, E), torch.bfloat16)
    _check("b_end", b_end, (E,), F32)
    plan = padded_sm90_plan(C, Tp - 2 * bt, B, dilation, "stream_final")
    out = torch.empty((B, Tp, E), dtype=F32, device=xp.device)
    wn_layer_stream_final.launches += 1
    _run(LIB_SM90.get().t2s_wn_stream_final_sm90, xp.device, xp.data_ptr(),
         spect_p.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
         w_cond.data_ptr(), b_cond.data_ptr(), w_rs.data_ptr(),
         b_rs.data_ptr(), skip_acc.data_ptr(), w_end.data_ptr(),
         b_end.data_ptr(), out.data_ptr(), B, Tp, bt, C, M, E, dilation,
         plan["nwin"], plan["nwst"])
    return out


KERNELS = (wn_layer_padded, wn_layer_spect, wn_layer_stream,
           wn_layer_stream_final)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
