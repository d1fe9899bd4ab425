"""The decomposition of ``csrc/wn_backward_sm90.cu`` (the k=3 dilated conv
backward for Hopper), checked on the CPU.

The kernel cannot run here, so a PyTorch "tile walk" follows its blocking
and its launch plan (``wn_backward.bwd_plan``) exactly, for both routes:

* wgmma (bf16, C % 128 == 0): dx tiles of [128 t, 256 c], K = 3 * 2C in
  stages of 64 that each lie inside one tap: A is a box of g at rows t0 +
  (1-j)d with rows outside [0, T) zero (TMA's fill), B the [256 c, 64 o]
  box of W_j with columns c >= C zero; dW_j tiles of [128 c, 256 o] over
  stages of 64 rows of one utterance: A = x^T, boxes of x at rows t0 +
  (j-1)d (zero outside [0, T)), as stored [t][c] and so read transposed
  (wgmma's MN-major A), B = g rows t0.. with rows past T zero;
* FMA (f32, and bf16 at other widths): the same with [128, 128] tiles and
  stages of 16;

dW in the plan's S splits of each tile's stages (split s takes stages
[total s / S, total (s+1) / S)) into f32 partials, summed in the fixed
order s = 0, 1, ...; dx rounded to x's dtype once at the end.  The walk is
held to the JAX package's Pallas kernel (``conv_k3_bwd_pallas``, interpret
mode, on ``pad_tiles`` inputs: the ragged T is zero-extended to the tile,
which changes neither dW nor the first T rows of dx) and to ``jax.vjp`` of
``conv_k3_fwd_xla``.

Tolerances are ``tests/test_torch_wn_backward.py``'s (the JAX package's own
for this kernel, ``tests/test_pallas.py:311-314``): f32 sums in another
order, dx to 2e-4 and dW to 2e-3 absolute with 1e-4 relative.  In bf16 the
references run in f32 on the same bf16-rounded values and the walk's dx is
rounded to bf16 once: one bf16 step (2^-8 relative) more on dx."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text2speech_tpu.ops.pallas.wn_backward import (conv_k3_bwd_pallas,
                                                    conv_k3_fwd_xla)
from text2speech_tpu.ops.pallas.wn_block import BT
from text2speech_tpu.ops.pallas.wn_block_padded import pad_tiles
from text2speech_tpu_torch.ops import wn_backward as twb

torch.set_num_threads(1)

F32 = torch.float32


def _rows(src, b, idx, extent):
    """src[b, idx] with rows outside [0, extent) read as zero."""
    out = torch.zeros(len(idx), src.shape[-1], dtype=F32)
    ok = (idx >= 0) & (idx < extent)
    out[ok] = src[b, idx[ok]].to(F32)
    return out


def _cols(a, c0, n):
    """Columns [c0, c0 + n) of a 2-D tensor, zero past its end."""
    out = torch.zeros(a.shape[0], n, dtype=F32)
    m = min(n, max(a.shape[1] - c0, 0))
    out[:, :m] = a[:, c0:c0 + m].to(F32)
    return out


def walk_dx(x, g, w, d, route):
    """dx as the kernel's dx blocks compute it, in x's dtype."""
    B, T, C = x.shape
    bm, bn, bk, _ = twb.BWD_TILES[route]
    dx = torch.zeros(B, T, C, dtype=F32)
    wt = [torch.cat([w[j].to(F32), torch.zeros(bn, 2 * C)]) for j in range(3)]
    for b in range(B):
        for t0 in range(0, T, bm):
            rows = torch.arange(t0, t0 + bm)
            for c0 in range(0, C, bn):
                acc = torch.zeros(bm, bn)
                for j in range(3):
                    a_tap = _rows(g, b, rows + (1 - j) * d, T)
                    for o0 in range(0, 2 * C, bk):    # one stage, one tap
                        b_box = wt[j][c0:c0 + bn, o0:o0 + bk]  # [n][k]
                        acc += a_tap[:, o0:o0 + bk] @ b_box.T
                n_r, n_c = min(bm, T - t0), min(bn, C - c0)
                dx[b, t0:t0 + n_r, c0:c0 + n_c] = acc[:n_r, :n_c]
    return dx.to(x.dtype)


def walk_dw(x, g, d, route, S):
    """dW as the kernel's split dW blocks and the ordered sum compute it ->
    (dW, the partials [3, S, C, 2C])."""
    B, T, C = x.shape
    bm, bn, bk, _ = twb.BWD_TILES[route]
    nt = -(-T // bk)
    total = B * nt
    partial = torch.zeros(3, S, C, 2 * C)
    for j in range(3):
        for m0 in range(0, C, bm):
            for n0 in range(0, 2 * C, bn):
                for s in range(S):
                    acc = torch.zeros(bm, bn)
                    for q in range(total * s // S, total * (s + 1) // S):
                        b, t0 = q // nt, (q % nt) * bk
                        rows = torch.arange(t0, t0 + bk)
                        # A as TMA stores it: [t][c], x rows shifted by
                        # (j-1)d; wgmma reads it MN-major, i.e. A = box^T
                        a_box = _cols(_rows(x, b, rows + (j - 1) * d, T),
                                      m0, bm)
                        b_box = _cols(_rows(g, b, rows, T), n0, bn)
                        acc += a_box.T @ b_box
                    mr, nr = min(bm, C - m0), min(bn, 2 * C - n0)
                    partial[j, s, m0:m0 + mr, n0:n0 + nr] = acc[:mr, :nr]
    dw = partial[:, 0].clone()
    for s in range(1, S):                 # the second pass, in order
        dw += partial[:, s]
    return dw, partial


def _inputs(seed, B, T, C):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, C).astype(np.float32),
            (0.3 * rng.randn(3, C, 2 * C)).astype(np.float32),
            rng.randn(B, T, 2 * C).astype(np.float32))


def _references(x, w, g, d):
    """(Pallas on the zero-extended pad_tiles layout, jax.vjp of the XLA
    conv), each (dx [B, T, C], dW) as numpy f32."""
    B, T, C = x.shape
    Tt = -(-T // BT) * BT
    ext = [np.concatenate([a, np.zeros((B, Tt - T, a.shape[-1]), np.float32)],
                          1) for a in (x, g)]
    dx_p, dw_p = conv_k3_bwd_pallas(pad_tiles(jnp.asarray(ext[0])),
                                    pad_tiles(jnp.asarray(ext[1])),
                                    jnp.asarray(w), d)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    _, vjp = jax.vjp(lambda x_, w_: conv_k3_fwd_xla(x_, w_, d), jx, jw)
    dx_r, dw_r = vjp(jnp.asarray(g))
    return ((np.asarray(dx_p)[:, :T], np.asarray(dw_p)),
            (np.asarray(dx_r), np.asarray(dw_r)))


@pytest.mark.parametrize("d", [1, 4, 128])
@pytest.mark.parametrize("dtype,C", [(F32, 128), (torch.bfloat16, 128),
                                     (torch.bfloat16, 24)])
def test_walk_matches_pallas_and_conv_vjp(d, dtype, C):
    """T = 1000 is ragged against every tile and stage (128, 64, 16 rows);
    bf16 at C = 128 takes the wgmma route, f32 and bf16 at C = 24 the FMA
    route."""
    B, T = 2, 1000
    x, w, g = _inputs(5 + d + C, B, T, C)
    tx, tw, tg = (torch.from_numpy(a).to(dtype) for a in (x, w, g))
    plan = twb.bwd_plan(B, T, C, dtype)
    assert plan["route"] == ("wgmma" if dtype == torch.bfloat16 and C == 128
                             else "fma")
    dx = walk_dx(tx, tg, tw, d, plan["route"])
    dw, _ = walk_dw(tx, tg, d, plan["route"], plan["splits"])
    assert dx.dtype == dtype and dw.dtype == F32
    # the references see the same (rounded) values, in f32
    vals = [t.float().numpy() for t in (tx, tw, tg)]
    rtol_dx = 1e-4 if dtype == F32 else 2.0 ** -8
    for want_dx, want_dw in _references(*vals, d):
        np.testing.assert_allclose(dx.float().numpy(), want_dx, atol=2e-4,
                                   rtol=rtol_dx)
        np.testing.assert_allclose(dw.numpy(), want_dw, atol=2e-3, rtol=1e-4)


@pytest.mark.parametrize("route", ["wgmma", "fma"])
def test_split_sum_is_fixed_order_and_independent_of_s(route):
    """Every S gives dW within f32 rounding of S = 1; each split's partial
    is the sum over exactly its stages; the ordered sum is the same from
    run to run (no atomics)."""
    B, T, C, d = 2, 333, 128, 8
    x, _, g = map(torch.from_numpy, _inputs(11, B, T, C))
    one, _ = walk_dw(x, g, d, route, 1)
    for S in (2, 3, 5):
        dw, partial = walk_dw(x, g, d, route, S)
        torch.testing.assert_close(dw, one, atol=2e-4, rtol=1e-5)
        again, _ = walk_dw(x, g, d, route, S)
        assert torch.equal(dw, again)
        torch.testing.assert_close(partial.sum(1), one, atol=2e-4, rtol=1e-5)


def test_walk_reads_zero_outside_the_sequence():
    """A dilation past T: every tap but the centre reads TMA's zero fill,
    so dx is g W1^T and dW has only its centre tap."""
    B, T, C, d = 1, 100, 128, 128
    x, w, g = map(torch.from_numpy, _inputs(12, B, T, C))
    dx = walk_dx(x, g, w, d, "wgmma")
    torch.testing.assert_close(dx, g @ w[1].T, atol=2e-4, rtol=1e-4)
    dw, _ = walk_dw(x, g, d, "wgmma", 2)
    assert not dw[0].any() and not dw[2].any()
    torch.testing.assert_close(dw[1], x[0].T @ g[0], atol=2e-3, rtol=1e-4)


# --- the launch plan ----------------------------------------------------------


@pytest.mark.parametrize("dtype,route,S,n_dx,n_dw", [
    # the main shape: 96 dx blocks of 48 stages and 48 dW tiles of 96 row
    # stages, 69.8 stages a block slot: 2 splits of 48
    (torch.bfloat16, "wgmma", 2, 96, 96),
    # f32: 192 dx blocks of 192 stages and 96 dW tiles of 375, 276 stages a
    # slot (two blocks per SM): twice 2 splits
    (F32, "fma", 4, 192, 384),
])
def test_bwd_plan_at_the_training_shape(dtype, route, S, n_dx, n_dw):
    plan = twb.bwd_plan(3, 2000, 512, dtype)
    assert (plan["route"], plan["splits"], plan["dx_blocks"],
            plan["dw_blocks"]) == (route, S, n_dx, n_dw)
    bm, bn, bk, _ = twb.BWD_TILES[route]
    assert plan["dx_stages"] == 3 * 1024 // bk
    assert plan["row_stages"] == 3 * -(-2000 // bk)


@pytest.mark.parametrize("dtype,B,T,C,S", [
    # few blocks: one wave whatever the split, so no split
    (torch.bfloat16, 1, 2000, 512, 1), (torch.bfloat16, 16, 64, 512, 1),
    # many rows: a slot's share outlasts a dx block
    (torch.bfloat16, 8, 2000, 512, 2), (torch.bfloat16, 3, 6400, 512, 2),
    # narrow: short dx blocks, so the dW tiles are cut finer
    (torch.bfloat16, 3, 2000, 256, 4), (F32, 3, 2000, 256, 8),
    (F32, 1, 2000, 512, 2), (F32, 8, 2000, 512, 4),
])
def test_bwd_plan_split_rule(dtype, B, T, C, S):
    """S is the least split (times the route's blocks per SM) that leaves
    no dW block longer than the longer of a dx block and one block slot's
    share of all the stages."""
    plan = twb.bwd_plan(B, T, C, dtype)
    assert plan["splits"] == S
    per_sm = twb.BWD_TILES[plan["route"]][3]
    slots = twb.BWD_SMS * per_sm
    share = (plan["dx_blocks"] * plan["dx_stages"]
             + plan["dw_blocks"] // S * plan["row_stages"]) / slots
    limit = max(plan["dx_stages"], share)
    k = S // per_sm
    assert S % per_sm == 0
    assert plan["row_stages"] / k <= limit
    assert k == 1 or plan["row_stages"] / (k - 1) > limit


@pytest.mark.parametrize("B,T,C", [(1, 1, 8), (2, 77, 128), (4, 6400, 512),
                                   (3, 2000, 384)])
def test_bwd_plan_blocks_cover_the_work(B, T, C):
    for dtype in (F32, torch.bfloat16):
        plan = twb.bwd_plan(B, T, C, dtype)
        bm, bn, bk, _ = twb.BWD_TILES[plan["route"]]
        assert plan["dx_blocks"] == -(-T // bm) * -(-C // bn) * B
        tiles = 3 * -(-C // bm) * -(-2 * C // bn)
        assert plan["dw_blocks"] == tiles * plan["splits"]
        assert 1 <= plan["splits"] <= min(twb.BWD_MAX_SPLITS,
                                          plan["row_stages"])


def test_bwd_plan_raises_for_widths_no_route_takes():
    for C in (4, 12, 130):
        with pytest.raises(ValueError, match="C % 8"):
            twb.bwd_plan(1, 10, C, F32)


def test_sm90_ctypes_signature():
    """``t2s_conv_k3_bwd_sm90`` in ``csrc/wn_backward_sm90.cu`` takes what
    ``ops/wn_backward.py`` declares to ctypes."""
    import ctypes
    import re
    from pathlib import Path

    src = (Path(twb.__file__).parent.parent / "csrc"
           / "wn_backward_sm90.cu").read_text()
    decls = dict(re.findall(r"^int (t2s_\w+)\(([^)]*)\)", src, re.M))
    assert set(decls) == set(twb.LIB_SM90.signatures)
    for name, params in decls.items():
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in params.split(",")]
        assert kinds == twb.LIB_SM90.signatures[name], name
