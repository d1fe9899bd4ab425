"""The decomposition of ``csrc/wn_block_sm90.cu``'s ``PART`` form (one
rank's share of a WN layer under tensor parallelism, layers 1..L-1),
checked on the CPU.

The kernel cannot run here, so a PyTorch "tile walk" follows its blocking:
blocks of ``sm90_plan``'s rows for the rank's width Cp; an activation
operand of K = 3 CX + M (the three taps of the whole hidden state, CX wide,
read at rows t-d, t, t+d and zero outside [0, n_valid), as TMA's
out-of-bounds fill gives them, then the spect rows) summed in f32 over the
plan's K stages; gate-pair chunks of 128 tanh + 128 sigmoid of the rank's
columns, the last one half (64 + 64) where Cp % 128 == 64; the gated tile
rounded to the input dtype; the res/skip product [rows, Cp] x [Cp, rs_out]
in chunks of 256 columns (the last one zero-filled past rs_out); the f32
partial written whole, zero at rows >= n_valid, with no bias.  The walk is
held to the JAX package's Pallas kernel (interpret mode) and to the port's
plain version.

Tolerances, those of the standard layer's walk
(``tests/test_torch_wn_block_sm90.py``).  Against Pallas in float32: the
same f32 products over K = 3 CX + M = 832 terms summed in another order,
values of order 1: 2e-5 absolute.  Against the plain version in bf16: both
round the gated activation to bf16, and f32 sums in another order can land
on the other side of a bf16 rounding boundary: four bf16 steps (2^-8 of
the value) at the output's peak, relative L2 under 5e-3."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text2speech_tpu.ops.pallas import wn_block as jwb
from text2speech_tpu_torch.ops import wn_block as twb
from text2speech_tpu_torch.parallel.tp import pair_cols

torch.set_num_threads(1)

CX, M = 256, 64          # the hidden state's width; Cp = CX / p
F32 = torch.float32
ATOL = 2e-5
BF16_MAX_ABS_STEPS = 4 * 2.0 ** -8
BF16_REL_L2 = 5e-3
GN = 256                 # gate-pair chunk (128 + 128) and res/skip chunk


def _rows(src, b, idx, extent):
    """src[b, idx] with rows outside [0, extent) read as zero."""
    out = torch.zeros(len(idx), src.shape[-1], dtype=src.dtype)
    ok = (idx >= 0) & (idx < extent)
    out[ok] = src[b, idx[ok]]
    return out


def tile_walk_partial(x, spect, w_in, b_in, w_cond, b_cond, w_rs, d, n_valid,
                      bm=None):
    """The partial layer as the kernel computes it -> [B, T, rs_out] f32."""
    B, T, cx = x.shape
    Cp, rs_out = w_rs.shape
    plan = twb.sm90_plan(Cp, T, B)
    bm, bk = bm or plan["bm"], plan["bk"]
    w_k = torch.cat(([w_in.reshape(3 * cx, 2 * Cp)] if n_valid else [])
                    + [w_cond]).to(F32)
    bias = b_in.to(F32) + b_cond.to(F32)
    out = torch.empty(B, T, rs_out)
    for b in range(B):
        for t0 in range(0, T, bm):
            rows = torch.arange(t0, t0 + bm)
            parts = [] if n_valid == 0 else [
                _rows(x, b, rows + s, n_valid) for s in (-d, 0, d)]
            a_op = torch.cat(parts + [_rows(spect, b, rows, T)], -1).to(F32)
            gated = torch.empty(bm, Cp, dtype=x.dtype)
            for c0 in range(0, Cp, GN // 2):
                # the chunk's four 64-column weight boxes: past the rank's
                # columns they hold other columns or zeros, never gated
                box = [c0, c0 + 64, Cp + c0, Cp + c0 + 64]
                cols = torch.cat([torch.arange(c, c + 64) for c in box])
                w_chunk = torch.zeros(w_k.shape[0], GN)
                ok = cols < 2 * Cp
                w_chunk[:, ok] = w_k[:, cols[ok]]
                acc = torch.zeros(bm, GN)
                for k0 in range(0, a_op.shape[1], bk):
                    acc += a_op[:, k0:k0 + bk] @ w_chunk[k0:k0 + bk]
                in_act = acc + torch.cat([bias, torch.zeros(GN)])[
                    torch.where(ok, cols, 2 * Cp)]
                width = min(GN // 2, Cp - c0)    # 64 in a half chunk
                gated[:, c0:c0 + width] = (
                    torch.tanh(in_act[:, :width])
                    * torch.sigmoid(in_act[:, GN // 2:GN // 2 + width])
                ).to(x.dtype)
            n_rows = min(bm, T - t0)
            valid = (rows[:n_rows] < n_valid)[:, None]
            g = gated.to(F32)
            for n0 in range(0, rs_out, GN):
                w_n = torch.zeros(Cp, GN)
                nn = min(GN, rs_out - n0)
                w_n[:, :nn] = w_rs[:, n0:n0 + nn].to(F32)
                acc = torch.zeros(bm, GN)
                for k0 in range(0, Cp, bk):
                    acc += g[:, k0:k0 + bk] @ w_n[k0:k0 + bk]
                out[b, t0:t0 + n_rows, n0:n0 + nn] = torch.where(
                    valid, acc[:n_rows, :nn], 0.0)
    return out


def _layer(seed, B, T, n_valid, rs_out, p, i, dtype=F32):
    """numpy inputs of a whole layer and rank i of p's share as tensors."""
    rng = np.random.RandomState(seed)
    mask = (np.arange(T) < n_valid)[None, :, None]

    def rn(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    k = {"x": rn(B, T, CX, scale=0.3) * mask,
         "spect": rn(B, T, M, scale=0.3),
         "w_in": rn(3, CX, 2 * CX, scale=(3 * CX) ** -0.5),
         "b_in": rn(2 * CX, scale=0.1),
         "w_cond": rn(M, 2 * CX, scale=M ** -0.5),
         "b_cond": rn(2 * CX, scale=0.1),
         "w_rs": rn(CX, rs_out, scale=CX ** -0.5)}
    cols, s = pair_cols(CX, p, i), CX // p
    share = {"x": k["x"], "spect": k["spect"],
             "w_in": k["w_in"][..., cols], "b_in": k["b_in"][cols],
             "w_cond": k["w_cond"][:, cols], "b_cond": k["b_cond"][cols],
             "w_rs": k["w_rs"][i * s:(i + 1) * s]}
    t = {n: torch.from_numpy(np.ascontiguousarray(v)) for n, v in
         share.items()}
    for n in ("x", "spect", "w_in", "w_cond", "w_rs"):
        t[n] = t[n].to(dtype)
    return share, t


NAMES = ["x", "spect", "w_in", "b_in", "w_cond", "b_cond", "w_rs"]


def _bf16_close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    peak = max(want.abs().max().item(), 1.0)
    assert (got - want).abs().max().item() <= BF16_MAX_ABS_STEPS * peak
    if want.norm() > 0:
        assert ((got - want).norm() / want.norm()).item() <= BF16_REL_L2


# --- against the Pallas kernel (interpret mode), float32 --------------------


@pytest.mark.parametrize("p", [4, 2, 1])          # Cp = 64, 128, 256
@pytest.mark.parametrize("rs_full", [True, False])
@pytest.mark.parametrize("d,n_valid", [(1, 511), (130, 389)])
def test_tile_walk_partial_matches_pallas(p, rs_full, d, n_valid):
    T = 512
    share, t = _layer(60 + p + d, 1, T, n_valid, 2 * CX if rs_full else CX,
                      p, p - 1)
    want = jwb.wn_layer_stream2_partial(
        *[jnp.asarray(share[n]) for n in NAMES], d, n_valid=n_valid)
    got = tile_walk_partial(*[t[n] for n in NAMES], d, n_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# --- against the plain version, bf16, T and n_valid off the tile grid ------


@pytest.mark.parametrize("p", [4, 2, 1])
@pytest.mark.parametrize("rs_full", [True, False])
@pytest.mark.parametrize("n_valid,d", [(332, 1), (129, 64), (0, 130)])
def test_tile_walk_partial_matches_plain_bf16(p, rs_full, n_valid, d):
    T = 333
    _, t = _layer(70 + p + n_valid, 2, T, n_valid, 2 * CX if rs_full else CX,
                  p, 0, dtype=torch.bfloat16)
    args = [t[n] for n in NAMES]
    want = twb.wn_layer_partial_plain(*args, d, n_valid=n_valid)
    got = tile_walk_partial(*args, d, n_valid)
    assert got.dtype == F32 and (got[:, n_valid:] == 0).all()
    if n_valid:
        _bf16_close(got, want)


def test_tile_walk_partial_is_independent_of_the_row_tile():
    T, n_valid, d = 333, 300, 64
    _, t = _layer(80, 1, T, n_valid, 2 * CX, 2, 1)
    args = [t[n] for n in NAMES]
    a = tile_walk_partial(*args, d, n_valid, bm=64)
    b = tile_walk_partial(*args, d, n_valid, bm=128)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_ranks_sum_to_the_whole_layer():
    """The p = 4 ranks' walks plus the res/skip bias are the whole layer's
    plain res/skip product (f32)."""
    T, n_valid, d = 200, 190, 3
    rng = np.random.RandomState(90)
    b_rs = torch.from_numpy(rng.randn(2 * CX).astype(np.float32) * 0.1)
    total = None
    for i in range(4):
        share, t = _layer(91, 1, T, n_valid, 2 * CX, 4, i)
        part = tile_walk_partial(*[t[n] for n in NAMES], d, n_valid)
        total = part if total is None else total + part
    k = _layer(91, 1, T, n_valid, 2 * CX, 1, 0)[1]
    in_act = (twb._taps(k["x"], k["w_in"], d, n_valid) + k["b_in"]
              + twb._cond(k["spect"], k["w_cond"], k["b_cond"]))
    whole = twb._gate(in_act, F32) @ k["w_rs"] + b_rs
    torch.testing.assert_close((total + b_rs)[:, :n_valid],
                               whole[:, :n_valid], atol=ATOL, rtol=0)


# --- the launch plan at the partial layer's widths --------------------------


@pytest.mark.parametrize("Cp", [64, 128, 192, 256, 320, 512, 1024, 1472])
@pytest.mark.parametrize("T,B", [(6400, 1), (6400, 3)])
def test_sm90_plan_covers_every_rank_width(Cp, T, B):
    """Every share ``check_partial_dims`` accepts up to the widths the first
    design's shared memory took (Cp <= 1472) has a tile: whole K stages of
    the rank's res/skip product, a ring of at least two stages."""
    twb.check_partial_dims(Cp, 128)
    plan = twb.sm90_plan(Cp, T, B)
    assert Cp % plan["bk"] == 0 and plan["stages"] >= 2
    assert plan["smem"] + twb.SM90_STATIC_SMEM <= twb.SM90_SMEM_LIMIT
    assert plan["grid"] == (-(-T // plan["bm"]), B)


@pytest.mark.parametrize("p,B,bm", [(2, 1, 64), (4, 1, 64), (2, 3, 128),
                                    (4, 3, 128), (8, 3, 128)])
def test_sm90_plan_at_the_tp_vocode(p, B, bm):
    """At T = 6400 groups: one utterance leaves 50 blocks of 128 rows for
    132 SMs, so 64-row blocks; batch 3 fills the card with 128-row ones."""
    assert twb.sm90_plan(512 // p, 6400, B)["bm"] == bm
