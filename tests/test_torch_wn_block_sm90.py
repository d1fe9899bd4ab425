"""The decomposition of ``csrc/wn_block_sm90.cu`` (the standard and final WN
layers for Hopper), checked on the CPU.

The kernel cannot run here, so a PyTorch "tile walk" follows its blocking
exactly: blocks of ``sm90_plan``'s rows of one utterance; an activation
operand of K = 3C + M made of the three taps read at rows t-d, t, t+d
(zero outside [0, n_valid), as TMA's out-of-bounds fill gives them) and the
spect rows (zero past T); gate-pair chunks of 128 tanh + 128 sigmoid
columns whose f32 sums run over 32-deep stages in the kernel's K order;
the gated tile rounded to the input dtype; the res/skip product in chunks
of 256 columns with the residual masked past n_valid and the skip rounded
before it is added to the running sum.  The walk is held to the JAX
package's Pallas kernels (interpret mode, as ``tests/test_pallas.py`` runs
them) and to the port's plain versions, and the launch plan is checked.

Tolerances.  Against Pallas in float32: the same f32 products over K =
3C + M = 448 terms summed in another order, values of order 1: 2e-5
absolute.  Against the plain versions in bf16: both round the gated
activation and the output to bf16, and f32 sums in another order can land
on the other side of a bf16 rounding boundary: four bf16 steps (2^-8 of
the value) at the output's peak, relative L2 under 5e-3 (the bounds the
kernel is held to on the card)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text2speech_tpu.ops.pallas import wn_block as jwb
from text2speech_tpu_torch.ops import wn_block as twb

torch.set_num_threads(1)

C, M = 128, 64
F32 = torch.float32
ATOL = 2e-5
BF16_MAX_ABS_STEPS = 4 * 2.0 ** -8
BF16_REL_L2 = 5e-3
GN, BK = 256, 32


def _rows(src, b, idx, extent):
    """src[b, idx] with rows outside [0, extent) read as zero."""
    out = torch.zeros(len(idx), src.shape[-1], dtype=src.dtype)
    ok = (idx >= 0) & (idx < extent)
    out[ok] = src[b, idx[ok]]
    return out


def _gated_tile(x, spect, w_in, b_in, w_cond, b_cond, b, t0, bm, d,
                n_valid):
    """One block's gated tile [bm, C] in the input dtype."""
    T, Cx = x.shape[1], x.shape[2]
    rows = torch.arange(t0, t0 + bm)
    parts = [] if n_valid == 0 else [
        _rows(x, b, rows + s, n_valid) for s in (-d, 0, d)]
    a_op = torch.cat(parts + [_rows(spect, b, rows, T)], -1).to(F32)
    w_k = torch.cat(([w_in.reshape(3 * Cx, 2 * Cx)] if n_valid else [])
                    + [w_cond]).to(F32)
    bias = b_in.to(F32) + b_cond.to(F32)
    gated = torch.empty(bm, Cx, dtype=x.dtype)
    for c0 in range(0, Cx, GN // 2):
        cols = torch.cat([torch.arange(c0, c0 + GN // 2),
                          torch.arange(Cx + c0, Cx + c0 + GN // 2)])
        acc = torch.zeros(bm, GN)
        for k0 in range(0, a_op.shape[1], BK):
            acc += a_op[:, k0:k0 + BK] @ w_k[k0:k0 + BK][:, cols]
        in_act = acc + bias[cols]
        gated[:, c0:c0 + GN // 2] = (
            torch.tanh(in_act[:, :GN // 2])
            * torch.sigmoid(in_act[:, GN // 2:])).to(x.dtype)
    return gated


def tile_walk_std(x, spect, w_in, b_in, w_cond, b_cond, w_rs, b_rs,
                  skip_acc, d, n_valid):
    """The standard layer as the kernel computes it -> (x_out, skip)."""
    B, T, Cx = x.shape
    rs_out = w_rs.shape[1]
    has_res = rs_out == 2 * Cx
    bm = twb.sm90_plan(Cx, T, B)["bm"]
    x_out = torch.empty_like(x)
    skip = skip_acc.clone()
    for b in range(B):
        for t0 in range(0, T, bm):
            g = _gated_tile(x, spect, w_in, b_in, w_cond, b_cond, b, t0, bm,
                            d, n_valid).to(F32)
            n_rows = min(bm, T - t0)
            t = torch.arange(t0, t0 + n_rows)
            valid = (t < n_valid)[:, None]
            for n0 in range(0, rs_out, GN):
                nn = min(GN, rs_out - n0)
                acc = torch.zeros(bm, nn)
                for k0 in range(0, Cx, BK):
                    acc += g[:, k0:k0 + BK] @ w_rs[k0:k0 + BK,
                                                   n0:n0 + nn].to(F32)
                v = (acc + b_rs[n0:n0 + nn].to(F32))[:n_rows]
                for j in range(nn):
                    n = n0 + j
                    if has_res and n < Cx:
                        res = (x[b, t0:t0 + n_rows, n].to(F32) + v[:, j])
                        x_out[b, t0:t0 + n_rows, n] = torch.where(
                            valid[:, 0], res.to(x.dtype), 0)
                    else:
                        cs = n - Cx if has_res else n
                        s = v[:, j].to(x.dtype).to(F32)
                        skip[b, t0:t0 + n_rows, cs] = (
                            skip[b, t0:t0 + n_rows, cs].to(F32)
                            + s).to(x.dtype)
            if not has_res:
                x_out[b, t0:t0 + n_rows] = torch.where(
                    valid, x[b, t0:t0 + n_rows], 0)
    return x_out, skip


def tile_walk_final(x, spect, w_in, b_in, w_cond, b_cond, w_eff, skip_acc,
                    w_end, b_eff, d, n_valid):
    """The final layer as the kernel computes it -> [B, T, E] f32."""
    B, T, Cx = x.shape
    bm = twb.sm90_plan(Cx, T, B)["bm"]
    out = torch.empty(B, T, w_end.shape[1])
    for b in range(B):
        for t0 in range(0, T, bm):
            g = _gated_tile(x, spect, w_in, b_in, w_cond, b_cond, b, t0, bm,
                            d, n_valid).to(F32)
            n_rows = min(bm, T - t0)
            s1 = g[:n_rows] @ w_eff.to(F32)
            s2 = skip_acc[b, t0:t0 + n_rows].to(F32) @ w_end.to(F32)
            out[b, t0:t0 + n_rows] = s1 + s2 + b_eff.to(F32)
    return out


def _inputs(seed, B, T, n_valid, rs_out, E=None, dtype=F32):
    rng = np.random.RandomState(seed)
    mask = (np.arange(T) < n_valid)[None, :, None]

    def rn(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    k = {
        "x": rn(B, T, C, scale=0.3) * mask,
        "spect": rn(B, T, M, scale=0.3),
        "w_in": rn(3, C, 2 * C, scale=(3 * C) ** -0.5),
        "b_in": rn(2 * C, scale=0.1),
        "w_cond": rn(M, 2 * C, scale=M ** -0.5),
        "b_cond": rn(2 * C, scale=0.1),
        "w_rs": rn(C, rs_out, scale=C ** -0.5),
        "b_rs": rn(rs_out, scale=0.1),
        "acc": rn(B, T, C, scale=0.3) * mask,
    }
    if E is not None:
        k["w_end"] = rn(C, E, scale=C ** -0.5)
        k["b_end"] = rn(E, scale=0.1)
    t = {n: torch.from_numpy(v) for n, v in k.items()}
    for n in ("x", "spect", "w_in", "w_cond", "w_rs", "acc", "w_end"):
        if n in t:
            t[n] = t[n].to(dtype)
    return k, t


STD = ["x", "spect", "w_in", "b_in", "w_cond", "b_cond", "w_rs", "b_rs",
       "acc"]


def _bf16_close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    peak = max(want.abs().max().item(), 1.0)
    assert (got - want).abs().max().item() <= BF16_MAX_ABS_STEPS * peak
    if want.norm() > 0:
        assert ((got - want).norm() / want.norm()).item() <= BF16_REL_L2


# --- against the Pallas kernels (interpret mode), float32 -------------------


@pytest.mark.parametrize("d", [1, 64, 130])
@pytest.mark.parametrize("rs_full", [True, False])
def test_tile_walk_std_matches_pallas(d, rs_full):
    T, n_valid = 512, 389
    k, t = _inputs(10 + d, 1, T, n_valid, 2 * C if rs_full else C)
    want_x, want_s = jwb.wn_layer_stream2(
        *[jnp.asarray(k[n]) for n in STD], d, n_valid=n_valid)
    got_x, got_s = tile_walk_std(*[t[n] for n in STD], d, n_valid)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=ATOL)
    np.testing.assert_allclose(got_s.numpy()[:, :n_valid],
                               np.asarray(want_s)[:, :n_valid], atol=ATOL)


@pytest.mark.parametrize("d,E", [(1, 8), (130, 5)])
def test_tile_walk_final_matches_pallas(d, E):
    T, n_valid = 512, 301
    k, t = _inputs(20 + d, 1, T, n_valid, C, E=E)
    names = STD + ["w_end", "b_end"]
    want = jwb.wn_layer_stream2_final(
        *[jnp.asarray(k[n]) for n in names], d, n_valid=n_valid)
    w_eff, b_eff = twb.fold_end(t["w_rs"], t["b_rs"], t["w_end"],
                                t["b_end"])
    got = tile_walk_final(*[t[n] for n in STD[:6]], w_eff, t["acc"],
                          t["w_end"], b_eff, d, n_valid)
    np.testing.assert_allclose(got.numpy()[:, :n_valid],
                               np.asarray(want)[:, :n_valid], atol=ATOL)


# --- against the plain versions, bf16, T and n_valid off the tile grid ------


@pytest.mark.parametrize("n_valid", [333, 300, 129, 128, 0])
@pytest.mark.parametrize("d", [1, 64, 130])
@pytest.mark.parametrize("rs_full", [True, False])
def test_tile_walk_std_matches_plain_bf16(n_valid, d, rs_full):
    T = 333
    _, t = _inputs(30 + d + n_valid, 2, T, n_valid,
                   2 * C if rs_full else C, dtype=torch.bfloat16)
    args = [t[n] for n in STD]
    want_x, want_s = twb.wn_layer_plain(*args, d, n_valid=n_valid)
    got_x, got_s = tile_walk_std(*args, d, n_valid)
    _bf16_close(got_x, want_x)
    assert (got_x[:, n_valid:] == 0).all()
    _bf16_close(got_s[:, :max(n_valid, 1)], want_s[:, :max(n_valid, 1)])


@pytest.mark.parametrize("n_valid,d,E", [(333, 1, 8), (129, 64, 4),
                                         (0, 130, 8)])
def test_tile_walk_final_matches_plain_bf16(n_valid, d, E):
    T = 333
    _, t = _inputs(40 + d, 2, T, n_valid, C, E=E, dtype=torch.bfloat16)
    w_eff, b_eff = twb.fold_end(t["w_rs"], t["b_rs"], t["w_end"],
                                t["b_end"])
    args = [t[n] for n in STD[:6]] + [w_eff, t["acc"], t["w_end"], b_eff, d]
    want = twb.wn_layer_final_plain(*args, n_valid=n_valid)
    got = tile_walk_final(*args, n_valid)
    _bf16_close(got, want)


# --- the host-side launch plan ----------------------------------------------


@pytest.mark.parametrize("width", range(128, 1025, 128))
@pytest.mark.parametrize("T,B", [(6400, 3), (1000, 3)])
def test_sm90_plan_fits_shared_memory(width, T, B):
    plan = twb.sm90_plan(width, T, B)
    bm, bk = plan["bm"], plan["bk"]
    # 128-row blocks where their gated tile fits and they fill the card
    assert bm == (128 if width <= 512 and B * -(-T // 128) >= 132 else 64)
    assert plan["nwg"] * 64 == bm and plan["threads"] == 2 * bm + 128
    assert 2 <= plan["stages"] <= twb.SM90_MAX_STAGES
    assert plan["grid"] == (-(-T // bm), B)
    ring = plan["stages"] * (bk * GN * 2 + bm * bk * 2)
    assert plan["smem"] == 1024 + ring + bm * width * 2
    assert plan["smem"] + twb.SM90_STATIC_SMEM <= 232448
    # the ring is as deep as fits, up to four stages; K = 64 where three of
    # its stages fit
    if plan["stages"] < twb.SM90_MAX_STAGES:
        deeper = twb.sm90_smem_bytes(plan["nwg"], bk, width,
                                     plan["stages"] + 1)
        assert deeper + twb.SM90_STATIC_SMEM > 232448
    three_of_64 = twb.sm90_smem_bytes(plan["nwg"], 64, width, 3)
    assert (bk == 64) == (three_of_64 + twb.SM90_STATIC_SMEM <= 232448)


@pytest.mark.parametrize("width,T,B,bm,bk", [
    (512, 6400, 3, 128, 32),   # the main path's vocode: 150 blocks of 128
    (512, 6400, 1, 64, 64),    # one utterance: 50 blocks of 128 leave 82
    (512, 16896, 1, 128, 32),  # SMs idle, 100 of 64 fill more of them
    (256, 6400, 3, 128, 64),   # three stages of K = 64 fit beside the tile
    (256, 1000, 3, 64, 64),
    (640, 6400, 3, 64, 64),    # the 128-row gated tile does not fit
    (1024, 6400, 3, 64, 32),
])
def test_sm90_plan_picks_the_tile_from_the_shape(width, T, B, bm, bk):
    plan = twb.sm90_plan(width, T, B)
    assert (plan["bm"], plan["bk"]) == (bm, bk)


@pytest.mark.parametrize("width", [1536, 2048])
def test_sm90_plan_raises_where_no_tile_fits(width):
    with pytest.raises(ValueError, match="no tile"):
        twb.sm90_plan(width)


def test_walk_is_independent_of_the_row_tile(monkeypatch):
    """Rows never mix: the 64-row tile of wide layers gives the 128-row
    tile's result."""
    T, n_valid, d = 333, 300, 64
    _, t = _inputs(50, 1, T, n_valid, 2 * C)
    args = [t[n] for n in STD]
    want = tile_walk_std(*args, d, n_valid)
    real = twb.sm90_plan
    monkeypatch.setattr(twb, "sm90_plan",
                        lambda *a: {**real(*a), "bm": 64, "nwg": 1})
    got = tile_walk_std(*args, d, n_valid)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)


def test_ctypes_signatures_match_the_c_interface():
    """Every exported function's argument list in ``csrc/wn_block_sm90.cu``
    (pointers, ints, the stream) is what ``ops/wn_block.py`` declares to
    ctypes: a miscount is caught here, not on a card."""
    import ctypes
    import re
    from pathlib import Path

    src = (Path(twb.__file__).parent.parent / "csrc"
           / "wn_block_sm90.cu").read_text()
    decls = dict(re.findall(r"^(?:int|size_t) (t2s_\w+)\(([^)]*)\)", src,
                            re.M))
    assert set(decls) == set(twb.LIB_SM90.signatures)
    for name, params in decls.items():
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in params.split(",")]
        assert kinds == twb.LIB_SM90.signatures[name], name
