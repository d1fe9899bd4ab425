"""The composed-conditioning (``dcond``) standard layer's Hopper design in
``csrc/wn_block_sm90.cu`` (the ``DCOND`` form of its standard role),
checked on the CPU.

The kernel cannot run here, so a PyTorch "tile walk" follows its blocking
exactly: blocks of ``sm90_plan``'s rows of one utterance;
an in-act operand of K = 3C only (no spect rows), the three taps read at
rows t-d, t, t+d (zero outside [0, n_valid), as TMA's out-of-bounds fill
gives them), summed in f32 over the plan's 32- or 64-deep stages in the
kernel's K order, for gate-pair chunks of 128 tanh + 128 sigmoid columns;
n_valid = 0 leaves no stage at all.  Then b_in, then the layer's slice of
``cond_all`` (rows t < T, widened to f32) before the gate; the gated tile
rounded to the input dtype; the res/skip product in chunks of 256 columns
with the residual masked past n_valid and the skip rounded before it is
added to the running sum.  The walk is held to the JAX package's Pallas
kernel ``wn_layer_stream2_dcond`` (interpret mode, as
``tests/test_torch_wn_block_dcond.py`` runs it) and to the port's plain
version, and the launch plan is checked.

Tolerances, those of ``tests/test_torch_wn_block_sm90.py``.  Against Pallas
in float32: the same f32 products over K = 3C = 384 terms summed in another
order, values of order 1: 2e-5 absolute.  Against the plain version in
bf16: both round the gated activation and the output to bf16, and f32 sums
in another order can land on the other side of a bf16 rounding boundary:
four bf16 steps (2^-8 of the value) at the output's peak, relative L2
under 5e-3."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text2speech_tpu.ops.pallas import wn_block_dcond as jwd
from text2speech_tpu_torch.ops import wn_block as twb
from text2speech_tpu_torch.ops import wn_block_dcond as twd

torch.set_num_threads(1)

C, L = 128, 3
F32 = torch.float32
ATOL = 2e-5
BF16_MAX_ABS_STEPS = 4 * 2.0 ** -8
BF16_REL_L2 = 5e-3
GN = 256


def _rows(src, b, idx, extent):
    """src[b, idx] with rows outside [0, extent) read as zero."""
    out = torch.zeros(len(idx), src.shape[-1], dtype=src.dtype)
    ok = (idx >= 0) & (idx < extent)
    out[ok] = src[b, idx[ok]]
    return out


def _gated_tile(x, cond_all, li, w_in, b_in, b, t0, bm, bk, d, n_valid):
    """One block's gated tile [bm, C] in the input dtype."""
    T, Cx = x.shape[1], x.shape[2]
    rows = torch.arange(t0, t0 + bm)
    k = 0 if n_valid == 0 else 3 * Cx          # no K stage when nothing valid
    a_op = torch.zeros(bm, 0) if k == 0 else torch.cat(
        [_rows(x, b, rows + s, n_valid) for s in (-d, 0, d)], -1).to(F32)
    w_k = w_in.reshape(3 * Cx, 2 * Cx).to(F32)
    cond = _rows(cond_all[..., 2 * Cx * li: 2 * Cx * (li + 1)], b, rows,
                 T).to(F32)
    gated = torch.empty(bm, Cx, dtype=x.dtype)
    for c0 in range(0, Cx, GN // 2):
        cols = torch.cat([torch.arange(c0, c0 + GN // 2),
                          torch.arange(Cx + c0, Cx + c0 + GN // 2)])
        acc = torch.zeros(bm, GN)
        for k0 in range(0, k, bk):
            acc += a_op[:, k0:k0 + bk] @ w_k[k0:k0 + bk][:, cols]
        in_act = (acc + b_in.to(F32)[cols]) + cond[:, cols]
        gated[:, c0:c0 + GN // 2] = (
            torch.tanh(in_act[:, :GN // 2])
            * torch.sigmoid(in_act[:, GN // 2:])).to(x.dtype)
    return gated


def tile_walk_dcond(x, cond_all, li, w_in, b_in, w_rs, b_rs, skip_acc, d,
                    n_valid):
    """The dcond standard layer as the kernel computes it -> (x_out,
    skip)."""
    B, T, Cx = x.shape
    rs_out = w_rs.shape[1]
    has_res = rs_out == 2 * Cx
    plan = twb.sm90_plan(Cx, T, B)
    bm, bk = plan["bm"], plan["bk"]
    x_out = torch.empty_like(x)
    skip = skip_acc.clone()
    for b in range(B):
        for t0 in range(0, T, bm):
            g = _gated_tile(x, cond_all, li, w_in, b_in, b, t0, bm, bk, d,
                            n_valid).to(F32)
            n_rows = min(bm, T - t0)
            valid = torch.arange(t0, t0 + n_rows) < n_valid
            for n0 in range(0, rs_out, GN):
                nn = min(GN, rs_out - n0)
                acc = torch.zeros(bm, nn)
                for k0 in range(0, Cx, bk):
                    acc += g[:, k0:k0 + bk] @ w_rs[k0:k0 + bk,
                                                   n0:n0 + nn].to(F32)
                v = (acc + b_rs[n0:n0 + nn].to(F32))[:n_rows]
                for j in range(nn):
                    n = n0 + j
                    if has_res and n < Cx:
                        res = x[b, t0:t0 + n_rows, n].to(F32) + v[:, j]
                        x_out[b, t0:t0 + n_rows, n] = torch.where(
                            valid, res.to(x.dtype), 0)
                    else:
                        cs = n - Cx if has_res else n
                        s = v[:, j].to(x.dtype).to(F32)
                        skip[b, t0:t0 + n_rows, cs] = (
                            skip[b, t0:t0 + n_rows, cs].to(F32)
                            + s).to(x.dtype)
            if not has_res:
                x_out[b, t0:t0 + n_rows] = torch.where(
                    valid[:, None], x[b, t0:t0 + n_rows], 0)
    return x_out, skip


def _inputs(seed, B, T, n_valid, rs_out, dtype=F32):
    rng = np.random.RandomState(seed)
    mask = (np.arange(T) < n_valid)[None, :, None]

    def rn(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    k = {
        "x": rn(B, T, C, scale=0.3) * mask,
        "cond_all": rn(B, T, 2 * C * L, scale=0.3),
        "w_in": rn(3, C, 2 * C, scale=(3 * C) ** -0.5),
        "b_in": rn(2 * C, scale=0.1),
        "w_rs": rn(C, rs_out, scale=C ** -0.5),
        "b_rs": rn(rs_out, scale=0.1),
        "acc": rn(B, T, C, scale=0.3) * mask,
    }
    t = {n: torch.from_numpy(v) for n, v in k.items()}
    for n in ("x", "cond_all", "w_in", "w_rs", "acc"):
        t[n] = t[n].to(dtype)
    return k, t


ARGS = ["x", "cond_all", "w_in", "b_in", "w_rs", "b_rs", "acc"]


def _call(fn, t, li, d, n_valid):
    return fn(t["x"], t["cond_all"], li, t["w_in"], t["b_in"], t["w_rs"],
              t["b_rs"], t["acc"], d, n_valid=n_valid)


def _bf16_close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    peak = max(want.abs().max().item(), 1.0)
    assert (got - want).abs().max().item() <= BF16_MAX_ABS_STEPS * peak
    if want.norm() > 0:
        assert ((got - want).norm() / want.norm()).item() <= BF16_REL_L2


# --- against the Pallas kernel (interpret mode), float32 --------------------


@pytest.mark.parametrize("n_valid,d,rs_full,li", [
    (389, 1, True, 0),          # n_valid off the tile grid
    (511, 130, False, L - 1),   # n_valid = T - 1, a halo past a 128-row tile
    (0, 64, True, L - 1),       # nothing valid: no K stage at all
    (389, 64, False, 0),
])
def test_dcond_tile_walk_matches_pallas(n_valid, d, rs_full, li):
    T = 512
    k, t = _inputs(10 + d + n_valid, 1, T, n_valid, 2 * C if rs_full else C)
    ja = [jnp.asarray(k[n]) for n in ARGS]
    want_x, want_s = jwd.wn_layer_stream2_dcond(
        ja[0], ja[1], li, *ja[2:], d, interpret=True, n_valid=n_valid)
    got_x, got_s = tile_walk_dcond(*[t[n] for n in ARGS[:2]], li,
                                   *[t[n] for n in ARGS[2:]], d, n_valid)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=ATOL)
    assert not got_x[:, n_valid:].any()
    rows = max(n_valid, 1)
    np.testing.assert_allclose(got_s.numpy()[:, :rows],
                               np.asarray(want_s)[:, :rows], atol=ATOL)


# --- against the plain version, bf16, T and n_valid off the tile grid -------


@pytest.mark.parametrize("n_valid", [332, 300, 129, 0])
@pytest.mark.parametrize("d", [1, 130])
@pytest.mark.parametrize("rs_full,li", [(True, 0), (False, L - 1)])
def test_dcond_tile_walk_matches_plain_bf16(n_valid, d, rs_full, li):
    T = 333
    _, t = _inputs(30 + d + n_valid, 2, T, n_valid, 2 * C if rs_full else C,
                   dtype=torch.bfloat16)
    want_x, want_s = _call(twd.wn_layer_dcond_plain, t, li, d, n_valid)
    got_x, got_s = tile_walk_dcond(*[t[n] for n in ARGS[:2]], li,
                                   *[t[n] for n in ARGS[2:]], d, n_valid)
    if n_valid:
        _bf16_close(got_x, want_x)
    assert not got_x[:, n_valid:].any() and not want_x[:, n_valid:].any()
    # the skip sum on every row: rows past n_valid are gated alike
    _bf16_close(got_s, want_s)


def test_dcond_walk_reads_cond_rows_up_to_t_not_n_valid():
    """Rows at or past n_valid of cond_all reach the skip sum of their own
    rows (read for t < T) and no valid row."""
    T, n_valid, d, li = 333, 200, 64, 1
    _, t = _inputs(60, 1, T, n_valid, 2 * C)
    x_a, s_a = tile_walk_dcond(*[t[n] for n in ARGS[:2]], li,
                               *[t[n] for n in ARGS[2:]], d, n_valid)
    junk = dict(t)
    junk["cond_all"] = t["cond_all"].clone()
    junk["cond_all"][:, n_valid:] = -3.0
    x_b, s_b = tile_walk_dcond(*[junk[n] for n in ARGS[:2]], li,
                               *[junk[n] for n in ARGS[2:]], d, n_valid)
    assert torch.equal(x_a, x_b)
    assert torch.equal(s_a[:, :n_valid], s_b[:, :n_valid])
    assert not torch.equal(s_a[:, n_valid:], s_b[:, n_valid:])
    want_x, want_s = _call(twd.wn_layer_dcond_plain, junk, li, d, n_valid)
    np.testing.assert_allclose(s_b.numpy(), want_s.numpy(), atol=ATOL)


def test_dcond_walk_is_independent_of_the_row_tile(monkeypatch):
    """Rows never mix: the 64-row tile gives the 128-row tile's result."""
    T, n_valid, d = 333, 300, 64
    _, t = _inputs(50, 1, T, n_valid, 2 * C)
    args = ([t[n] for n in ARGS[:2]], [t[n] for n in ARGS[2:]])
    want = tile_walk_dcond(*args[0], 2, *args[1], d, n_valid)
    real = twb.sm90_plan
    for bm, bk in ((64, 64), (128, 32)):
        monkeypatch.setattr(
            twb, "sm90_plan",
            lambda *a, **kw: {**real(*a, **kw), "bm": bm, "nwg": bm // 64,
                              "bk": bk})
        got = tile_walk_dcond(*args[0], 2, *args[1], d, n_valid)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=0)


# --- the host-side launch plan ----------------------------------------------


@pytest.mark.parametrize("width", [128, 256, 512, 640, 1024])
@pytest.mark.parametrize("T,B", [(6400, 1), (6400, 3), (777, 2)])
def test_sm90_plan_for_dcond(width, T, B):
    """The dcond layer launches with the standard layer's plan (the same
    [bk, 256] weight tile and [bm, bk] activation tile a ring stage).  Its
    producer issues one tap box a stage, so each tap's C rows of K must
    split into whole stages, and the ring must fit beside the gated
    tile."""
    plan = twb.sm90_plan(width, T, B)
    assert width % plan["bk"] == 0
    assert plan["stages"] >= 2
    assert plan["smem"] == twb.sm90_smem_bytes(plan["nwg"], plan["bk"],
                                               width, plan["stages"])
    assert plan["smem"] + twb.SM90_STATIC_SMEM <= twb.SM90_SMEM_LIMIT
    assert plan["grid"] == (-(-T // plan["bm"]), B)


@pytest.mark.parametrize("width,T,B,bm,bk,stages", [
    (512, 6400, 1, 64, 64, 4),    # the composed vocode at batch 1: 100 blocks
    (512, 6400, 3, 128, 32, 4),   # batch 3: 150 blocks of 128 rows
])
def test_sm90_plan_dcond_at_the_composed_vocode(width, T, B, bm, bk, stages):
    plan = twb.sm90_plan(width, T, B)
    assert (plan["bm"], plan["bk"], plan["stages"]) == (bm, bk, stages)


def test_dcond_sm90_ctypes_signature():
    """The new entry ``t2s_wn_layer_dcond_sm90`` of ``csrc/wn_block_sm90.cu``
    takes what ``ops/wn_block.py`` declares: 8 pointers, 11 ints, the
    stream."""
    import ctypes
    import re
    from pathlib import Path

    src = (Path(twb.__file__).parent.parent / "csrc"
           / "wn_block_sm90.cu").read_text()
    params = re.search(r"^int t2s_wn_layer_dcond_sm90\(([^)]*)\)", src,
                       re.M).group(1)
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
             for p in params.split(",")]
    assert kinds == twb.LIB_SM90.signatures["t2s_wn_layer_dcond_sm90"]
    assert kinds == [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
