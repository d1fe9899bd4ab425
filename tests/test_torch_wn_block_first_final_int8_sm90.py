"""The ``FINAL`` and ``FIRST`` roles of ``csrc/wn_block_int8_sm90.cu`` (the
last and the first int8 WN layer of a flow on s8 ``wgmma``), checked on
the CPU.

The kernel cannot run here, so a PyTorch "tile walk" follows its blocking:
blocks of 64 rows of one utterance and ``int8_sm90_plan``'s column groups
(consumer warpgroups that take alternate gate chunks of 64 tanh + the
matching 64 sigmoid columns).

``FINAL``: the standard layer's in-act product, 128-deep int8 stages in the
kernel's order, tap 0, 1, 2 (rows t-d, t, t+d read as zero outside [0,
n_valid), as TMA's out-of-bounds fill gives them, with a row scale of 0
there) and then the conditioning (its last stage zero-filled past M); each
tap's s32 sums flushed at its end with the scale of its own shifted row;
the gate in f32 cast to bf16; then, per chunk, the gate times the chunk's
rows of w_eff plus the running skip sum's columns times w_end's, into the
column group's [64, 8] f32 sums (w_eff and w_end as [C, 8] tables, zero
past E); after the last chunk the groups' sums meet and b_eff is added.

``FIRST``: the in-act product is the conditioning alone (K = M stages);
the rank-n_half taps are FMAs of the block's three tap rows of x0 (zero
outside [0, n_valid)) with the chunk's columns of wp, then b_all, the
conditioning's term and the edge take-back (b_edge[0] where t < d,
b_edge[1] where t >= n_valid - d); the gate quantized at 127; the res/skip
product in chunks of 128 columns, the residual chunks first: x_new = x0[t]
start_k + start_b + rs parked, zero at rows >= n_valid, a running amax
kept per row and column group; the skip chunks WRITTEN as bf16(rs); after
the last chunk the groups' maxima meet and the rows are requantized.

The integer sums are taken in float64, exact here.  The walks are held to
the JAX package's Pallas kernels (interpret mode, as
``tests/test_int8_vocoder.py`` runs them) and to the port's plain versions
within the JAX package's int8 bounds (``tests/test_int8_vocoder.py:
127-137, 256-258``): payloads within 1 count with a mean absolute
difference under 0.01, row scales to 1e-3 relative, the bf16 skip to 0.09,
the final layer's f32 output to 0.02.  ``FINAL``'s gate values equal the
plain version's bit for bit (the same f32 operations in the same order),
so against it only the rank-E projection's f32 sums differ in order:
1e-5 absolute at outputs of order 1.  The launch plan of both roles at
every width their first designs took and the C interface are checked
too."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text2speech_tpu.ops.pallas import wn_block_int8 as jq
from text2speech_tpu_torch.ops import wn_block as twb
from text2speech_tpu_torch.ops import wn_block_int8 as tq

torch.set_num_threads(1)

F32, F64, BF = torch.float32, torch.float64, torch.bfloat16
BM, GH, QN = 64, 64, 128     # rows a block; gate chunk; res/skip chunk
MEAN_COUNTS, SCALE_RTOL, SKIP_ATOL = 0.01, 1e-3, 0.09
FINAL_ATOL, FINAL_PLAIN_ATOL = 0.02, 1e-5
SRC = Path(tq.__file__).parent.parent / "csrc" / "wn_block_int8_sm90.cu"


def _rows(src, b, idx, extent):
    """src[b, idx] with rows outside [0, extent) read as zero."""
    out = torch.zeros(len(idx), src.shape[-1], dtype=src.dtype)
    ok = (idx >= 0) & (idx < extent)
    out[ok] = src[b, idx[ok]]
    return out


def _k_stages(a, w):
    """s32 sums of a [rows, K] . w [N, K] over 128-deep stages, the last
    zero-filled past K, in float64 (exact)."""
    K = tq.INT8_SM90_K
    acc = torch.zeros(a.shape[0], w.shape[0], dtype=F64)
    for k0 in range(0, a.shape[1], K):
        acc += a[:, k0:k0 + K].to(F64) @ w[:, k0:k0 + K].to(F64).T
    return acc


def _gate_cols(Cx, c0):
    return torch.cat([torch.arange(c0, c0 + GH),
                      torch.arange(Cx + c0, Cx + c0 + GH)])


def walk_final(qx, sx, qspect, sspect, qw_in, sw_in, b_in, qw_cond, sw_cond,
               b_cond, w_eff, skip_acc, w_end, b_eff, d, n_valid, nc=None):
    """The final int8 layer as the kernel's ``FINAL`` role computes it ->
    [B, T, E] f32."""
    B, T, Cx = qx.shape
    E = w_end.shape[1]
    nc = nc or tq.int8_sm90_plan(Cx, T, B, role="final")["nc"]
    we = torch.zeros(Cx, 8)
    wd = torch.zeros(Cx, 8)
    we[:, :E], wd[:, :E] = w_eff.to(F32), w_end.to(F32)
    out = torch.empty(B, T, E)
    for b in range(B):
        for t0 in range(0, T, BM):
            rows = torch.arange(t0, t0 + BM)
            taps = [_rows(qx, b, rows + (j - 1) * d, n_valid)
                    for j in range(3)] if n_valid else []
            st = [_rows(sx, b, rows + (j - 1) * d, n_valid)[:, 0]
                  for j in range(3)]
            spec = _rows(qspect, b, rows, T)
            ss = _rows(sspect, b, rows, T)[:, 0]
            sk = _rows(skip_acc, b, rows, T).to(F32)
            fin = torch.zeros(nc, BM, 8)
            for c0 in range(0, Cx, GH):
                grp = (c0 // GH) % nc
                cols = _gate_cols(Cx, c0)
                tsum = torch.zeros(BM, 2 * GH)
                for j, a in enumerate(taps):       # flush at each tap's end
                    tsum = tsum + _k_stages(a, qw_in[j][cols]).to(F32) * \
                        st[j][:, None]
                cond = _k_stages(spec, qw_cond[cols]).to(F32)
                in_act = ((tsum * sw_in[cols] + b_in[cols])
                          + ((cond * ss[:, None]) * sw_cond[cols]
                             + b_cond[cols]))
                g = (torch.tanh(in_act[:, :GH])
                     * torch.sigmoid(in_act[:, GH:])).to(BF).to(F32)
                cs = slice(c0, c0 + GH)
                fin[grp] += g @ we[cs] + sk[:, cs] @ wd[cs]
            n = min(BM, T - t0)
            out[b, t0:t0 + n] = fin.sum(0)[:n, :E] + b_eff
    return out


def walk_first(x0, qspect, sspect, start_k, start_b, wp, b_all, b_edge,
               qw_cond, sw_cond, b_cond, qw_rs, sw_rs, b_rs, d, n_valid,
               nc=None):
    """The first int8 layer as the kernel's ``FIRST`` role computes it ->
    (qx_hidden, sx_hidden, skip bf16)."""
    B, T, nh = x0.shape
    Cx = start_k.shape[1]
    nc = nc or tq.int8_sm90_plan(Cx, T, B, role="first")["nc"]
    inv127 = 1.0 / 127.0
    qx_out = torch.empty(B, T, Cx, dtype=torch.int8)
    sx_out = torch.empty(B, T, 1)
    skip = torch.empty(B, T, Cx, dtype=BF)
    for b in range(B):
        for t0 in range(0, T, BM):
            rows = torch.arange(t0, t0 + BM)
            sX = [_rows(x0, b, rows + (j - 1) * d, n_valid).to(F64)
                  for j in range(3)]
            spec = _rows(qspect, b, rows, T)
            ss = _rows(sspect, b, rows, T)[:, 0]
            left, right = rows < d, rows >= n_valid - d
            gated = torch.empty(BM, Cx, dtype=torch.int8)
            for c0 in range(0, Cx, GH):
                cols = _gate_cols(Cx, c0)
                taps = torch.zeros(BM, 2 * GH, dtype=F64)   # the FMAs
                for j in range(3):
                    for i in range(nh):
                        taps = taps + sX[j][:, i:i + 1] * wp[j, i, cols].to(F64)
                cond = _k_stages(spec, qw_cond[cols]).to(F32)
                at = ((taps.to(F32) + b_all[cols])
                      + ((cond * ss[:, None]) * sw_cond[cols] + b_cond[cols]))
                at = at - torch.where(left[:, None], b_edge[0][cols], 0.0)
                at = at - torch.where(right[:, None], b_edge[1][cols], 0.0)
                g = torch.tanh(at[:, :GH]) * torch.sigmoid(at[:, GH:])
                gated[:, c0:c0 + GH] = torch.round(g * 127.0).to(torch.int8)
            n = min(BM, T - t0)
            valid = (rows[:n] < n_valid)[:, None]
            base = x0[b, t0:t0 + n].to(F32) @ start_k.to(F32) + start_b
            xn = torch.empty(n, Cx)
            amax = torch.zeros(nc, n)    # per column group
            for n0 in range(0, 2 * Cx, QN):
                grp = (n0 // QN) % nc      # the warpgroup that takes it
                s32 = _k_stages(gated, qw_rs[n0:n0 + QN]).to(F32)[:n]
                v = s32 * (sw_rs[n0:n0 + QN] * inv127) + b_rs[n0:n0 + QN]
                if n0 < Cx:                        # residual: park, amax
                    x = torch.where(valid, base[:, n0:n0 + QN] + v, 0.0)
                    xn[:, n0:n0 + QN] = x
                    amax[grp] = torch.maximum(amax[grp], x.abs().amax(1))
                else:                              # skip: written
                    skip[b, t0:t0 + n, n0 - Cx:n0 - Cx + QN] = v.to(BF)
            s = torch.clamp_min(amax.amax(0), 1e-12) * inv127
            qx_out[b, t0:t0 + n] = torch.round(xn / s[:, None]).to(
                torch.int8)
            sx_out[b, t0:t0 + n, 0] = s
    return qx_out, sx_out, skip


# --- inputs, made with numpy from a seed and quantized by the JAX functions


def _quant_rows(rng, B, T, width, n_valid):
    x = rng.randn(B, T, width).astype(np.float32)
    x = x * (np.arange(T) < n_valid)[None, :, None]
    q, s = jq.quantize_rows(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _quant_cols(rng, *shape):
    q, s = jq.quantize_cols(
        jnp.asarray(rng.randn(*shape).astype(np.float32) * 0.1))
    return np.asarray(q), np.asarray(s)


def _vec(rng, n):
    return rng.randn(n).astype(np.float32) * 0.1


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16), both round-to-nearest-even."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(BF)


def _t(a):
    return torch.from_numpy(np.array(a))


def _out_major(q):
    return tq.to_output_major(_t(q))


def final_case(seed, B, T, n_valid, C, M, E):
    """-> (the Pallas kernel's arguments, the port's)."""
    rng = np.random.RandomState(seed)
    qx, sx = _quant_rows(rng, B, T, C, n_valid)
    qs, ss = _quant_rows(rng, B, T, M, T)
    qw_in, sw_in = _quant_cols(rng, 3, C, 2 * C)
    b_in = _vec(rng, 2 * C)
    qw_cond, sw_cond = _quant_cols(rng, M, 2 * C)
    b_cond = _vec(rng, 2 * C)
    jw_rs, tw_rs = _bf16(rng.randn(C, C).astype(np.float32) * 0.1)
    b_rs = _vec(rng, C)
    jw_end, tw_end = _bf16(rng.randn(C, E).astype(np.float32) * 0.1)
    b_end = _vec(rng, E)
    acc = rng.randn(B, T, C).astype(np.float32)
    acc = acc * (np.arange(T) < n_valid)[None, :, None]
    jacc, tacc = _bf16(acc)
    jax_args = (*map(jnp.asarray, (qx, sx, qs, ss, qw_in, sw_in, b_in,
                                   qw_cond, sw_cond, b_cond)),
                jw_rs, jnp.asarray(b_rs), jacc, jw_end, jnp.asarray(b_end))
    w_eff, b_eff = twb.fold_end(tw_rs, _t(b_rs), tw_end, _t(b_end))
    port = (_t(qx), _t(sx), _t(qs), _t(ss), _out_major(qw_in), _t(sw_in),
            _t(b_in), _out_major(qw_cond), _t(sw_cond), _t(b_cond), w_eff,
            tacc, tw_end, b_eff)
    return jax_args, port


def first_case(seed, B, T, n_valid, C, M, n_half):
    """-> (the Pallas kernel's arguments, the port's)."""
    rng = np.random.RandomState(seed)
    x0 = rng.randn(B, T, n_half).astype(np.float32)
    jx0, tx0 = _bf16(x0 * (np.arange(T) < n_valid)[None, :, None])
    qs, ss = _quant_rows(rng, B, T, M, T)
    jsk, tsk = _bf16(rng.randn(n_half, C).astype(np.float32) * 0.3)
    start_b = _vec(rng, C)
    jw_in, tw_in = _bf16(rng.randn(3, C, 2 * C).astype(np.float32) * 0.1)
    b_in = _vec(rng, 2 * C)
    qw_cond, sw_cond = _quant_cols(rng, M, 2 * C)
    b_cond = _vec(rng, 2 * C)
    qw_rs, sw_rs = _quant_cols(rng, C, 2 * C)
    b_rs = _vec(rng, 2 * C)
    jax_args = (jx0, jnp.asarray(qs), jnp.asarray(ss), jsk,
                jnp.asarray(start_b), jw_in, jnp.asarray(b_in),
                jnp.asarray(qw_cond), jnp.asarray(sw_cond),
                jnp.asarray(b_cond), jnp.asarray(qw_rs), jnp.asarray(sw_rs),
                jnp.asarray(b_rs))
    fold = twb.fold_first_taps(tsk, _t(start_b), tw_in, _t(b_in))
    port = (tx0, _t(qs), _t(ss), tsk, _t(start_b), *fold,
            _out_major(qw_cond), _t(sw_cond), _t(b_cond), _out_major(qw_rs),
            _t(sw_rs), _t(b_rs))
    return jax_args, port


def int8_close(got, want, n_rows, skip_rows):
    gq, gs, gk = (np.asarray(a, dtype=np.float32) for a in got)
    wq, ws, wk = (np.asarray(a, dtype=np.float32) for a in want)
    diff = np.abs(gq[:, :n_rows] - wq[:, :n_rows])
    assert diff.max() <= 1, diff.max()
    assert diff.mean() < MEAN_COUNTS, diff.mean()
    np.testing.assert_allclose(gs[:, :n_rows], ws[:, :n_rows],
                               rtol=SCALE_RTOL)
    np.testing.assert_allclose(gk[:, :skip_rows], wk[:, :skip_rows], rtol=0,
                               atol=SKIP_ATOL)


def _np(out):
    q, s, k = out
    return q.numpy(), s.numpy(), k.float().numpy()


# --- FINAL --------------------------------------------------------------------


@pytest.mark.parametrize("C,E,d,n_valid", [(128, 8, 64, 511), (512, 1, 1, 389),
                                           (128, 4, 128, 0)])
def test_final_walk_matches_pallas(C, E, d, n_valid):
    """T = 512 (one Pallas tile); n_valid T - 1, off the 64-row tile, 0."""
    B, T, M = 1, 512, 192
    jax_args, port = final_case(10 + C + d, B, T, n_valid, C, M, E)
    want = np.asarray(jq.wn_layer_stream2_final_int8(
        *jax_args, dilation=d, n_valid=n_valid))
    got = walk_final(*port, d, n_valid).numpy()
    assert got.shape == want.shape == (B, T, E)
    np.testing.assert_allclose(got, want, rtol=0, atol=FINAL_ATOL)


@pytest.mark.parametrize("E", [1, 8])
@pytest.mark.parametrize("d,n_valid", [(1, 332), (64, 200), (128, 0)])
@pytest.mark.parametrize("C", [128, 512])
def test_final_walk_matches_plain(C, d, n_valid, E):
    """T = 333, off the 64-row tile; every row t < T is computed."""
    B, T, M = 2, 333, 128
    _, port = final_case(20 + C + d + E, B, T, n_valid, C, M, E)
    want = tq.wn_layer_final_int8_plain(*port, d, n_valid=n_valid)
    got = walk_final(*port, d, n_valid)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=FINAL_PLAIN_ATOL)


def test_final_walk_one_or_two_column_groups():
    """The groups split the chunks and meet once: one or two groups give
    the same output within the f32 sums' order."""
    B, T, n_valid, d, C = 1, 200, 150, 3, 256
    _, port = final_case(30, B, T, n_valid, C, 64, 6)
    one = walk_final(*port, d, n_valid, nc=1)
    two = walk_final(*port, d, n_valid, nc=2)
    torch.testing.assert_close(one, two, rtol=0, atol=FINAL_PLAIN_ATOL)


# --- FIRST --------------------------------------------------------------------


@pytest.mark.parametrize("C,n_half,d,n_valid", [
    (128, 4, 1, 511), (512, 2, 64, 389), (128, 1, 128, 0)])
def test_first_walk_matches_pallas(C, n_half, d, n_valid):
    """T = 512 (one Pallas tile); n_valid T - 1, off the 64-row tile, 0."""
    B, T, M = 1, 512, 192
    jax_args, port = first_case(40 + C + d, B, T, n_valid, C, M, n_half)
    want = jq.wn_layer_stream2_first_int8(*jax_args, dilation=d,
                                          n_valid=n_valid)
    got = walk_first(*port, d, n_valid)
    int8_close(_np(got), [np.asarray(w, np.float32) for w in want], T,
               n_valid)


@pytest.mark.parametrize("n_half", [1, 2, 3, 4])
@pytest.mark.parametrize("d,n_valid", [(1, 332), (64, 200), (128, 0)])
@pytest.mark.parametrize("C", [128, 512])
def test_first_walk_matches_plain(C, d, n_valid, n_half):
    """T = 333, off the 64-row tile; the skip on every row t < T (rows
    past n_valid are computed alike), the payload zero there with the
    floor scale."""
    B, T, M = 2, 333, 128
    _, port = first_case(50 + C + d + n_half, B, T, n_valid, C, M, n_half)
    want = tq.wn_layer_first_int8_plain(*port, d, n_valid=n_valid)
    got = walk_first(*port, d, n_valid)
    int8_close(_np(got), _np(want), T, T)
    assert (got[0][:, n_valid:] == 0).all()
    assert torch.equal(got[1][:, n_valid:], want[1][:, n_valid:])


def test_first_walk_is_independent_of_the_column_groups():
    """The groups' maxima meet exactly: one or two groups give the same
    layer bit for bit."""
    B, T, n_valid, d, C = 1, 200, 150, 3, 256
    _, port = first_case(60, B, T, n_valid, C, 64, 3)
    one = walk_first(*port, d, n_valid, nc=1)
    two = walk_first(*port, d, n_valid, nc=2)
    for x, y in zip(one, two):
        assert torch.equal(x, y)


def test_first_walk_takes_the_edge_bias_back():
    """A layer whose taps read only the folded start bias (x0 = 0): the
    in-act value is b_all + conditioning, minus b_edge[0] on the rows
    t < d and b_edge[1] on the rows t >= n_valid - d, as in the plain
    version (rows near both edges lose both)."""
    B, T, n_valid, d, C = 1, 130, 100, 40, 128
    _, port = first_case(70, B, T, n_valid, C, 64, 2)
    port = (torch.zeros_like(port[0]),) + port[1:]
    got = walk_first(*port, d, n_valid)
    want = tq.wn_layer_first_int8_plain(*port, d, n_valid=n_valid)
    int8_close(_np(got), _np(want), T, T)
    # the take-back moves the layer: without it the skip differs
    no_edge = port[:7] + (torch.zeros_like(port[7]),) + port[8:]
    other = walk_first(*no_edge, d, n_valid)
    assert not torch.equal(other[2], got[2])


# --- the host-side launch plan ----------------------------------------------


def _first_design_smem(role: str, C: int) -> int:
    """Shared memory of ``csrc/wn_block_int8.cu``'s block (its
    ``smem_bytes``): three cp.async stages of a [64, 80] and a [128, 80]
    byte tile, four [64] f32 row-scale tables, then FINAL's bf16 gated tile
    [64, C + 8] or FIRST's s8 one [64, C + 16] with its bf16 tap tables
    (768 + 1536 values)."""
    n = 3 * (64 * 80 + 128 * 80) + 4 * 64 * 4
    if role == "final":
        return n + 64 * (C + 8) * 2
    return n + 64 * (C + 16) + (768 + 1536) * 2


FIRST_DESIGN_WIDTHS = {
    role: [c for c in range(128, 4097, 128)
           if _first_design_smem(role, c) <= twb.SM90_SMEM_LIMIT]
    for role in ("first", "final")}


@pytest.mark.parametrize("role", ["first", "final"])
def test_plan_takes_every_width_the_first_design_took(role):
    """Every width the first design took (C % 128 == 0 up to 2688 for the
    first layer, 1408 for the final one) has a tile: two column groups
    where three of their ring stages fit, else one, the ring as deep as
    fits, up to six stages, at batch 1 and 3."""
    widths = FIRST_DESIGN_WIDTHS[role]
    assert widths[-1] == {"first": 2688, "final": 1408}[role]
    for width in widths:
        for T, B in ((6400, 3), (1000, 1)):
            plan = tq.int8_sm90_plan(width, T, B, role=role)
            nc, stages = plan["nc"], plan["stages"]

            def fit(nc, n):
                return (tq.int8_sm90_smem_bytes(nc, width, n, role)
                        + tq.INT8_SM90_STATIC_SMEM <= twb.SM90_SMEM_LIMIT)

            assert nc == (2 if fit(2, 3) else 1)
            assert plan["bm"] == 64 and plan["threads"] == 128 * (nc + 1)
            assert 2 <= stages <= tq.INT8_SM90_MAX_STAGES
            assert plan["grid"] == (-(-T // 64), B)
            assert fit(nc, stages)
            assert (stages == tq.INT8_SM90_MAX_STAGES
                    or not fit(nc, stages + 1))


@pytest.mark.parametrize("role,width,nc,stages", [
    ("first", 512, 2, 4),     # the reference width: the standard layer's
    ("final", 512, 2, 5),     # no gated tile: one stage deeper
    ("first", 1536, 2, 3),
    ("first", 1664, 1, 4),    # the x0 table tips it to one group
    ("final", 1408, 2, 4),
    ("final", 3200, 2, 3),
    ("first", 2688, 1, 2),
])
def test_plan_per_role(role, width, nc, stages):
    plan = tq.int8_sm90_plan(width, 6400, 3, role=role)
    assert (plan["nc"], plan["stages"]) == (nc, stages)
    stage = nc * 128 * 128 + 64 * 128
    side = (width * 8 * 2 * 2 + 2 * 64 * 8 * 4 if role == "final"
            else 64 * width + 64 * 3 * 4 * 4)
    assert plan["smem"] == 1024 + stages * stage + side


def test_plan_rejects_an_unknown_role():
    with pytest.raises(ValueError, match="no role"):
        tq.int8_sm90_plan(512, role="last")


def test_roles_and_c_interface():
    """The roles the plan names are the kernel's enum; the two new entries
    take what ``ops/wn_block_int8.py`` declares; the shared-memory query
    takes the role."""
    src = SRC.read_text()
    enum = re.search(r"enum Role \{([^}]*)\}", src).group(1)
    roles = {n.strip().lower(): int(v) for n, v in
             re.findall(r"(\w+) = (\d+)", enum)}
    assert roles == tq.INT8_SM90_ROLES
    for name, n_ptr, n_int in (("t2s_wn_layer_final_int8_sm90", 15, 9),
                               ("t2s_wn_layer_first_int8_sm90", 18, 9)):
        params = re.search(rf"^int {name}\(([^)]*)\)", src, re.M).group(1)
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in params.split(",")]
        assert kinds == [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        assert kinds == tq.LIB_SM90.signatures[name]
    assert re.search(r"t2s_wn_int8_sm90_smem_bytes\(int nc, int C, int "
                     r"stages, int role\)", src)
    for role in ("FINAL", "FIRST"):
        assert f"launch<{role}, 2>" in src and f"launch<{role}, 1>" in src
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(const["MAX_E"]) == 8 and int(const["MAX_NHALF"]) == 4

