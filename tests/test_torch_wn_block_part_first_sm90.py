"""The ``PART_FIRST`` role of ``csrc/wn_block_sm90.cu`` (one rank's share of
layer 0 of a flow under tensor parallelism), checked on the CPU.

The kernel cannot run here, so a PyTorch "tile walk" follows its blocking:
blocks of ``sm90_plan(Cp, T, B, role="part_first")``'s rows of one
utterance; the block's tap tile staged once, 16 columns wide:
x0[t + (j - 1) d, i] at column j n_half + i, zero outside [0, n_valid), past
T and from column 3 n_half on; gate-pair chunks of the rank's columns in
order, each read as four 64-column weight boxes (c0, c0 + 64, Cp + c0, Cp +
c0 + 64), so that at Cp % 128 == 64 the last chunk is half: its boxes past
the rank's tanh columns hold sigmoid columns or TMA's zero fill, and only
its 64 tanh columns are gated.  Each chunk's in-act product starts with the
tap stage, the tap tile times wp's 16 rows [3 n_half, 2Cp] (the rows past 3
n_half zero-filled: one K = 16 product on the tensor cores), then runs the
conditioning's stages, spect's rows (zero past T) times w_cond over the
plan's 32- or 64-deep stages; then b_all + b_cond, the edge take-back
(b_edge[0] where t < d, b_edge[1] where t >= n_valid - d) and the gate in
f32 rounded to the input dtype.  The res/skip product [rows, Cp] x [Cp,
rs_out] runs in chunks of 256 columns; the f32 partial is written whole,
zero at rows >= n_valid, with no bias, residual base or skip.

The walk is held to the JAX package's Pallas kernel
``wn_layer_stream2_partial`` with ``b_edge`` (interpret mode, as
``tests/test_torch_wn_block_partial.py`` runs it) and to the port's plain
version ``wn_layer_partial_plain(b_edge=...)``; the launch plan of the role
is checked at every rank width of the reference config and the role's
constants against the C interface.

Tolerances, those of ``tests/test_torch_wn_block_first_sm90.py``.  Against
Pallas in float32: the same f32 products summed in another order, values
of order 1: 2e-5 absolute.  Against the plain version in bf16: both round
the gated activation to bf16, and f32 sums in another order can land on the
other side of a bf16 rounding boundary: four bf16 steps (2^-8 of the value)
at the output's peak, relative L2 under 5e-3 (the bounds the kernel is held
to on the card)."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text2speech_tpu.ops.pallas import wn_block as jwb
from text2speech_tpu_torch.ops import wn_block as twb
from text2speech_tpu_torch.parallel.tp import pair_cols

torch.set_num_threads(1)

C, M = 256, 96           # the whole layer's width; a rank's Cp is C / p
F32 = torch.float32
ATOL = 2e-5
BF16_MAX_ABS_STEPS = 4 * 2.0 ** -8
BF16_REL_L2 = 5e-3
GN, TAP_ROWS = 256, 16
SRC = Path(twb.__file__).parent.parent / "csrc" / "wn_block_sm90.cu"


def _rows(src, b, idx, extent):
    """src[b, idx] with rows outside [0, extent) read as zero."""
    out = torch.zeros(len(idx), src.shape[-1], dtype=src.dtype)
    ok = (idx >= 0) & (idx < extent)
    out[ok] = src[b, idx[ok]]
    return out


def _tap_tile(x0, b, rows, d, n_valid):
    """The block's tap tile [bm, 16] f32: x0[t + (j - 1) d, i] at column
    j n_half + i, zero outside [0, n_valid), past T and past 3 n_half."""
    T, nh = x0.shape[1], x0.shape[2]
    xa = torch.zeros(len(rows), TAP_ROWS)
    xa[:, :3 * nh] = torch.cat([_rows(x0, b, rows + s, n_valid).to(F32)
                                for s in (-d, 0, d)], -1)
    return torch.where((rows < T)[:, None], xa, 0.0)


def _boxes(w, c0, Cp):
    """The chunk's four 64-column boxes of ``w`` [K, 2Cp] as [K, 256] f32:
    columns past 2Cp read TMA's zero fill."""
    cols = torch.cat([torch.arange(c, c + 64)
                      for c in (c0, c0 + 64, Cp + c0, Cp + c0 + 64)])
    out = torch.zeros(w.shape[0], GN)
    ok = cols < 2 * Cp
    out[:, ok] = w[:, cols[ok]].to(F32)
    return out, torch.where(ok, cols, 2 * Cp)


def tile_walk_part_first(x0, spect, wp, b_all, w_cond, b_cond, w_rs, d,
                         b_edge, n_valid, bm=None, bk=None):
    """The layer-0 partial as the kernel computes it -> [B, T, rs_out]
    f32, the chunks visited in order (returned second)."""
    B, T, nh = x0.shape
    Cp, rs_out = w_rs.shape
    plan = twb.sm90_plan(Cp, T, B, role="part_first")
    bm, bk = bm or plan["bm"], bk or plan["bk"]
    w_taps = torch.zeros(TAP_ROWS, 2 * Cp, dtype=wp.dtype)
    w_taps[:3 * nh] = wp.reshape(3 * nh, 2 * Cp)
    pad = torch.zeros(1, 2 * Cp)      # the bias of a zero-filled column
    bias = torch.cat([(b_all + b_cond.to(F32))[None], pad], 1)[0]
    edge = torch.cat([b_edge, torch.zeros(2, 1)], 1)
    out = torch.empty(B, T, rs_out)
    order = []
    for b in range(B):
        for t0 in range(0, T, bm):
            rows = torch.arange(t0, t0 + bm)
            xa = _tap_tile(x0, b, rows, d, n_valid)
            src = _rows(spect, b, rows, T).to(F32)
            left = (rows < d)[:, None]
            right = (rows >= n_valid - d)[:, None]
            gated = torch.empty(bm, Cp, dtype=x0.dtype)
            for c0 in range(0, Cp, GN // 2):
                if b == 0 and t0 == 0:
                    order.append(c0)
                wt, cols = _boxes(w_taps, c0, Cp)
                acc = xa @ wt                          # the tap stage
                wc, _ = _boxes(w_cond, c0, Cp)
                for k0 in range(0, M, bk):
                    acc += src[:, k0:k0 + bk] @ wc[k0:k0 + bk]
                in_act = acc + bias[cols]
                in_act = in_act - torch.where(left, edge[0, cols], 0.0)
                in_act = in_act - torch.where(right, edge[1, cols], 0.0)
                width = min(GN // 2, Cp - c0)         # 64 in a half chunk
                gated[:, c0:c0 + width] = (
                    torch.tanh(in_act[:, :width])
                    * torch.sigmoid(in_act[:, GN // 2:GN // 2 + width])
                ).to(x0.dtype)
            g = gated.to(F32)
            n = min(bm, T - t0)
            valid = (rows[:n] < n_valid)[:, None]
            for n0 in range(0, rs_out, GN):
                nn = min(GN, rs_out - n0)
                acc = torch.zeros(bm, nn)
                for k0 in range(0, Cp, bk):
                    acc += g[:, k0:k0 + bk] @ w_rs[k0:k0 + bk,
                                                   n0:n0 + nn].to(F32)
                out[b, t0:t0 + n, n0:n0 + nn] = torch.where(valid, acc[:n],
                                                            0.0)
    return out, order


def _share(seed, B, T, n_valid, n_half, p, i, dtype=F32):
    """numpy inputs of a whole layer 0 and rank i of p's share as tensors,
    with the rank's composed taps folded once (as the TP vocoder does)."""
    rng = np.random.RandomState(seed)
    mask = (np.arange(T) < n_valid)[None, :, None]

    def rn(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    k = {"x0": rn(B, T, n_half, scale=0.5) * mask,
         "spect": rn(B, T, M, scale=0.5),
         "start_k": rn(n_half, C, scale=0.4), "start_b": rn(C, scale=0.1),
         "w_in": rn(3, C, 2 * C, scale=(3 * C) ** -0.5),
         "b_in": rn(2 * C, scale=0.1),
         "w_cond": rn(M, 2 * C, scale=M ** -0.5),
         "b_cond": rn(2 * C, scale=0.1),
         "w_rs": rn(C, 2 * C, scale=C ** -0.5)}
    cols, s = pair_cols(C, p, i), C // p
    sh = {"x0": k["x0"], "spect": k["spect"], "start_k": k["start_k"],
          "start_b": k["start_b"], "w_in": k["w_in"][..., cols],
          "b_in": k["b_in"][cols], "w_cond": k["w_cond"][:, cols],
          "b_cond": k["b_cond"][cols], "w_rs": k["w_rs"][i * s:(i + 1) * s]}
    t = {n: torch.from_numpy(np.ascontiguousarray(v)) for n, v in sh.items()}
    for n in ("x0", "spect", "start_k", "w_in", "w_cond", "w_rs"):
        t[n] = t[n].to(dtype)
    wp, b_all, b_edge = twb.fold_first_taps(t["start_k"], t["start_b"],
                                            t["w_in"], t["b_in"])
    args = (t["x0"], t["spect"], wp, b_all, t["w_cond"], t["b_cond"],
            t["w_rs"])
    return sh, args, b_edge


def _bf16_close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    peak = max(want.abs().max().item(), 1.0)
    assert (got - want).abs().max().item() <= BF16_MAX_ABS_STEPS * peak
    if want.norm() > 0:
        assert ((got - want).norm() / want.norm()).item() <= BF16_REL_L2


# --- against the Pallas kernel (interpret mode), float32 --------------------


@pytest.mark.parametrize("p,n_half,n_valid,d", [
    (1, 4, 512, 1),       # Cp = 256: two whole chunks, all valid
    (2, 3, 389, 64),      # Cp = 128: one chunk, n_valid off the tile grid
    (4, 2, 40, 130),      # Cp = 64: a half chunk, n_valid < d
])
def test_part_first_tile_walk_matches_pallas(p, n_half, n_valid, d):
    T = 512
    sh, args, b_edge = _share(10 + p + d, 1, T, n_valid, n_half, p, p - 1)
    jwp, b_extra, jb_edge = jwb._fold_first_taps(
        jnp.asarray(sh["start_k"]), jnp.asarray(sh["start_b"]),
        jnp.asarray(sh["w_in"]))
    want = jwb.wn_layer_stream2_partial(
        jnp.asarray(sh["x0"]), jnp.asarray(sh["spect"]), jwp,
        jnp.asarray(sh["b_in"]) + b_extra, jnp.asarray(sh["w_cond"]),
        jnp.asarray(sh["b_cond"]), jnp.asarray(sh["w_rs"]), d,
        b_edge=jb_edge, interpret=True, n_valid=n_valid)
    got, _ = tile_walk_part_first(*args, d, b_edge, n_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert not got[:, n_valid:].any()


# --- against the plain version, bf16, T and n_valid off the tile grid ------


@pytest.mark.parametrize("p", [1, 2, 4])          # Cp = 256, 128, 64
@pytest.mark.parametrize("n_valid,d,n_half", [
    (333, 1, 4), (300, 64, 3), (129, 130, 2), (1, 1, 3), (0, 1, 4)])
def test_part_first_tile_walk_matches_plain_bf16(p, n_valid, d, n_half):
    T = 333
    _, args, b_edge = _share(30 + p + d + n_valid, 2, T, n_valid, n_half, p,
                             0 if n_valid % 2 else p - 1,
                             dtype=torch.bfloat16)
    want = twb.wn_layer_partial_plain(*args, d, b_edge=b_edge,
                                      n_valid=n_valid)
    got, _ = tile_walk_part_first(*args, d, b_edge, n_valid)
    assert got.dtype == F32 and got.shape == want.shape
    assert not got[:, n_valid:].any() and not want[:, n_valid:].any()
    if n_valid:
        _bf16_close(got, want)


def test_part_first_chunk_order_and_the_half_chunk():
    """Chunks of 128 gate columns in order; at Cp % 128 == 64 the last one
    gates its 64 tanh columns only, and the zero-filled boxes past the
    rank's columns change nothing: a walk on wp and w_cond padded with
    garbage columns past 2Cp would differ, the kernel's does not read
    them."""
    T, n_valid, d = 200, 180, 1
    for p, want in ((1, [0, 128]), (2, [0]), (4, [0])):
        _, args, b_edge = _share(60 + p, 1, T, n_valid, 4, p, 0)
        got, order = tile_walk_part_first(*args, d, b_edge, n_valid)
        assert order == want
        torch.testing.assert_close(
            got, twb.wn_layer_partial_plain(*args, d, b_edge=b_edge,
                                            n_valid=n_valid),
            atol=ATOL, rtol=0)
    # Cp = 192: two chunks, the second half
    w_rs = torch.randn(192, 2 * C) * 0.05
    x0 = torch.randn(1, 100, 2) * 0.5
    spect = torch.randn(1, 100, M) * 0.5
    wp = torch.randn(3, 2, 384) * 0.3
    b_all, b_edge = torch.randn(384) * 0.1, torch.randn(2, 384) * 0.1
    w_cond, b_cond = torch.randn(M, 384) * 0.1, torch.randn(384) * 0.1
    args = (x0, spect, wp, b_all, w_cond, b_cond, w_rs)
    got, order = tile_walk_part_first(*args, 3, b_edge, 90)
    assert order == [0, 128]
    torch.testing.assert_close(
        got, twb.wn_layer_partial_plain(*args, 3, b_edge=b_edge, n_valid=90),
        atol=ATOL, rtol=0)


def test_part_first_tap_stage_reads_no_row_past_three_n_half():
    """The tap stage's K is 16: wp's rows past 3 n_half are zero-filled, so
    values there in the 16-column tap tile (which the kernel zeroes too)
    reach nothing, and neither do wp's contents past its 3 n_half rows."""
    T, n_valid, d = 150, 150, 2
    _, args, b_edge = _share(70, 1, T, n_valid, 2, 2, 1)
    x0, spect, wp = args[:3]
    xa = _tap_tile(x0, 0, torch.arange(128), d, n_valid)
    assert not xa[:, 6:].any()
    big = torch.cat([wp.reshape(6, -1), torch.full((10, wp.shape[-1]), 9.0)])
    w_taps = torch.zeros_like(big)
    w_taps[:6] = big[:6]
    assert torch.equal(xa @ big, xa @ w_taps)


def test_part_first_takes_the_edge_bias_back_where_the_plain_version_does():
    """With zero x0 and spect the gate's input is b_all + b_cond minus the
    edge rows' b_edge: the partial is a function of the row's edge class
    (left, middle, right), and zero from n_valid on."""
    T, n_valid, d = 200, 150, 16
    _, args, b_edge = _share(80, 1, T, n_valid, 3, 2, 0)
    args = (torch.zeros_like(args[0]), torch.zeros_like(args[1]), *args[2:])
    got, _ = tile_walk_part_first(*args, d, b_edge, n_valid)
    want = twb.wn_layer_partial_plain(*args, d, b_edge=b_edge,
                                      n_valid=n_valid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    s = got[0]
    assert torch.equal(s[0], s[d - 1]) and not torch.equal(s[0], s[d])
    assert torch.equal(s[d], s[n_valid - d - 1])
    assert torch.equal(s[n_valid - d], s[n_valid - 1])
    assert not torch.equal(s[d], s[n_valid - d])
    assert not s[n_valid:].any()


def test_part_first_walk_is_independent_of_the_row_tile():
    """Rows never mix: the 64-row tile gives the 128-row tile's result,
    whatever the stage depth."""
    T, n_valid, d = 333, 300, 64
    _, args, b_edge = _share(50, 1, T, n_valid, 4, 2, 1)
    want, _ = tile_walk_part_first(*args, d, b_edge, n_valid, bm=128,
                                   bk=64)
    for bm, bk in ((64, 64), (128, 32), (64, 32)):
        got, _ = tile_walk_part_first(*args, d, b_edge, n_valid, bm=bm,
                                      bk=bk)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_part_first_ranks_sum_to_the_whole_first_layer():
    """The p = 4 ranks' walks plus the res/skip bias are the whole first
    layer's res/skip term (the skip half, and the residual half before the
    base x0 start_k + start_b, which the TP path adds after the sum)."""
    T, n_valid, d = 200, 190, 1
    p = 4
    rng = np.random.RandomState(90)
    b_rs = torch.from_numpy(rng.randn(2 * C).astype(np.float32) * 0.1)
    total = None
    for i in range(p):
        _, args, b_edge = _share(91, 1, T, n_valid, 4, p, i)
        part, _ = tile_walk_part_first(*args, d, b_edge, n_valid)
        total = part if total is None else total + part
    sh, args, b_edge = _share(91, 1, T, n_valid, 4, 1, 0)
    x_out, skip = twb.wn_layer_first_plain(
        args[0], args[1], torch.from_numpy(sh["start_k"]),
        torch.from_numpy(sh["start_b"]), args[2], args[3], b_edge, args[4],
        args[5], args[6], b_rs, d, n_valid=n_valid)
    base = args[0] @ torch.from_numpy(sh["start_k"]) + torch.from_numpy(
        sh["start_b"])
    rs = total + b_rs
    torch.testing.assert_close(skip[:, :n_valid], rs[:, :n_valid, C:],
                               atol=ATOL, rtol=0)
    torch.testing.assert_close(x_out[:, :n_valid],
                               (base + rs[..., :C])[:, :n_valid],
                               atol=ATOL, rtol=0)


# --- the host-side launch plan and the C interface --------------------------


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("T,B", [(6400, 1), (6400, 3), (1000, 3)])
def test_part_first_plan_at_every_rank_width(p, T, B):
    """At the reference width (C = 512): the partial layer's rows, with the
    tap stage's [bm, bk] bf16 tile after the gated tile; whole K stages of
    the res/skip product; a ring of at least two stages that is as deep as
    fits."""
    Cp = 512 // p
    twb.check_partial_dims(Cp, 1024)
    plan = twb.sm90_plan(Cp, T, B, role="part_first")
    part = twb.sm90_plan(Cp, T, B, role="part")
    bm, bk, stages = plan["bm"], plan["bk"], plan["stages"]
    assert bm == part["bm"] and plan["grid"] == part["grid"] == (
        -(-T // bm), B)
    assert Cp % bk == 0 and 2 <= stages <= twb.SM90_MAX_STAGES
    assert plan["smem"] == (1024 + stages * (bk * GN * 2 + bm * bk * 2)
                            + bm * Cp * 2 + bm * bk * 2)
    assert plan["smem"] == twb.sm90_smem_bytes(plan["nwg"], bk, Cp, stages,
                                               role="part_first")
    assert plan["smem"] + twb.SM90_STATIC_SMEM <= twb.SM90_SMEM_LIMIT
    assert (stages == twb.SM90_MAX_STAGES
            or twb.sm90_smem_bytes(plan["nwg"], bk, Cp, stages + 1,
                                   role="part_first")
            + twb.SM90_STATIC_SMEM > twb.SM90_SMEM_LIMIT)


@pytest.mark.parametrize("p,B,bm", [(2, 1, 64), (4, 1, 64), (2, 3, 128),
                                    (4, 3, 128), (8, 3, 128)])
def test_part_first_plan_at_the_tp_vocode(p, B, bm):
    """At T = 6400 groups: one utterance leaves 50 blocks of 128 rows for
    132 SMs, so 64-row blocks; batch 3 fills the card with 128-row ones."""
    assert twb.sm90_plan(512 // p, 6400, B, role="part_first")["bm"] == bm


def test_part_first_role_constants_and_c_interface():
    """The role's code, its tap stage and its epilogue are what the plan
    and the walk restate; the new entry takes what ``ops/wn_block.py``
    declares (9 pointers and 11 ints, then the stream), in the first
    design's order of the pointers."""
    src = SRC.read_text()
    assert "PART_FIRST = 4 };" in src
    assert twb.SM90_ROLES["part_first"] == 4
    assert set(twb.SM90_TAP_ROLES) == {"first", "part_first"}
    assert "return role == FIRST || role == PART_FIRST;" in src
    assert "if (ROLE == PART || ROLE == PART_FIRST) {" in src
    const = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert int(const["TAP_ROWS"]) == TAP_ROWS and const["GN"] == "256"
    decls = dict(re.findall(r"^(?:int|size_t) (t2s_\w+)\(([^)]*)\)", src,
                            re.M))
    P, I = ctypes.c_void_p, ctypes.c_int
    params = [s.split()[-1].lstrip("*")
              for s in decls["t2s_wn_layer_partial_first_sm90"].split(",")]
    kinds = [P if "*" in s else I
             for s in decls["t2s_wn_layer_partial_first_sm90"].split(",")]
    assert kinds == twb.LIB_SM90.signatures[
        "t2s_wn_layer_partial_first_sm90"] == [P] * 9 + [I] * 11 + [P]
    assert params[:9] == ["x0", "spect", "wp", "b_all", "b_edge", "w_cond",
                          "b_cond", "w_rs", "out"]
    assert "dispatch<PART_FIRST>(p, B, nwg, bk, stream)" in src
