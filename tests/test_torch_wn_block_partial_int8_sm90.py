"""The ``PART`` form of ``csrc/wn_block_int8_sm90.cu`` (one rank's share of
an int8 WN layer under tensor parallelism, layers 1..L-1, on s8 ``wgmma``),
checked on the CPU.

The kernel cannot run here, so a PyTorch "tile walk" follows its blocking:
blocks of 64 rows of one utterance and ``int8_sm90_plan``'s column
groups (consumer warpgroups that take alternate chunks, a group with no
chunk left sitting it out); gate chunks of 64 tanh + the matching 64
sigmoid columns of the rank's Cp, so that at Cp % 128 == 64 the last pair
has one chunk; the in-act K in 128-deep int8 stages in the kernel's order,
tap 0, 1, 2 (CX each, rows t-d, t, t+d read as zero outside [0, n_valid),
as TMA's out-of-bounds fill gives them, with a row scale of 0 there) and
then the conditioning (M, its last stage zero-filled past M); each tap's
s32 sums flushed at its end into an f32 sum with the scale of its own
shifted row (a multiply, then an add); the gate in f32 quantized at 127
with round-half-even into a gated tile of whole 128-column panels (its
columns past Cp hold whatever shared memory held); the res/skip product in
chunks of 128 columns over ceil(Cp / 128) stages whose weight boxes are
zero past Cp; each chunk's s32 sums times sw_rs / 127, written whole, zero
at rows >= n_valid.  The integer sums are taken in float64, exact here.

The walk is held to the JAX package's Pallas kernel (interpret mode) by the
bound of ``tests/test_torch_wn_block_partial.py`` (a gated value on a
round-half-even knife edge moves one output by at most its column's
weight scale: 0.02 at most, 1e-4 on average), and to the port's plain
version BIT FOR BIT: both take the integer sums exactly and every f32
operation after them in the same order.  The launch plan at every rank
width and the C interface are checked too."""

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
from text2speech_tpu_torch.parallel.tp import pair_cols

torch.set_num_threads(1)

CX, M = 256, 192         # the hidden state's width; Cp = CX / p
F32, F64 = torch.float32, torch.float64
GH, QN = 64, 128         # gate chunk: 64 tanh + 64 sigmoid; res/skip chunk
PALLAS_MAX, PALLAS_MEAN = 0.02, 1e-4
SRC = Path(tq.__file__).parent.parent / "csrc" / "wn_block_int8_sm90.cu"


def _rows(src, b, idx, extent):
    """src[b, idx] with rows outside [0, extent) read as zero."""
    out = torch.zeros(len(idx), src.shape[-1], dtype=src.dtype)
    ok = (idx >= 0) & (idx < extent)
    out[ok] = src[b, idx[ok]]
    return out


def _k_stages(a, w, K):
    """s32 sums of a [rows, Kx] . w [N, Kx] over K-deep stages, in float64
    (exact)."""
    acc = torch.zeros(a.shape[0], w.shape[0], dtype=F64)
    for k0 in range(0, a.shape[1], K):
        acc += a[:, k0:k0 + K].to(F64) @ w[:, k0:k0 + K].to(F64).T
    return acc


def tile_walk_partial_int8(qx, sx, qspect, sspect, qw_in, sw_in, b_in,
                           qw_cond, sw_cond, b_cond, qw_rs, sw_rs, d,
                           n_valid, nc=None, bm=64, seed=0):
    """The partial int8 layer as the kernel computes it -> [B, T, rs_out]
    f32.  ``nc`` column groups (the plan's), ``bm`` rows a block (the
    kernel's 64; rows never mix); ``seed`` fills the gated tile's columns
    past Cp, which the gate never writes."""
    B, T, cx = qx.shape
    rs_out, Cp = qw_rs.shape
    nc = nc or tq.int8_sm90_plan(Cp, T, B)["nc"]
    K = tq.INT8_SM90_K
    width = -(-Cp // K) * K                 # whole 128-column panels
    w_rs = torch.zeros(rs_out, width, dtype=torch.int8)  # boxes zero past Cp
    w_rs[:, :Cp] = qw_rs
    junk = torch.Generator().manual_seed(seed)
    inv127 = 1.0 / 127.0
    out = torch.empty(B, T, rs_out)
    for b in range(B):
        for t0 in range(0, T, bm):
            rows = torch.arange(t0, t0 + bm)
            taps = [_rows(qx, b, rows + (j - 1) * d, n_valid)
                    for j in range(3)] if n_valid else []
            st = [_rows(sx, b, rows + (j - 1) * d, n_valid)[:, 0]
                  for j in range(3)]
            spec = _rows(qspect, b, rows, T)
            ss = _rows(sspect, b, rows, T)[:, 0]
            gated = torch.randint(-128, 128, (bm, width), generator=junk,
                                  dtype=torch.int8)
            for c0 in range(0, Cp, GH * nc):
                for g in range(nc):
                    c = c0 + GH * g
                    if c >= Cp:                  # this group sits it out
                        continue
                    cols = torch.cat([torch.arange(c, c + GH),
                                      torch.arange(Cp + c, Cp + c + GH)])
                    tsum = torch.zeros(bm, 2 * GH)
                    for j, a in enumerate(taps):   # flush at each tap's end
                        s32 = _k_stages(a, qw_in[j][cols], K).to(F32)
                        tsum = tsum + s32 * st[j][:, None]
                    cond = _k_stages(spec, qw_cond[cols], K).to(F32)
                    at = tsum * sw_in[cols] + b_in[cols]
                    cq = (cond * ss[:, None]) * sw_cond[cols] + b_cond[cols]
                    in_act = at + cq
                    gv = (torch.tanh(in_act[:, :GH])
                          * torch.sigmoid(in_act[:, GH:]))
                    gated[:, c:c + GH] = torch.round(gv * 127.0).to(
                        torch.int8)
            n = min(bm, T - t0)
            valid = (rows[:n] < n_valid)[:, None]
            for n0 in range(0, rs_out, QN * nc):
                for g in range(nc):
                    nc0 = n0 + QN * g
                    if nc0 >= rs_out:
                        continue
                    s32 = _k_stages(gated, w_rs[nc0:nc0 + QN], K).to(F32)[:n]
                    v = s32 * (sw_rs[nc0:nc0 + QN] * inv127)
                    out[b, t0:t0 + n, nc0:nc0 + QN] = torch.where(valid, v,
                                                                  0.0)
    return out


# --- inputs, made with numpy from a seed and quantized by the JAX functions


def _quant_rows(x):
    q, s = jq.quantize_rows(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _quant_cols(w):
    q, s = jq.quantize_cols(jnp.asarray(w))
    return np.asarray(q), np.asarray(s)


def _whole(seed, B, T, n_valid, rs_out, spread=False):
    """A whole layer in floating point (numpy, the JAX layout) and its
    quantized activations.  ``spread``: row scales over orders of
    magnitude."""
    rng = np.random.RandomState(seed)
    mask = (np.arange(T) < n_valid)[None, :, None]

    def rn(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    x = rn(B, T, CX, scale=1.0) * mask
    if spread:
        x = x * np.exp(rng.randn(B, T, 1) * 2).astype(np.float32)
    k = {"w_in": rn(3, CX, 2 * CX, scale=0.1), "b_in": rn(2 * CX, scale=0.1),
         "w_cond": rn(M, 2 * CX, scale=0.1),
         "b_cond": rn(2 * CX, scale=0.1),
         "w_rs": rn(CX, rs_out, scale=0.1), "b_rs": rn(rs_out, scale=0.1)}
    k["qx"], k["sx"] = _quant_rows(x)
    k["qspect"], k["sspect"] = _quant_rows(rn(B, T, M, scale=1.0))
    return k


def _share(k, p, i):
    """Rank i of p's share, each weight quantized with the rank's own
    column scales (as the tensor-parallel server prepares them), in the
    JAX layout."""
    cols, s = pair_cols(CX, p, i), CX // p
    q = {}
    q["qw_in"], q["sw_in"] = _quant_cols(k["w_in"][..., cols])
    q["qw_cond"], q["sw_cond"] = _quant_cols(k["w_cond"][:, cols])
    q["qw_rs"], q["sw_rs"] = _quant_cols(k["w_rs"][i * s:(i + 1) * s])
    q["b_in"], q["b_cond"] = k["b_in"][cols], k["b_cond"][cols]
    return q


ACTS = ["qx", "sx", "qspect", "sspect"]
WEIGHTS = ["qw_in", "sw_in", "b_in", "qw_cond", "sw_cond", "b_cond", "qw_rs",
           "sw_rs"]


def _port_args(k, q):
    """The port's tensors: output-major int8 weights."""
    t = {n: torch.from_numpy(np.array(v))
         for n, v in {**{n: k[n] for n in ACTS}, **q}.items()}
    for n in ("qw_in", "qw_cond", "qw_rs"):
        t[n] = tq.to_output_major(t[n])
    return [t[n] for n in ACTS + WEIGHTS]


# --- against the Pallas kernel (interpret mode) -----------------------------


@pytest.mark.parametrize("p,rs_full,d,n_valid", [
    (4, True, 1, 511),      # Cp = 64: one gate chunk, the second group out
    (4, False, 64, 389),    # a halo of a whole tile, n_valid off the tile
    (2, True, 64, 0),       # Cp = 128: nothing valid, no tap stage
    (1, False, 1, 389),     # Cp = 256: two gate-chunk pairs
])
def test_walk_matches_pallas(p, rs_full, d, n_valid):
    """T = 512, one Pallas tile; rank p - 1."""
    B, T = 1, 512
    k = _whole(100 + 10 * p + d, B, T, n_valid, 2 * CX if rs_full else CX)
    q = _share(k, p, p - 1)
    want = jq.wn_layer_stream2_partial_int8(
        *[jnp.asarray(k[n]) for n in ACTS],
        *[jnp.asarray(q[n]) for n in WEIGHTS], d, n_valid=n_valid)
    got = tile_walk_partial_int8(*_port_args(k, q), d, n_valid)
    diff = np.abs(got.numpy() - np.asarray(want))
    assert diff.max() <= PALLAS_MAX, diff.max()
    assert diff.mean() < PALLAS_MEAN, diff.mean()
    assert (got[:, n_valid:] == 0).all()


# --- against the plain version, bit for bit, T and n_valid off the tile ----


@pytest.mark.parametrize("p", [4, 2, 1])           # Cp = 64, 128, 256
@pytest.mark.parametrize("rs_full", [True, False])
@pytest.mark.parametrize("n_valid,d", [(332, 1), (200, 64), (0, 64)])
def test_walk_equals_the_plain_version_bit_for_bit(p, rs_full, n_valid, d):
    """T = 333 (six blocks, the last one short), n_valid = T - 1, off the
    tile and 0; row scales spread over orders of magnitude, so that an f32
    operation in another order would show."""
    B, T = 2, 333
    k = _whole(200 + p + n_valid + d, B, T, n_valid,
               2 * CX if rs_full else CX, spread=True)
    args = _port_args(k, _share(k, p, 0))
    want = tq.wn_layer_partial_int8_plain(*args, d, n_valid=n_valid)
    got = tile_walk_partial_int8(*args, d, n_valid)
    assert got.dtype == F32 and got.shape == want.shape
    assert torch.equal(got, want)
    assert (got[:, n_valid:] == 0).all()


@pytest.mark.parametrize("p", [4, 2])
def test_walk_is_independent_of_the_tile(p):
    """Rows never mix, the column groups own disjoint columns, and the
    gated tile's columns past Cp multiply zeros: one or two column groups,
    64- or 128-row blocks and any leftover shared memory give the same
    partial bit for bit."""
    B, T, n_valid, d = 1, 333, 300, 64
    k = _whole(300 + p, B, T, n_valid, 2 * CX)
    args = _port_args(k, _share(k, p, 1))
    want = tile_walk_partial_int8(*args, d, n_valid, nc=1, bm=64, seed=0)
    for nc, bm, seed in ((2, 64, 1), (1, 128, 2), (2, 128, 3)):
        got = tile_walk_partial_int8(*args, d, n_valid, nc=nc, bm=bm,
                                     seed=seed)
        assert torch.equal(got, want)


@pytest.mark.parametrize("p", [2, 4])
def test_ranks_sum_to_the_unsharded_int8_layer(p):
    """With the unsharded layer's own quantized weights split by rank (a
    rank owns whole in-act columns, so its columns' scales are the
    layer's, and the res/skip scales are per output column), every gated
    value is the unsharded layer's, and the p partials plus b_rs are its
    res/skip product up to the f32 rounding of their p-term sum."""
    B, T, n_valid, d = 1, 333, 300, 8
    k = _whole(400 + p, B, T, n_valid, 2 * CX)
    qw_in, sw_in = _quant_cols(k["w_in"])
    qw_cond, sw_cond = _quant_cols(k["w_cond"])
    qw_rs, sw_rs = _quant_cols(k["w_rs"])
    t = {n: torch.from_numpy(np.array(v)) for n, v in (
        ("qw_in", qw_in), ("sw_in", sw_in), ("qw_cond", qw_cond),
        ("sw_cond", sw_cond), ("qw_rs", qw_rs), ("sw_rs", sw_rs),
        ("b_in", k["b_in"]), ("b_cond", k["b_cond"]), ("b_rs", k["b_rs"]),
        *((n, k[n]) for n in ACTS))}
    acts = [t[n] for n in ACTS]
    s = CX // p
    total = None
    for i in range(p):
        cols = torch.from_numpy(pair_cols(CX, p, i))
        share = [tq.to_output_major(t["qw_in"][..., cols]), t["sw_in"][cols],
                 t["b_in"][cols], tq.to_output_major(t["qw_cond"][:, cols]),
                 t["sw_cond"][cols], t["b_cond"][cols],
                 tq.to_output_major(t["qw_rs"][i * s:(i + 1) * s]),
                 t["sw_rs"]]
        part = tile_walk_partial_int8(*acts, *share, d, n_valid)
        total = part if total is None else total + part
    qw = [tq.to_output_major(t[n]) for n in ("qw_in", "qw_cond", "qw_rs")]
    in_act = (tq._taps_q(t["qx"], t["sx"], qw[0], t["sw_in"], d, n_valid)
              + t["b_in"] + tq._cond_q(t["qspect"], t["sspect"], qw[1],
                                       t["sw_cond"], t["b_cond"]))
    whole = tq._rs_q(tq._gate_q(in_act), qw[2], t["sw_rs"], t["b_rs"])
    torch.testing.assert_close((total + t["b_rs"])[:, :n_valid],
                               whole[:, :n_valid], rtol=1e-5, atol=1e-5)


# --- the host-side launch plan ----------------------------------------------


def _check_partial_plan(Cp, T, B):
    twb.check_partial_dims(Cp, 128)
    plan = tq.int8_sm90_plan(Cp, T, B)
    nc, stages = plan["nc"], plan["stages"]

    def fit(nc, n):
        return (tq.int8_sm90_smem_bytes(nc, Cp, n)
                + tq.INT8_SM90_STATIC_SMEM <= twb.SM90_SMEM_LIMIT)

    assert nc == (2 if fit(2, 3) else 1)
    assert plan["bm"] == 64 and plan["threads"] == 128 * (nc + 1)
    assert 2 <= stages <= tq.INT8_SM90_MAX_STAGES
    assert plan["grid"] == (-(-T // 64), B)
    panels = -(-Cp // 128)
    assert plan["smem"] == (1024 + stages * (nc * 128 * 128 + 64 * 128)
                            + 64 * 128 * panels)
    assert fit(nc, stages)
    assert stages == tq.INT8_SM90_MAX_STAGES or not fit(nc, stages + 1)
    return plan


@pytest.mark.parametrize("Cp", [64, 128, 192, 256, 320, 512, 1024, 1600,
                                1664, 1728, 2816])
@pytest.mark.parametrize("T,B", [(6400, 3), (1000, 1)])
def test_partial_plan_fits_the_rank_widths(Cp, T, B):
    """A tile for the rank widths around the plan's turns: two column
    groups where three of their ring stages fit beside the gated tile of
    whole 128-column panels (at Cp = 64 too, where the second sits out the
    in-act product), else one (past 1664); the ring as deep as fits, up
    to six stages."""
    _check_partial_plan(Cp, T, B)


def test_partial_plan_fits_every_rank_width():
    """Every width ``check_partial_dims`` accepts up to 2816 (a multiple of
    64) has such a tile."""
    for Cp in range(64, 2817, 64):
        _check_partial_plan(Cp, 6400, 3)


@pytest.mark.parametrize("p,stages", [(1, 4), (2, 5), (4, 5), (8, 5)])
def test_partial_plan_at_the_tp_vocode(p, stages):
    """At C = 512, T = 6400 groups, batch 1 and 3: two column groups (at p =
    8 too, where one runs within 3% of them) and the deepest ring that fits
    beside the rank's gated tile."""
    for B in (1, 3):
        plan = tq.int8_sm90_plan(512 // p, 6400, B)
        assert (plan["nc"], plan["stages"]) == (2, stages)


def test_partial_plan_raises_where_no_tile_fits():
    with pytest.raises(ValueError, match="no tile"):
        tq.int8_sm90_plan(2880)


# --- the C interface ----------------------------------------------------------


def test_partial_ctypes_signature_and_constants():
    """``t2s_wn_layer_partial_int8_sm90`` takes what ``ops/wn_block_int8.py``
    declares (13 pointers, 10 ints, the stream); the shared-memory formula
    rounds the gated tile up to whole 128-column panels, as the plan does;
    the role is a template flag of the one kernel."""
    src = SRC.read_text()
    params = re.search(r"^int t2s_wn_layer_partial_int8_sm90\(([^)]*)\)",
                       src, re.M).group(1)
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
             for p in params.split(",")]
    assert kinds == tq.LIB_SM90.signatures["t2s_wn_layer_partial_int8_sm90"]
    assert kinds == [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    assert "(size_t)BM * ((C + QK - 1) / QK * QK)" in src
    assert "enum Role { STD = 0, PART = 1, FINAL = 2, FIRST = 3 };" in src
    assert "launch<PART, 2>" in src and "launch<PART, 1>" in src
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(const["QN"]) == QN and "constexpr int QH = QN / 2;" in src
    assert tq.int8_sm90_smem_bytes(2, 64, 5) == tq.int8_sm90_smem_bytes(
        2, 128, 5)
