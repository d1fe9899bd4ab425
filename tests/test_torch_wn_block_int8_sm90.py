"""The decomposition of ``csrc/wn_block_int8_sm90.cu`` (the standard int8 WN
layer on s8 ``wgmma``), checked on the CPU.

The kernel cannot run here, so a PyTorch "tile walk" follows its blocking:
blocks of 64 rows of one utterance and ``int8_sm90_plan``'s column groups
(consumer warpgroups that take alternate chunks); gate chunks of 64 tanh +
the matching 64 sigmoid columns (N = 128); the in-act K in 128-deep
int8 stages in the kernel's order, tap 0, 1, 2 (C each, rows t-d, t, t+d
read as zero outside [0, n_valid), as TMA's out-of-bounds fill gives them,
with a row scale of 0 there) and then the conditioning (M, its last stage
zero-filled past M); each tap's s32 sums flushed at its end into an f32 sum
with the scale of its own shifted row (a multiply, then an add); the gate
in f32 quantized at 127 with round-half-even; the res/skip product in
chunks of 128 columns, the residual chunks first: x_new parked and a
running amax kept per row and column group, the skip chunks added to the
bf16 running sum; after the last chunk the groups' maxima meet, sx = max(
amax, 1e-12) / 127 and q = rint(x / sx).  The integer sums are taken in
float64, exact here.

The walk is held to the JAX package's Pallas kernel (interpret mode, as
``tests/test_int8_vocoder.py`` runs it) and to the port's plain version,
within the JAX package's own int8 bounds (``tests/test_int8_vocoder.py:
127-137``): the integer products are exact on both sides, and the f32
operations around them run in another order, which can move a value across
a round-half-even knife edge: payloads within 1 count with a mean absolute
difference under 0.01, row scales to 1e-3 relative, the bf16 skip sum to
0.09.  The launch plan and the C interface are checked too."""

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

C, M = 256, 192          # two K stages a tap; the conditioning's second half-filled
F32, F64 = torch.float32, torch.float64
GH, QN = 64, 128         # gate chunk: 64 tanh + 64 sigmoid; res/skip chunk
MEAN_COUNTS, SCALE_RTOL, SKIP_ATOL = 0.01, 1e-3, 0.09


def _rows(src, b, idx, extent):
    """src[b, idx] with rows outside [0, extent) read as zero."""
    out = torch.zeros(len(idx), src.shape[-1], dtype=src.dtype)
    ok = (idx >= 0) & (idx < extent)
    out[ok] = src[b, idx[ok]]
    return out


def _k_stages(a, w, K):
    """s32 sums of a [rows, Kx] . w [N, Kx] over 128-deep stages, the last
    zero-filled past Kx, in float64 (exact)."""
    acc = torch.zeros(a.shape[0], w.shape[0], dtype=F64)
    for k0 in range(0, a.shape[1], K):
        acc += a[:, k0:k0 + K].to(F64) @ w[:, k0:k0 + K].to(F64).T
    return acc


def tile_walk_int8(qx, sx, qspect, sspect, qw_in, sw_in, b_in, qw_cond,
                   sw_cond, b_cond, qw_rs, sw_rs, b_rs, skip_acc, d, n_valid,
                   bm=64, nc=None):
    """The standard int8 layer as the kernel computes it -> (qx_new,
    sx_new, skip).  ``bm`` rows a block (the kernel's 64; rows never mix),
    ``nc`` column groups (the plan's)."""
    B, T, Cx = qx.shape
    nc = nc or tq.int8_sm90_plan(Cx, T, B)["nc"]
    K = tq.INT8_SM90_K
    inv127 = 1.0 / 127.0
    qx_out = torch.empty_like(qx)
    sx_out = torch.empty(B, T, 1)
    skip = skip_acc.clone()
    for b in range(B):
        for t0 in range(0, T, bm):
            rows = torch.arange(t0, t0 + bm)
            taps = [_rows(qx, b, rows + (j - 1) * d, n_valid)
                    for j in range(3)] if n_valid else []
            st = [_rows(sx, b, rows + (j - 1) * d, n_valid)[:, 0]
                  for j in range(3)]
            spec = _rows(qspect, b, rows, T)
            ss = _rows(sspect, b, rows, T)[:, 0]
            gated = torch.empty(bm, Cx, dtype=torch.int8)
            for c0 in range(0, Cx, GH):
                cols = torch.cat([torch.arange(c0, c0 + GH),
                                  torch.arange(Cx + c0, Cx + c0 + GH)])
                tsum = torch.zeros(bm, 2 * GH)
                for j, a in enumerate(taps):       # flush at each tap's end
                    s32 = _k_stages(a, qw_in[j][cols], K).to(F32)
                    tsum = tsum + s32 * st[j][:, None]
                cond = _k_stages(spec, qw_cond[cols], K).to(F32)
                at = tsum * sw_in[cols] + b_in[cols]
                cq = (cond * ss[:, None]) * sw_cond[cols] + b_cond[cols]
                in_act = at + cq
                g = torch.tanh(in_act[:, :GH]) * torch.sigmoid(in_act[:, GH:])
                gated[:, c0:c0 + GH] = torch.round(g * 127.0).to(torch.int8)
            n = min(bm, T - t0)
            valid = (rows[:n] < n_valid)[:, None]
            base = qx[b, t0:t0 + n].to(F32) * st[1][:n, None]
            xn = torch.empty(n, Cx)
            amax = torch.zeros(nc, n)    # per column group
            for n0 in range(0, 2 * Cx, QN):
                grp = (n0 // QN) % nc      # the warpgroup that takes it
                s32 = _k_stages(gated, qw_rs[n0:n0 + QN], K).to(F32)[:n]
                v = s32 * (sw_rs[n0:n0 + QN] * inv127) + b_rs[n0:n0 + QN]
                if n0 < Cx:                        # residual: park, amax
                    x = torch.where(valid, base[:, n0:n0 + QN] + v, 0.0)
                    xn[:, n0:n0 + QN] = x
                    amax[grp] = torch.maximum(amax[grp], x.abs().amax(1))
                else:                              # skip, in place
                    cs = slice(n0 - Cx, n0 - Cx + QN)
                    skip[b, t0:t0 + n, cs] = (
                        skip[b, t0:t0 + n, cs].to(F32)
                        + v.to(skip.dtype).to(F32)).to(skip.dtype)
            # after the last chunk: the groups' maxima meet, then requantize
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


def _layer(seed, B, T, n_valid):
    """numpy arrays in the JAX layout ([..., K, N] weights)."""
    rng = np.random.RandomState(seed)
    k = {}
    k["qx"], k["sx"] = _quant_rows(rng, B, T, C, n_valid)
    k["qspect"], k["sspect"] = _quant_rows(rng, B, T, M, T)
    k["qw_in"], k["sw_in"] = _quant_cols(rng, 3, C, 2 * C)
    k["b_in"] = rng.randn(2 * C).astype(np.float32) * 0.1
    k["qw_cond"], k["sw_cond"] = _quant_cols(rng, M, 2 * C)
    k["b_cond"] = rng.randn(2 * C).astype(np.float32) * 0.1
    k["qw_rs"], k["sw_rs"] = _quant_cols(rng, C, 2 * C)
    k["b_rs"] = rng.randn(2 * C).astype(np.float32) * 0.1
    k["acc"] = rng.randn(B, T, C).astype(np.float32)
    return k


ORDER = ["qx", "sx", "qspect", "sspect", "qw_in", "sw_in", "b_in", "qw_cond",
         "sw_cond", "b_cond", "qw_rs", "sw_rs", "b_rs"]


def _port_args(k):
    """The port's tensors: output-major int8 weights, a bf16 skip sum."""
    t = {n: torch.from_numpy(np.array(v)) for n, v in k.items()}
    for n in ("qw_in", "qw_cond", "qw_rs"):
        t[n] = tq.to_output_major(t[n])
    return [t[n] for n in ORDER] + [t["acc"].to(torch.bfloat16)]


def _int8_close(got, want, n_rows, skip_rows):
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


# --- against the Pallas kernel (interpret mode) -----------------------------


@pytest.mark.parametrize("n_valid", [0, 511, 389])
@pytest.mark.parametrize("d", [2, 64])
def test_tile_walk_matches_pallas(n_valid, d):
    """T = 512 (one Pallas tile); d = 64 is the plan's row tile here."""
    B, T = 1, 512
    k = _layer(10 + d + n_valid, B, T, n_valid)
    want = jq.wn_layer_stream2_int8(
        *[jnp.asarray(k[n]) for n in ORDER],
        jnp.asarray(k["acc"], jnp.bfloat16), dilation=d, n_valid=n_valid)
    got = tile_walk_int8(*_port_args(k), d, n_valid)
    assert tq.int8_sm90_plan(C, T, B)["bm"] == 64
    _int8_close(_np(got), [np.asarray(w, np.float32) for w in want], T,
                n_valid)


# --- against the plain version, T and n_valid off the tile grid -------------


@pytest.mark.parametrize("n_valid", [0, 332, 200])
@pytest.mark.parametrize("d", [1, 64])
@pytest.mark.parametrize("nc", [1, 2])
def test_tile_walk_matches_plain(n_valid, d, nc):
    B, T = 2, 333
    k = _layer(20 + d + n_valid, B, T, n_valid)
    args = _port_args(k)
    want = tq.wn_layer_int8_plain(*args, d, n_valid=n_valid)
    got = tile_walk_int8(*args, d, n_valid, nc=nc)
    _int8_close(_np(got), _np(want), T, max(n_valid, 1))
    # rows past n_valid: zero payload with the floor scale
    assert (got[0][:, n_valid:] == 0).all()
    assert torch.equal(got[1][:, n_valid:], want[1][:, n_valid:])


def test_tile_walk_is_independent_of_the_tile():
    """Rows never mix and the column groups' maxima meet exactly: 64- and
    128-row blocks, one or two column groups, give the same layer."""
    B, T, n_valid, d = 1, 333, 300, 64
    args = _port_args(_layer(30, B, T, n_valid))
    want = tile_walk_int8(*args, d, n_valid, bm=64, nc=1)
    for bm, nc in ((64, 2), (128, 1), (128, 2)):
        got = tile_walk_int8(*args, d, n_valid, bm=bm, nc=nc)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_walk_equals_the_plain_version_bit_for_bit():
    """Each tap's integer sums are scaled by the scale of its own shifted
    row and added in the plain version's order (tap 0, 1, 2; a multiply,
    then an add), and so is everything after them: with row scales spread
    over orders of magnitude the walk equals the plain version bit for
    bit."""
    B, T, n_valid, d = 1, 200, 190, 3
    k = _layer(40, B, T, n_valid)
    k["sx"] = k["sx"] * np.exp(np.random.RandomState(1).randn(B, T, 1) * 2
                               ).astype(np.float32)
    args = _port_args(k)
    got = tile_walk_int8(*args, d, n_valid)
    want = tq.wn_layer_int8_plain(*args, d, n_valid=n_valid)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# --- the host-side launch plan ----------------------------------------------


@pytest.mark.parametrize("width", range(128, 2817, 128))
@pytest.mark.parametrize("T,B", [(6400, 3), (1000, 1)])
def test_int8_sm90_plan_fits_shared_memory(width, T, B):
    """Every width the first design took (C % 128 == 0 up to 2816) has a
    tile: 64-row blocks, two column groups where three of their ring stages
    fit, else one; the ring as deep as fits, up to six stages."""
    plan = tq.int8_sm90_plan(width, T, B)
    nc, stages = plan["nc"], plan["stages"]

    def fit(nc, n):
        return (tq.int8_sm90_smem_bytes(nc, width, n)
                + tq.INT8_SM90_STATIC_SMEM <= twb.SM90_SMEM_LIMIT)

    assert nc == (2 if fit(2, 3) else 1)
    assert plan["bm"] == 64 and plan["threads"] == 128 * (nc + 1)
    assert 2 <= stages <= tq.INT8_SM90_MAX_STAGES
    assert plan["grid"] == (-(-T // 64), B)
    stage = nc * 128 * 128 + 64 * 128
    assert plan["smem"] == 1024 + stages * stage + 64 * width
    assert fit(nc, stages)
    assert stages == tq.INT8_SM90_MAX_STAGES or not fit(nc, stages + 1)


@pytest.mark.parametrize("width,nc,stages", [
    (512, 2, 4),     # the reference width
    (640, 2, 4),
    (1664, 2, 3),    # the widest with three stages of two column groups
    (1792, 1, 4),
    (2816, 1, 2),    # the first design's widest
])
def test_int8_sm90_plan_picks_the_tile_from_the_width(width, nc, stages):
    for B in (1, 3):
        plan = tq.int8_sm90_plan(width, 6400, B)
        assert (plan["nc"], plan["stages"]) == (nc, stages)


def test_int8_sm90_plan_raises_where_no_tile_fits():
    with pytest.raises(ValueError, match="no tile"):
        tq.int8_sm90_plan(2944)


def test_ctypes_signatures_match_the_c_interface():
    """Every exported function's argument list in
    ``csrc/wn_block_int8_sm90.cu`` (pointers, ints, the stream) is what
    ``ops/wn_block_int8.py`` declares to ctypes."""
    src = (Path(tq.__file__).parent.parent / "csrc"
           / "wn_block_int8_sm90.cu").read_text()
    decls = dict(re.findall(r"^(?:int|size_t) (t2s_\w+)\(([^)]*)\)", src,
                            re.M))
    assert set(decls) == set(tq.LIB_SM90.signatures)
    for name, params in decls.items():
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in params.split(",")]
        assert kinds == tq.LIB_SM90.signatures[name], name


def test_kernel_constants_are_the_plans():
    """The tile constants the plan restates are the kernel's."""
    src = (Path(tq.__file__).parent.parent / "csrc"
           / "wn_block_int8_sm90.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(const["QK"]) == tq.INT8_SM90_K and int(const["BM"]) == 64
    assert int(const["MAX_STAGES"]) == tq.INT8_SM90_MAX_STAGES
    assert int(const["QN"]) == QN and int(const["QN"]) // 2 == GH
    # the two mbarrier arrays of MAX_STAGES 8-byte words and two column
    # groups' maxima of 64 rows
    assert (2 * 8 * tq.INT8_SM90_MAX_STAGES + 4 * 2 * 64
            == tq.INT8_SM90_STATIC_SMEM)
    assert "xamax[NC == 2 ? 128 : 1]" in src
