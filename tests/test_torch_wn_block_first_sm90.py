"""The ``FIRST`` role of ``csrc/wn_block_sm90.cu`` (the bf16 first WN layer
of a flow, and with ``DCOND`` the composed-conditioning one), checked on
the CPU.

The kernel cannot run here, so a PyTorch "tile walk" follows its blocking:
blocks of ``sm90_plan(role="first")``'s rows of one utterance; the block's
tap tile staged once: x0[t + (j - 1) d, i] at column j n_half + i (zero
outside [0, n_valid) and past T); gate-pair chunks of 128 tanh + 128
sigmoid columns in order.  Each chunk's in-act product starts with the tap
stage, the tap tile times wp's rows [3 n_half, 2C] (one K = 16 product on
the tensor cores), then runs the conditioning's stages: spect's rows (zero
past T) times w_cond over the plan's 32- or 64-deep stages (the last
zero-filled past M), then b_all + b_cond; with ``DCOND`` the tap stage
alone, then b_all, then the chunk's columns of slice 0 of ``cond_all``
(rows t < T) widened to f32.  Then the edge take-back (b_edge[0] where t <
d, b_edge[1] where t >= n_valid - d); the gate in f32 rounded to the input
dtype.  The res/skip product in chunks of 256 columns: the residual base
x0[t] start_k + start_b (n_half FMAs, then the bias) plus rs, zero at rows
>= n_valid; the skip written as the rounded rs (no running sum).  An FMA
is emulated in float64 (the product of two f32 values is exact there).

The walks are held to the JAX package's Pallas kernels
``wn_layer_stream2_first`` and ``wn_layer_stream2_first_dcond``
(interpret mode, as ``tests/test_torch_wn_block.py`` and
``tests/test_torch_wn_block_dcond.py`` run them) and to the port's plain
versions, and the launch plan of the role is checked at every width the
role's first CUDA design took (its shared-memory rule is restated
below).

Tolerances, those of ``tests/test_torch_wn_block_sm90.py``.  Against
Pallas in float32: the same f32 products summed in another order, values
of order 1: 2e-5 absolute.  Against the plain versions in bf16: both round
the gated activation and the outputs to bf16, and f32 sums in another
order can land on the other side of a bf16 rounding boundary: four bf16
steps (2^-8 of the value) at the output's peak, relative L2 under 5e-3
(the bounds the kernel is held to on the card)."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text2speech_tpu.ops.pallas import wn_block as jwb
from text2speech_tpu.ops.pallas import wn_block_dcond as jwd
from text2speech_tpu_torch.ops import wn_block as twb
from text2speech_tpu_torch.ops import wn_block_dcond as twd

torch.set_num_threads(1)

C, M, L = 128, 96, 3
F32, F64 = torch.float32, torch.float64
ATOL = 2e-5
BF16_MAX_ABS_STEPS = 4 * 2.0 ** -8
BF16_REL_L2 = 5e-3
GN, MAX_NHALF = 256, 4
SRC = Path(twb.__file__).parent.parent / "csrc" / "wn_block_sm90.cu"


def _rows(src, b, idx, extent):
    """src[b, idx] with rows outside [0, extent) read as zero."""
    out = torch.zeros(len(idx), src.shape[-1], dtype=src.dtype)
    ok = (idx >= 0) & (idx < extent)
    out[ok] = src[b, idx[ok]]
    return out


def _fma(x, w, acc):
    """fmaf(x, w, acc) elementwise: one rounding of the exact result."""
    return (x.to(F64) * w.to(F64) + acc.to(F64)).to(F32)


def _tap_tile(x0, b, rows, d, n_valid):
    """The block's tap tile [bm, 3 n_half] f32: x0[t + (j - 1) d, i] at
    column j n_half + i, zero outside [0, n_valid) and past T."""
    T = x0.shape[1]
    xa = torch.cat([_rows(x0, b, rows + s, n_valid).to(F32)
                    for s in (-d, 0, d)], -1)
    return torch.where((rows < T)[:, None], xa, 0.0)


def _base(x0, b, rows, n_valid, start_k, start_b):
    """The residual base x0[t] start_k + start_b [bm, C] (x0 zero at rows
    >= n_valid, whose residual is masked): n_half FMAs, channels past
    n_half repeating the last against an x0 of 0, then the bias."""
    nh = start_k.shape[0]
    x = torch.zeros(len(rows), MAX_NHALF)
    x[:, :nh] = _rows(x0, b, rows, n_valid).to(F32)
    s = torch.zeros(len(rows), start_k.shape[1])
    for i in range(MAX_NHALF):
        s = _fma(x[:, i:i + 1], start_k[min(i, nh - 1)][None], s)
    return s + start_b.to(F32)


def tile_walk_first(x0, cond_src, start_k, start_b, wp, b_all, b_edge,
                    w_cond, b_cond, w_rs, b_rs, d, n_valid):
    """The first layer as the kernel computes it -> (x_out, skip).  With
    ``w_cond`` None, ``cond_src`` is ``cond_all`` (DCOND, slice 0), else
    ``spect``."""
    B, T, nh = x0.shape
    Cx = start_k.shape[1]
    w_taps = wp.reshape(3 * nh, 2 * Cx).to(F32)
    dt = cond_src.dtype
    plan = twb.sm90_plan(Cx, T, B, role="first")
    bm, bk = plan["bm"], plan["bk"]
    x_out = torch.zeros(B, T, Cx, dtype=dt)
    skip = torch.zeros(B, T, Cx, dtype=dt)
    for b in range(B):
        for t0 in range(0, T, bm):
            rows = torch.arange(t0, t0 + bm)
            xa = _tap_tile(x0, b, rows, d, n_valid)
            left = (rows < d)[:, None]
            right = (rows >= n_valid - d)[:, None]
            src = _rows(cond_src, b, rows, T).to(F32)
            gated = torch.empty(bm, Cx, dtype=dt)
            for c0 in range(0, Cx, GN // 2):
                cols = torch.cat([torch.arange(c0, c0 + GN // 2),
                                  torch.arange(Cx + c0, Cx + c0 + GN // 2)])
                acc = xa @ w_taps[:, cols]            # the tap stage
                if w_cond is None:
                    in_act = (acc + b_all[cols]) + src[:, cols]
                else:
                    for k0 in range(0, src.shape[1], bk):
                        acc += (src[:, k0:k0 + bk]
                                @ w_cond[k0:k0 + bk][:, cols].to(F32))
                    in_act = acc + (b_all + b_cond.to(F32))[cols]
                in_act = in_act - torch.where(left, b_edge[0, cols], 0.0)
                in_act = in_act - torch.where(right, b_edge[1, cols], 0.0)
                gated[:, c0:c0 + GN // 2] = (
                    torch.tanh(in_act[:, :GN // 2])
                    * torch.sigmoid(in_act[:, GN // 2:])).to(dt)
            g = gated.to(F32)
            base = _base(x0, b, rows, n_valid, start_k, start_b)
            n = min(bm, T - t0)
            valid = (rows[:n] < n_valid)[:, None]
            for n0 in range(0, 2 * Cx, GN):
                acc = torch.zeros(bm, GN)
                for k0 in range(0, Cx, bk):
                    acc += g[:, k0:k0 + bk] @ w_rs[k0:k0 + bk,
                                                   n0:n0 + GN].to(F32)
                v = (acc + b_rs[n0:n0 + GN].to(F32))[:n]
                for j in range(GN):
                    col = n0 + j
                    if col < Cx:
                        x_out[b, t0:t0 + n, col] = torch.where(
                            valid[:, 0], (base[:n, col] + v[:, j]).to(dt), 0)
                    else:
                        skip[b, t0:t0 + n, col - Cx] = v[:, j].to(dt)
    return x_out, skip


def _inputs(seed, B, T, n_valid, n_half, Cx=C, dtype=F32):
    """Seeded weights and activations; the fold done once, as the
    vocoder does per checkpoint."""
    rng = np.random.RandomState(seed)
    mask = (np.arange(T) < n_valid)[None, :, None]

    def rn(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    k = {
        "x0": rn(B, T, n_half, scale=0.5) * mask,
        "spect": rn(B, T, M, scale=0.5),
        "cond_all": rn(B, T, 2 * Cx * L, scale=0.5),
        "start_k": rn(n_half, Cx, scale=0.4),
        "start_b": rn(Cx, scale=0.1),
        "w_in": rn(3, Cx, 2 * Cx, scale=(3 * Cx) ** -0.5),
        "b_in": rn(2 * Cx, scale=0.1),
        "w_cond": rn(M, 2 * Cx, scale=M ** -0.5),
        "b_cond": rn(2 * Cx, scale=0.1),
        "w_rs": rn(Cx, 2 * Cx, scale=Cx ** -0.5),
        "b_rs": rn(2 * Cx, scale=0.1),
    }
    t = {n: torch.from_numpy(v) for n, v in k.items()}
    for n in ("x0", "spect", "cond_all", "start_k", "w_in", "w_cond",
              "w_rs"):
        t[n] = t[n].to(dtype)
    wp, b_all, b_edge = twb.fold_first_taps(t["start_k"], t["start_b"],
                                            t["w_in"], t["b_in"])
    t.update(wp=wp, b_all=b_all, b_edge=b_edge)
    return k, t


def _args(t, dcond: bool):
    """The wrapper's arguments (without the dilation) of row 1 or 10."""
    head = (t["start_k"], t["start_b"], t["wp"], t["b_all"], t["b_edge"])
    if dcond:
        return (t["x0"], t["cond_all"], *head, t["w_rs"], t["b_rs"])
    return (t["x0"], t["spect"], *head, t["w_cond"], t["b_cond"], t["w_rs"],
            t["b_rs"])


def _walk(t, dcond: bool, d, n_valid):
    if dcond:
        return tile_walk_first(t["x0"], t["cond_all"], *_args(t, True)[2:7],
                               None, None, t["w_rs"], t["b_rs"], d, n_valid)
    return tile_walk_first(*_args(t, False), d, n_valid)


def _plain(t, dcond: bool, d, n_valid):
    if dcond:
        return twd.wn_layer_first_dcond_plain(*_args(t, True), d,
                                              n_valid=n_valid)
    return twb.wn_layer_first_plain(*_args(t, False), d, n_valid=n_valid)


def _bf16_close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    peak = max(want.abs().max().item(), 1.0)
    assert (got - want).abs().max().item() <= BF16_MAX_ABS_STEPS * peak
    if want.norm() > 0:
        assert ((got - want).norm() / want.norm()).item() <= BF16_REL_L2


# --- against the Pallas kernels (interpret mode), float32 -------------------


@pytest.mark.parametrize("dcond", [False, True], ids=["row1", "row10"])
@pytest.mark.parametrize("n_half,n_valid,d", [
    (4, 512, 1),      # all valid
    (2, 389, 64),     # n_valid off the tile grid
    (3, 40, 130),     # n_valid < d: every row takes both edges back
])
def test_first_tile_walk_matches_pallas(dcond, n_half, n_valid, d):
    T = 512
    k, t = _inputs(10 + n_half + d, 1, T, n_valid, n_half)
    if dcond:
        names = ["x0", "cond_all", "start_k", "start_b", "w_in", "b_in",
                 "w_rs", "b_rs"]
        want_x, want_s = jwd.wn_layer_stream2_first_dcond(
            *[jnp.asarray(k[n]) for n in names], d, interpret=True,
            n_valid=n_valid)
    else:
        names = ["x0", "spect", "start_k", "start_b", "w_in", "b_in",
                 "w_cond", "b_cond", "w_rs", "b_rs"]
        want_x, want_s = jwb.wn_layer_stream2_first(
            *[jnp.asarray(k[n]) for n in names], d, interpret=True,
            n_valid=n_valid)
    got_x, got_s = _walk(t, dcond, d, n_valid)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=ATOL)
    assert not got_x[:, n_valid:].any()
    # skip rows past n_valid: the path cuts them (the Pallas kernel's
    # last tile leaves them as its own)
    np.testing.assert_allclose(got_s.numpy()[:, :n_valid],
                               np.asarray(want_s)[:, :n_valid], atol=ATOL)


# --- against the plain versions, bf16, T and n_valid off the tile grid ------


@pytest.mark.parametrize("dcond", [False, True], ids=["row1", "row10"])
@pytest.mark.parametrize("n_valid,d", [
    (333, 1), (300, 64), (129, 130), (50, 64), (0, 1)])
@pytest.mark.parametrize("n_half", [2, 3, 4])
def test_first_tile_walk_matches_plain_bf16(dcond, n_valid, d, n_half):
    T = 333
    _, t = _inputs(30 + d + n_valid + n_half, 2, T, n_valid, n_half,
                   dtype=torch.bfloat16)
    want_x, want_s = _plain(t, dcond, d, n_valid)
    got_x, got_s = _walk(t, dcond, d, n_valid)
    assert got_x.dtype == got_s.dtype == torch.bfloat16
    if n_valid:
        _bf16_close(got_x, want_x)
    assert not got_x[:, n_valid:].any() and not want_x[:, n_valid:].any()
    # the skip on every row: rows past n_valid are gated alike
    _bf16_close(got_s, want_s)


def test_first_tile_walk_two_chunks_matches_plain_bf16():
    """At C = 256 the gate runs two chunks and the res/skip product two
    chunks of 256, the first all residual, the second all skip."""
    T, n_valid, d = 300, 280, 8
    _, t = _inputs(70, 1, T, n_valid, 4, Cx=256, dtype=torch.bfloat16)
    for dcond in (False, True):
        want = _plain(t, dcond, d, n_valid)
        got = _walk(t, dcond, d, n_valid)
        for g, w in zip(got, want):
            _bf16_close(g, w)


def test_first_walk_takes_the_edge_bias_back_where_the_plain_version_does():
    """With zero activations and conditioning, the gate's input is b_all
    minus the edge rows' b_edge: the walk's hidden state is then a function
    of the row's edge class alone (left, middle, right)."""
    T, n_valid, d = 200, 150, 16
    _, t = _inputs(80, 1, T, n_valid, 3)
    for n in ("x0", "spect", "cond_all"):
        t[n] = torch.zeros_like(t[n])
    for dcond in (False, True):
        got_x, got_s = _walk(t, dcond, d, n_valid)
        want_x, want_s = _plain(t, dcond, d, n_valid)
        np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), atol=ATOL)
        s = got_s[0]
        assert torch.equal(s[0], s[d - 1]) and not torch.equal(s[0], s[d])
        assert torch.equal(s[d], s[n_valid - d - 1])
        assert torch.equal(s[n_valid - d], s[T - 1])
        assert not torch.equal(s[d], s[n_valid - d])


def test_first_walk_is_independent_of_the_row_tile(monkeypatch):
    """Rows never mix: the 64-row tile gives the 128-row tile's result,
    whatever the stage depth."""
    T, n_valid, d = 333, 300, 64
    _, t = _inputs(50, 1, T, n_valid, 4)
    want = [_walk(t, dcond, d, n_valid) for dcond in (False, True)]
    real = twb.sm90_plan
    for bm, bk in ((64, 64), (128, 32)):
        monkeypatch.setattr(
            twb, "sm90_plan",
            lambda *a, **kw: {**real(*a, **kw), "bm": bm, "nwg": bm // 64,
                              "bk": bk})
        for dcond, w in zip((False, True), want):
            for g, ww in zip(_walk(t, dcond, d, n_valid), w):
                torch.testing.assert_close(g, ww, atol=1e-6, rtol=0)


# --- the host-side launch plan ----------------------------------------------


def _first_design_smem(C: int) -> int:
    """Shared memory of the first CUDA design's FIRST block: three cp.async stages of a [64, 40] and a [32, 136] bf16
    tile, the gated tile [64, C + 8] and the tap tables (768 + 1536 bf16
    values)."""
    return (3 * (64 * 40 + 32 * 136) + 64 * (C + 8) + 768 + 1536) * 2


FIRST_DESIGN_WIDTHS = [c for c in range(128, 4097, 128)
                       if _first_design_smem(c) <= twb.SM90_SMEM_LIMIT]


def test_first_plan_takes_every_width_the_first_design_took():
    """Every width the first design took (C % 128 == 0 up to 1408) has a
    tile of the FIRST role: the standard layer's rule with the tap stage's
    [bm, bk] bf16 activation tile after the gated tile, at batch 1 and
    3."""
    assert FIRST_DESIGN_WIDTHS[-1] == 1408
    for width in FIRST_DESIGN_WIDTHS:
        for T, B in ((6400, 3), (6400, 1), (1000, 3)):
            plan = twb.sm90_plan(width, T, B, role="first")
            std = twb.sm90_plan(width, T, B)
            bm, bk, stages = plan["bm"], plan["bk"], plan["stages"]
            assert bm == std["bm"] and plan["nwg"] * 64 == bm
            assert plan["grid"] == std["grid"]
            assert plan["smem"] == (1024 + stages * (bk * GN * 2 + bm * bk * 2)
                                    + bm * width * 2 + bm * bk * 2)
            assert plan["smem"] == twb.sm90_smem_bytes(
                plan["nwg"], bk, width, stages, role="first")

            def fit(k, n):
                return (twb.sm90_smem_bytes(plan["nwg"], k, width, n,
                                            role="first")
                        + twb.SM90_STATIC_SMEM <= twb.SM90_SMEM_LIMIT)

            assert 2 <= stages <= twb.SM90_MAX_STAGES and fit(bk, stages)
            assert stages == twb.SM90_MAX_STAGES or not fit(bk, stages + 1)
            assert (bk == 64) == fit(64, 3)
    with pytest.raises(ValueError, match="no tile"):
        twb.sm90_plan(1536, role="first")
    with pytest.raises(ValueError, match="no role"):
        twb.sm90_plan(512, role="first_dcond")


@pytest.mark.parametrize("T,B,bm,bk,stages", [
    (6400, 1, 64, 64, 3),    # one utterance: the tap tile costs a stage
    (6400, 3, 128, 32, 3),   # the served batch: so it does here
])
def test_first_plan_at_the_vocode(T, B, bm, bk, stages):
    plan = twb.sm90_plan(512, T, B, role="first")
    assert (plan["bm"], plan["bk"], plan["stages"]) == (bm, bk, stages)


def test_first_role_constants_and_c_interface():
    """The kernel's role code and tap stage are what the plan and the walk
    restate; the two new entries take what ``ops/wn_block.py`` declares (13
    pointers and 10 ints, 11 and 11, each with the stream)."""
    src = SRC.read_text()
    assert ("enum Role { STD = 0, FINAL = 1, PART = 2, FIRST = 3, "
            "PART_FIRST = 4 };") in src
    assert twb.SM90_ROLES == {"std": 0, "final": 1, "part": 2, "first": 3,
                              "part_first": 4}
    const = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert const["MAX_NHALF"] == "4"
    assert int(const["TAP_ROWS"]) == 16 >= 3 * 4     # one k16 step
    assert "return role == FIRST || role == PART_FIRST;" in src
    assert "(tap_stage_role(role) ? (size_t)nwg * 64 * bk * 2 : 0)" in src
    decls = dict(re.findall(r"^(?:int|size_t) (t2s_\w+)\(([^)]*)\)", src,
                            re.M))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, want in (("t2s_wn_layer_first_sm90", [P] * 13 + [I] * 10),
                       ("t2s_wn_layer_first_dcond_sm90",
                        [P] * 11 + [I] * 11),
                       ("t2s_wn_sm90_smem_bytes", [I] * 5)):
        kinds = [P if "*" in p else I for p in decls[name].split(",")]
        assert kinds == twb.LIB_SM90.signatures[name]
        assert kinds[:len(want)] == want
