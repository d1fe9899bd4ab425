"""The composed-conditioning (``dcond``) final layer's Hopper design in
``csrc/wn_block_sm90.cu`` (its ``FINAL`` role with ``DCOND``), checked on
the CPU.

The kernel cannot run here, so a PyTorch "tile walk" follows its blocking:
blocks of ``sm90_plan``'s rows of one utterance; an in-act operand of
K = 3C only (no spect rows), the three taps read at rows t-d, t, t+d (zero
outside [0, n_valid), as TMA's out-of-bounds fill gives them), summed in
f32 over the plan's 32- or 64-deep stages in the kernel's K order, for
gate-pair chunks of 128 tanh + 128 sigmoid columns; n_valid = 0 leaves no
stage at all, so the gate sees b_in and the conditioning alone.  Then
b_in, then the layer's slice of ``cond_all`` (rows t < T, widened to f32)
before the gate (``DCOND``'s gate), the gated tile rounded to the input
dtype; then ``FINAL``'s epilogue on every row t < T: the gated tile times
the folded w_eff plus the running skip sum (read, never written) times
w_end plus b_eff, in f32.  The walk is held to the JAX package's Pallas
kernel ``wn_layer_stream2_final_dcond`` (interpret mode, ``fold_rs=True``)
and to the port's plain version.

Tolerances, those of ``tests/test_torch_wn_block_sm90.py``'s final layer.
Against Pallas in float32: the same f32 products over K = 3C = 384 terms
summed in another order, values of order 1: 2e-5 absolute on the valid
rows.  Against the plain version in bf16: both round the gated activation
to bf16, and f32 sums in another order can land on the other side of a
bf16 rounding boundary: four bf16 steps (2^-8 of the value) at the
output's peak, relative L2 under 5e-3."""

import ctypes
import re
from pathlib import Path

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
SRC = Path(twb.__file__).parent.parent / "csrc" / "wn_block_sm90.cu"


def _rows(src, b, idx, extent):
    """src[b, idx] with rows outside [0, extent) read as zero."""
    out = torch.zeros(len(idx), src.shape[-1], dtype=src.dtype)
    ok = (idx >= 0) & (idx < extent)
    out[ok] = src[b, idx[ok]]
    return out


def tile_walk_final_dcond(x, cond_all, li, w_in, b_in, w_eff, skip_acc,
                          w_end, b_eff, d, n_valid, bm=None, bk=None):
    """The dcond final layer as the kernel computes it -> [B, T, E] f32.
    ``bm``, ``bk``: the plan's row tile and stage depth unless given."""
    B, T, Cx = x.shape
    plan = twb.sm90_plan(Cx, T, B)
    bm, bk = bm or plan["bm"], bk or plan["bk"]
    k = 0 if n_valid == 0 else 3 * Cx          # no K stage when nothing valid
    w_k = w_in.reshape(3 * Cx, 2 * Cx).to(F32)
    out = torch.empty(B, T, w_end.shape[1])
    for b in range(B):
        for t0 in range(0, T, bm):
            rows = torch.arange(t0, t0 + bm)
            a_op = torch.zeros(bm, 0) if k == 0 else torch.cat(
                [_rows(x, b, rows + s, n_valid) for s in (-d, 0, d)],
                -1).to(F32)
            cond = _rows(cond_all[..., 2 * Cx * li: 2 * Cx * (li + 1)], b,
                         rows, T).to(F32)
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
            n_rows = min(bm, T - t0)
            s1 = gated[:n_rows].to(F32) @ w_eff.to(F32)
            s2 = skip_acc[b, t0:t0 + n_rows].to(F32) @ w_end.to(F32)
            out[b, t0:t0 + n_rows] = s1 + s2 + b_eff.to(F32)
    return out


def _inputs(seed, B, T, n_valid, E, dtype=F32):
    """numpy arrays of one final layer (JAX's arguments) and the port's
    tensors with the end projection folded."""
    rng = np.random.RandomState(seed)
    mask = (np.arange(T) < n_valid)[None, :, None]

    def rn(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    k = {
        "x": rn(B, T, C, scale=0.3) * mask,
        "cond_all": rn(B, T, 2 * C * L, scale=0.3),
        "w_in": rn(3, C, 2 * C, scale=(3 * C) ** -0.5),
        "b_in": rn(2 * C, scale=0.1),
        "w_rs": rn(C, C, scale=C ** -0.5),
        "b_rs": rn(C, scale=0.1),
        "acc": rn(B, T, C, scale=0.3) * mask,
        "w_end": rn(C, E, scale=C ** -0.5),
        "b_end": rn(E, scale=0.1),
    }
    t = {n: torch.from_numpy(v) for n, v in k.items()}
    for n in ("x", "cond_all", "w_in", "w_rs", "acc", "w_end"):
        t[n] = t[n].to(dtype)
    t["w_eff"], t["b_eff"] = twb.fold_end(t["w_rs"], t["b_rs"], t["w_end"],
                                          t["b_end"])
    return k, t


def _args(t, li, d):
    return (t["x"], t["cond_all"], li, t["w_in"], t["b_in"], t["w_eff"],
            t["acc"], t["w_end"], t["b_eff"], d)


def _bf16_close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    peak = max(want.abs().max().item(), 1.0)
    assert (got - want).abs().max().item() <= BF16_MAX_ABS_STEPS * peak
    assert ((got - want).norm() / want.norm()).item() <= BF16_REL_L2


# --- against the Pallas kernel (interpret mode), float32 --------------------


@pytest.mark.parametrize("n_valid,d,E,li", [
    (389, 1, 8, 1),          # n_valid off the tile grid
    (511, 130, 1, L - 1),    # n_valid = T - 1, a halo past a 128-row tile
    (0, 64, 8, 2),           # nothing valid: no K stage at all
    (512, 64, 1, 0),
])
def test_final_dcond_walk_matches_pallas(n_valid, d, E, li):
    T = 512
    k, t = _inputs(10 + d + n_valid + E, 1, T, n_valid, E)
    names = ["w_in", "b_in", "w_rs", "b_rs", "acc", "w_end", "b_end"]
    want = jwd.wn_layer_stream2_final_dcond(
        jnp.asarray(k["x"]), jnp.asarray(k["cond_all"]), li,
        *[jnp.asarray(k[n]) for n in names], d, interpret=True,
        n_valid=n_valid)
    got = tile_walk_final_dcond(*_args(t, li, d), n_valid)
    rows = max(n_valid, 1)
    np.testing.assert_allclose(got.numpy()[:, :rows],
                               np.asarray(want)[:, :rows], atol=ATOL)


# --- against the plain version, bf16, T and n_valid off the tile grid -------


@pytest.mark.parametrize("n_valid", [333, 332, 200, 129, 0])
@pytest.mark.parametrize("E,d,li", [(1, 1, 1), (8, 130, L - 1)])
def test_final_dcond_walk_matches_plain_bf16(n_valid, E, d, li):
    """Every row t < T: rows past n_valid are gated and projected alike."""
    T = 333
    _, t = _inputs(30 + d + n_valid + E, 2, T, n_valid, E,
                   dtype=torch.bfloat16)
    want = twd.wn_layer_final_dcond_plain(*_args(t, li, d), n_valid=n_valid)
    got = tile_walk_final_dcond(*_args(t, li, d), n_valid)
    assert got.shape == want.shape == (2, T, E) and got.dtype == F32
    _bf16_close(got, want)


def test_final_dcond_with_nothing_valid_gates_bias_and_cond_alone():
    """n_valid = 0 leaves no K stage: the gate sees b_in + the layer's
    conditioning alone, and FINAL's epilogue adds the skip term."""
    T, li, E = 333, 2, 8
    _, t = _inputs(60, 1, T, 0, E)
    got = tile_walk_final_dcond(*_args(t, li, 64), 0)
    cond = t["cond_all"][..., 2 * C * li: 2 * C * (li + 1)]
    in_act = t["b_in"] + cond
    g = torch.tanh(in_act[..., :C]) * torch.sigmoid(in_act[..., C:])
    want = g @ t["w_eff"] + t["acc"] @ t["w_end"] + t["b_eff"]
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_final_dcond_reads_its_own_slice_of_cond_all():
    """A nonzero ``cond_index`` reads columns [2C li, 2C (li + 1)): junk in
    every other slice changes nothing."""
    T, n_valid, d, li = 333, 300, 8, 1
    _, t = _inputs(70, 1, T, n_valid, 8)
    want = tile_walk_final_dcond(*_args(t, li, d), n_valid)
    junk = dict(t)
    junk["cond_all"] = t["cond_all"].clone()
    junk["cond_all"][..., : 2 * C * li] = 7.0
    junk["cond_all"][..., 2 * C * (li + 1):] = -7.0
    assert torch.equal(tile_walk_final_dcond(*_args(junk, li, d), n_valid),
                       want)
    np.testing.assert_allclose(
        want.numpy(),
        twd.wn_layer_final_dcond_plain(*_args(junk, li, d),
                                       n_valid=n_valid).numpy(), atol=ATOL)


@pytest.mark.parametrize("bm,bk", [(64, 64), (128, 32), (128, 64)])
def test_final_dcond_walk_is_independent_of_the_tile(bm, bk):
    """Rows never mix: every row tile and stage depth the plan can pick
    give the same layer, up to the f32 order of the in-act sums."""
    T, n_valid, d, li = 333, 300, 64, 2
    _, t = _inputs(80, 1, T, n_valid, 8)
    want = tile_walk_final_dcond(*_args(t, li, d), n_valid, bm=64, bk=32)
    got = tile_walk_final_dcond(*_args(t, li, d), n_valid, bm=bm, bk=bk)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


# --- the plan and the C interface -------------------------------------------


@pytest.mark.parametrize("T,B,bm,bk,stages", [
    (6400, 1, 64, 64, 4),    # the composed vocode at batch 1: 100 blocks
    (6400, 3, 128, 32, 4),   # batch 3: 150 blocks of 128 rows
])
def test_sm90_plan_at_the_composed_vocode(T, B, bm, bk, stages):
    """The final layer launches with the standard layer's plan: C = 512
    splits into whole K stages per tap, the ring fits beside the gated
    tile."""
    plan = twb.sm90_plan(512, T, B)
    assert (plan["bm"], plan["bk"], plan["stages"]) == (bm, bk, stages)
    assert 512 % plan["bk"] == 0
    assert plan["smem"] + twb.SM90_STATIC_SMEM <= twb.SM90_SMEM_LIMIT


def test_final_dcond_sm90_ctypes_signature():
    """``t2s_wn_layer_final_dcond_sm90`` takes what ``ops/wn_block.py``
    declares (9 pointers, 11 ints, the stream), launches the FINAL role
    with DCOND, maps the taps only (no spect or w_cond map) and hands
    skip_acc to the kernel read-only."""
    src = SRC.read_text()
    m = re.search(r"^int t2s_wn_layer_final_dcond_sm90\(([^)]*)\) \{(.*?)"
                  r"^\}", src, re.M | re.S)
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
             for p in m.group(1).split(",")]
    assert kinds == twb.LIB_SM90.signatures["t2s_wn_layer_final_dcond_sm90"]
    assert kinds == [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    assert "const void* skip_acc" in m.group(1)
    body = m.group(2)
    assert "dispatch<FINAL, true>" in body and "encode_taps" in body
    assert "encode_inact" not in body and "encode_wrs" not in body
