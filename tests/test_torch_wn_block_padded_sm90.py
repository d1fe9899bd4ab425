"""The STREAM and STREAM_FINAL roles of ``csrc/wn_block_padded_sm90.cu``
(rows 14 and 15 of the padded oracle family, redesigned for Hopper),
checked on the CPU.

The kernel cannot run here, so a PyTorch "tile walk" follows its blocking:
tiles of BM = 64 rows (``PADDED_SM90_BM``) of one utterance on the
``pad_tiles`` layout; per gate chunk (64 tanh columns c0.. and their 64
sigmoid partners C + c0..: N = 128) and per 64-channel K chunk of x, the
window of rows [t0 - d, t0 + BM + d) staged once (one TMA box, or two of
``padded_window``'s rows where BM + 2d > 256; rows past Tp read TMA's zero
fill) and read at row offsets 0, d and 2d against the three taps' weights;
then the conditioning's stages (spect rows [t0, t0 + BM) and w_cond, 64
deep, zero past M); b_in + b_cond and the gate in f32 (the sigmoid as 0.5
tanh(x / 2) + 0.5) rounded to the input dtype into the gated tile [BM, C];
the res/skip product in chunks of 128 columns over 64-deep stages; STREAM's
epilogue (the residual, zero at real rows >= n_valid; the skip sum
skip + round(rs), rs whole when rs_out == C; the hidden state passed
through, masked, when rs_out == C) or STREAM_FINAL's (round(skip + rs),
then its rank-E projection and b_end).  The pad tiles of every output are
zero.

The walk is held to the JAX package's Pallas kernels ``wn_layer_stream`` /
``wn_layer_stream_final`` (interpret mode, as
``tests/test_torch_wn_block_padded.py`` runs them; each package pads with
its own tiles and the two are compared on the T real rows) and to the
port's plain versions in bf16.  The launch plan, the C interface, the
role constants and the rule that the oracle shares no code with the
serving kernel are checked against the sources.

Tolerances, those of the other walk files.  Against Pallas in float32: the
same f32 products summed in another order, values of order 1: 2e-5
absolute.  Against the plain versions in bf16: both round the gated
activation (and the outputs) to bf16, and f32 sums in another order can
land on the other side of a bf16 rounding boundary: four bf16 steps (2^-8
of the value) at the output's peak, relative L2 under 5e-3 (the bounds the
kernel is held to on the card)."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text2speech_tpu.ops.pallas import wn_block_padded as jwp
from text2speech_tpu_torch.ops import wn_block_padded as twp

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
BT = twp.BT_PAD
KC, GW = 64, 64
ATOL = 2e-5
BF16_MAX_ABS_STEPS = 4 * 2.0 ** -8
BF16_REL_L2 = 5e-3
CSRC = Path(twp.__file__).parent.parent / "csrc"
SRC = CSRC / "wn_block_padded_sm90.cu"


def _stage(src, k0, width=KC):
    """Columns [k0, k0 + 64) of ``src`` [..., K] as f32, zero past K (TMA's
    zero fill of a box past the tensor's extent)."""
    out = torch.zeros(*src.shape[:-1], width)
    n = max(0, min(width, src.shape[-1] - k0))
    out[..., :n] = src[..., k0:k0 + n].to(F32)
    return out


def _weights(w, k0, cols):
    """A weight stage [64, len(cols)] f32: rows [k0, k0 + 64) of ``w`` [K, N]
    at ``cols``, zero past K and past N."""
    out = torch.zeros(KC, len(cols))
    rows = min(KC, w.shape[0] - k0)
    ok = cols < w.shape[1]
    if rows > 0:
        out[:rows, ok] = w[k0:k0 + rows][:, cols[ok]].to(F32)
    return out


def tile_walk(xp, spect_p, w_in, b_in, w_cond, b_cond, w_rs, b_rs, skip_acc,
              d, n_valid=None, w_end=None, b_end=None, stats=None):
    """STREAM (``w_end`` None: -> (x_new, skip_acc + skip)) or STREAM_FINAL
    (-> wn_out [B, Tp, E] f32) as the kernel computes it.  ``stats``, a
    dict, receives the windows staged and their rows."""
    B, Tp, C = xp.shape
    T, M, rs_out = Tp - 2 * BT, spect_p.shape[-1], w_rs.shape[-1]
    n_valid = T if n_valid is None else n_valid
    final = w_end is not None
    bm = twp.PADDED_SM90_BM
    nb, h = twp.padded_window(d)
    dt = xp.dtype
    bias = (b_in + b_cond).to(F32)
    # the x window rows of a tile: [t0 - d, t0 - d + nb h), zero past Tp
    xz = torch.cat([xp, torch.zeros(B, nb * h, C, dtype=dt)], 1)
    if final:
        out = torch.zeros(B, Tp, w_end.shape[-1])
    else:
        x_new, skip = torch.zeros_like(xp), torch.zeros_like(skip_acc)
    if stats is not None:
        stats.update(windows=0, rows=nb * h, order=[])
    for b in range(B):
        for t0 in range(BT, BT + T, bm):
            gated = torch.empty(bm, C, dtype=dt)
            for c0 in range(0, C, GW):
                if stats is not None and b == 0 and t0 == BT:
                    stats["order"].append(c0)
                cols = torch.cat([torch.arange(c0, c0 + GW),
                                  torch.arange(C + c0, C + c0 + GW)])
                acc = torch.zeros(bm, 2 * GW)
                for k0 in range(0, C, KC):            # one window, three taps
                    win = _stage(xz[b, t0 - d:t0 - d + nb * h], k0)
                    if stats is not None:
                        stats["windows"] += 1
                    for j in range(3):
                        acc += win[j * d:j * d + bm] @ _weights(
                            w_in[j], k0, cols)
                for k0 in range(0, M, KC):            # the conditioning
                    acc += _stage(spect_p[b, t0:t0 + bm], k0) @ _weights(
                        w_cond, k0, cols)
                a = acc + bias[cols]
                gated[:, c0:c0 + GW] = (
                    torch.tanh(a[:, :GW])
                    * (0.5 * torch.tanh(0.5 * a[:, GW:]) + 0.5)).to(dt)
            g = gated.to(F32)
            rs = torch.empty(bm, rs_out)
            for n0 in range(0, rs_out, 2 * GW):
                cols = torch.arange(n0, n0 + 2 * GW)
                acc = torch.zeros(bm, 2 * GW)
                for k0 in range(0, C, KC):
                    acc += g[:, k0:k0 + KC] @ _weights(w_rs, k0, cols)
                nn = min(2 * GW, rs_out - n0)
                rs[:, n0:n0 + nn] = acc[:, :nn] + b_rs[n0:n0 + nn].to(F32)
            t = slice(t0, t0 + bm)
            sk = skip_acc[b, t]
            if final:
                s = (sk.to(F32) + rs).to(dt).to(F32)
                out[b, t] = s @ w_end.to(F32) + b_end.to(F32)
                continue
            ok = (torch.arange(t0, t0 + bm) - BT < n_valid)[:, None]
            if rs_out == 2 * C:
                x_new[b, t] = torch.where(
                    ok, (xp[b, t].to(F32) + rs[:, :C]).to(dt), 0)
                skip[b, t] = sk + rs[:, C:].to(dt)
            else:
                x_new[b, t] = torch.where(ok, xp[b, t], 0)
                skip[b, t] = sk + rs.to(dt)
    return out if final else (x_new, skip)


def _inputs(seed, B, T, n_valid, C, M, rs_out, E=8):
    """numpy inputs, the activations [B, T, .] unpadded: hidden state, mel
    and skip sum zero past n_valid, as a serving path leaves them."""
    rng = np.random.RandomState(seed)
    mask = (np.arange(T) < n_valid)[None, :, None]

    def rn(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return {"x": rn(B, T, C, scale=0.5) * mask,
            "spect": rn(B, T, M, scale=0.5) * mask,
            "w_in": rn(3, C, 2 * C, scale=(3 * C) ** -0.5),
            "b_in": rn(2 * C, scale=0.1),
            "w_cond": rn(M, 2 * C, scale=M ** -0.5),
            "b_cond": rn(2 * C, scale=0.1),
            "w_rs": rn(C, rs_out, scale=C ** -0.5),
            "b_rs": rn(rs_out, scale=0.1),
            "acc": rn(B, T, C, scale=0.5) * mask,
            "w_end": rn(C, E, scale=C ** -0.5),
            "b_end": rn(E, scale=0.1)}


ACTS = ("x", "spect", "acc")
BIASES = ("b_in", "b_cond", "b_rs", "b_end")
ORDER = ("x", "spect", "w_in", "b_in", "w_cond", "b_cond", "w_rs", "b_rs",
         "acc")


def _port(k, dtype=F32):
    """Port tensors, the activations on the port's pad tiles."""
    t = {n: torch.from_numpy(v).to(F32 if n in BIASES else dtype)
         for n, v in k.items()}
    for n in ACTS:
        t[n] = twp.pad_tiles(t[n])
    return t


def _bf16_close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    peak = max(want.abs().max().item(), 1.0)
    assert (got - want).abs().max().item() <= BF16_MAX_ABS_STEPS * peak
    if want.norm() > 0:
        assert ((got - want).norm() / want.norm()).item() <= BF16_REL_L2


def _pads_zero(*ts):
    for t in ts:
        assert not t[:, :BT].any() and not t[:, -BT:].any()


# --- against the Pallas kernels (interpret mode), float32 -------------------

T_J, M_J = 512, 96      # M % 64 == 32: the last conditioning stage is half


@pytest.mark.parametrize("C,d,n_valid,rs_half", [
    (64, 0, 512, False),     # C % 128 == 64, no dilation
    (64, 1, 475, True),      # rs_out = C: the hidden state passes, masked
    (128, 33, 1, False),     # two gate chunks, one valid row
    (64, 128, 0, False),     # a halo of a whole pad tile, nothing valid
])
def test_stream_walk_matches_pallas(C, d, n_valid, rs_half):
    rs_out = C if rs_half else 2 * C
    k = _inputs(10 + C + d, 1, T_J, n_valid, C, M_J, rs_out)
    j = {n: jnp.asarray(v) for n, v in k.items()}
    for n in ACTS:
        j[n] = jwp.pad_tiles(j[n])
    xw, sw = jwp.wn_layer_stream(*(j[n] for n in ORDER), d, interpret=True,
                                 n_valid=n_valid)
    t = _port(k)
    x_new, skip = tile_walk(*(t[n] for n in ORDER), d, n_valid)
    _pads_zero(x_new, skip)
    np.testing.assert_allclose(twp.unpad_tiles(x_new).numpy(),
                               np.asarray(jwp.unpad_tiles(xw)), atol=ATOL)
    np.testing.assert_allclose(twp.unpad_tiles(skip).numpy(),
                               np.asarray(jwp.unpad_tiles(sw)), atol=ATOL)
    assert not twp.unpad_tiles(x_new)[:, n_valid:].any()


@pytest.mark.parametrize("C,d,n_valid,E", [(64, 1, 475, 8), (128, 128, 0, 1)])
def test_stream_final_walk_matches_pallas(C, d, n_valid, E):
    k = _inputs(20 + C + d, 1, T_J, n_valid, C, M_J, C, E)
    j = {n: jnp.asarray(v) for n, v in k.items()}
    for n in ACTS:
        j[n] = jwp.pad_tiles(j[n])
    want = jwp.wn_layer_stream_final(*(j[n] for n in ORDER), j["w_end"],
                                     j["b_end"], d, interpret=True,
                                     n_valid=n_valid)
    t = _port(k)
    got = tile_walk(*(t[n] for n in ORDER), d, n_valid, w_end=t["w_end"],
                    b_end=t["b_end"])
    _pads_zero(got)
    np.testing.assert_allclose(twp.unpad_tiles(got).numpy(),
                               np.asarray(jwp.unpad_tiles(want)), atol=ATOL)


# --- against the plain versions, bf16 ---------------------------------------


@pytest.mark.parametrize("C,M,B", [(64, 96, 2), (192, 64, 1)])
@pytest.mark.parametrize("d,n_valid", [(0, 256), (1, 219), (33, 1),
                                       (128, 0)])
@pytest.mark.parametrize("rs_half", [False, True])
def test_stream_walk_matches_plain_bf16(C, M, B, d, n_valid, rs_half):
    T = 256
    rs_out = C if rs_half else 2 * C
    t = _port(_inputs(30 + C + d + n_valid, B, T, n_valid, C, M, rs_out),
              BF16)
    args = [t[n] for n in ORDER]
    want = twp.wn_layer_stream_plain(*args, d, n_valid)
    got = tile_walk(*args, d, n_valid)
    for g, w in zip(got, want):
        assert g.dtype == BF16
        _pads_zero(g)
        _bf16_close(g, w)
    assert not twp.unpad_tiles(got[0])[:, n_valid:].any()


@pytest.mark.parametrize("C,M,E", [(64, 96, 8), (192, 64, 1), (128, 32, 3)])
@pytest.mark.parametrize("d", [0, 33, 128])
def test_stream_final_walk_matches_plain_bf16(C, M, E, d):
    T, n_valid = 256, 219
    t = _port(_inputs(40 + C + d, 2, T, n_valid, C, M, C, E), BF16)
    args = [t[n] for n in ORDER]
    want = twp.wn_layer_stream_final_plain(*args, t["w_end"], t["b_end"], d,
                                           n_valid)
    got = tile_walk(*args, d, n_valid, w_end=t["w_end"], b_end=t["b_end"])
    assert got.dtype == F32 and got.shape == want.shape == (2, T + 2 * BT, E)
    _pads_zero(got)
    _bf16_close(got, want)


# --- the blocking ------------------------------------------------------------


def test_x_window_is_staged_once_per_k_chunk():
    """Per tile and gate chunk, one window per 64-channel K chunk, read at
    offsets 0, d and 2d: x crosses into shared memory (1 + 2d / BM) times
    per gate chunk, where three tap boxes would cross it three times.  Gate
    chunks run in order, 64 columns apart."""
    C, T, d = 128, 256, 33
    t = _port(_inputs(50, 1, T, T, C, 64, 2 * C))
    stats = {}
    tile_walk(*(t[n] for n in ORDER), d, stats=stats)
    plan = twp.padded_sm90_plan(C, T, 1, d)
    bm, tiles = plan["bm"], plan["tiles"]
    assert stats["order"] == [0, 64]
    assert stats["windows"] == tiles * (C // GW) * (C // KC)
    nb, h = plan["window"]
    assert stats["rows"] == nb * h >= bm + 2 * d and nb * h - (bm + 2 * d) < 8
    assert nb * h < 3 * bm


@pytest.mark.parametrize("d", [1, 100, 128])
def test_a_tile_reads_only_its_window(d):
    """The first tile's outputs depend on x only through its window, the
    rows [t0 - d, t0 + 64 + d) (one TMA box, or two at d = 100, 128): x
    changed past the window leaves them as they were, and changes the
    next tile's."""
    C, T, bm = 64, 256, twp.PADDED_SM90_BM
    t = _port(_inputs(60 + d, 1, T, 200, C, 96, 2 * C))
    args = [t[n] for n in ORDER]
    a = tile_walk(*args, d, 200)
    args[0] = args[0].clone()
    args[0][:, BT + bm + d:] += 1.0
    b = tile_walk(*args, d, 200)
    assert twp.padded_window(d)[0] == (2 if bm + 2 * d > 256 else 1)
    first, second = slice(BT, BT + bm), slice(BT + bm, BT + 2 * bm)
    for x, y in zip(a, b):
        assert torch.equal(x[:, first], y[:, first])
        assert not torch.equal(x[:, second], y[:, second])


def test_the_skip_sum_is_rounded_before_the_end_projection():
    """STREAM_FINAL rounds skip + rs to bf16 before w_end (row 3 folds
    w_rs into the projection instead): with rs tiny against a skip sum on
    a bf16 knife edge the projection sees the rounded value."""
    C, T, E = 64, 128, 1
    t = _port(_inputs(70, 1, T, T, C, 32, C, E), BF16)
    for n in ("w_in", "w_cond", "w_rs"):
        t[n] = torch.zeros_like(t[n])
    for n in ("b_in", "b_cond"):
        t[n] = torch.zeros_like(t[n])
    t["b_rs"] = torch.full((C,), 2.0 ** -10)
    t["acc"] = twp.pad_tiles(torch.ones(1, T, C, dtype=BF16))
    t["w_end"] = torch.ones(C, E, dtype=BF16)
    t["b_end"] = torch.zeros(E)
    got = tile_walk(*(t[n] for n in ORDER), 1, w_end=t["w_end"],
                    b_end=t["b_end"])
    # 1 + 2^-10 rounds to 1 in bf16: each row sums C ones
    assert torch.equal(twp.unpad_tiles(got), torch.full((1, T, E), float(C)))


# --- the launch plan ---------------------------------------------------------


def _accepted_widths(role):
    """(C, ok) for every C % 64 == 0 up to past the plan's largest."""
    out = []
    for C in range(64, 2049, 64):
        try:
            twp.padded_sm90_plan(C, 6400, 1, 128, role)
            out.append((C, True))
        except ValueError as e:
            assert f"{twp.PADDED_SM90_SMEM_LIMIT} bytes" in str(e)
            out.append((C, False))
    return out


@pytest.mark.parametrize("role", ["stream", "stream_final"])
def test_plan_fits_shared_memory_at_every_dilation_and_width(role):
    """Every width the plan takes fits 227 KB at every d in [0, 128], at
    one and three utterances, with a ring of two to four weight stages and
    one or two window slots; the widths it refuses are those past one
    limit, named in the error; the reference width 512 is taken."""
    widths = _accepted_widths(role)
    ok = [C for C, taken in widths if taken]
    assert 512 in ok and ok == list(range(64, ok[-1] + 1, 64))
    assert all(not taken for C, taken in widths if C > ok[-1])
    for C in ok:
        for d in range(0, 129):
            for B, T in ((1, 6400), (3, 6400), (1, 256)):
                p = twp.padded_sm90_plan(C, T, B, d, role)
                assert (p["smem"] + twp.PADDED_SM90_STATIC_SMEM
                        <= twp.PADDED_SM90_SMEM_LIMIT)
                assert p["smem"] == twp.padded_sm90_smem_bytes(
                    role, C, d, p["nwin"], p["nwst"])
                assert 2 <= p["nwst"] <= twp.PADDED_SM90_MAX_WST
                assert p["nwin"] in (1, 2) and p["bm"] == 64
                nb, h = p["window"]
                assert h % 8 == 0 and h <= 256 and nb * h >= 64 + 2 * d
                assert p["tiles"] == B * T // 64


@pytest.mark.parametrize("B,role,nwst", [(1, "stream", 4),
                                         (3, "stream_final", 4)])
def test_plan_at_the_ladder_shapes(B, role, nwst):
    """T = 6400, C = 512, d = 64: 64-row blocks with two window slots and
    four weight slots, 100 tiles for one utterance, 300 for three; a role
    the kernel does not have raises."""
    p = twp.padded_sm90_plan(512, 6400, B, 64, role)
    assert (p["bm"], p["nwin"], p["nwst"]) == (64, 2, nwst)
    assert p["tiles"] == 100 * B and p["window"] == (1, 192)
    with pytest.raises(ValueError, match="no role"):
        twp.padded_sm90_plan(512, 6400, B, 64, "spect")


def test_plan_restates_the_kernel_constants():
    src = SRC.read_text()
    const = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert const["KC"] == "64" and const["GW"] == "64"
    assert int(const["BM"]) == twp.PADDED_SM90_BM == 64
    assert const["WBOX"] == "KC * 64 * 2" and const["WSLOT"] == "2 * WBOX"
    assert twp.PADDED_SM90_WSLOT == 2 * KC * 64 * 2
    assert int(const["MAX_WST"]) == twp.PADDED_SM90_MAX_WST
    assert const["MAX_BOX_ROWS"] == "256" and const["E_PAD"] == "8"
    assert "return 1024 + (size_t)BM * C * 2 + (size_t)nwin * window_of(d)" \
        in src
    assert "window_of(int d)" in src and "const int rows = BM + 2 * d;" in src
    # twelve mbarriers of 8 bytes are the static shared memory
    assert "win_full[MAX_WIN], win_empty[MAX_WIN]" in src
    assert "w_full[MAX_WST], w_empty[MAX_WST]" in src
    assert twp.PADDED_SM90_STATIC_SMEM == 8 * (2 * 2 + 2 * 4)


# --- the C interface and the sources ----------------------------------------


def test_role_constants_and_c_interface():
    src = SRC.read_text()
    assert "enum PaddedRole { STREAM = 0, STREAM_FINAL = 1 };" in src
    assert twp.PADDED_SM90_ROLES == {"stream": 0, "stream_final": 1}
    decls = dict(re.findall(r"^(?:int|size_t) (t2s_\w+)\(([^)]*)\)", src,
                            re.M))
    assert set(decls) == set(twp.LIB_SM90.signatures)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, params in decls.items():
        kinds = [P if "*" in p else I for p in params.split(",")]
        assert kinds == twp.LIB_SM90.signatures[name], name
    names = [p.split()[-1].lstrip("*")
             for p in decls["t2s_wn_stream_sm90"].split(",")]
    assert names[:10] == ["x", "spect", "w_in", "b_in", "w_cond", "b_cond",
                          "w_rs", "b_rs", "skip", "x_out"]
    assert names[-3:] == ["nwin", "nwst", "stream"]
    assert [p.split()[-1] for p in decls[
        "t2s_wn_padded_sm90_smem_bytes"].split(",")] == [
        "role", "C", "d", "nwin", "nwst"]


def _defined_functions(text):
    """Names of the functions a CUDA source defines (a name, its parameter
    list and an opening brace, at any template or qualifier)."""
    text = re.sub(r"//[^\n]*", "", text)
    names = re.findall(r"\b(\w+)\s*\([^;{}()]*(?:\([^()]*\)[^;{}()]*)*\)\s*"
                       r"(?:const\s*)?\{", text)
    keywords = {"if", "for", "while", "switch", "return", "sizeof"}
    return {n for n in names if n not in keywords}


def test_the_oracle_shares_no_code_with_the_serving_kernel():
    """The new file includes ``sm90.cuh`` (PTX wrappers) and system headers
    only, and defines no function that ``wn_block_sm90.cu`` defines: an
    oracle built from the serving kernel's code would prove nothing."""
    src = SRC.read_text()
    includes = re.findall(r'#include\s+([<"][^>"]+[>"])', src)
    assert [i for i in includes if i.startswith('"')] == ['"sm90.cuh"']
    assert all(i.startswith("<") for i in includes if i != '"sm90.cuh"')
    ours = _defined_functions(src)
    serving = _defined_functions((CSRC / "wn_block_sm90.cu").read_text())
    assert {"feed", "consume", "inact", "gate_chunk", "stream_store",
            "final_fold", "start"} <= ours
    assert {"produce", "gate_store", "rs_phase", "final_phase",
            "launch"} <= serving
    assert not ours & serving


def test_wrappers_on_the_cpu_take_the_plain_versions():
    """CPU tensors take the plain versions and count no launch; the plan
    is only computed for CUDA tensors."""
    twp.reset_launch_counts()
    t = _port(_inputs(80, 1, 128, 128, 64, 32, 128), BF16)
    args = [t[n] for n in ORDER]
    x_new, skip = twp.wn_layer_stream(*args, 1)
    for g, w in zip((x_new, skip), twp.wn_layer_stream_plain(*args, 1)):
        assert torch.equal(g, w)
    assert twp.launch_counts()["wn_layer_stream"] == 0
    assert twp.launch_counts()["wn_layer_stream_final"] == 0
