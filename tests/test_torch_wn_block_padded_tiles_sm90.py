"""The SPECT and PADDED roles of ``csrc/wn_block_padded_tiles_sm90.cu``
(rows 13 and 12 of the padded oracle family, redesigned for Hopper),
checked on the CPU.

The kernel cannot run here, so a PyTorch "tile walk" follows its blocking:
tiles of BM = 64 rows (``PADDED_TILES_BM``) of one utterance on the
``pad_tiles`` layout; per gate chunk (64 tanh columns c0.. and their 64
sigmoid partners C + c0..: N = 128) and per 64-channel K chunk of x, three
boxes of 64 rows each, x[t0 - d, t0 + 64 - d), x[t0, t0 + 64) and x[t0 + d,
t0 + 64 + d) (the TPU kernel's neighbour tiles t-1, t, t+1 read as three
tiles), each against its tap's weights; then SPECT's conditioning stages
(spect rows [t0, t0 + 64) and w_cond, 64 deep, zero past M) with b_in +
b_cond, or PADDED's cond slot (the chunk's tanh and sigmoid columns of the
layer's 2C slice of ``cond_p``) added after b_in; the gate in f32 (the
sigmoid as 0.5 tanh(x / 2) + 0.5) rounded to the input dtype into the
gated tile [64, C]; the res/skip product in chunks of 128 columns over
64-deep stages; the epilogue (the residual, zero at real rows >= n_valid;
SPECT's skip sum skip + round(rs), PADDED's skip round(rs); rs whole when
rs_out == C, the hidden state then passed through, masked).  The pad tiles
of both outputs are zero.

The walk is held to the JAX package's Pallas kernels ``wn_layer_spect`` /
``wn_layer_padded`` (interpret mode, as
``tests/test_torch_wn_block_padded.py`` runs them; each package pads with
its own tiles and the two are compared on the T real rows) and to the
port's plain versions in bf16.  The launch plan, the C interface, the
role constants and the rule that the oracle shares no code with the
kernels it checks are checked against the sources.

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
BM = twp.PADDED_TILES_BM
KC, GW = 64, 64
ATOL = 2e-5
BF16_MAX_ABS_STEPS = 4 * 2.0 ** -8
BF16_REL_L2 = 5e-3
CSRC = Path(twp.__file__).parent.parent / "csrc"
SRC = CSRC / "wn_block_padded_tiles_sm90.cu"
WIDEST = {"spect": 1408, "padded": 1280}


def _stage(src, k0, width=KC):
    """Columns [k0, k0 + 64) of ``src`` [..., K] as f32, zero past K (TMA's
    zero fill of a box past the tensor's extent)."""
    out = torch.zeros(*src.shape[:-1], width)
    n = max(0, min(width, src.shape[-1] - k0))
    out[..., :n] = src[..., k0:k0 + n].to(F32)
    return out


def _weights(w, k0, cols):
    """A weight tile [64, len(cols)] f32: rows [k0, k0 + 64) of ``w`` [K, N]
    at ``cols``, zero past K and past N."""
    out = torch.zeros(KC, len(cols))
    rows = min(KC, w.shape[0] - k0)
    ok = cols < w.shape[1]
    if rows > 0:
        out[:rows, ok] = w[k0:k0 + rows][:, cols[ok]].to(F32)
    return out


def tile_walk(xp, w_in, b_in, w_rs, b_rs, d, n_valid=None, spect=None,
              w_cond=None, b_cond=None, skip_acc=None, cond_p=None,
              cond_index=0, stats=None):
    """SPECT (``spect`` given: -> (x_new, skip_acc + skip)) or PADDED
    (``cond_p`` given: -> (x_new, skip)) as the kernel computes it.
    ``stats``, a dict, receives the boxes staged (their first rows, per
    tile and gate chunk) and the cond columns read."""
    B, Tp, C = xp.shape
    T, rs_out = Tp - 2 * BT, w_rs.shape[-1]
    n_valid = T if n_valid is None else n_valid
    role_spect = spect is not None
    dt = xp.dtype
    bias = (b_in + b_cond).to(F32) if role_spect else b_in.to(F32)
    x_new, skip = torch.zeros_like(xp), torch.zeros_like(xp)
    if stats is not None:
        stats.update(boxes=[], cond_cols=set())
    for b in range(B):
        for t0 in range(BT, BT + T, BM):
            gated = torch.empty(BM, C, dtype=dt)
            for c0 in range(0, C, GW):
                cols = torch.cat([torch.arange(c0, c0 + GW),
                                  torch.arange(C + c0, C + c0 + GW)])
                acc = torch.zeros(BM, 2 * GW)
                for k0 in range(0, C, KC):            # three tap boxes
                    for j in range(3):
                        r = t0 + (j - 1) * d
                        if stats is not None:
                            stats["boxes"].append((b, t0, c0, k0, j, r))
                        acc += _stage(xp[b, r:r + BM], k0) @ _weights(
                            w_in[j], k0, cols)
                if role_spect:                         # the conditioning
                    for k0 in range(0, spect.shape[-1], KC):
                        acc += _stage(spect[b, t0:t0 + BM], k0) @ _weights(
                            w_cond, k0, cols)
                a = acc + bias[cols]
                if not role_spect:                     # the cond slot
                    cc = 2 * C * cond_index + cols
                    if stats is not None:
                        stats["cond_cols"].update(cc.tolist())
                    a = a + cond_p[b, t0:t0 + BM][:, cc].to(F32)
                gated[:, c0:c0 + GW] = (
                    torch.tanh(a[:, :GW])
                    * (0.5 * torch.tanh(0.5 * a[:, GW:]) + 0.5)).to(dt)
            g = gated.to(F32)
            rs = torch.empty(BM, rs_out)
            for n0 in range(0, rs_out, 2 * GW):
                cols = torch.arange(n0, n0 + 2 * GW)
                acc = torch.zeros(BM, 2 * GW)
                for k0 in range(0, C, KC):
                    acc += g[:, k0:k0 + KC] @ _weights(w_rs, k0, cols)
                nn = min(2 * GW, rs_out - n0)
                rs[:, n0:n0 + nn] = acc[:, :nn] + b_rs[n0:n0 + nn].to(F32)
            t = slice(t0, t0 + BM)
            ok = (torch.arange(t0, t0 + BM) - BT < n_valid)[:, None]
            if rs_out == 2 * C:
                x_new[b, t] = torch.where(
                    ok, (xp[b, t].to(F32) + rs[:, :C]).to(dt), 0)
                sk = rs[:, C:].to(dt)
            else:
                x_new[b, t] = torch.where(ok, xp[b, t], 0)
                sk = rs.to(dt)
            skip[b, t] = skip_acc[b, t] + sk if role_spect else sk
    return x_new, skip


def _inputs(seed, B, T, n_valid, C, M, rs_out, n_cond=3):
    """numpy inputs, the activations [B, T, .] unpadded: hidden state, mel,
    skip sum and conditioning zero past n_valid, as a serving path leaves
    them."""
    rng = np.random.RandomState(seed)
    mask = (np.arange(T) < n_valid)[None, :, None]

    def rn(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return {"x": rn(B, T, C, scale=0.5) * mask,
            "spect": rn(B, T, M, scale=0.5) * mask,
            "cond": rn(B, T, 2 * C * n_cond, scale=0.5) * mask,
            "w_in": rn(3, C, 2 * C, scale=(3 * C) ** -0.5),
            "b_in": rn(2 * C, scale=0.1),
            "w_cond": rn(M, 2 * C, scale=M ** -0.5),
            "b_cond": rn(2 * C, scale=0.1),
            "w_rs": rn(C, rs_out, scale=C ** -0.5),
            "b_rs": rn(rs_out, scale=0.1),
            "acc": rn(B, T, C, scale=0.5) * mask}


ACTS = ("x", "spect", "cond", "acc")
BIASES = ("b_in", "b_cond", "b_rs")
SPECT_ORDER = ("x", "spect", "w_in", "b_in", "w_cond", "b_cond", "w_rs",
               "b_rs", "acc")
PADDED_ORDER = ("x", "cond", "w_in", "b_in", "w_rs", "b_rs")


def _port(k, dtype=F32):
    """Port tensors, the activations on the port's pad tiles."""
    t = {n: torch.from_numpy(v).to(F32 if n in BIASES else dtype)
         for n, v in k.items()}
    for n in ACTS:
        t[n] = twp.pad_tiles(t[n])
    return t


def _walk(role, t, d, n_valid, cond_index=0, stats=None):
    """The walk of ``role`` on ``_port``'s tensors."""
    head = (t["x"], t["w_in"], t["b_in"], t["w_rs"], t["b_rs"], d, n_valid)
    if role == "spect":
        return tile_walk(*head, spect=t["spect"], w_cond=t["w_cond"],
                         b_cond=t["b_cond"], skip_acc=t["acc"], stats=stats)
    return tile_walk(*head, cond_p=t["cond"], cond_index=cond_index,
                     stats=stats)


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


@pytest.mark.parametrize("role", ["spect", "padded"])
@pytest.mark.parametrize("C,d,n_valid,rs_half,ci", [
    (64, 2, 512, False, 0),     # C % 128 == 64 (the Pallas kernel has
                                # no d = 0: its halo slices are empty)
    (64, 1, 475, True, 2),      # rs_out = C: the hidden state passes, masked
    (128, 33, 1, False, 2),     # two gate chunks, one valid row
    (64, 128, 0, True, 0),      # a halo of a whole pad tile, nothing valid
])
def test_tiles_walk_matches_pallas(role, C, d, n_valid, rs_half, ci):
    rs_out = C if rs_half else 2 * C
    k = _inputs(10 + C + d, 1, T_J, n_valid, C, M_J, rs_out)
    j = {n: jnp.asarray(v) for n, v in k.items()}
    for n in ACTS:
        j[n] = jwp.pad_tiles(j[n])
    if role == "spect":
        xw, sw = jwp.wn_layer_spect(*(j[n] for n in SPECT_ORDER), d,
                                    interpret=True, n_valid=n_valid)
    else:
        xw, sw = jwp.wn_layer_padded(*(j[n] for n in PADDED_ORDER), d, ci,
                                     interpret=True, n_valid=n_valid)
    x_new, skip = _walk(role, _port(k), d, n_valid, ci)
    _pads_zero(x_new, skip)
    np.testing.assert_allclose(twp.unpad_tiles(x_new).numpy(),
                               np.asarray(jwp.unpad_tiles(xw)), atol=ATOL)
    np.testing.assert_allclose(twp.unpad_tiles(skip).numpy(),
                               np.asarray(jwp.unpad_tiles(sw)), atol=ATOL)
    assert not twp.unpad_tiles(x_new)[:, n_valid:].any()


# --- against the plain versions, bf16 ---------------------------------------


@pytest.mark.parametrize("role", ["spect", "padded"])
@pytest.mark.parametrize("C,M,B", [(64, 96, 2), (192, 64, 1)])
@pytest.mark.parametrize("d,n_valid", [(0, 256), (1, 219), (33, 1),
                                       (128, 0)])
@pytest.mark.parametrize("rs_half", [False, True])
def test_tiles_walk_matches_plain_bf16(role, C, M, B, d, n_valid, rs_half):
    T = 256
    rs_out = C if rs_half else 2 * C
    ci = 2 if rs_half else 0
    t = _port(_inputs(30 + C + d + n_valid, B, T, n_valid, C, M, rs_out),
              BF16)
    if role == "spect":
        want = twp.wn_layer_spect_plain(*(t[n] for n in SPECT_ORDER), d,
                                        n_valid)
    else:
        want = twp.wn_layer_padded_plain(*(t[n] for n in PADDED_ORDER), d,
                                         ci, n_valid)
    got = _walk(role, t, d, n_valid, ci)
    for g, w in zip(got, want):
        assert g.dtype == BF16
        _pads_zero(g)
        _bf16_close(g, w)
    assert not twp.unpad_tiles(got[0])[:, n_valid:].any()


# --- the blocking ------------------------------------------------------------


@pytest.mark.parametrize("d", [0, 33, 128])
def test_three_tap_boxes_per_k_chunk(d):
    """Per tile, gate chunk and 64-channel K chunk, three boxes of 64 rows
    starting at t0 - d, t0 and t0 + d (the TPU's tiles t-1, t, t+1): x
    crosses into shared memory three times per gate chunk, and no box
    crosses the padded array's ends at any d <= 128."""
    C, T = 128, 256
    t = _port(_inputs(50, 1, T, T, C, 64, 2 * C))
    stats = {}
    _walk("spect", t, d, T, stats=stats)
    plan = twp.padded_tiles_plan(C, T, 1, d, "spect")
    boxes = stats["boxes"]
    assert len(boxes) == plan["tiles"] * (C // GW) * (C // KC) * 3
    for b, t0, c0, k0, j, r in boxes:
        assert r == t0 + (j - 1) * d
        assert 0 <= r and r + BM <= T + 2 * BT
    # every x row a tile reads lies in one of its three boxes
    t0s = sorted({bx[1] for bx in boxes})
    assert t0s == list(range(BT, BT + T, BM))


@pytest.mark.parametrize("ci", [0, 2])
def test_padded_reads_only_its_cond_slice(ci):
    """PADDED reads the columns [2C ci, 2C (ci + 1)) of ``cond_p``, the
    tanh half for the gate chunk's first 64 columns and the sigmoid half
    for its partners: the other slices changed leave both outputs as they
    were."""
    C, T = 64, 128
    t = _port(_inputs(55, 1, T, T, C, 32, 2 * C), BF16)
    stats = {}
    a = _walk("padded", t, 1, T, ci, stats=stats)
    assert stats["cond_cols"] == set(range(2 * C * ci, 2 * C * (ci + 1)))
    other = torch.ones(t["cond"].shape[-1], dtype=torch.bool)
    other[2 * C * ci:2 * C * (ci + 1)] = False
    t["cond"] = t["cond"].clone()
    t["cond"][..., other] += 1.0
    b = _walk("padded", t, 1, T, ci)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_padded_skip_is_not_accumulated_and_spect_sums_it():
    """On the same weights and a conditioning equal to spect W_cond +
    b_cond, PADDED returns the layer's own skip and SPECT adds it to the
    skip sum it is given."""
    C, T, M = 64, 128, 64
    t = _port(_inputs(60, 1, T, 100, C, M, 2 * C), BF16)
    cond = (t["spect"].float() @ t["w_cond"].float()
            + t["b_cond"]).to(BF16)
    t["cond"] = torch.cat([cond, torch.zeros_like(cond)], -1)
    t["acc"] = torch.zeros_like(t["acc"])
    xs, ss = _walk("spect", t, 3, 100)
    xp, sp = _walk("padded", t, 3, 100, 0)
    _bf16_close(xp, xs)
    _bf16_close(sp, ss)


# --- the launch plan ---------------------------------------------------------


def _accepted_widths(role):
    """(C, ok) for every C % 64 == 0 up to past the plan's largest."""
    out = []
    for C in range(64, 2049, 64):
        try:
            twp.padded_tiles_plan(C, 6400, 1, 128, role)
            out.append((C, True))
        except ValueError as e:
            assert f"{twp.PADDED_SM90_SMEM_LIMIT} bytes" in str(e)
            out.append((C, False))
    return out


@pytest.mark.parametrize("role", ["spect", "padded"])
def test_plan_fits_shared_memory_at_every_dilation_and_width(role):
    """Every width up to the widest (1408 SPECT, 1280 PADDED) fits 227 KB
    at every d in [0, 128], at one and three utterances, with a ring of two
    to eight stages; the widths past it are refused with the limit named;
    the reference width 512 takes six stages."""
    widths = _accepted_widths(role)
    ok = [C for C, taken in widths if taken]
    assert ok == list(range(64, WIDEST[role] + 1, 64))
    assert all(not taken for C, taken in widths if C > WIDEST[role])
    for C in ok:
        for d in range(0, 129):
            for B, T in ((1, 6400), (3, 6400), (1, 256)):
                p = twp.padded_tiles_plan(C, T, B, d, role)
                assert (p["smem"] + twp.PADDED_TILES_STATIC_SMEM
                        <= twp.PADDED_SM90_SMEM_LIMIT)
                assert p["smem"] == twp.padded_tiles_smem_bytes(
                    role, C, p["nst"])
                assert 2 <= p["nst"] <= twp.PADDED_TILES_MAX_ST
                assert p["bm"] == 64 and p["tiles"] == B * T // 64
    assert twp.padded_tiles_plan(WIDEST[role], 6400, 1, 64, role)["nst"] == 2
    assert twp.padded_tiles_plan(512, 6400, 3, 64, role)["nst"] == 6
    with pytest.raises(ValueError, match="no role"):
        twp.padded_tiles_plan(512, 6400, 1, 64, "stream")


def test_plan_restates_the_kernel_constants():
    src = SRC.read_text()
    const = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert const["KC"] == "64" and const["GW"] == "64"
    assert int(const["BM"]) == twp.PADDED_TILES_BM == 64
    assert const["ABOX"] == "BM * KC * 2" and const["WBOX"] == "KC * 64 * 2"
    assert const["STAGE"] == "ABOX + 2 * WBOX"
    assert twp.PADDED_TILES_STAGE == 64 * KC * 2 + 2 * KC * 64 * 2
    assert const["CSLOT"] == "2 * BM * GW * 2"
    assert twp.PADDED_TILES_CSLOT == 2 * 64 * GW * 2
    assert int(const["MAX_ST"]) == twp.PADDED_TILES_MAX_ST
    assert ("return 1024 + (size_t)BM * C * 2 + (role == PADDED ? CSLOT : 0)"
            " +\n         (size_t)nst * STAGE;") in src
    # 2 MAX_ST + 2 mbarriers of 8 bytes are the static shared memory
    assert "uint64_t full[MAX_ST], empty[MAX_ST];" in src
    assert "uint64_t cond_full, cond_empty;" in src
    assert twp.PADDED_TILES_STATIC_SMEM == 8 * (2 * 8 + 2)


# --- the C interface and the sources ----------------------------------------


def test_role_constants_and_c_interface():
    src = SRC.read_text()
    assert "enum TilesRole { SPECT = 0, PADDED = 1 };" in src
    assert twp.PADDED_TILES_ROLES == {"spect": 0, "padded": 1}
    decls = dict(re.findall(r"^(?:int|size_t) (t2s_\w+)\(([^)]*)\)", src,
                            re.M))
    assert set(decls) == set(twp.LIB_TILES.signatures)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, params in decls.items():
        kinds = [P if "*" in p else I for p in params.split(",")]
        assert kinds == twp.LIB_TILES.signatures[name], name

    def names(fn):
        return [p.split()[-1].lstrip("*") for p in decls[fn].split(",")]

    assert names("t2s_wn_spect_tiles_sm90") == [
        "x", "spect", "w_in", "b_in", "w_cond", "b_cond", "w_rs", "b_rs",
        "skip", "x_out", "B", "Tp", "bt", "n_valid", "C", "M", "rs_out", "d",
        "nst", "stream"]
    assert names("t2s_wn_padded_tiles_sm90") == [
        "x", "cond", "w_in", "b_in", "w_rs", "b_rs", "x_out", "skip_out", "B",
        "Tp", "bt", "n_valid", "C", "n_cond", "cond_index", "rs_out", "d",
        "nst", "stream"]
    assert names("t2s_wn_padded_tiles_sm90_smem_bytes") == ["role", "C",
                                                            "nst"]


def _defined_functions(text):
    """Names of the functions a CUDA source defines (a name, its parameter
    list and an opening brace, at any template or qualifier)."""
    text = re.sub(r"//[^\n]*", "", text)
    names = re.findall(r"\b(\w+)\s*\([^;{}()]*(?:\([^()]*\)[^;{}()]*)*\)\s*"
                       r"(?:const\s*)?\{", text)
    keywords = {"if", "for", "while", "switch", "return", "sizeof"}
    return {n for n in names if n not in keywords}


@pytest.mark.parametrize("other", ["wn_block_sm90.cu",
                                   "wn_block_padded_sm90.cu"])
def test_the_oracle_shares_no_code(other):
    """The new file includes ``sm90.cuh`` (PTX wrappers) and system headers
    only, and defines no function that the serving kernel or the stream
    kernel (the other side of the ladder's rung 13 vs 14) define: an oracle
    built from their code would prove nothing."""
    src = SRC.read_text()
    includes = re.findall(r'#include\s+([<"][^>"]+[>"])', src)
    assert [i for i in includes if i.startswith('"')] == ['"sm90.cuh"']
    assert all(i.startswith("<") for i in includes if i != '"sm90.cuh"')
    ours = _defined_functions(src)
    theirs = _defined_functions((CSRC / other).read_text())
    assert {"producer_loop", "consumer_loop", "inact_product", "apply_gate",
            "rs_product", "store_rows", "launch_tiles"} <= ours
    assert len(theirs) > 10
    assert not ours & theirs


def test_wrappers_on_the_cpu_take_the_plain_versions():
    """CPU tensors take the plain versions and count no launch; the plan
    is only computed for CUDA tensors."""
    twp.reset_launch_counts()
    t = _port(_inputs(80, 1, 128, 128, 64, 32, 128), BF16)
    spect = [t[n] for n in SPECT_ORDER]
    got = twp.wn_layer_spect(*spect, 1)
    for g, w in zip(got, twp.wn_layer_spect_plain(*spect, 1)):
        assert torch.equal(g, w)
    padded = [t[n] for n in PADDED_ORDER]
    got = twp.wn_layer_padded(*padded, 1, 2)
    for g, w in zip(got, twp.wn_layer_padded_plain(*padded, 1, 2)):
        assert torch.equal(g, w)
    assert twp.launch_counts()["wn_layer_spect"] == 0
    assert twp.launch_counts()["wn_layer_padded"] == 0
