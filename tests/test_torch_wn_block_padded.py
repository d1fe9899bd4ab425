"""Parity of the port's padded-layout WN layers
(``text2speech_tpu_torch.ops.wn_block_padded``) with the JAX package's
Pallas kernels (``text2speech_tpu.ops.pallas.wn_block_padded``, interpret
mode, as ``tests/test_pallas.py`` runs them), then the parity ladder of
``tests/test_pallas.py:81-250`` among the port's plain versions.

Each package pads with its own ``pad_tiles`` (JAX: 512-row tiles, the port:
``BT_PAD`` = 128) and the two are compared on the T real rows.  Inputs are
made with numpy from a seed; the hidden state and the conditioning are
zero past ``n_valid``, as a serving path leaves them.  One interpret-mode
call takes about a second here, so the JAX outputs are computed once per
case and shared by the tests.

Tolerances.  float32: the same float32 products summed in another order,
contractions of at most 3C + M = 240 terms on activations of order 1:
2e-5.  bfloat16: the inputs are rounded to bf16 once (the same values on
both sides), both sides accumulate in float32 and round the gate and the
outputs at the same places, so they differ where a float32 sum in another
order falls on the other side of a bf16 rounding boundary: one bf16 step
(2^-8 of the value) on outputs that stay under 2 (8e-3), and 2e-3 on the
final layer's float32 output (C = 64 terms each off by at most 2^-9)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text2speech_tpu.ops.pallas import wn_block_padded as jwp
from text2speech_tpu_torch.ops import wn_block as twb
from text2speech_tpu_torch.ops import wn_block_dcond as twd
from text2speech_tpu_torch.ops import wn_block_padded as twp

torch.set_num_threads(1)

B, C, M, E, N_COND = 1, 64, 48, 8, 3
T = 512
N_VALID = T - 37
ATOL = {"float32": 2e-5, "bfloat16": 8e-3}
ATOL_FINAL = {"float32": 2e-5, "bfloat16": 2e-3}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BIASES = ("b_in", "b_cond", "b_rs", "b_end")
KERNELS = ("padded", "spect", "stream", "final")


def _inputs(seed: int, rs_out: int, n_valid: int = N_VALID) -> dict:
    rng = np.random.RandomState(seed)
    mask = (np.arange(T) < n_valid)[None, :, None]

    def rn(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return {
        "x": rn(B, T, C, scale=0.1) * mask,
        "spect": rn(B, T, M, scale=0.3) * mask,
        "cond": rn(B, T, 2 * C * N_COND, scale=0.3),
        "acc": rn(B, T, C, scale=0.1) * mask,
        "w_in": rn(3, C, 2 * C, scale=0.05),
        "b_in": rn(2 * C, scale=0.05),
        "w_cond": rn(M, 2 * C, scale=0.05),
        "b_cond": rn(2 * C, scale=0.05),
        "w_rs": rn(C, rs_out, scale=0.05),
        "b_rs": rn(rs_out, scale=0.05),
        "w_end": rn(C, E, scale=0.05),
        "b_end": rn(E, scale=0.05),
    }


PADDED = ("x", "spect", "cond", "acc")


def _jax(k, dtype):
    """JAX arrays: activations padded with the JAX tiles, in ``dtype``."""
    out = {}
    for n, v in k.items():
        a = jnp.asarray(v, jnp.float32 if n in BIASES else JDT[dtype])
        out[n] = jwp.pad_tiles(a) if n in PADDED else a
    return out


def _torch(k, dtype):
    """Port tensors: activations padded with the port's tiles."""
    out = {}
    for n, v in k.items():
        t = torch.from_numpy(v).to(torch.float32 if n in BIASES
                                   else TDT[dtype])
        out[n] = twp.pad_tiles(t) if n in PADDED else t
    return out


def _run_jax(kind, j, d, cond_index, n_valid):
    a = (j["w_in"], j["b_in"])
    if kind == "padded":
        xo, so = jwp.wn_layer_padded(j["x"], j["cond"], *a, j["w_rs"],
                                     j["b_rs"], d, cond_index,
                                     interpret=True, n_valid=n_valid)
        return {"x": xo, "skip": so}
    args = (j["x"], j["spect"], *a, j["w_cond"], j["b_cond"], j["w_rs"],
            j["b_rs"], j["acc"])
    if kind == "final":
        return {"out": jwp.wn_layer_stream_final(
            *args, j["w_end"], j["b_end"], d, interpret=True,
            n_valid=n_valid)}
    fn = jwp.wn_layer_spect if kind == "spect" else jwp.wn_layer_stream
    xo, so = fn(*args, d, interpret=True, n_valid=n_valid)
    return {"x": xo, "skip": so}


def _run_port(kind, t, d, cond_index, n_valid):
    a = (t["w_in"], t["b_in"])
    if kind == "padded":
        xo, so = twp.wn_layer_padded(t["x"], t["cond"], *a, t["w_rs"],
                                     t["b_rs"], d, cond_index,
                                     n_valid=n_valid)
        return {"x": xo, "skip": so}
    args = (t["x"], t["spect"], *a, t["w_cond"], t["b_cond"], t["w_rs"],
            t["b_rs"], t["acc"])
    if kind == "final":
        return {"out": twp.wn_layer_stream_final(
            *args, t["w_end"], t["b_end"], d, n_valid=n_valid)}
    fn = twp.wn_layer_spect if kind == "spect" else twp.wn_layer_stream
    xo, so = fn(*args, d, n_valid=n_valid)
    return {"x": xo, "skip": so}


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


# (kernel, dtype, d, rs_out, cond_index, n_valid): d in {1, the largest
# dilation}, both w_rs widths, cond_index > 0, n_valid short of T (and whole
# once per kernel)
CASES = [
    (kind, dtype, d, rs, ci, nv)
    for kind in KERNELS
    for dtype in ("float32", "bfloat16")
    for d, rs, ci, nv in ((1, 2 * C, 1, T), (128, C if kind != "final"
                                              else C, 2, N_VALID))
] + [("padded", "float32", 128, 2 * C, 2, N_VALID),
     ("spect", "bfloat16", 128, 2 * C, 0, N_VALID),
     ("stream", "float32", 64, 2 * C, 0, N_VALID)]


@pytest.fixture(scope="module")
def pallas_cache():
    return {}


@pytest.mark.parametrize("kind,dtype,d,rs_out,cond_index,n_valid", CASES)
def test_plain_matches_pallas(pallas_cache, kind, dtype, d, rs_out,
                              cond_index, n_valid):
    if kind == "final":
        rs_out = C
    seed = 7 + d + rs_out + cond_index
    k = _inputs(seed, rs_out, n_valid)
    key = (kind, dtype, d, rs_out, cond_index, n_valid)
    if key not in pallas_cache:
        pallas_cache[key] = _run_jax(kind, _jax(k, dtype), d, cond_index,
                                     n_valid)
    want = pallas_cache[key]
    got = _run_port(kind, _torch(k, dtype), d, cond_index, n_valid)
    for name, g in got.items():
        w = jwp.unpad_tiles(want[name])
        g_real = twp.unpad_tiles(g)
        # the pad tiles of every output are zero
        assert not g[:, : twp.BT_PAD].any() and not g[:, -twp.BT_PAD:].any()
        atol = ATOL_FINAL[dtype] if kind == "final" else ATOL[dtype]
        np.testing.assert_allclose(_np(g_real), _np(w), atol=atol,
                                   err_msg=f"{kind} {name}")
        if name == "x":
            assert not g_real[:, n_valid:].any()


def _f32(seed, rs_out, n_valid=N_VALID):
    return _torch(_inputs(seed, rs_out, n_valid), "float32")


@pytest.mark.parametrize("d,rs_out", [(1, 2 * C), (128, 2 * C), (33, C)])
def test_ladder_spect_equals_stream(d, rs_out):
    """Rung 13 vs 14: two loop structures, one contract (f32: 1e-5)."""
    t = _f32(60 + d, rs_out)
    args = (t["x"], t["spect"], t["w_in"], t["b_in"], t["w_cond"],
            t["b_cond"], t["w_rs"], t["b_rs"], t["acc"], d)
    xa, sa = twp.wn_layer_spect(*args, n_valid=N_VALID)
    xb, sb = twp.wn_layer_stream(*args, n_valid=N_VALID)
    np.testing.assert_allclose(xa.numpy(), xb.numpy(), atol=1e-5)
    np.testing.assert_allclose(sa.numpy(), sb.numpy(), atol=1e-5)


@pytest.mark.parametrize("d", [1, 128])
def test_ladder_stream_plus_end_equals_stream_final(d):
    """Rung 14 + an explicit end matmul vs 15 on the real rows (f32)."""
    t = _f32(70 + d, C)
    args = (t["x"], t["spect"], t["w_in"], t["b_in"], t["w_cond"],
            t["b_cond"], t["w_rs"], t["b_rs"])
    _, skip = twp.wn_layer_stream(*args, t["acc"], d, n_valid=N_VALID)
    want = skip @ t["w_end"] + t["b_end"]
    got = twp.wn_layer_stream_final(*args, t["acc"], t["w_end"], t["b_end"],
                                    d, n_valid=N_VALID)
    np.testing.assert_allclose(twp.unpad_tiles(got).numpy(),
                               twp.unpad_tiles(want).numpy(), atol=1e-5)


@pytest.mark.parametrize("d,rs_out", [(1, 2 * C), (128, 2 * C), (16, C)])
def test_ladder_unpadded_layer_equals_stream(d, rs_out):
    """The unpadded standard layer (kernel 2's plain version) vs rung 14 on
    the valid rows (f32: 1e-5)."""
    t = _f32(80 + d, rs_out)
    u = {n: twp.unpad_tiles(v) if n in PADDED else v for n, v in t.items()}
    args = ("spect", "w_in", "b_in", "w_cond", "b_cond", "w_rs", "b_rs")
    xa, sa = twb.wn_layer_plain(u["x"], *(u[n] for n in args), u["acc"], d,
                                n_valid=N_VALID)
    xb, sb = twp.wn_layer_stream(t["x"], *(t[n] for n in args), t["acc"], d,
                                 n_valid=N_VALID)
    np.testing.assert_allclose(xa.numpy(), twp.unpad_tiles(xb).numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(sa[:, :N_VALID].numpy(),
                               twp.unpad_tiles(sb)[:, :N_VALID].numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("d", [1, 128])
def test_ladder_unpadded_final_equals_stream_final(d):
    """The unpadded final layer (kernel 3's plain version, end projection
    folded) vs rung 15 on the valid rows (f32: 1e-5)."""
    t = _f32(90 + d, C)
    u = {n: twp.unpad_tiles(v) if n in PADDED else v for n, v in t.items()}
    w_eff, b_eff = twb.fold_end(t["w_rs"], t["b_rs"], t["w_end"],
                                t["b_end"])
    want = twb.wn_layer_final_plain(u["x"], u["spect"], u["w_in"],
                                    u["b_in"], u["w_cond"], u["b_cond"],
                                    w_eff, u["acc"], u["w_end"], b_eff, d,
                                    n_valid=N_VALID)
    got = twp.wn_layer_stream_final(
        t["x"], t["spect"], t["w_in"], t["b_in"], t["w_cond"], t["b_cond"],
        t["w_rs"], t["b_rs"], t["acc"], t["w_end"], t["b_end"], d,
        n_valid=N_VALID)
    np.testing.assert_allclose(twp.unpad_tiles(got)[:, :N_VALID].numpy(),
                               want[:, :N_VALID].numpy(), atol=1e-5)


@pytest.mark.parametrize("d,cond_index", [(1, 0), (128, 2)])
def test_ladder_dcond_equals_padded(d, cond_index):
    """Kernel 9's plain version vs rung 12 with the same stacked
    conditioning; rung 12 returns the skip alone, so kernel 9 starts from
    a zero skip sum (f32: 1e-5)."""
    t = _f32(100 + d, 2 * C)
    u = {n: twp.unpad_tiles(v) if n in PADDED else v for n, v in t.items()}
    xa, sa = twd.wn_layer_dcond_plain(
        u["x"], u["cond"], cond_index, u["w_in"], u["b_in"], u["w_rs"],
        u["b_rs"], torch.zeros_like(u["x"]), d, n_valid=N_VALID)
    xb, sb = twp.wn_layer_padded(t["x"], t["cond"], t["w_in"], t["b_in"],
                                 t["w_rs"], t["b_rs"], d, cond_index,
                                 n_valid=N_VALID)
    np.testing.assert_allclose(xa.numpy(), twp.unpad_tiles(xb).numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(sa[:, :N_VALID].numpy(),
                               twp.unpad_tiles(sb)[:, :N_VALID].numpy(),
                               atol=1e-5)


def test_pad_tiles_round_trip_and_layout_errors():
    x = torch.randn(2, 256, 8)
    xp = twp.pad_tiles(x)
    assert xp.shape == (2, 256 + 2 * twp.BT_PAD, 8)
    assert torch.equal(twp.unpad_tiles(xp), x)
    assert not xp[:, : twp.BT_PAD].any() and not xp[:, -twp.BT_PAD:].any()
    with pytest.raises(ValueError, match="multiple of the pad tile"):
        twp.pad_tiles(torch.zeros(1, 100, 8))


def test_cpu_wrappers_count_no_launches_and_mixed_devices_raise():
    twp.reset_launch_counts()
    t = _f32(110, 2 * C)
    args = [t["x"], t["cond"], t["w_in"], t["b_in"], t["w_rs"], t["b_rs"], 1]
    twp.wn_layer_padded(*args)
    assert twp.launch_counts() == {"wn_layer_padded": 0, "wn_layer_spect": 0,
                                   "wn_layer_stream": 0,
                                   "wn_layer_stream_final": 0}
    args[1] = args[1].to("meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        twp.wn_layer_padded(*args)


@pytest.mark.parametrize("module,lib", [
    ("wn_block_padded", "LIB_SM90"), ("wn_block_padded", "LIB_TILES"),
    ("gated", "LIB"), ("vits_conv", "LIB")])
def test_ctypes_signatures_match_the_c_interface(module, lib):
    """Every ``t2s_*`` function the library's C source exports has the
    argument list its wrapper module declares to ctypes (pointers and the
    stream as ``c_void_p``, ``int``, ``long long`` and ``float`` as their
    ctypes widths): a miscount or a wrong width is caught here, not on a
    card."""
    import ctypes
    import importlib
    import re

    lib = getattr(importlib.import_module(
        f"text2speech_tpu_torch.ops.{module}"), lib)
    src = re.sub(r"//[^\n]*", "", lib.source.read_text())
    decls = dict(re.findall(r"^(?:int|size_t) (t2s_\w+)\(([^)]*)\)", src,
                            re.M))
    assert decls and set(decls) == set(lib.signatures)
    scalar = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
              "float": ctypes.c_float}
    for name, params in decls.items():
        kinds = [ctypes.c_void_p if "*" in p
                 else scalar[" ".join(p.split()[:-1])]
                 for p in params.split(",")]
        assert kinds == lib.signatures[name], name
