"""Parity of the port's plain composed-conditioning WN layers
(``text2speech_tpu_torch.ops.wn_block_dcond``) with the JAX package's Pallas
kernels (``text2speech_tpu.ops.pallas.wn_block_dcond``), which run here in
interpret mode as in ``tests/test_pallas.py``.

Inputs are made with numpy from a seed and fed to both sides; rows past
``n_valid`` of the hidden state are zero, as the serving path leaves them.
``cond_all`` [B, T, 2C * L] holds L = 3 layers' conditioning; a layer reads
its slice.

Tolerances.  float32: both sides compute float32 products over the same
values with float32 accumulation in another order, at activations of order
1 and contractions of at most 3C = 192 terms: 2e-5 absolute.  bfloat16: the
inputs are rounded to bf16 once (the same values on both sides); products
accumulate in float32 on both sides, ``cond_all`` is widened to float32 at
the same place, and the gated activation and the outputs round to bf16 at
the same places, so the two differ where a float32 sum in another order
falls on the other side of a bf16 rounding boundary: one bf16 step (2^-8 of
the value) on the hidden state and the skip sum, whose values stay under 2
(8e-3), and 2e-3 on the final layer's float32 output, which sums C = 64
gated values each off by at most one step of 2^-9."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text2speech_tpu.ops.pallas import wn_block_dcond as jwd
from text2speech_tpu_torch.ops import wn_block as twb
from text2speech_tpu_torch.ops import wn_block_dcond as twd

torch.set_num_threads(1)

B, C, L = 2, 64, 3
ATOL = {"float32": 2e-5, "bfloat16": 8e-3}
ATOL_FINAL = {"float32": 2e-5, "bfloat16": 2e-3}


def _inputs(seed: int, T: int, n_valid: int, rs_out: int, n_half=None,
            E=None):
    rng = np.random.RandomState(seed)
    mask = (np.arange(T) < n_valid)[None, :, None]

    def rn(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    k = {
        "cond_all": rn(B, T, 2 * C * L, scale=0.3),
        "w_in": rn(3, C, 2 * C, scale=0.05),
        "b_in": rn(2 * C, scale=0.05),
        "w_rs": rn(C, rs_out, scale=0.05),
        "b_rs": rn(rs_out, scale=0.05),
        "acc": rn(B, T, C, scale=0.1) * mask,
        "x": rn(B, T, C, scale=0.1) * mask,
    }
    if n_half is not None:
        k["x0"] = rn(B, T, n_half, scale=0.3) * mask
        k["start_k"] = rn(n_half, C, scale=0.2)
        k["start_b"] = rn(C, scale=0.2)
    if E is not None:
        k["w_end"] = rn(C, E, scale=0.05)
        k["b_end"] = rn(E, scale=0.05)
    return k


BIASES = ("b_in", "b_rs", "start_b", "b_end")


def _both(k, names, dtype: str):
    """(jax arrays, torch tensors): weights and activations in ``dtype``,
    biases float32, as the serving path hands them over."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ja, ta = [], []
    for n in names:
        keep = n in BIASES
        ja.append(jnp.asarray(k[n], jnp.float32 if keep else jdt))
        ta.append(torch.from_numpy(k[n]).to(torch.float32 if keep else tdt))
    return ja, ta


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_half,T,n_valid,d", [
    (2, 2 * 512, 2 * 512, 1),
    (4, 3 * 512, 3 * 512 - 300, 1),
    (3, 2 * 512, 2 * 512 - 77, 128),
])
def test_first_dcond_plain_matches_pallas(dtype, n_half, T, n_valid, d):
    k = _inputs(10 + n_half + d, T, n_valid, 2 * C, n_half=n_half)
    names = ["x0", "cond_all", "start_k", "start_b", "w_in", "b_in", "w_rs",
             "b_rs"]
    ja, ta = _both(k, names, dtype)
    want_x, want_s = jwd.wn_layer_stream2_first_dcond(*ja, d, interpret=True,
                                                      n_valid=n_valid)
    x0, cond_all, start_k, start_b, w_in, b_in, w_rs, b_rs = ta
    fold = twb.fold_first_taps(start_k, start_b, w_in, b_in)
    got_x, got_s = twd.wn_layer_first_dcond(
        x0, cond_all, start_k, start_b, *fold, w_rs, b_rs, d, n_valid=n_valid)
    assert got_x.dtype == cond_all.dtype
    np.testing.assert_allclose(_np(got_x), _np(want_x), atol=ATOL[dtype])
    assert not got_x[:, n_valid:].any()
    np.testing.assert_allclose(_np(got_s)[:, :n_valid],
                               _np(want_s)[:, :n_valid], atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,rs_full,li", [(1, True, 0), (128, True, L - 1),
                                          (16, False, 1)])
def test_standard_dcond_plain_matches_pallas(dtype, d, rs_full, li):
    T = 3 * 512
    n_valid = T - 200
    rs_out = 2 * C if rs_full else C
    k = _inputs(20 + d + rs_out, T, n_valid, rs_out)
    ja, ta = _both(k, ["x", "cond_all", "w_in", "b_in", "w_rs", "b_rs",
                       "acc"], dtype)
    want_x, want_s = jwd.wn_layer_stream2_dcond(
        ja[0], ja[1], li, *ja[2:], d, interpret=True, n_valid=n_valid)
    got_x, got_s = twd.wn_layer_dcond(ta[0], ta[1], li, *ta[2:], d,
                                      n_valid=n_valid)
    np.testing.assert_allclose(_np(got_x), _np(want_x), atol=ATOL[dtype])
    assert not got_x[:, n_valid:].any()
    np.testing.assert_allclose(_np(got_s)[:, :n_valid],
                               _np(want_s)[:, :n_valid], atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,E,n_valid,li", [(1, 8, 2 * 512, 0),
                                            (128, 4, 900, L - 1)])
def test_final_dcond_plain_matches_pallas(dtype, d, E, n_valid, li):
    T = 2 * 512
    k = _inputs(30 + d + E, T, n_valid, C, E=E)
    ja, ta = _both(k, ["x", "cond_all", "w_in", "b_in", "w_rs", "b_rs", "acc",
                       "w_end", "b_end"], dtype)
    want = jwd.wn_layer_stream2_final_dcond(
        ja[0], ja[1], li, *ja[2:], d, interpret=True, n_valid=n_valid)
    x, cond_all, w_in, b_in, w_rs, b_rs, acc, w_end, b_end = ta
    w_eff, b_eff = twb.fold_end(w_rs, b_rs, w_end, b_end)
    got = twd.wn_layer_final_dcond(x, cond_all, li, w_in, b_in, w_eff, acc,
                                   w_end, b_eff, d, n_valid=n_valid)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got)[:, :n_valid], _np(want)[:, :n_valid],
                               atol=ATOL_FINAL[dtype])


def test_dcond_equals_projecting_layer_on_projected_cond():
    """The dcond layer on ``cond_all = spect @ w_cond + b_cond`` (float32,
    so nothing is rounded) is the projecting layer: 1e-6 (one more float32
    sum in another order)."""
    T, n_valid, d, M = 300, 250, 4, 24
    k = _inputs(70, T, n_valid, 2 * C)
    rng = np.random.RandomState(71)
    spect = torch.from_numpy(rng.randn(B, T, M).astype(np.float32) * 0.3)
    w_cond = torch.from_numpy(rng.randn(M, 2 * C * L).astype(np.float32) * .1)
    b_cond = torch.from_numpy(rng.randn(2 * C * L).astype(np.float32) * 0.1)
    cond_all = spect @ w_cond + b_cond
    t = {n: torch.from_numpy(v) for n, v in k.items()}
    li = 1
    cols = slice(2 * C * li, 2 * C * (li + 1))
    want_x, want_s = twb.wn_layer(
        t["x"], spect, t["w_in"], t["b_in"], w_cond[:, cols], b_cond[cols],
        t["w_rs"], t["b_rs"], t["acc"], d, n_valid=n_valid)
    got_x, got_s = twd.wn_layer_dcond(
        t["x"], cond_all, li, t["w_in"], t["b_in"], t["w_rs"], t["b_rs"],
        t["acc"], d, n_valid=n_valid)
    np.testing.assert_allclose(got_x.numpy(), want_x.numpy(), atol=1e-6)
    np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), atol=1e-6)


def test_dcond_rows_past_n_valid_are_ignored():
    """Input rows at or past n_valid reach no valid output row, whatever
    they hold, in the hidden state or in cond_all."""
    T, n_valid, d = 300, 250, 64
    k = _inputs(40, T, n_valid, 2 * C)
    t = {n: torch.from_numpy(v) for n, v in k.items()}
    args = (t["w_in"], t["b_in"], t["w_rs"], t["b_rs"], t["acc"], d)
    x_a, s_a = twd.wn_layer_dcond(t["x"], t["cond_all"], 2, *args,
                                  n_valid=n_valid)
    junk_x, junk_c = t["x"].clone(), t["cond_all"].clone()
    junk_x[:, n_valid:] = 7.0
    junk_c[:, n_valid:] = -3.0
    x_b, s_b = twd.wn_layer_dcond(junk_x, junk_c, 2, *args, n_valid=n_valid)
    assert torch.equal(x_a, x_b)
    assert (x_b[:, n_valid:] == 0).all()
    assert torch.equal(s_a[:, :n_valid], s_b[:, :n_valid])


def test_dcond_cpu_wrappers_count_no_launches_and_mixed_devices_raise():
    twd.reset_launch_counts()
    T = 32
    k = _inputs(50, T, T, 2 * C)
    t = {n: torch.from_numpy(v) for n, v in k.items()}
    args = [t["x"], t["cond_all"], 0, t["w_in"], t["b_in"], t["w_rs"],
            t["b_rs"], t["acc"], 1]
    twd.wn_layer_dcond(*args)
    assert twd.launch_counts() == {"wn_layer_first_dcond": 0,
                                   "wn_layer_dcond": 0,
                                   "wn_layer_final_dcond": 0}
    args[1] = args[1].to("meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        twd.wn_layer_dcond(*args)
