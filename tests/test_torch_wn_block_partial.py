"""Parity of the port's plain tensor-parallel partial WN layers
(``text2speech_tpu_torch.ops.wn_block.wn_layer_partial`` and
``ops.wn_block_int8.wn_layer_partial_int8``) with the JAX package's Pallas
kernels ``wn_layer_stream2_partial`` / ``wn_layer_stream2_partial_int8``,
which run here in interpret mode.

Inputs are made with numpy from a seed and handed to both sides; a rank's
share is cut from the whole layer's weights by the gate-paired columns of
``parallel.tp.pair_cols``.  Rows past ``n_valid`` of the hidden state are
zero, as the TP path leaves them.

Tolerances.  Floating point: both sides compute float32 matmuls over the
same values in another order at activations of order 1 and contractions of
at most 3C + M terms: 2e-5 absolute (the whole-layer file's bound).  int8:
the integer products are exact on both sides; a gated value on a
round-half-even knife edge may land one count apart, which moves an output
by at most one weight scale (~0.004 here), so the f32 partial is held to
0.02 absolute, the JAX tests' bound for the final int8 layer's f32 output,
and to a mean absolute difference under 1e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text2speech_tpu.ops.pallas import wn_block as jwb
from text2speech_tpu.ops.pallas import wn_block_int8 as jq
from text2speech_tpu_torch.ops import wn_block as twb
from text2speech_tpu_torch.ops import wn_block_int8 as tq
from text2speech_tpu_torch.parallel.tp import pair_cols

torch.set_num_threads(1)

B, C, M = 2, 64, 48
ATOL = 2e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _layer(seed: int, T: int, n_valid: int, rs_out: int, n_half=None):
    rng = np.random.RandomState(seed)
    mask = (np.arange(T) < n_valid)[None, :, None]

    def rn(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    k = {"spect": rn(B, T, M, scale=0.1) * mask,
         "x": rn(B, T, C, scale=0.1) * mask,
         "w_in": rn(3, C, 2 * C, scale=0.05), "b_in": rn(2 * C, scale=0.05),
         "w_cond": rn(M, 2 * C, scale=0.05), "b_cond": rn(2 * C, scale=0.05),
         "w_rs": rn(C, rs_out, scale=0.05), "b_rs": rn(rs_out, scale=0.05)}
    if n_half is not None:
        k["x0"] = rn(B, T, n_half, scale=0.3) * mask
        k["start_k"] = rn(n_half, C, scale=0.2)
        k["start_b"] = rn(C, scale=0.2)
    return k


def _share(k, p: int, i: int):
    """Rank i's slices of the whole layer's weights."""
    cols, s = pair_cols(C, p, i), C // p
    return {"w_in": k["w_in"][..., cols], "b_in": k["b_in"][cols],
            "w_cond": k["w_cond"][:, cols], "b_cond": k["b_cond"][cols],
            "w_rs": k["w_rs"][i * s:(i + 1) * s]}


@pytest.mark.parametrize("p,d,rs_full,n_valid", [
    (2, 1, True, 2 * 512), (2, 128, False, 2 * 512 - 77),
    (4, 4, True, 2 * 512 - 300), (4, 64, False, 2 * 512)])
def test_partial_plain_matches_pallas(p, d, rs_full, n_valid):
    T = 2 * 512
    k = _layer(100 + p + d, T, n_valid, 2 * C if rs_full else C)
    for i in range(p):
        sh = _share(k, p, i)
        names = ["w_in", "b_in", "w_cond", "b_cond", "w_rs"]
        want = jwb.wn_layer_stream2_partial(
            jnp.asarray(k["x"]), jnp.asarray(k["spect"]),
            *[jnp.asarray(sh[n]) for n in names], d, n_valid=n_valid)
        got = twb.wn_layer_partial(
            _t(k["x"]), _t(k["spect"]), *[_t(sh[n]) for n in names], d,
            n_valid=n_valid)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        assert (got[:, n_valid:] == 0).all()


@pytest.mark.parametrize("p,n_half,n_valid", [(2, 4, 512 - 60), (4, 2, 512)])
def test_partial_first_form_matches_pallas(p, n_half, n_valid):
    """The layer-0 form: K = n_half composed taps with the edge-bias rows,
    each side folding the start projection by its own fold."""
    T = 512
    k = _layer(200 + p, T, n_valid, 2 * C, n_half=n_half)
    for i in range(p):
        sh = _share(k, p, i)
        wp, b_extra, b_edge = jwb._fold_first_taps(
            jnp.asarray(k["start_k"]), jnp.asarray(k["start_b"]),
            jnp.asarray(sh["w_in"]))
        want = jwb.wn_layer_stream2_partial(
            jnp.asarray(k["x0"]), jnp.asarray(k["spect"]), wp,
            jnp.asarray(sh["b_in"]) + b_extra, jnp.asarray(sh["w_cond"]),
            jnp.asarray(sh["b_cond"]), jnp.asarray(sh["w_rs"]), 1,
            b_edge=b_edge, n_valid=n_valid)
        twp, tb_all, tb_edge = twb.fold_first_taps(
            _t(k["start_k"]), _t(k["start_b"]), _t(sh["w_in"]),
            _t(sh["b_in"]))
        np.testing.assert_allclose(twp.numpy(), np.asarray(wp), atol=1e-6)
        np.testing.assert_allclose(tb_edge.numpy(), np.asarray(b_edge),
                                   atol=1e-6)
        got = twb.wn_layer_partial(
            _t(k["x0"]), _t(k["spect"]), twp, tb_all, _t(sh["w_cond"]),
            _t(sh["b_cond"]), _t(sh["w_rs"]), 1, b_edge=tb_edge,
            n_valid=n_valid)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("rs_full", [True, False])
def test_partials_sum_to_the_whole_layer(p, rs_full):
    """Sum of the ranks' partials + the res/skip bias == the whole plain
    layer's residual and skip terms (f32, another summation order)."""
    T, n_valid, d = 300, 260, 8
    rs_out = 2 * C if rs_full else C
    k = _layer(300 + p, T, n_valid, rs_out)
    names = ["w_in", "b_in", "w_cond", "b_cond", "w_rs"]
    total = sum(
        twb.wn_layer_partial(
            _t(k["x"]), _t(k["spect"]),
            *[_t(_share(k, p, i)[n]) for n in names], d, n_valid=n_valid)
        for i in range(p)) + _t(k["b_rs"])
    acc = torch.zeros(B, T, C)
    x_new, skip = twb.wn_layer_plain(
        _t(k["x"]), _t(k["spect"]), _t(k["w_in"]), _t(k["b_in"]),
        _t(k["w_cond"]), _t(k["b_cond"]), _t(k["w_rs"]), _t(k["b_rs"]), acc,
        d, n_valid=n_valid)
    if rs_full:
        np.testing.assert_allclose(
            (_t(k["x"]) + total[..., :C])[:, :n_valid].numpy(),
            x_new[:, :n_valid].numpy(), atol=ATOL)
        np.testing.assert_allclose(total[:, :n_valid, C:].numpy(),
                                   skip[:, :n_valid].numpy(), atol=ATOL)
    else:
        np.testing.assert_allclose(total[:, :n_valid].numpy(),
                                   skip[:, :n_valid].numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------


def _quantized_share(k, p: int, i: int):
    """Rank i's slices quantized per rank by the JAX ``quantize_cols``, as
    ``shard_waveglow_params(int8=True)`` does -> numpy (q, s) pairs in the
    JAX ``[.., K, N]`` layout."""
    sh = _share(k, p, i)
    out = {}
    for name in ("w_in", "w_cond", "w_rs"):
        q, s = jq.quantize_cols(jnp.asarray(sh[name]))
        out[name] = (np.asarray(q), np.asarray(s))
    out["b_in"], out["b_cond"] = sh["b_in"], sh["b_cond"]
    return out


@pytest.mark.parametrize("p,d,rs_full,n_valid", [
    (2, 2, True, 512 - 100), (4, 128, False, 512), (4, 16, True, 512 - 1)])
def test_partial_int8_plain_matches_pallas(p, d, rs_full, n_valid):
    T = 512
    k = _layer(400 + p + d, T, n_valid, 2 * C if rs_full else C)
    k["x"] *= 10.0          # row scales well above the floor
    qx, sx = jq.quantize_rows(jnp.asarray(k["x"]))
    qsp, ssp = jq.quantize_rows(jnp.asarray(k["spect"]))
    for i in (0, p - 1):
        q = _quantized_share(k, p, i)
        want = jq.wn_layer_stream2_partial_int8(
            qx, sx, qsp, ssp, jnp.asarray(q["w_in"][0]),
            jnp.asarray(q["w_in"][1]), jnp.asarray(q["b_in"]),
            jnp.asarray(q["w_cond"][0]), jnp.asarray(q["w_cond"][1]),
            jnp.asarray(q["b_cond"]), jnp.asarray(q["w_rs"][0]),
            jnp.asarray(q["w_rs"][1]), d, n_valid=n_valid)
        got = tq.wn_layer_partial_int8(
            _t(qx), _t(sx), _t(qsp), _t(ssp),
            tq.to_output_major(_t(q["w_in"][0])), _t(q["w_in"][1]),
            _t(q["b_in"]), tq.to_output_major(_t(q["w_cond"][0])),
            _t(q["w_cond"][1]), _t(q["b_cond"]),
            tq.to_output_major(_t(q["w_rs"][0])), _t(q["w_rs"][1]), d,
            n_valid=n_valid)
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.max() <= 0.02, diff.max()
        assert diff.mean() < 1e-4, diff.mean()
        assert (got[:, n_valid:] == 0).all()


def test_int8_partials_dequantize_by_their_own_scales():
    """Every rank dequantizes with ITS res/skip scales, so the sum of the
    int8 partials tracks the sum of the floating-point partials within the
    quantization error (a few percent of the output's spread), although
    the ranks' scales differ."""
    T, n_valid, d, p = 256, 256, 4, 4
    k = _layer(500, T, n_valid, 2 * C)
    k["x"] *= 10.0
    # give the ranks res/skip rows of very different magnitude
    for i in range(p):
        k["w_rs"][i * (C // p):(i + 1) * (C // p)] *= 2.0 ** i
    qx, sx = tq.quantize_rows(_t(k["x"]))
    qsp, ssp = tq.quantize_rows(_t(k["spect"]))
    names = ["w_in", "b_in", "w_cond", "b_cond", "w_rs"]
    fp = sum(twb.wn_layer_partial(
        _t(k["x"]), _t(k["spect"]), *[_t(_share(k, p, i)[n]) for n in names],
        d) for i in range(p))
    q8, scales = 0, []
    for i in range(p):
        sh = _share(k, p, i)
        (qi, si), (qc, sc), (qr, sr) = [tq.quantize_cols(_t(sh[n]))
                                        for n in ("w_in", "w_cond", "w_rs")]
        scales.append(sr.mean().item())
        q8 = q8 + tq.wn_layer_partial_int8(
            qx, sx, qsp, ssp, tq.to_output_major(qi), si, _t(sh["b_in"]),
            tq.to_output_major(qc), sc, _t(sh["b_cond"]),
            tq.to_output_major(qr), sr, d)
    assert scales[-1] > 4 * scales[0]
    err = ((q8 - fp).norm() / fp.norm()).item()
    assert err < 0.05, err


def test_cpu_partial_wrappers_count_no_launches():
    from text2speech_tpu_torch.parallel import tp

    tp.reset_launch_counts()
    k = _layer(600, 64, 64, 2 * C)
    sh = _share(k, 2, 0)
    names = ["w_in", "b_in", "w_cond", "b_cond", "w_rs"]
    twb.wn_layer_partial(_t(k["x"]), _t(k["spect"]),
                         *[_t(sh[n]) for n in names], 1)
    assert tp.launch_counts() == {"wn_layer_partial": 0,
                                  "wn_layer_partial_int8": 0}
