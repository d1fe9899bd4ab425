"""Parity of the port's int8 quantizers and plain int8 WN-layer versions
(``text2speech_tpu_torch.ops.wn_block_int8``) with the JAX package's
(``text2speech_tpu.ops.pallas.wn_block_int8``), whose Pallas kernels run
here in interpret mode as in ``tests/test_int8_vocoder.py``.

Inputs are made with numpy from a seed at that file's sizes (C=256, M=128,
T of one or two 512-row tiles) and handed to both sides: the same int8
payloads, scales and weights.  The port takes int8 weights output-major,
so it gets the transposes.

Tolerances are the JAX tests' own (``tests/test_int8_vocoder.py:127-137,
256-258``).  The integer products are exact on both sides; what differs is
the order of a few f32 operations around them (scale products, the gate,
the residual add), which can move a value across a round-half-even knife
edge: int8 payloads within 1 count with mean absolute difference under
0.01, row scales to 1e-3 relative, the bf16 skip sum to 0.09 (one bf16 step
at its magnitude of ~4-8 is 0.03-0.06), the final layer's f32 output to
0.02 (a gate value that flips one bf16 step times w_eff of order 1).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text2speech_tpu.ops.pallas import wn_block_int8 as jq
from text2speech_tpu_torch.ops import wn_block as twb
from text2speech_tpu_torch.ops import wn_block_int8 as tq

torch.set_num_threads(1)

B, C, M = 1, 256, 128


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16), both round-to-nearest-even."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _rows(rng, T, width, n_valid):
    """f32 [B, T, width], zero at rows >= n_valid, quantized per row by the
    JAX function -> (q int8, s f32) as numpy."""
    x = rng.randn(B, T, width).astype(np.float32)
    x = x * (np.arange(T) < n_valid)[None, :, None]
    q, s = jq.quantize_rows(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _cols(rng, *shape):
    """f32 weights [..., K, N] quantized per output column by the JAX
    function -> (q int8, s f32) as numpy."""
    q, s = jq.quantize_cols(
        jnp.asarray(rng.randn(*shape).astype(np.float32) * 0.1))
    return np.asarray(q), np.asarray(s)


def _vec(rng, n):
    return rng.randn(n).astype(np.float32) * 0.1


def _out_major(q):
    return _t(np.swapaxes(q, -1, -2))


def _payload_close(got: torch.Tensor, want, n_rows: int):
    diff = np.abs(got.numpy()[:, :n_rows].astype(np.int32)
                  - np.asarray(want)[:, :n_rows].astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert diff.mean() < 0.01, diff.mean()


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


def test_quantize_rows_bit_equal():
    """Same f32 operations in the same order (abs-max, max with eps, times
    1/127, divide, round half to even): equal bit for bit, an all-zero row
    included (q = 0, scale = 1e-12 / 127)."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 50, 96).astype(np.float32) * rng.rand(3, 50, 1).astype(
        np.float32) * 4
    x[1, 7] = 0.0
    x[0, 3, :] = 0.5          # every element on the amax
    jq_, js = jq.quantize_rows(jnp.asarray(x))
    q, s = tq.quantize_rows(_t(x))
    assert q.dtype == torch.int8 and s.shape == (3, 50, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (q[1, 7] == 0).all()
    assert s[1, 7, 0].item() == np.float32(1e-12) * np.float32(1.0 / 127.0)
    q2, s2 = tq.rowquant_f32(_t(x))
    assert torch.equal(q2, q) and torch.equal(s2, s)
    # a bf16 input is quantized from its f32 value
    xb = _t(x).to(torch.bfloat16)
    qb, sb = tq.quantize_rows(xb)
    jqb, jsb = jq.quantize_rows(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(qb.numpy(), np.asarray(jqb))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jsb))


@pytest.mark.parametrize("shape", [(3, 64, 128), (48, 128), (1, 5, 7)])
def test_quantize_cols_bit_equal(shape):
    """One scale per output column over every other axis: the three taps
    of a conv share a column's scale."""
    rng = np.random.RandomState(len(shape))
    w = rng.randn(*shape).astype(np.float32) * 0.07
    w[..., 2] = 0.0           # a dead output column
    jq_, js = jq.quantize_cols(jnp.asarray(w))
    q, s = tq.quantize_cols(_t(w))
    assert s.shape == (shape[-1],)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    t = tq.to_output_major(q)
    assert t.is_contiguous() and t.shape[-2:] == (shape[-1], shape[-2])
    assert torch.equal(t.transpose(-1, -2), q)


# ---------------------------------------------------------------------------
# the three layers
# ---------------------------------------------------------------------------


def _std_weights(rng):
    qw_in, sw_in = _cols(rng, 3, C, 2 * C)
    qw_cond, sw_cond = _cols(rng, M, 2 * C)
    return qw_in, sw_in, _vec(rng, 2 * C), qw_cond, sw_cond, _vec(rng, 2 * C)


# (dilation, JAX tile-multiple T, n_valid, the port's T)
STD_CASES = [(1, 1024, 1024, 1024), (4, 1024, 900, 1024),
             (128, 1024, 777, 777), (64, 512, 300, 300)]


@pytest.mark.parametrize("d,T,n_valid,T_port", STD_CASES)
def test_standard_int8_plain_matches_pallas(d, T, n_valid, T_port):
    """``T_port < T``: the port takes exactly n_valid rows where the JAX
    side pads to its tile; the first n_valid rows agree."""
    rng = np.random.RandomState(d)
    qx, sx = _rows(rng, T, C, n_valid)
    qs, ss = _rows(rng, T, M, n_valid)
    qw_in, sw_in, b_in, qw_cond, sw_cond, b_cond = _std_weights(rng)
    qw_rs, sw_rs = _cols(rng, C, 2 * C)
    b_rs = _vec(rng, 2 * C)
    acc = rng.randn(B, T, C).astype(np.float32)
    jacc, tacc = _bf16(acc)

    wq, ws, wskip = jq.wn_layer_stream2_int8(
        *map(jnp.asarray, (qx, sx, qs, ss, qw_in, sw_in, b_in, qw_cond,
                           sw_cond, b_cond, qw_rs, sw_rs, b_rs)),
        jacc, dilation=d, n_valid=n_valid)
    cut = slice(0, T_port)
    gq, gs, gskip = tq.wn_layer_int8(
        _t(qx[:, cut]), _t(sx[:, cut]), _t(qs[:, cut]), _t(ss[:, cut]),
        _out_major(qw_in), _t(sw_in), _t(b_in), _out_major(qw_cond),
        _t(sw_cond), _t(b_cond), _out_major(qw_rs), _t(sw_rs), _t(b_rs),
        tacc[:, cut].contiguous(), d, n_valid=n_valid)
    assert gq.dtype == torch.int8 and gq.shape == (B, T_port, C)
    assert gs.shape == (B, T_port, 1) and gskip.dtype == torch.bfloat16
    _payload_close(gq, wq, T_port)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws)[:, cut], rtol=1e-3)
    np.testing.assert_allclose(
        gskip.float().numpy()[:, :n_valid],
        np.asarray(wskip, np.float32)[:, :n_valid], rtol=0, atol=0.09)


@pytest.mark.parametrize("n_half,T,n_valid,T_port",
                         [(2, 512, 512, 512), (3, 1024, 700, 700),
                          (4, 512, 450, 512)])
def test_first_int8_plain_matches_pallas(n_half, T, n_valid, T_port):
    rng = np.random.RandomState(10 + n_half)
    x0 = rng.randn(B, T, n_half).astype(np.float32)
    x0 = x0 * (np.arange(T) < n_valid)[None, :, None]
    jx0, tx0 = _bf16(x0)
    qs, ss = _rows(rng, T, M, n_valid)
    jsk, tsk = _bf16(rng.randn(n_half, C).astype(np.float32) * 0.3)
    start_b = _vec(rng, C)
    jw_in, tw_in = _bf16(rng.randn(3, C, 2 * C).astype(np.float32) * 0.1)
    b_in = _vec(rng, 2 * C)
    qw_cond, sw_cond = _cols(rng, M, 2 * C)
    b_cond = _vec(rng, 2 * C)
    qw_rs, sw_rs = _cols(rng, C, 2 * C)
    b_rs = _vec(rng, 2 * C)

    wq, ws, wskip = jq.wn_layer_stream2_first_int8(
        jx0, jnp.asarray(qs), jnp.asarray(ss), jsk, jnp.asarray(start_b),
        jw_in, jnp.asarray(b_in), jnp.asarray(qw_cond), jnp.asarray(sw_cond),
        jnp.asarray(b_cond), jnp.asarray(qw_rs), jnp.asarray(sw_rs),
        jnp.asarray(b_rs), dilation=1, n_valid=n_valid)
    cut = slice(0, T_port)
    fold = twb.fold_first_taps(tsk, _t(start_b), tw_in, _t(b_in))
    gq, gs, gskip = tq.wn_layer_first_int8(
        tx0[:, cut].contiguous(), _t(qs[:, cut]), _t(ss[:, cut]), tsk,
        _t(start_b), *fold, _out_major(qw_cond), _t(sw_cond), _t(b_cond),
        _out_major(qw_rs), _t(sw_rs), _t(b_rs), 1, n_valid=n_valid)
    assert gskip.dtype == torch.bfloat16
    _payload_close(gq, wq, T_port)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws)[:, cut], rtol=1e-3)
    np.testing.assert_allclose(
        gskip.float().numpy()[:, :n_valid],
        np.asarray(wskip, np.float32)[:, :n_valid], rtol=0, atol=0.09)


@pytest.mark.parametrize("E,d,T,n_valid,T_port",
                         [(8, 2, 512, 512, 512), (4, 128, 1024, 900, 900),
                          (6, 1, 512, 333, 512)])
def test_final_int8_plain_matches_pallas(E, d, T, n_valid, T_port):
    rng = np.random.RandomState(20 + E)
    qx, sx = _rows(rng, T, C, n_valid)
    qs, ss = _rows(rng, T, M, n_valid)
    qw_in, sw_in, b_in, qw_cond, sw_cond, b_cond = _std_weights(rng)
    jw_rs, tw_rs = _bf16(rng.randn(C, C).astype(np.float32) * 0.1)
    b_rs = _vec(rng, C)
    jw_end, tw_end = _bf16(rng.randn(C, E).astype(np.float32) * 0.1)
    b_end = _vec(rng, E)
    jacc, tacc = _bf16(rng.randn(B, T, C).astype(np.float32))

    want = jq.wn_layer_stream2_final_int8(
        *map(jnp.asarray, (qx, sx, qs, ss, qw_in, sw_in, b_in, qw_cond,
                           sw_cond, b_cond)),
        jw_rs, jnp.asarray(b_rs), jacc, jw_end, jnp.asarray(b_end),
        dilation=d, n_valid=n_valid)
    cut = slice(0, T_port)
    w_eff, b_eff = twb.fold_end(tw_rs, _t(b_rs), tw_end, _t(b_end))
    got = tq.wn_layer_final_int8(
        _t(qx[:, cut]), _t(sx[:, cut]), _t(qs[:, cut]), _t(ss[:, cut]),
        _out_major(qw_in), _t(sw_in), _t(b_in), _out_major(qw_cond),
        _t(sw_cond), _t(b_cond), w_eff, tacc[:, cut].contiguous(), tw_end,
        b_eff, d, n_valid=n_valid)
    assert got.dtype == torch.float32 and got.shape == (B, T_port, E)
    np.testing.assert_allclose(got.numpy()[:, :n_valid],
                               np.asarray(want)[:, :n_valid], rtol=0,
                               atol=0.02)


# ---------------------------------------------------------------------------
# what the port promises beyond the Pallas kernels
# ---------------------------------------------------------------------------


def _small_std(seed, T, n_valid, c=64, m=64):
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    mask = (torch.arange(T) < n_valid)[None, :, None]
    qx, sx = tq.quantize_rows(rn(2, T, c) * mask)
    qs, ss = tq.quantize_rows(rn(2, T, m) * mask)
    ws = []
    for shape in ((3, c, 2 * c), (m, 2 * c), (c, 2 * c)):
        q, s = tq.quantize_cols(rn(*shape, scale=0.1))
        ws += [tq.to_output_major(q), s, rn(2 * c, scale=0.1)]
    acc = (rn(2, T, c) * mask).to(torch.bfloat16)
    return [qx, sx, qs, ss, *ws, acc]


def test_masked_rows_store_zero_payload_and_floor_scale():
    """Rows at or past n_valid are zeroed BEFORE the requantization: q = 0
    and scale = 1e-12 / 127, and whatever an input holds there reaches no
    valid row."""
    T, n_valid, d = 300, 250, 64
    args = _small_std(1, T, n_valid)
    qa, sa, ka = tq.wn_layer_int8(*args, d, n_valid=n_valid)
    assert (qa[:, n_valid:] == 0).all()
    floor = np.float32(1e-12) * np.float32(1.0 / 127.0)
    assert (sa[:, n_valid:] == float(floor)).all()
    junk = list(args)
    junk[0] = args[0].clone()
    junk[0][:, n_valid:] = 99
    junk[1] = args[1].clone()
    junk[1][:, n_valid:] = 5.0
    qb, sb, kb = tq.wn_layer_int8(*junk, d, n_valid=n_valid)
    assert torch.equal(qa, qb) and torch.equal(sa, sb)
    assert torch.equal(ka[:, :n_valid], kb[:, :n_valid])


def test_cpu_int8_wrappers_count_no_launches():
    tq.reset_launch_counts()
    tq.wn_layer_int8(*_small_std(2, 64, 64), 1)
    assert tq.launch_counts() == {
        "wn_layer_first_int8": 0, "wn_layer_int8": 0,
        "wn_layer_final_int8": 0}


def test_int8_mixed_devices_raise():
    args = _small_std(3, 16, 16)
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        tq.wn_layer_int8(*args, 1)


def test_plain_product_refuses_inexact_depth():
    """s8 products summed in f32 are exact only while K * 127^2 < 2^24."""
    k = tq.MAX_EXACT_K + 1
    assert tq.MAX_EXACT_K * 127 * 127 < 2 ** 24 <= k * 127 * 127
    with pytest.raises(ValueError, match="exact in f32 only"):
        tq._qdot(torch.zeros(1, 2, k, dtype=torch.int8),
                 torch.zeros(4, k, dtype=torch.int8))
