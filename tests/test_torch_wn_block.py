"""Parity of the port's plain WN-layer versions (``text2speech_tpu_torch.ops.
wn_block``) with the JAX package's Pallas kernels (``text2speech_tpu.ops.
pallas.wn_block``), which run here in interpret mode as in
``tests/test_pallas.py``.

Inputs are float32, made with numpy from a seed and fed to both sides; rows
past ``n_valid`` are zero, as the serving path leaves them.  Tolerance:
both sides compute float32 matmuls over the same values with float32
accumulation in another order, at activations of order 1 and contractions
of at most 3C + M = 240 terms, so they agree to a few float32 ulps of the
partial sums: 2e-5 absolute."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text2speech_tpu.ops.pallas import wn_block as jwb
from text2speech_tpu_torch.ops import wn_block as twb

torch.set_num_threads(1)

B, C, M = 2, 64, 48
ATOL = 2e-5


def _inputs(seed: int, T: int, n_valid: int, rs_out: int, n_half=None,
            E=None):
    rng = np.random.RandomState(seed)
    mask = (np.arange(T) < n_valid)[None, :, None]

    def rn(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    k = {
        "spect": rn(B, T, M, scale=0.1) * mask,
        "w_in": rn(3, C, 2 * C, scale=0.05),
        "b_in": rn(2 * C, scale=0.05),
        "w_cond": rn(M, 2 * C, scale=0.05),
        "b_cond": rn(2 * C, scale=0.05),
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


def _both(k, names):
    return ([jnp.asarray(k[n]) for n in names],
            [torch.from_numpy(k[n]) for n in names])


@pytest.mark.parametrize("n_half,T,n_valid,d", [
    (2, 2 * 512, 2 * 512, 1),
    (4, 3 * 512, 3 * 512 - 300, 1),
    (4, 2 * 512, 2 * 512 - 77, 128),
])
def test_first_layer_plain_matches_pallas(n_half, T, n_valid, d):
    k = _inputs(10 + n_half + d, T, n_valid, 2 * C, n_half=n_half)
    names = ["x0", "spect", "start_k", "start_b", "w_in", "b_in", "w_cond",
             "b_cond", "w_rs", "b_rs"]
    ja, ta = _both(k, names)
    want_x, want_s = jwb.wn_layer_stream2_first(*ja, d, n_valid=n_valid)
    # the port folds the start projection onto the taps once, outside the
    # wrapper (the JAX wrapper folds on every call)
    x0, spect, start_k, start_b, w_in, b_in = ta[:6]
    fold = twb.fold_first_taps(start_k, start_b, w_in, b_in)
    got_x, got_s = twb.wn_layer_first(x0, spect, start_k, start_b, *fold,
                                      *ta[6:], d, n_valid=n_valid)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=ATOL)
    # skip rows past n_valid are unused by the path (the coupling output
    # is cut there); compare the valid rows
    np.testing.assert_allclose(got_s.numpy()[:, :n_valid],
                               np.asarray(want_s)[:, :n_valid], atol=ATOL)


@pytest.mark.parametrize("d", [1, 128])
@pytest.mark.parametrize("rs_full", [True, False])
def test_standard_layer_plain_matches_pallas(d, rs_full):
    T = 3 * 512
    n_valid = T - 200
    rs_out = 2 * C if rs_full else C
    k = _inputs(20 + d + rs_out, T, n_valid, rs_out)
    names = ["x", "spect", "w_in", "b_in", "w_cond", "b_cond", "w_rs",
             "b_rs", "acc"]
    ja, ta = _both(k, names)
    want_x, want_s = jwb.wn_layer_stream2(*ja, d, n_valid=n_valid)
    got_x, got_s = twb.wn_layer(*ta, d, n_valid=n_valid)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=ATOL)
    np.testing.assert_allclose(got_s.numpy()[:, :n_valid],
                               np.asarray(want_s)[:, :n_valid], atol=ATOL)


@pytest.mark.parametrize("d,E,n_valid", [(1, 8, 2 * 512), (128, 4, 900)])
def test_final_layer_plain_matches_pallas(d, E, n_valid):
    T = 2 * 512
    k = _inputs(30 + d + E, T, n_valid, C, E=E)
    names = ["x", "spect", "w_in", "b_in", "w_cond", "b_cond", "w_rs",
             "b_rs", "acc", "w_end", "b_end"]
    ja, ta = _both(k, names)
    want = jwb.wn_layer_stream2_final(*ja, d, n_valid=n_valid)
    # the port folds w_rs @ w_end once, outside the wrapper
    w_rs, b_rs, acc, w_end, b_end = ta[6:]
    w_eff, b_eff = twb.fold_end(w_rs, b_rs, w_end, b_end)
    got = twb.wn_layer_final(*ta[:6], w_eff, acc, w_end, b_eff, d,
                             n_valid=n_valid)
    np.testing.assert_allclose(got.numpy()[:, :n_valid],
                               np.asarray(want)[:, :n_valid], atol=ATOL)


def test_rows_past_n_valid_are_ignored():
    """What the port promises beyond the Pallas kernels: input rows at or
    past n_valid do not reach any valid output row, whatever they hold."""
    T, n_valid, d = 300, 250, 64
    k = _inputs(40, T, n_valid, 2 * C, n_half=3, E=6)
    names = ["x", "spect", "w_in", "b_in", "w_cond", "b_cond", "w_rs",
             "b_rs", "acc"]
    _, ta = _both(k, names)
    x_a, s_a = twb.wn_layer(*ta, d, n_valid=n_valid)
    junk = ta[0].clone()
    junk[:, n_valid:] = 7.0
    x_b, s_b = twb.wn_layer(junk, *ta[1:], d, n_valid=n_valid)
    assert torch.equal(x_a, x_b)
    assert (x_b[:, n_valid:] == 0).all()
    assert torch.equal(s_a[:, :n_valid], s_b[:, :n_valid])


def test_cpu_wrappers_count_no_launches():
    twb.reset_launch_counts()
    T = 64
    k = _inputs(50, T, T, 2 * C)
    names = ["x", "spect", "w_in", "b_in", "w_cond", "b_cond", "w_rs",
             "b_rs", "acc"]
    _, ta = _both(k, names)
    twb.wn_layer(*ta, 1)
    assert twb.launch_counts() == {
        "wn_layer_first": 0, "wn_layer": 0, "wn_layer_final": 0}


def test_mixed_devices_raise():
    """A wrapper never quietly picks a path for tensors it was not meant to
    take: a tensor off the CPU that is not on one CUDA device raises."""
    T = 16
    k = _inputs(60, T, T, 2 * C)
    names = ["x", "spect", "w_in", "b_in", "w_cond", "b_cond", "w_rs",
             "b_rs", "acc"]
    _, ta = _both(k, names)
    ta[0] = ta[0].to("meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        twb.wn_layer(*ta, 1)
