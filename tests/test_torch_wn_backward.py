"""The port's k=3 dilated conv backward (``ops/wn_backward.py``) against the
JAX package's Pallas probe kernel (interpret mode, on ``pad_tiles`` inputs),
against ``jax.vjp`` of its conv lowering and against PyTorch's autograd of
``F.conv1d``, on the same numpy inputs.  On the CPU the wrapper takes the
plain version; the CUDA kernel is held to it in ``test_torch_cuda.py``.

Tolerances are the JAX package's own for this kernel
(``tests/test_pallas.py:311-314``): f32 sums of 48 (dx) and 2048 (dW) terms
in another order, 2e-4 / 2e-3 absolute with 1e-4 relative."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from text2speech_tpu.ops.pallas.wn_backward import (conv_k3_bwd_pallas,
                                                    conv_k3_fwd_xla)
from text2speech_tpu.ops.pallas.wn_block import BT
from text2speech_tpu.ops.pallas.wn_block_padded import pad_tiles
from text2speech_tpu_torch.ops import wn_backward as twb

torch.set_num_threads(1)


def _inputs(seed, B, T, C):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, C).astype(np.float32),
            (0.3 * rng.randn(3, C, 2 * C)).astype(np.float32),
            rng.randn(B, T, 2 * C).astype(np.float32))


@pytest.mark.parametrize("d", [1, 4, 128, BT])
def test_conv_k3_bwd_matches_pallas_and_conv_vjp(d):
    B, T, C = 2, 2 * BT, 16
    x, w, g = _inputs(3 + d, B, T, C)
    jx, jw, jg = jnp.asarray(x), jnp.asarray(w), jnp.asarray(g)
    dx_p, dw_p = conv_k3_bwd_pallas(pad_tiles(jx), pad_tiles(jg), jw, d)
    _, vjp = jax.vjp(lambda x_, w_: conv_k3_fwd_xla(x_, w_, d), jx, jw)
    dx_r, dw_r = vjp(jg)
    args = tuple(map(torch.from_numpy, (x, g, w)))
    # the wrapper takes the dilations of the WN ladder (up to 128); the
    # plain version any
    fn = twb.conv_k3_bwd if d <= twb.MAX_DILATION else twb.conv_k3_bwd_plain
    dx, dw = fn(*args, d)
    assert dx.shape == (B, T, C) and dw.shape == (3, C, 2 * C)
    for want_dx, want_dw in ((dx_p, dw_p), (dx_r, dw_r)):
        np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx),
                                   atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw),
                                   atol=2e-3, rtol=1e-4)


@pytest.mark.parametrize("B,T,C,d", [(2, 50, 24, 5), (1, 9, 8, 16),
                                     (3, 130, 16, 128)])
def test_conv_k3_bwd_matches_torch_autograd(B, T, C, d):
    """Odd sizes, and dilations past the sequence (every tap but the
    centre reads zeros)."""
    x, w, g = _inputs(d, B, T, C)
    xr = torch.from_numpy(x).requires_grad_()
    wr = torch.from_numpy(w).requires_grad_()
    y = F.conv1d(xr.transpose(1, 2), wr.permute(2, 1, 0), padding=d,
                 dilation=d).transpose(1, 2)
    y.backward(torch.from_numpy(g))
    dx, dw = twb.conv_k3_bwd(torch.from_numpy(x), torch.from_numpy(g),
                             torch.from_numpy(w), d)
    torch.testing.assert_close(dx, xr.grad, atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(dw, wr.grad, atol=2e-3, rtol=1e-4)


def test_conv_k3_bwd_bf16_types():
    """bf16 in: dx comes back bf16, dW f32, both from f32 sums over the
    bf16 values (one bf16 step, 2^-8 relative, on dx)."""
    x, w, g = (torch.from_numpy(v).bfloat16() for v in _inputs(7, 2, 40, 8))
    dx, dw = twb.conv_k3_bwd(x, g, w, 2)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    dx32, dw32 = twb.conv_k3_bwd(x.float(), g.float(), w.float(), 2)
    torch.testing.assert_close(dx.float(), dx32, atol=0, rtol=2.0 ** -8)
    torch.testing.assert_close(dw, dw32)


def test_conv_k3_bwd_rejects_what_the_kernel_does_not_take():
    x, w, g = map(torch.from_numpy, _inputs(8, 1, 10, 4))
    for d in (0, 129):
        with pytest.raises(ValueError, match="dilation"):
            twb.conv_k3_bwd(x, g, w, d)
    with pytest.raises(ValueError, match="g:"):
        twb.conv_k3_bwd(x, g[..., :4], w, 1)
    with pytest.raises(ValueError, match="w:"):
        twb.conv_k3_bwd(x, g, w.bfloat16(), 1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        twb.conv_k3_bwd(x.double(), g.double(), w.double(), 1)
    assert twb.launch_counts() == {"conv_k3_bwd": 0}
