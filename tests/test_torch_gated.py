"""The port's gated activation (``ops/gated.py``) against the JAX package's
Pallas kernels in interpret mode and its reference expression, forward and
VJP, on the same numpy inputs; plus the autograd Function's contracts.  On
the CPU the wrappers take their plain versions, which carry the kernels'
arithmetic; the CUDA kernels are held to them in ``test_torch_cuda.py``.

Tolerances: f32 1e-6 forward (|out| < 1; tanh / exp of the two libraries
differ in the last bit) and 1e-5 on the VJP, the JAX package's own bounds
(``tests/test_pallas.py:35-42``); bf16 against the Pallas kernels one step
of the output's type, 2^-8 for values below 1 and 2^-6 for cotangents of a
few units.  The reference expression does its bf16 tanh, sigmoid and
products in bf16 (the kernels in f32), so it rounds once more: two steps."""

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import jax
import jax.numpy as jnp

from text2speech_tpu.ops.pallas import gated as jgated
from text2speech_tpu_torch.ops import gated as tgated

torch.set_num_threads(1)


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernels in interpreter mode on the CPU."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _pair(seed, shape=(2, 300, 512)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-6),
                                        ("bfloat16", 2.0 ** -8)])
def test_gated_forward_matches_pallas_and_reference(interpret, dtype, atol):
    a, b = _pair(1)                       # T % BLOCK_T != 0
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ja, jb = jnp.asarray(a, jd), jnp.asarray(b, jd)
    pallas = np.asarray(jgated.gated_activation_pallas(ja, jb), np.float32)
    ref = np.asarray(jgated.gated_activation_reference(ja, jb), np.float32)
    got = tgated.gated_fwd(_to_torch(a, td), _to_torch(b, td))
    assert got.dtype == td and got.shape == (2, 300, 256)
    np.testing.assert_allclose(got.float().numpy(), pallas, atol=atol)
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=2 * atol if dtype == "bfloat16" else atol)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2.0 ** -6)])
def test_gated_vjp_matches_pallas_and_reference(interpret, dtype, atol):
    a, b = _pair(2)
    g = np.random.RandomState(3).randn(2, 300, 256).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ja, jb, jg = (jnp.asarray(v, jd) for v in (a, b, g))
    da_p, db_p = jax.vjp(jgated.gated_activation_pallas, ja, jb)[1](jg)
    da_r, _ = jax.vjp(jgated.gated_activation_reference, ja, jb)[1](jg)
    ta = _to_torch(a, td).requires_grad_()
    tb = _to_torch(b, td).requires_grad_()
    tgated.gated_activation(ta, tb).backward(_to_torch(g, td))
    assert ta.grad.dtype == td
    assert torch.equal(ta.grad, tb.grad)          # da = db = dx
    for want, tol in ((da_p, atol), (db_p, atol),
                      (da_r, 2 * atol if dtype == "bfloat16" else atol)):
        np.testing.assert_allclose(ta.grad.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol)
    dx = tgated.gated_bwd(ta.detach(), tb.detach(), _to_torch(g, td))
    assert torch.equal(dx, ta.grad)


def test_gated_function_matches_autograd_of_the_plain_expression():
    """``b`` a column slice of a fused projection (row stride 3 x 2C), odd
    sizes: the Function's gradients equal autograd's through
    ``gated_plain`` and reach the whole projection."""
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.randn(3, 37, 10).astype(np.float32))
    fused = torch.from_numpy(rng.randn(3, 37, 30).astype(np.float32))
    g = torch.from_numpy(rng.randn(3, 37, 5).astype(np.float32))
    grads = []
    for fn in (tgated.gated_activation, tgated.gated_plain):
        a_, f_ = a.clone().requires_grad_(), fused.clone().requires_grad_()
        out = sum(fn(a_, c) for c in f_.split(10, dim=-1))
        out.backward(g)
        grads.append((out.detach(), a_.grad, f_.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("which", ["a", "b"])
def test_gated_function_with_one_input_requiring_grad(which):
    a, b = (torch.from_numpy(v) for v in _pair(5, (2, 9, 8)))
    (a if which == "a" else b).requires_grad_()
    tgated.gated_activation(a, b).sum().backward()
    need, other = (a, b) if which == "a" else (b, a)
    assert other.grad is None
    want = tgated.gated_bwd_plain(a.detach(), b.detach(),
                                  torch.ones(2, 9, 4))
    torch.testing.assert_close(need.grad, want)


def test_gated_function_under_checkpoint():
    a, b = (torch.from_numpy(v).requires_grad_() for v in _pair(6, (2, 9, 8)))
    checkpoint(tgated.gated_activation, a, b, use_reentrant=False) \
        .square().sum().backward()
    got = a.grad.clone()
    a.grad = b.grad = None
    tgated.gated_activation(a, b).square().sum().backward()
    assert torch.equal(got, a.grad) and torch.equal(got, b.grad)


def test_row_stride_of_views():
    x = torch.zeros(3, 7, 24)
    assert tgated._row_stride(x) == 24
    assert tgated._row_stride(x.split(8, dim=-1)[1]) == 24
    assert tgated._row_stride(x[:, ::2]) is None          # two row strides
    assert tgated._row_stride(x.transpose(1, 2)) is None  # last stride != 1
    assert tgated._row_stride(x[:1, :, :8]) == 24         # size-1 dims skip
    assert tgated._row_stride(x[0, 0].expand(5, 24)) is None
    t, s = tgated._as_rows(x[:, ::2])
    assert t.is_contiguous() and s == 24


def test_gated_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="equal"):
        tgated.gated_fwd(a, torch.zeros(2, 4, 6))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tgated.gated_fwd(a.double(), a.double())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tgated.gated_fwd(a, a.bfloat16())
    with pytest.raises(ValueError, match="cotangent"):
        tgated.gated_bwd(a, a, torch.zeros(2, 4, 8))
    assert tgated.launch_counts() == {"gated_fwd": 0, "gated_bwd": 0}
