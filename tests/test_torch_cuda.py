"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a CUDA device and ``nvcc``).  Run on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:cacheprovider --noconftest

(``--noconftest``: the suite's conftest imports JAX, which the port's GPU
machine need not have; this file imports none of it).

Each kernel is held against its plain PyTorch version on the same bf16
inputs on the card.  Bound: both accumulate in f32 in another order, so an
activation or output can round to the neighbouring bf16 value (2^-8 of
its magnitude); four such steps at the output's peak, and relative L2
under 5e-3 (flips are rare).

The int8 kernels are held to their plain versions by the rule of
``tests/test_int8_vocoder.py``: the integer products are exact on both
sides, and the f32 operations around them run in another order (and with
the card's tanhf/expf), which can move a value across a round-half-even
knife edge.  So int8 payloads agree within 1 count with a mean absolute
difference under 0.01, row scales to 1e-3 relative, the bf16 skip sum to
0.09 and the final layer's f32 output to 0.02."""

import pytest
import torch

from text2speech_tpu_torch.config import WaveGlowConfig
from text2speech_tpu_torch.ops import wn_block as wb
from text2speech_tpu_torch.ops import wn_block_int8 as wq

pytestmark = pytest.mark.cuda

MAX_ABS_STEPS = 4 * 2.0 ** -8
REL_L2 = 5e-3


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from text2speech_tpu_torch.ops.build import find_nvcc

    try:
        find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    peak = max(want.abs().max().item(), 1.0)
    assert (got - want).abs().max().item() <= MAX_ABS_STEPS * peak
    assert ((got - want).norm() / want.norm()).item() <= REL_L2


def inputs(dev, B, T, n_valid, C, M, seed, rs_out=None, n_half=None, E=None):
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    mask = (torch.arange(T) < n_valid)[None, :, None].to(dev)
    k = {"spect": rn(B, T, M),
         "w_in": rn(3, C, 2 * C, scale=(3 * C) ** -0.5),
         "b_in": rn(2 * C, scale=0.1, dtype=torch.float32),
         "w_cond": rn(M, 2 * C, scale=M ** -0.5),
         "b_cond": rn(2 * C, scale=0.1, dtype=torch.float32),
         "acc": rn(B, T, C, scale=0.5) * mask,
         "x": rn(B, T, C) * mask}
    rs_out = rs_out or 2 * C
    k["w_rs"] = rn(C, rs_out, scale=C ** -0.5)
    k["b_rs"] = rn(rs_out, scale=0.1, dtype=torch.float32)
    if n_half:
        k["x0"] = rn(B, T, n_half) * mask
        k["start_k"] = rn(n_half, C, scale=n_half ** -0.5)
        k["start_b"] = rn(C, scale=0.1, dtype=torch.float32)
    if E:
        k["w_end"] = rn(C, E, scale=C ** -0.5)
        k["b_end"] = rn(E, scale=0.1, dtype=torch.float32)
    return k


@pytest.mark.parametrize("n_half,d", [(2, 1), (3, 1), (4, 5)])
def test_first_layer_kernel_matches_plain(dev, n_half, d):
    B, T, nv, C, M = 2, 300, 271, 128, 64
    k = inputs(dev, B, T, nv, C, M, n_half, n_half=n_half)
    fold = wb.fold_first_taps(k["start_k"], k["start_b"], k["w_in"],
                              k["b_in"])
    args = (k["x0"], k["spect"], k["start_k"], k["start_b"], *fold,
            k["w_cond"], k["b_cond"], k["w_rs"], k["b_rs"], d)
    gx, gs = wb.wn_layer_first(*args, n_valid=nv)
    px, ps = wb.wn_layer_first_plain(*args, n_valid=nv)
    close(gx, px)
    close(gs[:, :nv], ps[:, :nv])


@pytest.mark.parametrize("d", [1, 64, 128, 400])
@pytest.mark.parametrize("rs_full", [True, False])
def test_standard_layer_kernel_matches_plain(dev, d, rs_full):
    B, T, nv, C, M = 2, 333, 300, 128, 64
    k = inputs(dev, B, T, nv, C, M, d, rs_out=2 * C if rs_full else C)
    args = (k["x"], k["spect"], k["w_in"], k["b_in"], k["w_cond"],
            k["b_cond"], k["w_rs"], k["b_rs"])
    px, ps = wb.wn_layer_plain(*args, k["acc"], d, n_valid=nv)
    acc = k["acc"].clone()
    gx, gs = wb.wn_layer(*args, acc, d, n_valid=nv)
    assert gs.data_ptr() == acc.data_ptr()     # skip sum updated in place
    close(gx, px)
    close(gs[:, :nv], ps[:, :nv])


@pytest.mark.parametrize("E,d", [(4, 1), (6, 64), (8, 128)])
def test_final_layer_kernel_matches_plain(dev, E, d):
    B, T, nv, C, M = 1, 257, 257, 256, 96
    k = inputs(dev, B, T, nv, C, M, E, rs_out=C, E=E)
    w_eff, b_eff = wb.fold_end(k["w_rs"], k["b_rs"], k["w_end"], k["b_end"])
    args = (k["x"], k["spect"], k["w_in"], k["b_in"], k["w_cond"],
            k["b_cond"], w_eff, k["acc"], k["w_end"], b_eff, d)
    close(wb.wn_layer_final(*args, n_valid=nv),
          wb.wn_layer_final_plain(*args, n_valid=nv))


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(dev):
    B, T, C, M = 1, 64, 128, 64
    k = inputs(dev, B, T, T, C, M, 7)
    args = [k["x"], k["spect"], k["w_in"], k["b_in"], k["w_cond"],
            k["b_cond"], k["w_rs"], k["b_rs"], k["acc"]]
    bad = list(args)
    bad[0] = args[0].float()
    with pytest.raises(ValueError, match="dtype"):
        wb.wn_layer(*bad, 1)
    bad = list(args)
    bad[1] = torch.cat([args[1], args[1]], -1)[..., :M]  # strided view
    with pytest.raises(ValueError, match="contiguous"):
        wb.wn_layer(*bad, 1)
    for i in (3, 8):     # a bias or the skip sum left on the CPU
        bad = list(args)
        bad[i] = args[i].cpu()
        with pytest.raises(ValueError, match="CPU or all on one CUDA"):
            wb.wn_layer(*bad, 1)
    bad = list(args)
    bad[8] = args[0]     # the skip sum, updated in place, aliasing x
    with pytest.raises(ValueError, match="must not share"):
        wb.wn_layer(*bad, 1)
    k = inputs(dev, B, T, T, 64, M, 8)
    with pytest.raises(ValueError, match="C % 128"):
        wb.wn_layer(k["x"], k["spect"], k["w_in"], k["b_in"], k["w_cond"],
                    k["b_cond"], k["w_rs"], k["b_rs"], k["acc"], 1)


def small_waveglow(dev):
    """A 4-flow, 4-layer WaveGlow at C=128, M = 16 * 8 = 128 on seeded
    random weights (orthogonal 1x1 convs, small end convs)."""
    from text2speech_tpu_torch.infer import random_weights_
    from text2speech_tpu_torch.models.waveglow import WaveGlow

    cfg = WaveGlowConfig(n_mel_channels=16, n_flows=4, n_group=8,
                         n_early_every=2, n_early_size=2, wn_n_layers=4,
                         wn_n_channels=128, upsample_kernel=64,
                         upsample_stride=16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = WaveGlow(cfg, device=dev)
    random_weights_(model, gen, out_first=False)
    with torch.no_grad():
        for w in model.convinv:
            q, _ = torch.linalg.qr(torch.randn(w.shape, generator=gen,
                                               device="cuda"))
            w.copy_(q)
        for wn in model.wn:
            wn.end_w.mul_(0.02)
    return model, cfg


def test_infer_fused_launches_each_kernel_and_matches_plain(dev):
    """One vocode through the kernels: 1 / L-2 / 1 launches per flow, and
    the audio agrees with the plain-layer path on the same noise."""
    from text2speech_tpu_torch.models.waveglow_fused import (infer_fused,
                                                             prepare_fused)

    model, _ = small_waveglow(dev)
    fw = prepare_fused(model)
    gen = torch.Generator(device="cuda").manual_seed(1)
    mel = torch.randn(2, 16, 77, generator=gen, device="cuda")
    noise = tuple(torch.randn(s, generator=gen, device="cuda")
                  for s in fw.noise_shapes(2, 77 * 2))
    wb.reset_launch_counts()
    got = infer_fused(fw, mel, 0.7, noise=noise)
    assert wb.launch_counts() == {"wn_layer_first": 4, "wn_layer": 8,
                                  "wn_layer_final": 4}
    want = infer_fused(fw, mel, 0.7, noise=noise, plain=True)
    assert got.shape == want.shape == (2, 77 * 16)
    assert torch.isfinite(got).all()
    # the audio is bf16 between flows: allow 16 bf16 steps at the peak
    assert (got - want).abs().max() <= 16 * 2.0 ** -8 * want.abs().max()
    assert ((got - want).norm() / want.norm()).item() < 2e-2


# ---------------------------------------------------------------------------
# int8 family
# ---------------------------------------------------------------------------


def int8_inputs(dev, B, T, n_valid, C, M, seed, n_half=None, E=None):
    """Quantized activations and output-major int8 weights at one layer's
    shapes; rows past n_valid of the hidden input are zero."""
    k = inputs(dev, B, T, n_valid, C, M, seed, rs_out=C if E else 2 * C,
               n_half=n_half, E=E)
    q = {"acc": k["acc"], "b_in": k["b_in"], "b_cond": k["b_cond"]}
    q["qx"], q["sx"] = wq.quantize_rows(k["x"])
    q["qspect"], q["sspect"] = wq.quantize_rows(k["spect"])
    for name in ("w_in", "w_cond") + (() if E else ("w_rs",)):
        qw, sw = wq.quantize_cols(k[name])
        q["q" + name], q["s" + name] = wq.to_output_major(qw), sw
    if n_half:
        q["x0"], q["start_k"], q["start_b"] = (k["x0"], k["start_k"],
                                               k["start_b"])
        q["fold"] = wb.fold_first_taps(k["start_k"], k["start_b"], k["w_in"],
                                       k["b_in"])
    if E:
        q["w_end"] = k["w_end"]
        q["w_eff"], q["b_eff"] = wb.fold_end(k["w_rs"], k["b_rs"],
                                             k["w_end"], k["b_end"])
    else:
        q["b_rs"] = k["b_rs"]
    return q


def close_int8(got, want, nv):
    gq, gs, gk = got
    pq, ps, pk = want
    diff = (gq.int() - pq.int()).abs()
    assert diff.max().item() <= 1
    assert diff.float().mean().item() < 0.01
    torch.testing.assert_close(gs, ps, rtol=1e-3, atol=0)
    assert torch.isfinite(gk.float()).all()
    assert (gk[:, :nv].float() - pk[:, :nv].float()).abs().max() <= 0.09


@pytest.mark.parametrize("n_half,d", [(2, 1), (3, 1), (4, 5)])
def test_first_int8_kernel_matches_plain(dev, n_half, d):
    B, T, nv, C, M = 2, 300, 271, 128, 64
    q = int8_inputs(dev, B, T, nv, C, M, n_half, n_half=n_half)
    args = (q["x0"], q["qspect"], q["sspect"], q["start_k"], q["start_b"],
            *q["fold"], q["qw_cond"], q["sw_cond"], q["b_cond"], q["qw_rs"],
            q["sw_rs"], q["b_rs"], d)
    close_int8(wq.wn_layer_first_int8(*args, n_valid=nv),
               wq.wn_layer_first_int8_plain(*args, n_valid=nv), nv)


@pytest.mark.parametrize("d", [1, 64, 128, 400])
@pytest.mark.parametrize("C,M", [(128, 64), (512, 128), (640, 64)])
def test_standard_int8_kernel_matches_plain(dev, d, C, M):
    B, T, nv = 2, 333, 300
    q = int8_inputs(dev, B, T, nv, C, M, d)
    args = (q["qx"], q["sx"], q["qspect"], q["sspect"], q["qw_in"],
            q["sw_in"], q["b_in"], q["qw_cond"], q["sw_cond"], q["b_cond"],
            q["qw_rs"], q["sw_rs"], q["b_rs"])
    want = wq.wn_layer_int8_plain(*args, q["acc"], d, n_valid=nv)
    acc = q["acc"].clone()
    got = wq.wn_layer_int8(*args, acc, d, n_valid=nv)
    assert got[2].data_ptr() == acc.data_ptr()  # skip sum updated in place
    close_int8(got, want, nv)
    # rows past n_valid: zero payload, floor scale
    assert (got[0][:, nv:] == 0).all()
    assert torch.equal(got[1][:, nv:], want[1][:, nv:])


@pytest.mark.parametrize("E,d", [(4, 1), (6, 64), (8, 128)])
def test_final_int8_kernel_matches_plain(dev, E, d):
    B, T, nv, C, M = 1, 257, 257, 256, 128
    q = int8_inputs(dev, B, T, nv, C, M, E, E=E)
    args = (q["qx"], q["sx"], q["qspect"], q["sspect"], q["qw_in"],
            q["sw_in"], q["b_in"], q["qw_cond"], q["sw_cond"], q["b_cond"],
            q["w_eff"], q["acc"], q["w_end"], q["b_eff"], d)
    got = wq.wn_layer_final_int8(*args, n_valid=nv)
    want = wq.wn_layer_final_int8_plain(*args, n_valid=nv)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 0.02


def test_int8_wrappers_reject_what_the_kernels_do_not_take(dev):
    B, T, C, M = 1, 64, 128, 64
    q = int8_inputs(dev, B, T, T, C, M, 7)
    args = [q["qx"], q["sx"], q["qspect"], q["sspect"], q["qw_in"],
            q["sw_in"], q["b_in"], q["qw_cond"], q["sw_cond"], q["b_cond"],
            q["qw_rs"], q["sw_rs"], q["b_rs"], q["acc"]]
    bad = list(args)
    bad[0] = args[0].to(torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        wq.wn_layer_int8(*bad, 1)
    bad = list(args)
    bad[4] = args[4].transpose(-1, -2)     # weights not output-major
    with pytest.raises(ValueError, match="shape|contiguous"):
        wq.wn_layer_int8(*bad, 1)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        wq.wn_layer_int8(*bad, 1)
    q = int8_inputs(dev, B, T, T, C, 96, 8)     # M not a multiple of 64
    with pytest.raises(ValueError, match="M % 64"):
        wq.wn_layer_int8(q["qx"], q["sx"], q["qspect"], q["sspect"],
                         q["qw_in"], q["sw_in"], q["b_in"], q["qw_cond"],
                         q["sw_cond"], q["b_cond"], q["qw_rs"], q["sw_rs"],
                         q["b_rs"], q["acc"], 1)


def test_infer_fused_int8_launches_each_kernel_and_matches_plain(dev):
    """One int8 vocode through the kernels: 1 / L-2 / 1 launches of the
    int8 wrappers per flow and none of the bf16 ones; the audio agrees with
    the plain-layer int8 path on the same noise.  Bound: a payload that
    flips by one count (1/127 of a row's peak) is carried through the later
    layers and flows, on top of the bf16 audio's own steps: 32 bf16 steps
    at the peak and 5e-2 relative L2."""
    from text2speech_tpu_torch.models.waveglow_fused import (
        infer_fused_int8, prepare_fused_int8)

    model, _ = small_waveglow(dev)
    fw = prepare_fused_int8(model)
    gen = torch.Generator(device="cuda").manual_seed(1)
    mel = torch.randn(2, 16, 77, generator=gen, device="cuda")
    noise = tuple(torch.randn(s, generator=gen, device="cuda")
                  for s in fw.noise_shapes(2, 77 * 2))
    wb.reset_launch_counts()
    wq.reset_launch_counts()
    got = infer_fused_int8(fw, mel, 0.7, noise=noise)
    assert wq.launch_counts() == {"wn_layer_first_int8": 4,
                                  "wn_layer_int8": 8,
                                  "wn_layer_final_int8": 4}
    assert sum(wb.launch_counts().values()) == 0
    want = infer_fused_int8(fw, mel, 0.7, noise=noise, plain=True)
    assert got.shape == want.shape == (2, 77 * 16)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 32 * 2.0 ** -8 * want.abs().max()
    assert ((got - want).norm() / want.norm()).item() < 5e-2


# ---------------------------------------------------------------------------
# training kernels: the gated activation (forward, backward) and the k=3
# conv backward
# ---------------------------------------------------------------------------


def _gated_inputs(dev, shape, dtype, strided, seed):
    """a, b [..., 2C] and g [..., C]; ``strided`` makes b the middle column
    slice of a fused [..., 3 * 2C] projection (row stride 6C)."""
    g = torch.Generator().manual_seed(seed)
    C2 = shape[-1]
    a = torch.randn(*shape, generator=g).to(dev, dtype)
    fused = torch.randn(*shape[:-1], 3 * C2, generator=g).to(dev, dtype)
    b = fused[..., C2: 2 * C2] if strided else fused[..., C2: 2 * C2].clone()
    cot = (2 * torch.randn(*shape[:-1], C2 // 2, generator=g)).to(dev, dtype)
    return a, b, cot


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 500, 1024), (2, 37, 6), (1, 5, 48)])
def test_gated_kernels_match_plain(dev, shape, dtype, strided):
    """Forward and backward kernel against their plain versions (the
    vectorised path at C % 4 / 8 == 0 and aligned rows, the scalar one
    otherwise).  Both do the same f32 arithmetic on the same rounded sum;
    the card's tanhf / expf differ from the library's in the last bits: 1e-6
    (1e-5 on dx, whose cotangents reach a few units) in f32, one bf16 step
    of the value (at most 2^-7 of it) in bf16."""
    from text2speech_tpu_torch.ops import gated

    a, b, cot = _gated_inputs(dev, shape, dtype, strided, 1)
    f32 = dtype == torch.float32
    gated.reset_launch_counts()
    out = gated.gated_fwd(a, b)
    dx = gated.gated_bwd(a, b, cot)
    assert gated.launch_counts() == {"gated_fwd": 1, "gated_bwd": 1}
    assert out.dtype == dx.dtype == dtype
    assert out.is_contiguous() and dx.is_contiguous()
    want_out, want_dx = gated.gated_plain(a, b), gated.gated_bwd_plain(a, b, cot)
    assert (out.float() - want_out.float()).abs().max().item() \
        <= (1e-6 if f32 else 2.0 ** -8)
    assert (dx.float() - want_dx.float()).abs().max().item() \
        <= (1e-5 if f32 else 2.0 ** -7 * want_dx.abs().max().item())


def test_gated_function_on_the_card_matches_autograd(dev):
    """The autograd Function through the kernels against autograd of the
    plain expression, with ``b`` a column slice: gradients reach ``a`` and
    the whole fused projection; under ``torch.utils.checkpoint`` the
    forward kernel runs twice."""
    from torch.utils.checkpoint import checkpoint

    from text2speech_tpu_torch.ops import gated

    g = torch.Generator().manual_seed(2)
    a0 = torch.randn(2, 300, 256, generator=g).to(dev)
    f0 = torch.randn(2, 300, 768, generator=g).to(dev)
    cot = torch.randn(2, 300, 128, generator=g).to(dev)
    grads = []
    for fn in (gated.gated_activation, gated.gated_plain):
        a, f = a0.clone().requires_grad_(), f0.clone().requires_grad_()
        sum(fn(a, c) for c in f.split(256, dim=-1)).backward(cot)
        grads.append((a.grad, f.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    a, f = a0.clone().requires_grad_(), f0.clone().requires_grad_()
    gated.reset_launch_counts()
    checkpoint(gated.gated_activation, a, f[..., :256],
               use_reentrant=False).backward(cot)
    assert gated.launch_counts() == {"gated_fwd": 2, "gated_bwd": 1}
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        gated.gated_fwd(a0, f0[..., :256].cpu())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,C,d", [(3, 500, 512, 1), (2, 300, 128, 8),
                                     (2, 77, 128, 128), (2, 50, 24, 5)])
def test_conv_k3_bwd_kernel_matches_plain_and_autograd(dev, dtype, B, T, C, d):
    """Kernel 18 against its plain version and against autograd of
    ``F.conv1d`` (bf16 at C % 128 == 0 takes the tensor-core path, the rest
    the f32 FMA path).  Sums of 6C (dx) and B*T (dW) f32 products in another
    order: f32 dx to 1e-4 and dW to 2e-5 of its peak; bf16 dx additionally
    rounds to bf16, one step (at most 2^-7) of its peak."""
    import torch.nn.functional as F

    from text2speech_tpu_torch.ops import wn_backward as twb

    g = torch.Generator().manual_seed(d)
    x = torch.randn(B, T, C, generator=g).to(dev, dtype)
    w = (torch.randn(3, C, 2 * C, generator=g) * (3 * C) ** -0.5).to(dev, dtype)
    cot = torch.randn(B, T, 2 * C, generator=g).to(dev, dtype)
    twb.reset_launch_counts()
    dx, dw = twb.conv_k3_bwd(x, cot, w, d)
    assert twb.launch_counts() == {"conv_k3_bwd": 1}
    assert dx.dtype == dtype and dw.dtype == torch.float32
    dx2, dw2 = twb.conv_k3_bwd(x, cot, w, d)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)   # no atomics
    xr = x.float().requires_grad_()
    wr = w.float().requires_grad_()
    F.conv1d(xr.transpose(1, 2), wr.permute(2, 1, 0), padding=d,
             dilation=d).transpose(1, 2).backward(cot.float())
    px, pw = twb.conv_k3_bwd_plain(x, cot, w, d)
    for want_dx, want_dw in ((px, pw), (xr.grad, wr.grad)):
        want_dx = want_dx.float()
        peak_x, peak_w = want_dx.abs().max().item(), want_dw.abs().max().item()
        tol_x = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * peak_x + 1e-4
        assert (dx.float() - want_dx).abs().max().item() <= tol_x
        assert (dw - want_dw).abs().max().item() <= 2e-5 * max(peak_w, 1.0)


def test_conv_k3_bwd_rejects_on_the_card(dev):
    from text2speech_tpu_torch.ops import wn_backward as twb

    x = torch.zeros(1, 10, 8, device=dev)
    g = torch.zeros(1, 10, 16, device=dev)
    w = torch.zeros(3, 8, 16, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        twb.conv_k3_bwd(x, g, w.transpose(0, 1).contiguous().transpose(0, 1),
                        1)
    with pytest.raises(ValueError, match="dtype"):
        twb.conv_k3_bwd(x, g.bfloat16(), w, 1)


def _tiny_trainable(dev, **kw):
    from text2speech_tpu_torch.models.waveglow import TrainableWaveGlow

    cfg = WaveGlowConfig(n_mel_channels=16, n_flows=4, n_group=8,
                         n_early_every=2, n_early_size=2, wn_n_layers=3,
                         wn_n_channels=128, upsample_kernel=64,
                         upsample_stride=16, segment_length=2048)
    model = TrainableWaveGlow(cfg, generator=torch.Generator().manual_seed(0),
                              device=dev, **kw)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():     # live end convs: every gradient leaf non-zero
        for name, p in model.params.items():
            p.add_(0.01 * torch.randn(p.shape, generator=g).to(dev))
    mel = torch.randn(2, 16, 129, generator=g).to(dev)
    audio = (0.1 * torch.randn(2, 2048, generator=g)).to(dev)
    return cfg, model, mel, audio


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_through_the_kernels_matches_plain_gated(dev, dtype, remat):
    """One WaveGlow training step with the gated kernels against the same
    step with ``gated=gated_plain``: 12 forward and 12 backward launches
    (24 forward under remat); loss and gradient norm agree (f32: 1e-5
    relative on the norm, 1e-6 absolute on a loss of 1e-2 terms; bf16: a
    gated value can differ by one bf16 step, carried through 4 flows)."""
    from text2speech_tpu_torch.ops import gated
    from text2speech_tpu_torch.train.state import create_train_state
    from text2speech_tpu_torch.train.waveglow import make_wg_train_step
    from text2speech_tpu_torch.data.mel2samp import VocoderBatch

    metrics = []
    for fn in (gated.gated_activation, gated.gated_plain):
        cfg, model, mel, audio = _tiny_trainable(dev, compute_dtype=dtype,
                                                 remat=remat, gated=fn)
        state = create_train_state(model.params, 1e-4)
        gated.reset_launch_counts()
        _, m = make_wg_train_step(model, 1.0)(state, VocoderBatch(mel, audio))
        counts = gated.launch_counts()
        if fn is gated.gated_activation:
            assert counts == {"gated_fwd": 24 if remat else 12,
                              "gated_bwd": 12}
        else:
            assert counts == {"gated_fwd": 0, "gated_bwd": 0}
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    (l0, g0), (l1, g1) = metrics
    f32 = dtype == torch.float32
    assert abs(l0 - l1) <= (1e-6 if f32 else 1e-3)
    assert abs(g0 - g1) <= (1e-5 if f32 else 2e-2) * g1
