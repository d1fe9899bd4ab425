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

import numpy as np
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


# the edges of the sm90 kernels' 128-row tile: T and n_valid off the tile
# grid, a halo of a whole tile (d=128), batch 3, nothing valid, a grid of
# 128-row tiles that fills the card
TILE_EDGES = [(1, 1000, 937, 1), (1, 1000, 128, 128), (1, 1000, 129, 64),
              (3, 1000, 1000, 128), (3, 777, 700, 1), (2, 300, 0, 5),
              (3, 6450, 6401, 64)]   # 51 x 3 tiles of 128 rows


@pytest.mark.parametrize("B,T,nv,d", TILE_EDGES)
def test_standard_layer_kernel_at_tile_edges(dev, B, T, nv, d):
    C, M = 256, 96
    k = inputs(dev, B, T, nv, C, M, 11 + d + nv)
    args = (k["x"], k["spect"], k["w_in"], k["b_in"], k["w_cond"],
            k["b_cond"], k["w_rs"], k["b_rs"])
    px, ps = wb.wn_layer_plain(*args, k["acc"], d, n_valid=nv)
    gx, gs = wb.wn_layer(*args, k["acc"].clone(), d, n_valid=nv)
    assert (gx[:, nv:] == 0).all()
    if nv:
        close(gx, px)
    close(gs, ps)      # every row: rows past n_valid are computed alike


@pytest.mark.parametrize("B,T,nv,d", TILE_EDGES)
def test_final_layer_kernel_at_tile_edges(dev, B, T, nv, d):
    C, M, E = 128, 64, 8
    k = inputs(dev, B, T, nv, C, M, 21 + d + nv, rs_out=C, E=E)
    w_eff, b_eff = wb.fold_end(k["w_rs"], k["b_rs"], k["w_end"], k["b_end"])
    args = (k["x"], k["spect"], k["w_in"], k["b_in"], k["w_cond"],
            k["b_cond"], w_eff, k["acc"], k["w_end"], b_eff, d)
    close(wb.wn_layer_final(*args, n_valid=nv),
          wb.wn_layer_final_plain(*args, n_valid=nv))


@pytest.mark.parametrize("C", [128, 512, 640])
def test_sm90_kernels_agree_with_the_first_design(dev, C):
    """The sm90 standard and final layers against their first design
    (``csrc/wn_block.cu``, 64-row blocks, mma.sync) on the same inputs,
    within the kernel bounds; 640 takes the 64-row tile."""
    B, T, nv, M, d = 2, 500, 451, 64, 64
    k = inputs(dev, B, T, nv, C, M, 31 + C, E=8)
    args = (k["x"], k["spect"], k["w_in"], k["b_in"], k["w_cond"],
            k["b_cond"], k["w_rs"], k["b_rs"])
    gx, gs = wb.wn_layer(*args, k["acc"].clone(), d, n_valid=nv)
    fx, fs = wb.first_design("wn_layer", *args, k["acc"].clone(), d,
                             n_valid=nv)
    close(gx, fx)
    close(gs[:, :nv], fs[:, :nv])
    w_eff, b_eff = wb.fold_end(k["w_rs"][:, :C].contiguous(),
                               k["b_rs"][:C].contiguous(), k["w_end"],
                               k["b_end"])
    fargs = (*args[:6], w_eff, k["acc"], k["w_end"], b_eff, d)
    close(wb.wn_layer_final(*fargs, n_valid=nv),
          wb.first_design("wn_layer_final", *fargs, n_valid=nv))


def test_sm90_wrappers_raise_where_no_tile_fits(dev):
    """C = 1536: the gated tile of even the 64-row form leaves no room for
    two ring stages.  The wrappers raise; nothing falls back."""
    B, T, C, M = 1, 64, 1536, 32
    k = inputs(dev, B, T, T, C, M, 9, E=4)
    args = (k["x"], k["spect"], k["w_in"], k["b_in"], k["w_cond"],
            k["b_cond"])
    wb.reset_launch_counts()
    with pytest.raises(ValueError, match="no tile"):
        wb.wn_layer(*args, k["w_rs"], k["b_rs"], k["acc"], 1)
    w_eff, b_eff = wb.fold_end(k["w_rs"][:, :C].contiguous(),
                               k["b_rs"][:C].contiguous(), k["w_end"],
                               k["b_end"])
    with pytest.raises(ValueError, match="no tile"):
        wb.wn_layer_final(*args, w_eff, k["acc"], k["w_end"], b_eff, 1)
    assert wb.launch_counts() == {"wn_layer_first": 0, "wn_layer": 0,
                                  "wn_layer_final": 0}


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,C,d", [(3, 2000, 512, 8), (2, 333, 256, 1),
                                     (1, 300, 128, 128), (2, 61, 384, 4),
                                     (2, 99, 24, 128)])
def test_conv_k3_bwd_sm90_agrees_with_the_first_design(dev, dtype, B, T, C,
                                                       d):
    """The sm90 conv backward (wgmma for bf16 at C % 128 == 0, the
    register-tiled FMA GEMM else) against its first design
    (``wn_backward.first_design``) and autograd of ``F.conv1d`` on the same
    inputs: T ragged against both routes' tiles, a dilation of a whole
    128-row tile, widths that leave part of a 256-column dx tile empty
    (128, 384); two runs bitwise equal.  Bounds as above: both sum f32
    products in another order; a bf16 dx may round to the neighbouring
    value, one step of its peak."""
    import torch.nn.functional as F

    from text2speech_tpu_torch.ops import wn_backward as twb

    g = torch.Generator().manual_seed(100 + d + C)
    x = torch.randn(B, T, C, generator=g).to(dev, dtype)
    w = (torch.randn(3, C, 2 * C, generator=g) * (3 * C) ** -0.5).to(dev, dtype)
    cot = torch.randn(B, T, 2 * C, generator=g).to(dev, dtype)
    twb.reset_launch_counts()
    dx, dw = twb.conv_k3_bwd(x, cot, w, d)
    fx, fw = twb.first_design(x, cot, w, d)
    assert twb.launch_counts() == {"conv_k3_bwd": 1}
    dx2, dw2 = twb.conv_k3_bwd(x, cot, w, d)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    xr = x.float().requires_grad_()
    wr = w.float().requires_grad_()
    F.conv1d(xr.transpose(1, 2), wr.permute(2, 1, 0), padding=d,
             dilation=d).transpose(1, 2).backward(cot.float())
    for want_dx, want_dw in ((fx, fw), (xr.grad, wr.grad)):
        want_dx = want_dx.float()
        peak_x, peak_w = want_dx.abs().max().item(), want_dw.abs().max().item()
        tol_x = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * peak_x + 1e-4
        assert (dx.float() - want_dx).abs().max().item() <= tol_x
        assert (dw - want_dw).abs().max().item() <= 2e-5 * max(peak_w, 1.0)


def test_conv_k3_bwd_raises_for_widths_no_route_takes(dev):
    from text2speech_tpu_torch.ops import wn_backward as twb

    x = torch.zeros(1, 10, 12, device=dev)
    g = torch.zeros(1, 10, 24, device=dev)
    w = torch.zeros(3, 12, 24, device=dev)
    twb.reset_launch_counts()
    with pytest.raises(ValueError, match="C % 8"):
        twb.conv_k3_bwd(x, g, w, 1)
    assert twb.launch_counts() == {"conv_k3_bwd": 0}


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


# ---------------------------------------------------------------------------
# the composed-conditioning (dcond) kernels
# ---------------------------------------------------------------------------


def cond_all_for(dev, B, T, C, L, seed):
    g = torch.Generator().manual_seed(1000 + seed)
    return torch.randn(B, T, 2 * C * L, generator=g).to(dev, torch.bfloat16)


@pytest.mark.parametrize("n_half,d", [(2, 1), (3, 1), (4, 5)])
def test_first_dcond_kernel_matches_plain(dev, n_half, d):
    from text2speech_tpu_torch.ops import wn_block_dcond as wd

    B, T, nv, C, L = 2, 300, 271, 128, 3
    k = inputs(dev, B, T, nv, C, 64, n_half, n_half=n_half)
    cond_all = cond_all_for(dev, B, T, C, L, n_half)
    fold = wb.fold_first_taps(k["start_k"], k["start_b"], k["w_in"],
                              k["b_in"])
    args = (k["x0"], cond_all, k["start_k"], k["start_b"], *fold, k["w_rs"],
            k["b_rs"], d)
    gx, gs = wd.wn_layer_first_dcond(*args, n_valid=nv)
    px, ps = wd.wn_layer_first_dcond_plain(*args, n_valid=nv)
    close(gx, px)
    assert not gx[:, nv:].any()
    close(gs[:, :nv], ps[:, :nv])


@pytest.mark.parametrize("d", [1, 64, 128, 400])
@pytest.mark.parametrize("rs_full,li", [(True, 0), (True, 2), (False, 1)])
def test_standard_dcond_kernel_matches_plain(dev, d, rs_full, li):
    from text2speech_tpu_torch.ops import wn_block_dcond as wd

    B, T, nv, C, L = 2, 333, 300, 128, 3
    k = inputs(dev, B, T, nv, C, 64, d, rs_out=2 * C if rs_full else C)
    cond_all = cond_all_for(dev, B, T, C, L, d)
    args = (k["x"], cond_all, li, k["w_in"], k["b_in"], k["w_rs"], k["b_rs"])
    px, ps = wd.wn_layer_dcond_plain(*args, k["acc"], d, n_valid=nv)
    acc = k["acc"].clone()
    gx, gs = wd.wn_layer_dcond(*args, acc, d, n_valid=nv)
    assert gs.data_ptr() == acc.data_ptr()     # skip sum updated in place
    close(gx, px)
    assert not gx[:, nv:].any()
    close(gs[:, :nv], ps[:, :nv])


@pytest.mark.parametrize("E,d,li", [(4, 1, 0), (6, 64, 1), (8, 128, 2)])
def test_final_dcond_kernel_matches_plain(dev, E, d, li):
    from text2speech_tpu_torch.ops import wn_block_dcond as wd

    B, T, nv, C, L = 1, 257, 250, 256, 3
    k = inputs(dev, B, T, nv, C, 96, E, rs_out=C, E=E)
    cond_all = cond_all_for(dev, B, T, C, L, E)
    w_eff, b_eff = wb.fold_end(k["w_rs"], k["b_rs"], k["w_end"], k["b_end"])
    args = (k["x"], cond_all, li, k["w_in"], k["b_in"], w_eff, k["acc"],
            k["w_end"], b_eff, d)
    close(wd.wn_layer_final_dcond(*args, n_valid=nv),
          wd.wn_layer_final_dcond_plain(*args, n_valid=nv))


@pytest.mark.parametrize("C,B,T,nv,d", [
    (512, 1, 1000, 937, 64),    # 64-row tile (one utterance)
    (512, 3, 6000, 5999, 128),  # 128-row tile (141 blocks), n_valid = T - 1
    (512, 2, 777, 0, 1),        # nothing valid: no in-act stage at all
    (128, 2, 333, 300, 130),    # n_valid off the tile, a halo past a tile
    (256, 3, 6400, 6400, 8),    # 128-row tile, K = 64 stages
])
@pytest.mark.parametrize("rs_full", [True, False])
def test_sm90_dcond_layer_agrees_with_first_design_and_plain(dev, C, B, T,
                                                             nv, d, rs_full):
    """The sm90 ``dcond`` standard layer against its first design
    (``wn_block.first_design("wn_layer_dcond", ...)``) and its plain
    version, at the first and the last ``cond_index``; rows past n_valid of
    x_out are zero, and the skip sum is updated in place on every row."""
    from text2speech_tpu_torch.ops import wn_block_dcond as wd

    L = 4
    k = inputs(dev, B, T, nv, C, 64, C + nv + d,
               rs_out=2 * C if rs_full else C)
    cond_all = cond_all_for(dev, B, T, C, L, nv + d)
    for li in (0, L - 1):
        args = (k["x"], cond_all, li, k["w_in"], k["b_in"], k["w_rs"],
                k["b_rs"])
        wd.reset_launch_counts()
        acc = k["acc"].clone()
        gx, gs = wd.wn_layer_dcond(*args, acc, d, n_valid=nv)
        assert wd.launch_counts()["wn_layer_dcond"] == 1
        assert gs.data_ptr() == acc.data_ptr()
        fx, fs = wb.first_design("wn_layer_dcond", *args, k["acc"].clone(),
                                 d, n_valid=nv)
        px, ps = wd.wn_layer_dcond_plain(*args, k["acc"], d, n_valid=nv)
        assert wd.launch_counts()["wn_layer_dcond"] == 1
        assert not gx[:, nv:].any()
        for want_x, want_s in ((fx, fs), (px, ps)):
            if nv:
                close(gx, want_x)
            else:
                assert not want_x.any()
            close(gs, want_s)


def test_dcond_wrappers_reject_what_the_kernels_do_not_take(dev):
    from text2speech_tpu_torch.ops import wn_block_dcond as wd

    B, T, C, L = 1, 64, 128, 2
    k = inputs(dev, B, T, T, C, 64, 7)
    cond_all = cond_all_for(dev, B, T, C, L, 7)
    tail = (k["w_in"], k["b_in"], k["w_rs"], k["b_rs"], k["acc"], 1)
    with pytest.raises(ValueError, match="cond_index"):
        wd.wn_layer_dcond(k["x"], cond_all, L, *tail)
    with pytest.raises(ValueError, match="contiguous"):    # a copied slice
        wd.wn_layer_dcond(k["x"], cond_all[..., : 2 * C], 0, *tail)
    with pytest.raises(ValueError, match="dtype"):
        wd.wn_layer_dcond(k["x"], cond_all.float(), 0, *tail)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        wd.wn_layer_dcond(k["x"], cond_all.cpu(), 0, *tail)


def test_infer_fused_composed_launches_dcond_kernels_and_matches(dev):
    """One composed vocode: 1 / L-2 / 1 launches per flow of the dcond
    wrappers and none of the projecting ones; the audio agrees with the
    composed plain path and, more loosely (cond_all is rounded to bf16
    once more than the in-kernel projection), with the in-kernel path."""
    from text2speech_tpu_torch.models.waveglow_fused import (
        infer_fused, precompute_composed_cond, prepare_fused)
    from text2speech_tpu_torch.ops import wn_block_dcond as wd

    model, _ = small_waveglow(dev)
    fw = prepare_fused(model)
    cc = precompute_composed_cond(model)
    gen = torch.Generator(device="cuda").manual_seed(1)
    mel = torch.randn(2, 16, 77, generator=gen, device="cuda")
    noise = tuple(torch.randn(s, generator=gen, device="cuda")
                  for s in fw.noise_shapes(2, 77 * 2))
    wb.reset_launch_counts()
    wd.reset_launch_counts()
    got = infer_fused(fw, mel, 0.7, noise=noise, composed_cond=cc)
    assert wd.launch_counts() == {"wn_layer_first_dcond": 4,
                                  "wn_layer_dcond": 8,
                                  "wn_layer_final_dcond": 4}
    assert sum(wb.launch_counts().values()) == 0
    want = infer_fused(fw, mel, 0.7, noise=noise, plain=True,
                       composed_cond=cc)
    inkernel = infer_fused(fw, mel, 0.7, noise=noise)
    assert got.shape == want.shape == (2, 77 * 16)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 16 * 2.0 ** -8 * want.abs().max()
    assert ((got - want).norm() / want.norm()).item() < 2e-2
    assert ((got - inkernel).norm() / inkernel.norm()).item() < 5e-2


# ---------------------------------------------------------------------------
# streaming on the card
# ---------------------------------------------------------------------------


def test_keep_masks_are_prefix_stable_on_a_cuda_generator(dev):
    """Masks for 200 steps are the first 200 of the masks for 256, drawn
    from a CUDA generator (a single larger draw need not start alike)."""
    from text2speech_tpu_torch.config import HParams
    from text2speech_tpu_torch.models.tacotron2 import Decoder

    dec = Decoder(HParams(), device=dev)

    def gen():
        return torch.Generator(device="cuda").manual_seed(3)

    short = dec.draw_keep_masks(200, 3, gen(), dev)
    long = dec.draw_keep_masks(256, 3, gen(), dev)
    assert short.shape == (200, 2, 3, 256) and short.is_cuda
    assert torch.equal(short, long[:200])


@pytest.mark.parametrize("rows", [1, 8, 32, 40])
def test_qdot_int8_product_is_exact_on_the_card(dev, rows):
    """``_qdot`` through ``torch._int_mm`` with zero-padded rows equals the
    integer product computed on the CPU, scales applied alike: 1e-6
    relative (the same float32 operations on the same integers)."""
    from text2speech_tpu_torch.models import tacotron_serve as ts

    g = torch.Generator().manual_seed(rows)
    w = torch.randn(256, 96, generator=g) * 0.1
    x = torch.randn(rows, 96, generator=g)
    entry = ts.quantize_kernel_int8(w)
    want = ts._qdot(x, entry, torch.float32)
    got = ts._qdot(x.to(dev), {k: v.to(dev) for k, v in entry.items()},
                   torch.float32)
    assert got.shape == (rows, 256)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


def test_streaming_small_synthesizer_on_the_card(dev):
    """A small synthesizer on the card: the chunked decode equals the batch
    decode bit for bit with masks drawn from a CUDA generator, the fp
    serving decode equals the module's, and the streamed audio (fused bf16
    kernels, C=128) agrees with the single pass over the final mel with
    the same noise within the end-to-end bounds of the kernel path."""
    from text2speech_tpu_torch.config import HParams
    from text2speech_tpu_torch.infer import random_synthesizer
    from text2speech_tpu_torch.models import tacotron_serve as ts
    from text2speech_tpu_torch.models.chunked import draw_noise

    hp = HParams(embedding_size=32, enc_conv_channels=32,
                 attention_rnn_dim=32, decoder_rnn_dim=32, prenet_dim=16,
                 attention_dim=16, n_mel_channels=16,
                 postnet_embedding_dim=32, max_decoder_steps=300)
    cfg = WaveGlowConfig(n_mel_channels=16, n_flows=4, n_group=8,
                         n_early_every=2, n_early_size=2, wn_n_layers=4,
                         wn_n_channels=128, upsample_kernel=64,
                         upsample_stride=16)
    synth = random_synthesizer(hp, cfg, 0, device="cuda", use_denoiser=False)
    texts = ["안녕하세요.", "네."]
    mel_ref, len_ref = synth.text_to_mel(texts, seed=3, max_steps=100)
    chunks = [m for m, _, _ in synth.text_to_mel_stream(
        texts, chunk_steps=32, seed=3, max_steps=100)]
    mel_s = torch.cat(chunks, dim=-1)
    assert mel_s.is_cuda and mel_s.shape == mel_ref.shape
    torch.testing.assert_close(mel_s, mel_ref, rtol=0, atol=2e-5)

    with torch.inference_mode():
        from text2speech_tpu_torch.text import encode_batch

        ids, lengths = encode_batch(texts)
        lengths = torch.from_numpy(lengths).to(dev)
        memory = synth.taco.encode(torch.from_numpy(ids).long().to(dev),
                                   text_lengths=lengths)
        carry = synth.taco.decoder.initial_carry(memory)
        masks = synth.taco.decoder.draw_keep_masks(
            16, 2, torch.Generator(device="cuda").manual_seed(1), dev)
        a = synth.taco.decode_chunk(memory, *carry, masks, lengths)
        b = ts.decode_chunk_serve(
            ts.extract_decoder_params(synth.taco), hp, memory,
            synth.taco.process_memory(memory), *carry, masks, lengths)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])

    gpf = cfg.upsample_stride // cfg.n_group
    wb.reset_launch_counts()
    got = torch.from_numpy(np.concatenate(list(synth.synthesize_incremental(
        texts[0], sigma=0.7, seed=3, chunk_steps=32, max_steps=100))))
    assert wb.launch_counts()["wn_layer"] > 0
    gen = torch.Generator(device="cuda").manual_seed(4)
    mels, noise = [], None
    for m, out_len, _ in synth.text_to_mel_stream(
            texts[0], chunk_steps=32, seed=3, max_steps=100):
        mels.append(m)
        nz = draw_noise(cfg, gen, 1, m.shape[-1] * gpf)
        noise = (list(nz) if noise is None
                 else [torch.cat([p, z], 1) for p, z in zip(noise, nz)])
    n = int(out_len[0])
    want = synth.mel_to_audio(
        torch.cat(mels, -1)[:, :, :n].contiguous(), 0.7,
        noise=tuple(z[:, : n * gpf] for z in noise))[0].cpu()
    assert got.shape == want.shape == (n * cfg.upsample_stride,)
    assert (got - want).abs().max() <= 16 * 2.0 ** -8 * want.abs().max()
    assert ((got - want).norm() / want.norm()).item() < 2e-2


# ---------------------------------------------------------------------------
# tensor-parallel partial layers (one rank's share of a WN layer)
# ---------------------------------------------------------------------------


def rank_cols(C, Cp, i):
    """Rank i's gate-paired columns of a 2C-wide in-act product."""
    return np.r_[i * Cp:(i + 1) * Cp, C + i * Cp:C + (i + 1) * Cp]


@pytest.mark.parametrize("p,d,rs_full", [(2, 1, True), (2, 64, False),
                                         (4, 128, True), (8, 400, True),
                                         (8, 2, False)])
def test_partial_kernel_matches_plain_and_sums_to_the_layer(dev, p, d,
                                                            rs_full):
    """Every rank's partial against its plain version, and the ranks' sum
    plus the bias against the whole layer's plain res/skip product."""
    B, T, nv, C, M = 2, 333, 300, 512, 64
    Cp = C // p
    rs_out = 2 * C if rs_full else C
    k = inputs(dev, B, T, nv, C, M, d, rs_out=rs_out)
    total = None
    for i in range(p):
        cols = torch.from_numpy(rank_cols(C, Cp, i)).to(dev)
        args = (k["x"], k["spect"], k["w_in"][..., cols].contiguous(),
                k["b_in"][cols].contiguous(),
                k["w_cond"][:, cols].contiguous(),
                k["b_cond"][cols].contiguous(),
                k["w_rs"][i * Cp:(i + 1) * Cp].contiguous(), d)
        got = wb.wn_layer_partial(*args, n_valid=nv)
        want = wb.wn_layer_partial_plain(*args, n_valid=nv)
        assert got.dtype == torch.float32 and got.shape == (B, T, rs_out)
        assert (got[:, nv:] == 0).all()
        close(got, want)
        total = got if total is None else total + got
    cond = wb._cond(k["spect"], k["w_cond"], k["b_cond"])
    in_act = wb._taps(k["x"], k["w_in"], d, nv) + k["b_in"] + cond
    whole = (wb._gate(in_act, torch.bfloat16).float() @ k["w_rs"].float()
             + k["b_rs"])
    close((total + k["b_rs"])[:, :nv], whole[:, :nv])


@pytest.mark.parametrize("n_half,p", [(2, 2), (3, 4), (4, 8)])
def test_partial_first_form_kernel_matches_plain(dev, n_half, p):
    """The layer-0 form: the audio half under a rank's columns of the
    composed taps, with the edge-bias rows."""
    B, T, nv, C, M = 3, 300, 271, 512, 64
    Cp = C // p
    k = inputs(dev, B, T, nv, C, M, n_half, n_half=n_half)
    for i in (0, p - 1):
        cols = torch.from_numpy(rank_cols(C, Cp, i)).to(dev)
        wp, b_all, b_edge = wb.fold_first_taps(
            k["start_k"], k["start_b"], k["w_in"][..., cols],
            k["b_in"][cols])
        args = (k["x0"], k["spect"], wp, b_all,
                k["w_cond"][:, cols].contiguous(),
                k["b_cond"][cols].contiguous(),
                k["w_rs"][i * Cp:(i + 1) * Cp].contiguous(), 1)
        got = wb.wn_layer_partial(*args, b_edge=b_edge, n_valid=nv)
        want = wb.wn_layer_partial_plain(*args, b_edge=b_edge, n_valid=nv)
        assert (got[:, nv:] == 0).all()
        close(got, want)


@pytest.mark.parametrize("p,d,rs_full", [(2, 1, True), (4, 128, False),
                                         (8, 400, True)])
def test_partial_int8_kernel_matches_plain(dev, p, d, rs_full):
    """Each rank quantizes its own slices.  The integer products are exact
    on both sides; a gated value on a rounding knife edge may differ by one
    count, which moves an output by at most that column's weight scale, so
    the f32 partial is held to the final int8 layer's bound, 0.02, and to
    5e-3 relative L2."""
    B, T, nv, C, M = 2, 333, 300, 512, 64
    Cp = C // p
    k = inputs(dev, B, T, nv, C, M, d, rs_out=2 * C if rs_full else C)
    qx, sx = wq.quantize_rows(k["x"])
    qspect, sspect = wq.quantize_rows(k["spect"])
    for i in (0, p - 1):
        cols = torch.from_numpy(rank_cols(C, Cp, i)).to(dev)
        qs = [wq.quantize_cols(w) for w in (
            k["w_in"][..., cols], k["w_cond"][:, cols],
            k["w_rs"][i * Cp:(i + 1) * Cp])]
        (qw_in, sw_in), (qw_cond, sw_cond), (qw_rs, sw_rs) = [
            (wq.to_output_major(q), s) for q, s in qs]
        args = (qx, sx, qspect, sspect, qw_in, sw_in,
                k["b_in"][cols].contiguous(), qw_cond, sw_cond,
                k["b_cond"][cols].contiguous(), qw_rs, sw_rs, d)
        got = wq.wn_layer_partial_int8(*args, n_valid=nv)
        want = wq.wn_layer_partial_int8_plain(*args, n_valid=nv)
        assert torch.isfinite(got).all() and (got[:, nv:] == 0).all()
        assert (got - want).abs().max().item() <= 0.02
        assert ((got - want).norm() / want.norm()).item() <= REL_L2


def test_partial_wrappers_reject_what_the_kernels_do_not_take(dev):
    B, T, C, M = 1, 64, 128, 64
    k = inputs(dev, B, T, T, C, M, 7)
    args = [k["x"], k["spect"], k["w_in"][..., :128].contiguous(),
            k["b_in"][:128].contiguous(), k["w_cond"][:, :128].contiguous(),
            k["b_cond"][:128].contiguous(), k["w_rs"][:64].contiguous()]
    wb.wn_layer_partial(*args, 1)
    bad = list(args)
    bad[0] = args[0].float()
    with pytest.raises(ValueError, match="dtype"):
        wb.wn_layer_partial(*bad, 1)
    bad = list(args)      # a rank's share narrower than one gate-pair chunk
    bad[2], bad[3] = args[2][..., :64].contiguous(), args[3][:64].contiguous()
    bad[4], bad[5] = args[4][:, :64].contiguous(), args[5][:64].contiguous()
    bad[6] = args[6][:32].contiguous()
    with pytest.raises(ValueError, match="Cp % 64"):
        wb.wn_layer_partial(*bad, 1)
    bad = list(args)
    bad[6] = args[6].cpu()
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        wb.wn_layer_partial(*bad, 1)


# --- the padded-layout family (kernels 12-15) and the ladder ---------------


def padded_case(dev, T, n_valid, seed, C=512, M=640, E=8):
    """Seeded bf16 inputs on the ``pad_tiles`` layout: hidden state and
    mel zero past ``n_valid``, a pre-materialized conditioning of 2 layers,
    the [C, 2C] and the last layer's [C, C] res/skip weights."""
    from text2speech_tpu_torch.ops.wn_block_padded import pad_tiles

    g = torch.Generator().manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    mask = (torch.arange(T) < n_valid)[None, :, None].to(dev)
    k = {"x": rn(1, T, C) * mask, "spect": rn(1, T, M) * mask,
         "cond": rn(1, T, 4 * C) * mask, "acc": rn(1, T, C, scale=0.5) * mask,
         "w_in": rn(3, C, 2 * C, scale=(3 * C) ** -0.5),
         "b_in": rn(2 * C, scale=0.1, dtype=f32),
         "w_cond": rn(M, 2 * C, scale=M ** -0.5),
         "b_cond": rn(2 * C, scale=0.1, dtype=f32),
         "w_rs": rn(C, 2 * C, scale=C ** -0.5),
         "b_rs": rn(2 * C, scale=0.1, dtype=f32),
         "w_last": rn(C, C, scale=C ** -0.5),
         "b_last": rn(C, scale=0.1, dtype=f32),
         "w_end": rn(C, E, scale=C ** -0.5),
         "b_end": rn(E, scale=0.1, dtype=f32)}
    p = {n: pad_tiles(k[n]) for n in ("x", "spect", "cond", "acc")}
    return k, p


@pytest.mark.parametrize("d,n_valid", [(1, 6400), (64, 6099), (128, 6400),
                                       (128, 5000)])
def test_padded_kernels_match_plain(dev, d, n_valid):
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    k, p = padded_case(dev, 6400, n_valid, d + n_valid)
    bt = wp.BT_PAD
    head = (k["w_in"], k["b_in"], k["w_cond"], k["b_cond"])
    calls = {
        "wn_layer_padded": lambda f: f(p["x"], p["cond"], k["w_in"],
                                       k["b_in"], k["w_rs"], k["b_rs"], d, 1,
                                       n_valid=n_valid),
        "wn_layer_spect": lambda f: f(p["x"], p["spect"], *head, k["w_rs"],
                                      k["b_rs"], p["acc"].clone(), d,
                                      n_valid=n_valid),
        "wn_layer_stream": lambda f: f(p["x"], p["spect"], *head, k["w_rs"],
                                       k["b_rs"], p["acc"].clone(), d,
                                       n_valid=n_valid),
        "wn_layer_stream_final": lambda f: f(
            p["x"], p["spect"], *head, k["w_last"], k["b_last"], p["acc"],
            k["w_end"], k["b_end"], d, n_valid=n_valid),
    }
    wp.reset_launch_counts()
    for name, call in calls.items():
        got = call(getattr(wp, name))
        want = call(getattr(wp, name + "_plain"))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert not g[:, :bt].any() and not g[:, -bt:].any(), name
            close(g, w)
    torch.cuda.synchronize()
    assert wp.launch_counts() == dict.fromkeys(calls, 1)


@pytest.mark.parametrize("d", [1, 128])
def test_padded_ladder_across_kernels(dev, d):
    """Kernel 2 vs 14 and 9 vs 12 on the valid rows, 13 vs 14 whole."""
    from text2speech_tpu_torch.ops import wn_block_dcond as wd
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    n_valid = 6300
    k, p = padded_case(dev, 6400, n_valid, 7 + d)
    head = (k["w_in"], k["b_in"], k["w_cond"], k["b_cond"])
    x2, s2 = wb.wn_layer(k["x"], k["spect"], *head, k["w_rs"], k["b_rs"],
                         k["acc"].clone(), d, n_valid=n_valid)
    std = (p["x"], p["spect"], *head, k["w_rs"], k["b_rs"])
    x14, s14 = wp.wn_layer_stream(*std, p["acc"].clone(), d, n_valid=n_valid)
    x13, s13 = wp.wn_layer_spect(*std, p["acc"].clone(), d, n_valid=n_valid)
    close(x2, wp.unpad_tiles(x14))
    close(s2[:, :n_valid], wp.unpad_tiles(s14)[:, :n_valid])
    close(x13, x14)
    close(s13, s14)
    x9, s9 = wd.wn_layer_dcond(k["x"], k["cond"], 1, k["w_in"], k["b_in"],
                               k["w_rs"], k["b_rs"], torch.zeros_like(k["x"]),
                               d, n_valid=n_valid)
    x12, s12 = wp.wn_layer_padded(p["x"], p["cond"], k["w_in"], k["b_in"],
                                  k["w_rs"], k["b_rs"], d, 1,
                                  n_valid=n_valid)
    close(x9, wp.unpad_tiles(x12))
    close(s9[:, :n_valid], wp.unpad_tiles(s12)[:, :n_valid])


def test_padded_wrappers_reject_what_the_kernels_do_not_take(dev):
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    k, p = padded_case(dev, 256, 256, 3, C=128, M=32)
    args = [p["x"], p["cond"], k["w_in"], k["b_in"], k["w_rs"], k["b_rs"]]
    with pytest.raises(ValueError, match="dilation"):
        wp.wn_layer_padded(*args, 129)
    with pytest.raises(ValueError, match="cond_index"):
        wp.wn_layer_padded(*args, 1, 5)
    with pytest.raises(ValueError, match="pad tile"):
        wp.wn_layer_padded(*args, 1, bt=64)
    with pytest.raises(ValueError, match="in place"):
        wp.wn_layer_spect(p["x"], p["spect"], k["w_in"], k["b_in"],
                          k["w_cond"], k["b_cond"], k["w_rs"], k["b_rs"],
                          p["x"], 1)


# --- Tacotron training on the card ------------------------------------------


def _small_tacotron():
    """A small Tacotron's seeded weights, a batch (text, text lengths, mel,
    output lengths, gate targets) and hand-built dropout masks, on the
    CPU."""
    from text2speech_tpu_torch.config import HParams
    from text2speech_tpu_torch.models.tacotron2 import (Tacotron2,
                                                        init_weights_)

    hp = HParams(embedding_size=64, enc_conv_channels=64,
                 attention_rnn_dim=128, decoder_rnn_dim=128, prenet_dim=32,
                 n_mel_channels=16, postnet_embedding_dim=64)
    g = torch.Generator().manual_seed(0)
    B, T_in, T_out = 4, 20, 48
    text = torch.randint(2, 70, (B, T_in), generator=g, dtype=torch.int32)
    in_len = torch.tensor([20, 17, 12, 9], dtype=torch.int32)
    out_len = torch.tensor([48, 40, 33, 20], dtype=torch.int32)
    mel = torch.randn(B, 16, T_out, generator=g)
    gate = (torch.arange(T_out)[None] >= out_len[:, None] - 1).float()
    model = init_weights_(Tacotron2(hp, 80), torch.Generator().manual_seed(1))
    masks = model.draw_train_masks(B, T_in, T_out,
                                   torch.Generator().manual_seed(2))
    return hp, model, (text, in_len, mel, out_len, gate), masks


def _tacotron_step(hp, model, batch, masks, d, compute_dtype=None):
    """One training forward and backward of a copy of ``model`` on device
    ``d`` -> (loss, {name: gradient}, {name: buffer}), on the CPU."""
    from text2speech_tpu_torch.models.losses import tacotron2_loss
    from text2speech_tpu_torch.models.tacotron2 import Tacotron2

    m = Tacotron2(hp, 80, device=d, compute_dtype=compute_dtype)
    m.load_state_dict(model.state_dict())
    mk = type(masks)(*([x.to(d) for x in f] if isinstance(f, list)
                       else f.to(d) for f in masks))
    text, in_len, mel, out_len, gate = (t.to(d) for t in batch)
    outs = m(text, in_len, mel, out_len, train=True, masks=mk)
    assert all(o.dtype == torch.float32 for o in outs)
    loss, _ = tacotron2_loss(*outs[:3], mel, gate)
    loss.backward()
    return (loss.item(), {n: p.grad.cpu() for n, p in m.named_parameters()},
            {n: b.cpu() for n, b in m.named_buffers()})


def _rel_l2(a, b):
    return ((a - b).norm() / b.norm()).item()


def test_tacotron_train_step_on_the_card_matches_the_cpu(dev):
    """One training step of a small Tacotron with the same weights, batch
    and dropout masks on the card and on the CPU (TF32 off): loss within
    1e-5 relative, the gradient within 1e-4 relative L2, equal running
    statistics within 1e-6."""
    setup = _small_tacotron()
    l_c, g_c, b_c = _tacotron_step(*setup, "cpu")
    l_g, g_g, b_g = _tacotron_step(*setup, dev)
    assert l_g == pytest.approx(l_c, rel=1e-5)
    flat = [torch.cat([g.flatten() for g in gs.values()]) for gs in (g_g, g_c)]
    assert _rel_l2(*flat) < 1e-4
    for n, b in b_c.items():
        assert torch.allclose(b_g[n].float(), b.float(), atol=1e-6), n


def test_tacotron_bf16_step_on_the_card_tracks_the_cpu_f32(dev):
    """The bf16 step on the card (CUDA autocast, the decoder step's weights
    cast once through ``_SharedCast``) against the f32 step on the CPU,
    same weights, batch and masks: products of bf16-rounded operands.  The
    same comparison under the CPU's autocast reads a loss 5.4e-4 relative
    apart, the gradient 0.061 relative L2 apart and each leaf at most 0.16
    apart; bounds of about three times that: loss 2e-3 relative, gradient
    0.2, each leaf 0.5 (a conv bias that feeds a BatchNorm has a zero
    gradient in exact arithmetic and is rounding noise on both sides, so it
    counts only in the whole); f32 gradients."""
    setup = _small_tacotron()
    l_c, g_c, _ = _tacotron_step(*setup, "cpu")
    l_g, g_g, _ = _tacotron_step(*setup, dev, torch.bfloat16)
    assert l_g == pytest.approx(l_c, rel=2e-3)
    assert all(g.dtype == torch.float32 for g in g_g.values())
    flat = [torch.cat([g.flatten() for g in gs.values()]) for gs in (g_g, g_c)]
    assert _rel_l2(*flat) < 0.2
    for n in g_c:
        if not (".convs." in n and n.endswith(".bias")):
            assert _rel_l2(g_g[n], g_c[n]) < 0.5, n


@pytest.fixture
def deterministic():
    """Deterministic cuDNN and PyTorch kernels for one test (a backward
    kernel that adds with atomics may round differently on every run)."""
    prev = (torch.backends.cudnn.deterministic,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.backends.cudnn.deterministic = prev[0]
    torch.use_deterministic_algorithms(prev[1], warn_only=prev[2])


def test_tacotron_bf16_remat_step_on_the_card(dev, deterministic):
    """bf16 products with decoder remat: the same loss and gradients as
    bf16 without (the recompute replays the same kernels, chosen
    deterministic so that two runs agree at all), f32 outputs."""
    from text2speech_tpu_torch.config import HParams
    from text2speech_tpu_torch.models.losses import tacotron2_loss
    from text2speech_tpu_torch.models.tacotron2 import (Tacotron2,
                                                        init_weights_)

    hp = HParams(embedding_size=64, enc_conv_channels=64,
                 attention_rnn_dim=128, decoder_rnn_dim=128, prenet_dim=32,
                 n_mel_channels=16, postnet_embedding_dim=64)
    g = torch.Generator().manual_seed(0)
    B, T_in, T_out = 2, 16, 32
    text = torch.randint(2, 70, (B, T_in), generator=g,
                         dtype=torch.int32).to(dev)
    lens = torch.tensor([16, 11], dtype=torch.int32, device=dev)
    outl = torch.tensor([32, 25], dtype=torch.int32, device=dev)
    mel = torch.randn(B, 16, T_out, generator=g).to(dev)
    gate = torch.zeros(B, T_out, device=dev)
    base = init_weights_(Tacotron2(hp, 80), torch.Generator().manual_seed(1))
    masks = base.draw_train_masks(B, T_in, T_out,
                                  torch.Generator(device=dev).manual_seed(3),
                                  dev)
    out = []
    for remat in (False, True):
        m = Tacotron2(hp, 80, device=dev, compute_dtype=torch.bfloat16,
                      decoder_remat=remat)
        m.load_state_dict(base.state_dict())
        preds = m(text, lens, mel, outl, train=True, masks=masks)
        assert all(p.dtype == torch.float32 for p in preds)
        loss, _ = tacotron2_loss(*preds[:3], mel, gate)
        loss.backward()
        out.append((loss.detach(), [p.grad.clone() for p in m.parameters()]))
    assert torch.isfinite(out[0][0])
    assert torch.allclose(out[0][0], out[1][0], rtol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6)
