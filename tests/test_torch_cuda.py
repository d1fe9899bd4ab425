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
def test_sm90_kernels_agree_with_plain(dev, C):
    """The sm90 standard and final layers against their plain versions on
    the same inputs, within the kernel bounds; 640 takes the 64-row
    tile."""
    B, T, nv, M, d = 2, 500, 451, 64, 64
    k = inputs(dev, B, T, nv, C, M, 31 + C, E=8)
    args = (k["x"], k["spect"], k["w_in"], k["b_in"], k["w_cond"],
            k["b_cond"], k["w_rs"], k["b_rs"])
    gx, gs = wb.wn_layer(*args, k["acc"].clone(), d, n_valid=nv)
    px, ps = wb.wn_layer_plain(*args, k["acc"], d, n_valid=nv)
    close(gx, px)
    close(gs[:, :nv], ps[:, :nv])
    w_eff, b_eff = wb.fold_end(k["w_rs"][:, :C].contiguous(),
                               k["b_rs"][:C].contiguous(), k["w_end"],
                               k["b_end"])
    fargs = (*args[:6], w_eff, k["acc"], k["w_end"], b_eff, d)
    close(wb.wn_layer_final(*fargs, n_valid=nv),
          wb.wn_layer_final_plain(*fargs, n_valid=nv))


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


# --- the bf16 first layers on wgmma (FIRST, FIRST + DCOND) ------------------

# (B, T, n_valid, d): all valid, n_valid off the tile at batch 3, n_valid
# < d, nothing valid, the 128-row tile; d up to the config's largest, 128
FIRST_EDGES = [(1, 1000, 1000, 1), (3, 777, 700, 64), (1, 1000, 50, 64),
               (2, 1000, 0, 128), (3, 6450, 6401, 128)]


def _first_args(k, d, cond_all=None):
    """Row 1's wrapper arguments, or with ``cond_all`` row 10's."""
    fold = wb.fold_first_taps(k["start_k"], k["start_b"], k["w_in"],
                              k["b_in"])
    head = (k["start_k"], k["start_b"], *fold)
    if cond_all is not None:
        return (k["x0"], cond_all, *head, k["w_rs"], k["b_rs"], d)
    return (k["x0"], k["spect"], *head, k["w_cond"], k["b_cond"], k["w_rs"],
            k["b_rs"], d)


def _close_first(got, want, nv):
    assert not got[0][:, nv:].any() and not want[0][:, nv:].any()
    if nv:
        close(got[0], want[0])
    close(got[1], want[1])                    # the skip on every row


@pytest.mark.parametrize("n_half", [2, 3, 4])
@pytest.mark.parametrize("B,T,nv,d", FIRST_EDGES)
@pytest.mark.parametrize("C,M", [(512, 640), (256, 96)])
def test_sm90_first_agrees_with_plain(dev, C, M, B, T, nv, d, n_half):
    """Row 1, the sm90 kernel's FIRST role (the tap stage on the tensor
    cores, the conditioning's K = M stages, the edge take-back, the
    residual base), against its plain version within the kernel
    bounds."""
    k = inputs(dev, B, T, nv, C, M, 3 * d + n_half + C, n_half=n_half)
    args = _first_args(k, d)
    got = wb.wn_layer_first(*args, n_valid=nv)
    _close_first(got, wb.wn_layer_first_plain(*args, n_valid=nv), nv)


@pytest.mark.parametrize("n_half", [2, 3, 4])
@pytest.mark.parametrize("B,T,nv,d", FIRST_EDGES)
@pytest.mark.parametrize("C", [512, 256])
def test_sm90_first_dcond_agrees_with_plain(dev, C, B, T, nv, d, n_half):
    """Row 10, FIRST with DCOND (the tap stage the whole in-act product,
    slice 0 of ``cond_all`` in the gate), against its plain version."""
    from text2speech_tpu_torch.ops import wn_block_dcond as wd

    k = inputs(dev, B, T, nv, C, 64, 5 * d + n_half + C, n_half=n_half)
    args = _first_args(k, d, cond_all_for(dev, B, T, C, 3, d + n_half))
    got = wd.wn_layer_first_dcond(*args, n_valid=nv)
    _close_first(got, wd.wn_layer_first_dcond_plain(*args, n_valid=nv), nv)


def test_sm90_first_layers_count_once(dev):
    """Each wrapper call is one launch of its counter, under the names the
    paths count (12 per vocode each)."""
    from text2speech_tpu_torch.ops import wn_block_dcond as wd

    k = inputs(dev, 1, 200, 180, 128, 64, 6, n_half=2)
    args = _first_args(k, 1)
    dargs = _first_args(k, 1, cond_all_for(dev, 1, 200, 128, 2, 6))
    wb.reset_launch_counts()
    wd.reset_launch_counts()
    wb.wn_layer_first(*args, n_valid=180)
    wd.wn_layer_first_dcond(*dargs, n_valid=180)
    assert wb.launch_counts() == {"wn_layer_first": 1, "wn_layer": 0,
                                  "wn_layer_final": 0}
    assert wd.launch_counts() == {"wn_layer_first_dcond": 1,
                                  "wn_layer_dcond": 0,
                                  "wn_layer_final_dcond": 0}


def test_sm90_plan_is_the_kernels(dev):
    """The plan's shared memory is what the kernel asks for, for every role
    of ``csrc/wn_block_sm90.cu``, up to C = 1408."""
    lib = wb.LIB_SM90.get()
    for role, code in wb.SM90_ROLES.items():
        for C in (128, 512, 1024, 1408):
            for B in (1, 3):
                plan = wb.sm90_plan(C, 6400, B, role=role)
                assert lib.t2s_wn_sm90_smem_bytes(
                    plan["nwg"], plan["bk"], C, plan["stages"],
                    code) == plan["smem"]


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


def small_waveglow(dev, **cfg_kw):
    """A 4-flow, 4-layer WaveGlow at C=128, M = 16 * 8 = 128 on seeded
    random weights (orthogonal 1x1 convs, small end convs); ``cfg_kw``
    replaces fields of that configuration."""
    from text2speech_tpu_torch.infer import random_weights_
    from text2speech_tpu_torch.models.waveglow import WaveGlow

    cfg = WaveGlowConfig(**{
        **dict(n_mel_channels=16, n_flows=4, n_group=8, n_early_every=2,
               n_early_size=2, wn_n_layers=4, wn_n_channels=128,
               upsample_kernel=64, upsample_stride=16), **cfg_kw})
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


# --- the s8 standard layer on wgmma (csrc/wn_block_int8_sm90.cu) -----------

S8_EDGES = [(1, 1000, 937, 1), (1, 1000, 128, 128), (1, 1000, 129, 64),
            (3, 777, 700, 128), (2, 1000, 0, 1), (3, 6450, 6401, 128),
            (1, 333, 332, 400)]


def _std_int8_args(q):
    return (q["qx"], q["sx"], q["qspect"], q["sspect"], q["qw_in"],
            q["sw_in"], q["b_in"], q["qw_cond"], q["sw_cond"], q["b_cond"],
            q["qw_rs"], q["sw_rs"], q["b_rs"])


@pytest.mark.parametrize("B,T,nv,d", S8_EDGES)
def test_sm90_int8_layer_agrees_with_plain(dev, B, T, nv, d):
    """At the edges of the 64-row tile (T and n_valid off the grid, a halo
    of a whole tile and more, nothing valid, batch 3): against the plain
    version by the int8 rule, the skip sum on every row (rows past n_valid
    are computed alike); two runs bitwise equal."""
    C, M = 512, 640
    q = int8_inputs(dev, B, T, nv, C, M, 11 + d + nv)
    args = _std_int8_args(q)
    got = wq.wn_layer_int8(*args, q["acc"].clone(), d, n_valid=nv)
    again = wq.wn_layer_int8(*args, q["acc"].clone(), d, n_valid=nv)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = wq.wn_layer_int8_plain(*args, q["acc"], d, n_valid=nv)
    close_int8(got, want, T)
    assert (got[0][:, nv:] == 0).all()


@pytest.fixture
def exact_wide_qdot(monkeypatch):
    """The plain int8 versions' integer products in float64 for widths past
    their f32 limit (K = 1040): sums of up to 2816 s8 products stay far
    under 2^53, so they are exact, and round to f32 once, as the kernels'
    s32 sums are converted."""
    monkeypatch.setattr(
        wq, "_qdot", lambda q, qw: (q.double() @ qw.double().T).float())


@pytest.mark.parametrize("C,M", [(1024, 128), (1792, 64), (2816, 64)])
def test_sm90_int8_layer_takes_wide_widths(dev, exact_wide_qdot, C, M):
    """Wide layers (one column group past C = 1664, a shallow ring) against
    the plain version, its integer products exact in float64, by the int8
    rule."""
    B, T, nv, d = 2, 300, 271, 8
    q = int8_inputs(dev, B, T, nv, C, M, C)
    args = _std_int8_args(q)
    got = wq.wn_layer_int8(*args, q["acc"].clone(), d, n_valid=nv)
    want = wq.wn_layer_int8_plain(*args, q["acc"], d, n_valid=nv)
    close_int8(got, want, T)


def test_int8_sm90_plan_is_the_kernels(dev):
    """The plan's shared memory is what the kernel asks for, for every
    role."""
    for role, code in wq.INT8_SM90_ROLES.items():
        for C in (128, 512, 1408 if role == "final" else 2688):
            for B in (1, 3):
                plan = wq.int8_sm90_plan(C, 6400, B, role=role)
                assert wq.LIB_SM90.get().t2s_wn_int8_sm90_smem_bytes(
                    plan["nc"], C, plan["stages"], code) == plan["smem"]


# --- the int8 final and first layers on wgmma (FINAL, FIRST) ---------------

# (B, T, n_valid, d): T - 1 valid, n_valid off the 64-row tile, nothing
# valid, batch 3, a halo past a whole tile
S8_END_EDGES = [(1, 1000, 999, 1), (2, 777, 700, 64), (2, 1000, 0, 1),
                (3, 1000, 937, 128), (1, 333, 332, 400)]


def _final_int8_args(q, d):
    return (q["qx"], q["sx"], q["qspect"], q["sspect"], q["qw_in"],
            q["sw_in"], q["b_in"], q["qw_cond"], q["sw_cond"], q["b_cond"],
            q["w_eff"], q["acc"], q["w_end"], q["b_eff"], d)


def _first_int8_args(q, d):
    return (q["x0"], q["qspect"], q["sspect"], q["start_k"], q["start_b"],
            *q["fold"], q["qw_cond"], q["sw_cond"], q["b_cond"], q["qw_rs"],
            q["sw_rs"], q["b_rs"], d)


@pytest.mark.parametrize("E", [1, 8])
@pytest.mark.parametrize("B,T,nv,d", S8_END_EDGES)
@pytest.mark.parametrize("C,M", [(512, 640), (128, 192), (640, 64)])
def test_sm90_final_int8_agrees_with_plain(dev, C, M, B, T, nv, d, E):
    """FINAL at the edges of its 64-row tile, C 128 / 512 / 640, M % 128 !=
    0: against the plain version within 0.02 on every row, skip_acc
    untouched, two runs bitwise equal."""
    q = int8_inputs(dev, B, T, nv, C, M, 5 * d + E + C, E=E)
    args = _final_int8_args(q, d)
    acc = q["acc"].clone()
    got = wq.wn_layer_final_int8(*args, n_valid=nv)
    assert got.shape == (B, T, E) and torch.isfinite(got).all()
    assert torch.equal(wq.wn_layer_final_int8(*args, n_valid=nv), got)
    assert torch.equal(q["acc"], acc)
    want = wq.wn_layer_final_int8_plain(*args, n_valid=nv)
    assert (got - want).abs().max().item() <= 0.02


@pytest.mark.parametrize("n_half", [1, 2, 3, 4])
@pytest.mark.parametrize("B,T,nv,d", S8_END_EDGES)
@pytest.mark.parametrize("C,M", [(512, 640), (128, 192), (640, 64)])
def test_sm90_first_int8_agrees_with_plain(dev, C, M, B, T, nv, d, n_half):
    """FIRST at the edges of its 64-row tile, n_half 1..4, C 128 / 512 /
    640, M % 128 != 0: against the plain version by the int8 rule, the
    skip on every row; rows past n_valid hold a zero
    payload with the floor scale; two runs bitwise equal."""
    q = int8_inputs(dev, B, T, nv, C, M, 7 * d + n_half + C, n_half=n_half)
    args = _first_int8_args(q, d)
    got = wq.wn_layer_first_int8(*args, n_valid=nv)
    again = wq.wn_layer_first_int8(*args, n_valid=nv)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = wq.wn_layer_first_int8_plain(*args, n_valid=nv)
    close_int8(got, want, T)
    assert (got[0][:, nv:] == 0).all()
    assert torch.equal(got[1][:, nv:], want[1][:, nv:])


@pytest.mark.parametrize("role,C", [("final", 1024), ("final", 1408),
                                    ("first", 1664), ("first", 2688)])
def test_sm90_end_layers_take_wide_widths(dev, exact_wide_qdot, role, C):
    """One column group (FIRST past C = 1536) and shallow rings, up to C =
    1408 (FINAL) and 2688 (FIRST), against the plain version, its integer
    products exact in float64."""
    B, T, nv, d, M = 2, 300, 271, 8, 64
    if role == "final":
        q = int8_inputs(dev, B, T, nv, C, M, C, E=8)
        args = _final_int8_args(q, d)
        got = wq.wn_layer_final_int8(*args, n_valid=nv)
        want = wq.wn_layer_final_int8_plain(*args, n_valid=nv)
        assert (got - want).abs().max().item() <= 0.02
    else:
        q = int8_inputs(dev, B, T, nv, C, M, C, n_half=4)
        args = _first_int8_args(q, d)
        close_int8(wq.wn_layer_first_int8(*args, n_valid=nv),
                   wq.wn_layer_first_int8_plain(*args, n_valid=nv), T)


def test_sm90_end_layers_launch_the_new_roles_and_count_once(dev):
    """Each wrapper call is one launch of its counter."""
    q = int8_inputs(dev, 1, 200, 180, 128, 64, 3, E=8)
    p = int8_inputs(dev, 1, 200, 180, 128, 64, 4, n_half=2)
    wq.reset_launch_counts()
    wq.wn_layer_final_int8(*_final_int8_args(q, 2), n_valid=180)
    wq.wn_layer_first_int8(*_first_int8_args(p, 1), n_valid=180)
    assert wq.launch_counts() == {"wn_layer_first_int8": 1,
                                  "wn_layer_int8": 0,
                                  "wn_layer_final_int8": 1}


def test_sm90_end_layers_reject_what_the_roles_do_not_take(dev):
    """n_half past 4, E past 8, C % 128, M % 64, a weight not output-major
    or on the CPU: each raises before a launch."""
    B, T = 1, 64
    q = int8_inputs(dev, B, T, T, 128, 64, 9, E=8)
    fin = list(_final_int8_args(q, 1))
    p = int8_inputs(dev, B, T, T, 128, 64, 10, n_half=4)
    first = list(_first_int8_args(p, 1))
    wq.reset_launch_counts()
    bad = list(fin)
    bad[10], bad[12] = (torch.zeros(128, 9, dtype=torch.bfloat16, device=dev)
                        for _ in range(2))
    bad[13] = torch.zeros(9, device=dev)
    with pytest.raises(ValueError, match="E in"):
        wq.wn_layer_final_int8(*bad)
    bad = list(first)
    bad[0] = torch.zeros(B, T, 5, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="n_half"):
        wq.wn_layer_first_int8(*bad)
    bad = list(first)
    bad[8] = first[8].transpose(0, 1)           # qw_cond not output-major
    with pytest.raises(ValueError, match="shape|contiguous"):
        wq.wn_layer_first_int8(*bad)
    bad = list(fin)
    bad[4] = fin[4].cpu()
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        wq.wn_layer_final_int8(*bad)
    q96 = int8_inputs(dev, B, T, T, 128, 96, 11, E=8)
    with pytest.raises(ValueError, match="M % 64"):
        wq.wn_layer_final_int8(*_final_int8_args(q96, 1))
    p96 = int8_inputs(dev, B, T, T, 128, 96, 12, n_half=2)
    with pytest.raises(ValueError, match="M % 64"):
        wq.wn_layer_first_int8(*_first_int8_args(p96, 1))
    q192 = int8_inputs(dev, B, T, T, 192, 64, 13, E=8)
    with pytest.raises(ValueError, match="C % 128"):
        wq.wn_layer_final_int8(*_final_int8_args(q192, 1))
    assert sum(wq.launch_counts().values()) == 0


def test_infer_fused_int8_at_reference_depth_launches_12_72_12(dev):
    """12 flows of 8 layers (narrow): 12 / 72 / 12 int8 launches per
    vocode, the 72 standard layers through the s8 wgmma kernel."""
    from text2speech_tpu_torch.models.waveglow_fused import (
        infer_fused_int8, prepare_fused_int8)

    model, _ = small_waveglow(dev, n_flows=12, n_early_every=4,
                              wn_n_layers=8)
    fw = prepare_fused_int8(model)
    gen = torch.Generator(device="cuda").manual_seed(2)
    mel = torch.randn(1, 16, 40, generator=gen, device="cuda")
    noise = tuple(torch.randn(s, generator=gen, device="cuda")
                  for s in fw.noise_shapes(1, 40 * 2))
    wq.reset_launch_counts()
    got = infer_fused_int8(fw, mel, 0.7, noise=noise)
    assert wq.launch_counts() == {"wn_layer_first_int8": 12,
                                  "wn_layer_int8": 72,
                                  "wn_layer_final_int8": 12}
    want = infer_fused_int8(fw, mel, 0.7, noise=noise, plain=True)
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() < 5e-2


# --- the partial layer's sm90 form (csrc/wn_block_sm90.cu PART) ------------


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("B,T,nv,d,rs_full", [
    (1, 1000, 937, 1, True), (3, 777, 700, 128, False),
    (3, 6450, 6401, 64, True), (2, 1000, 0, 1, True)])
def test_sm90_partial_agrees_with_plain(dev, p, B, T, nv, d, rs_full):
    """The first and the last rank's share at reference width: Cp = 256,
    128 and 64 (a half gate chunk), rs_out 2C and C, 64- and 128-row
    tiles, nothing valid."""
    C, M = 512, 640
    Cp = C // p
    k = inputs(dev, B, T, nv, C, M, 3 * p + d, rs_out=2 * C if rs_full else C)
    for i in (0, p - 1):
        cols = torch.from_numpy(rank_cols(C, Cp, i)).to(dev)
        args = (k["x"], k["spect"], k["w_in"][..., cols].contiguous(),
                k["b_in"][cols].contiguous(),
                k["w_cond"][:, cols].contiguous(),
                k["b_cond"][cols].contiguous(),
                k["w_rs"][i * Cp:(i + 1) * Cp].contiguous(), d)
        got = wb.wn_layer_partial(*args, n_valid=nv)
        assert (got[:, nv:] == 0).all()
        if nv:
            close(got, wb.wn_layer_partial_plain(*args, n_valid=nv))


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("int8", [False, True])
def test_tp_vocoder_launches_96p_partial_kernels(dev, p, int8):
    """12 flows of 8 layers at C=256 split over p shards on this card: 96 p
    launches of the bf16 partial wrapper (12 p of them the layer-0 form,
    84 p the sm90 form), or with int8 12 p bf16 and 84 p int8.  The audio
    against the f32 vocoder by ``chip_smoke.py``'s rule: within 3 x (int8:
    5 x) the single-device fused bf16 vocoder's own distance from it, and
    no tighter than 2e-2 (int8: 0.05)."""
    from text2speech_tpu_torch.models.waveglow_fused import (infer_fused,
                                                             prepare_fused)
    from text2speech_tpu_torch.parallel import tp

    model, _ = small_waveglow(dev, n_flows=12, n_early_every=4,
                              wn_n_layers=8, wn_n_channels=256)
    gen = torch.Generator(device="cuda").manual_seed(3)
    mel = torch.randn(1, 16, 40, generator=gen, device="cuda")
    fw = prepare_fused(model)
    noise = tuple(torch.randn(s, generator=gen, device="cuda")
                  for s in fw.noise_shapes(1, 40 * 2))
    server = tp.TPWaveGlowServer(model, p, int8=int8)
    tp.reset_launch_counts()
    got = server(mel, 0.7, noise=noise)
    want = ({"wn_layer_partial": 12 * p, "wn_layer_partial_int8": 84 * p}
            if int8 else {"wn_layer_partial": 96 * p,
                          "wn_layer_partial_int8": 0})
    assert tp.launch_counts() == want
    exact = model.infer(mel, 0.7, noise=noise)
    rel = lambda a: ((a - exact).norm() / exact.norm()).item()  # noqa: E731
    single = rel(infer_fused(fw, mel, 0.7, noise=noise))
    assert torch.isfinite(got).all()
    assert rel(got) < (max(5 * single, 0.05) if int8
                       else max(3 * single, 2e-2))


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
def test_conv_k3_bwd_sm90_agrees_with_plain_and_autograd(dev, dtype, B, T,
                                                         C, d):
    """The sm90 conv backward (wgmma for bf16 at C % 128 == 0, the
    register-tiled FMA GEMM else) against its plain version and autograd
    of ``F.conv1d`` on the same inputs: T ragged against both routes' tiles, a dilation of a whole
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
    px, pw = twb.conv_k3_bwd_plain(x, cot, w, d)
    assert twb.launch_counts() == {"conv_k3_bwd": 1}
    dx2, dw2 = twb.conv_k3_bwd(x, cot, w, d)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    xr = x.float().requires_grad_()
    wr = w.float().requires_grad_()
    F.conv1d(xr.transpose(1, 2), wr.permute(2, 1, 0), padding=d,
             dilation=d).transpose(1, 2).backward(cot.float())
    for want_dx, want_dw in ((px, pw), (xr.grad, wr.grad)):
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
def test_sm90_dcond_layer_agrees_with_plain(dev, C, B, T, nv, d, rs_full):
    """The sm90 ``dcond`` standard layer against its plain version, at the
    first and the last ``cond_index``; rows past n_valid of
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
        px, ps = wd.wn_layer_dcond_plain(*args, k["acc"], d, n_valid=nv)
        assert wd.launch_counts()["wn_layer_dcond"] == 1
        assert not gx[:, nv:].any()
        if nv:
            close(gx, px)
        else:
            assert not px.any()
        close(gs, ps)


@pytest.mark.parametrize("C,B,T,nv,d,E", [
    (512, 1, 1000, 937, 64, 8),     # 64-row tile (one utterance)
    (512, 3, 6000, 5999, 128, 1),   # 128-row tile, n_valid = T - 1, E = 1
    (512, 2, 777, 0, 1, 8),         # nothing valid: no in-act stage at all
    (128, 2, 333, 300, 400, 4),     # n_valid off the tile, a halo past it
    (256, 3, 6400, 6400, 8, 6),     # 128-row tile, K = 64 stages
])
def test_sm90_final_dcond_agrees_with_plain(dev, C, B, T, nv, d, E):
    """The sm90 ``dcond`` final layer (``FINAL`` with ``DCOND``) against its
    plain version at the first and the last ``cond_index``, on every
    row; skip_acc is read, never written; one launch per call."""
    from text2speech_tpu_torch.ops import wn_block_dcond as wd

    L = 4
    k = inputs(dev, B, T, nv, C, 64, C + nv + d, rs_out=C, E=E)
    cond_all = cond_all_for(dev, B, T, C, L, nv + d + E)
    w_eff, b_eff = wb.fold_end(k["w_rs"], k["b_rs"], k["w_end"], k["b_end"])
    acc = k["acc"].clone()
    for li in (0, L - 1):
        args = (k["x"], cond_all, li, k["w_in"], k["b_in"], w_eff, k["acc"],
                k["w_end"], b_eff, d)
        wd.reset_launch_counts()
        got = wd.wn_layer_final_dcond(*args, n_valid=nv)
        want = wd.wn_layer_final_dcond_plain(*args, n_valid=nv)
        assert wd.launch_counts()["wn_layer_final_dcond"] == 1
        assert got.shape == (B, T, E) and got.dtype == torch.float32
        close(got, want)
        assert torch.equal(k["acc"], acc)


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


def partial_first_args(k, C, p, i, d):
    """Rank i of p's layer-0 arguments (the rank's columns of the composed
    taps, folded once) and its b_edge."""
    Cp = C // p
    cols = torch.from_numpy(rank_cols(C, Cp, i)).to(k["x0"].device)
    wp, b_all, b_edge = wb.fold_first_taps(
        k["start_k"], k["start_b"], k["w_in"][..., cols], k["b_in"][cols])
    return (k["x0"], k["spect"], wp, b_all,
            k["w_cond"][:, cols].contiguous(), k["b_cond"][cols].contiguous(),
            k["w_rs"][i * Cp:(i + 1) * Cp].contiguous(), d), b_edge


@pytest.mark.parametrize("p", [1, 2, 4, 8])       # Cp = 512, 256, 128, 64
@pytest.mark.parametrize("B,T,nv,d,M,n_half", [
    (1, 6400, 6400, 1, 640, 4),     # n_valid = T, one utterance
    (3, 6400, 6321, 1, 640, 3),     # the served batch, n_valid < T
    (3, 777, 700, 64, 640, 2),      # T off the 128-row tile, d = 64
    (1, 777, 1, 64, 640, 3),        # n_valid = 1
    (3, 1000, 0, 1, 640, 4),        # nothing valid
    (2, 333, 50, 1, 96, 2)])        # a narrower M
def test_sm90_partial_first_matches_plain(dev, p, B, T, nv, d, M, n_half):
    """The layer-0 form on the sm90 kernel's ``PART_FIRST`` role: the first
    and the last rank against the plain version; one launch a call; zero
    from n_valid on."""
    C = 512
    k = inputs(dev, B, T, nv, C, M, 17 * p + d + nv, n_half=n_half)
    for i in (0, p - 1) if p > 1 else (0,):
        args, b_edge = partial_first_args(k, C, p, i, d)
        wb.wn_layer_partial.launches = 0
        got = wb.wn_layer_partial(*args, b_edge=b_edge, n_valid=nv)
        want = wb.wn_layer_partial_plain(*args, b_edge=b_edge, n_valid=nv)
        assert wb.wn_layer_partial.launches == 1
        assert got.dtype == torch.float32 and got.shape == (B, T, 2 * C)
        assert torch.isfinite(got).all() and (got[:, nv:] == 0).all()
        if nv:
            close(got, want)
        else:
            assert not got.any() and not want.any()


def test_sm90_partial_first_ranks_sum_to_the_first_layer(dev):
    """The p = 4 ranks' layer-0 partials plus the res/skip bias: the whole
    first layer's skip, and its hidden state once the residual base x0
    start_k + start_b is added (as the TP path does after the sum)."""
    B, T, nv, C, M, p = 2, 777, 700, 512, 640, 4
    k = inputs(dev, B, T, nv, C, M, 31, n_half=4)
    total = sum(wb.wn_layer_partial(*a, b_edge=e, n_valid=nv) for a, e in
                (partial_first_args(k, C, p, i, 1) for i in range(p)))
    fold = wb.fold_first_taps(k["start_k"], k["start_b"], k["w_in"],
                              k["b_in"])
    x_out, skip = wb.wn_layer_first_plain(
        k["x0"], k["spect"], k["start_k"], k["start_b"], *fold, k["w_cond"],
        k["b_cond"], k["w_rs"], k["b_rs"], 1, n_valid=nv)
    rs = total + k["b_rs"]
    base = k["x0"].float() @ k["start_k"].float() + k["start_b"]
    close(rs[:, :nv, C:], skip[:, :nv])
    close(base[:, :nv] + rs[:, :nv, :C], x_out[:, :nv])


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("B,T", [(1, 32), (2, 416)])
def test_partial_at_the_demo_widths(dev, layer, B, T):
    """The widths of ``examples/demo.py``'s tensor-parallel vocoder: C =
    128 in two shares of 64 columns, M = 640, n_half 4; layer 0's
    ``PART_FIRST`` at d 1 and layer 1's ``PART`` (the last layer, res/skip
    C wide) at d 2, every row valid.  Each rank against its plain version,
    one launch a call, and the ranks' sum + bias against the whole layer's
    plain res/skip term."""
    C, M, p = 128, 640, 2
    k = inputs(dev, B, T, T, C, M, 41 + layer + T,
               rs_out=2 * C if layer == 0 else C, n_half=4)
    total = None
    for i in range(p):
        if layer == 0:
            args, b_edge = partial_first_args(k, C, p, i, 1)
        else:
            cols = torch.from_numpy(rank_cols(C, C // p, i)).to(dev)
            args = (k["x"], k["spect"], k["w_in"][..., cols].contiguous(),
                    k["b_in"][cols].contiguous(),
                    k["w_cond"][:, cols].contiguous(),
                    k["b_cond"][cols].contiguous(),
                    k["w_rs"][i * (C // p):(i + 1) * (C // p)].contiguous(),
                    2)
            b_edge = None
        wb.wn_layer_partial.launches = 0
        got = wb.wn_layer_partial(*args, b_edge=b_edge, n_valid=T)
        assert wb.wn_layer_partial.launches == 1
        close(got, wb.wn_layer_partial_plain(*args, b_edge=b_edge, n_valid=T))
        total = got if total is None else total + got
    cond = wb._cond(k["spect"], k["w_cond"], k["b_cond"])
    if layer == 0:
        wp, b_all, b_edge = wb.fold_first_taps(k["start_k"], k["start_b"],
                                               k["w_in"], k["b_in"])
        in_act = wb._edge_bias_suppress(
            wb._taps(k["x0"], wp, 1, T) + b_all + cond, b_edge, 1, T)
    else:
        in_act = wb._taps(k["x"], k["w_in"], 2, T) + k["b_in"] + cond
    whole = (wb._gate(in_act, torch.bfloat16).float() @ k["w_rs"].float()
             + k["b_rs"])
    close(total + k["b_rs"], whole)


def test_partial_first_form_counts_one_launch(dev):
    """The layer-0 form's wrapper counts one launch a call; its plain
    version counts none."""
    k = inputs(dev, 1, 200, 180, 512, 64, 5, n_half=3)
    args, b_edge = partial_first_args(k, 512, 2, 1, 1)
    wb.wn_layer_partial.launches = 0
    want = wb.wn_layer_partial_plain(*args, b_edge=b_edge, n_valid=180)
    assert wb.wn_layer_partial.launches == 0
    close(wb.wn_layer_partial(*args, b_edge=b_edge, n_valid=180), want)
    assert wb.wn_layer_partial.launches == 1


@pytest.mark.parametrize("p,d,rs_full", [(2, 1, True), (4, 128, False),
                                         (8, 400, True)])
def test_partial_int8_kernel_matches_plain(dev, p, d, rs_full):
    """Each rank quantizes its own slices.  The integer products are exact
    on both sides, and the s8 wgmma form runs every f32 operation after
    them in the plain version's order, so the f32 partial equals the plain
    version bit for bit."""
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
        assert torch.equal(got, want)


@pytest.mark.parametrize("p", [2, 4, 8])          # Cp = 256, 128, 64
@pytest.mark.parametrize("B,T,nv,d,rs_full", [
    (2, 1000, 0, 1, True),        # nothing valid: no tap stage
    (1, 1000, 999, 64, False),    # n_valid = T - 1
    (3, 777, 700, 128, True),     # n_valid off the tile, batch 3
    (1, 333, 200, 400, False),    # a halo past several tiles
    (3, 6450, 6401, 8, True)])    # the grid of batch 3 at full length
def test_sm90_partial_int8_equals_plain_at_tile_edges(dev, p, B, T, nv, d,
                                                      rs_full):
    """The s8 wgmma ``PART`` form (csrc/wn_block_int8_sm90.cu) equals its
    plain version bit for bit (the integer sums are exact on both sides and
    every f32 operation after them runs in the plain version's order), at
    the first and the last rank; one launch per call."""
    C, M = 512, 640
    Cp = C // p
    k = inputs(dev, B, T, nv, C, M, 5 * p + d, rs_out=2 * C if rs_full else C)
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
        wq.wn_layer_partial_int8.launches = 0
        got = wq.wn_layer_partial_int8(*args, n_valid=nv)
        assert wq.wn_layer_partial_int8.launches == 1
        want = wq.wn_layer_partial_int8_plain(*args, n_valid=nv)
        assert wq.wn_layer_partial_int8.launches == 1
        assert torch.equal(got, want)
        assert (got[:, nv:] == 0).all()


def test_int8_partial_plan_is_the_kernels(dev):
    """The partial plan's shared memory is what the kernel asks for, at
    every rank width of the reference config and a wide one."""
    for Cp in (64, 128, 192, 256, 512, 2816):
        for B in (1, 3):
            plan = wq.int8_sm90_plan(Cp, 6400, B, role="part")
            assert wq.LIB_SM90.get().t2s_wn_int8_sm90_smem_bytes(
                plan["nc"], Cp, plan["stages"],
                wq.INT8_SM90_ROLES["part"]) == plan["smem"]


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


# --- rows 14-15 on csrc/wn_block_padded_sm90.cu (STREAM, STREAM_FINAL) -----


def stream_case(dev, B, T, n_valid, C, M, E, d, seed, rs_half):
    """Rows 14-15's argument tuples (without n_valid) on the pad tiles:
    seeded bf16 inputs, hidden state, mel and skip sum zero past n_valid;
    the stream layer's res/skip weights [C, 2C] or, with ``rs_half``,
    [C, C] (the final layer's)."""
    from text2speech_tpu_torch.ops.wn_block_padded import pad_tiles

    k = inputs(dev, B, T, n_valid, C, M, seed, E=E)
    g = torch.Generator().manual_seed(seed + 1)
    w_last = (torch.randn(C, C, generator=g) * C ** -0.5).to(dev,
                                                             torch.bfloat16)
    b_last = (torch.randn(C, generator=g) * 0.1).to(dev)
    xp, sp, acc = (pad_tiles(k[n]) for n in ("x", "spect", "acc"))
    head = (xp, sp, k["w_in"], k["b_in"], k["w_cond"], k["b_cond"])
    rs = (w_last, b_last) if rs_half else (k["w_rs"], k["b_rs"])
    return ((*head, *rs, acc, d),
            (*head, w_last, b_last, acc, k["w_end"], k["b_end"], d))


STREAM_CASES = (
    [(1, 6400, 512, 640, d, nv) for d in (0, 1, 63, 64, 128)
     for nv in (6400, 6099, 1, 0)]
    + [(3, 6400, 512, 640, d, 6099) for d in (1, 64, 128)]
    + [(1, 1024, 192, 96, 63, 723), (3, 1024, 192, 96, 128, 1)]
    # C = 1024 at d = 128: the plan's one window slot
    + [(1, 256, 1024, 64, 128, 200)])


@pytest.mark.parametrize("case", range(len(STREAM_CASES)))
def test_stream_sm90_matches_plain(dev, case):
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    B, T, C, M, d, nv = STREAM_CASES[case]
    rs_half, E = case % 2 == 1, 1 if case % 3 == 1 else 8
    std, fin = stream_case(dev, B, T, nv, C, M, E, d, 40 + case, rs_half)
    bt = wp.BT_PAD
    acc = std[-2]
    x_new, skip = wp.wn_layer_stream(*std[:-2], acc.clone(), d, n_valid=nv)
    want = wp.wn_layer_stream_plain(*std[:-2], acc, d, nv)
    keep = fin[-4].clone()
    out = wp.wn_layer_stream_final(*fin, n_valid=nv)
    assert torch.equal(fin[-4], keep)
    pairs = list(zip((x_new, skip), want)) + [
        (out, wp.wn_layer_stream_final_plain(*fin, nv))]
    for g, w in pairs:
        assert not g[:, :bt].any() and not g[:, -bt:].any()
        if not w.any():          # x_new at n_valid = 0: zero, exactly
            assert not g.any()
            continue
        close(g, w)
    assert not wp.unpad_tiles(x_new)[:, nv:].any()


def test_stream_sm90_skip_sum_in_place_between_guards(dev):
    """The skip sum is updated in place in a buffer with guard values on
    both sides: the guards stay, the returned tensor is the argument."""
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    std, _ = stream_case(dev, 1, 1024, 1000, 512, 640, 8, 64, 7, False)
    acc = std[-2]
    buf = torch.full((acc.numel() + 128,), 7.0, dtype=torch.bfloat16,
                     device=dev)
    skip = buf[64:64 + acc.numel()].view_as(acc)
    skip.copy_(acc)
    _, got = wp.wn_layer_stream(*std[:-2], skip, 64, n_valid=1000)
    assert got.data_ptr() == skip.data_ptr()
    assert (buf[:64] == 7).all() and (buf[-64:] == 7).all()
    close(got, wp.wn_layer_stream_plain(*std[:-2], acc, 64, 1000)[1])


def test_stream_sm90_plan_is_the_kernels_shared_memory(dev):
    """The plan's shared memory is what the kernel's own query gives, at
    every accepted width's edge and dilation, in both roles."""
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    lib = wp.LIB_SM90.get()
    for role, code in wp.PADDED_SM90_ROLES.items():
        for C in (64, 192, 512, 1024):
            for d in (0, 1, 63, 96, 97, 128):
                p = wp.padded_sm90_plan(C, 6400, 1, d, role)
                assert lib.t2s_wn_padded_sm90_smem_bytes(
                    code, C, d, p["nwin"], p["nwst"]) == p["smem"]


def test_stream_sm90_counts_one_launch_a_call(dev):
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    std, fin = stream_case(dev, 1, 512, 512, 128, 64, 8, 1, 3, False)
    wp.reset_launch_counts()
    wp.wn_layer_stream(*std[:-2], std[-2].clone(), 1)
    wp.wn_layer_stream_final(*fin)
    assert wp.launch_counts() == {"wn_layer_padded": 0, "wn_layer_spect": 0,
                                  "wn_layer_stream": 1,
                                  "wn_layer_stream_final": 1}


def test_stream_sm90_wrappers_raise_on_what_the_kernel_refuses(dev):
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    std, fin = stream_case(dev, 1, 256, 256, 128, 64, 8, 1, 5, False)
    head, acc = std[:-2], std[-2]
    with pytest.raises(ValueError, match="dilation"):
        wp.wn_layer_stream(*head, acc.clone(), 129)
    with pytest.raises(ValueError, match="pad tile"):
        wp.wn_layer_stream(*head, acc.clone(), 1, bt=64)
    w_bad = torch.zeros(128, 96, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="w_rs"):
        wp.wn_layer_stream(*head[:-2], w_bad, head[-1], acc.clone(), 1)
    with pytest.raises(ValueError, match="skip only"):
        wp.wn_layer_stream_final(*std[:-2], acc, fin[-3], fin[-2], 1)
    w_end = torch.zeros(128, 9, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="E in"):
        wp.wn_layer_stream_final(*fin[:-3], w_end, fin[-2], 1)
    with pytest.raises(ValueError, match="in place"):
        wp.wn_layer_stream(*head, std[0], 1)
    # a width past the plan's shared memory
    big, _ = stream_case(dev, 1, 256, 256, 2048, 32, 8, 1, 6, False)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        wp.wn_layer_stream(*big[:-2], big[-2], 1)


# --- rows 12-13 on csrc/wn_block_padded_tiles_sm90.cu (SPECT, PADDED) ------


def tiles_case(dev, B, T, n_valid, C, M, d, seed, rs_half, n_cond=2):
    """Rows 13 and 12's argument tuples (without n_valid and, for row 12,
    without ``cond_index``) on the pad tiles: seeded bf16 inputs, hidden
    state, mel, skip sum and conditioning zero past n_valid; res/skip
    weights [C, 2C] or, with ``rs_half``, [C, C]."""
    from text2speech_tpu_torch.ops.wn_block_padded import pad_tiles

    k = inputs(dev, B, T, n_valid, C, M, seed,
               rs_out=C if rs_half else 2 * C)
    g = torch.Generator().manual_seed(seed + 1)
    mask = (torch.arange(T) < n_valid)[None, :, None].to(dev)
    cond = (torch.randn(B, T, 2 * C * n_cond, generator=g).to(
        dev, torch.bfloat16) * mask)
    xp, sp, acc = (pad_tiles(k[n]) for n in ("x", "spect", "acc"))
    spect = (xp, sp, k["w_in"], k["b_in"], k["w_cond"], k["b_cond"],
             k["w_rs"], k["b_rs"], acc, d)
    padded = (xp, pad_tiles(cond), k["w_in"], k["b_in"], k["w_rs"],
              k["b_rs"], d)
    return spect, padded


TILES_CASES = (
    [(1, 6400, 512, 640, d, nv) for d in (0, 1, 63, 64, 128)
     for nv in (6400, 6099, 1, 0)]
    + [(3, 6400, 512, 640, d, 6099) for d in (1, 64, 128)]
    + [(1, 1024, 192, 96, 63, 723), (3, 1024, 192, 96, 128, 1)]
    # the widest widths the plan takes, with two stages: SPECT's 1408 (past
    # PADDED's, whose cond slot leaves room for 1280), both at 1280
    + [(1, 256, 1408, 64, 128, 200), (1, 256, 1280, 64, 1, 256)])


@pytest.mark.parametrize("case", range(len(TILES_CASES)))
def test_tiles_sm90_matches_plain(dev, case):
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    B, T, C, M, d, nv = TILES_CASES[case]
    rs_half, ci = case % 2 == 1, case % 3 % 2
    spect, padded = tiles_case(dev, B, T, nv, C, M, d, 60 + case, rs_half)
    bt = wp.BT_PAD
    acc = spect[-2]
    sx, ss = wp.wn_layer_spect(*spect[:-2], acc.clone(), d, n_valid=nv)
    pairs = list(zip(
        (sx, ss), wp.wn_layer_spect_plain(*spect[:-2], acc, d, nv)))
    outs = [sx]
    if C <= 1280:
        keep = padded[1].clone()
        px, ps = wp.wn_layer_padded(*padded, ci, n_valid=nv)
        assert torch.equal(padded[1], keep)
        pairs += zip((px, ps), wp.wn_layer_padded_plain(*padded, ci, nv))
        outs.append(px)
    for g, w in pairs:
        assert not g[:, :bt].any() and not g[:, -bt:].any()
        if not w.any():          # x_new at n_valid = 0: zero, exactly
            assert not g.any()
            continue
        close(g, w)
    for x_new in outs:
        assert not wp.unpad_tiles(x_new)[:, nv:].any()


def test_tiles_sm90_skip_sum_in_place_between_guards(dev):
    """SPECT's skip sum is updated in place in a buffer with guard values
    on both sides: the guards stay, the returned tensor is the argument."""
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    spect, _ = tiles_case(dev, 1, 1024, 1000, 512, 640, 64, 8, False)
    acc = spect[-2]
    buf = torch.full((acc.numel() + 128,), 7.0, dtype=torch.bfloat16,
                     device=dev)
    skip = buf[64:64 + acc.numel()].view_as(acc)
    skip.copy_(acc)
    _, got = wp.wn_layer_spect(*spect[:-2], skip, 64, n_valid=1000)
    assert got.data_ptr() == skip.data_ptr()
    assert (buf[:64] == 7).all() and (buf[-64:] == 7).all()
    close(got, wp.wn_layer_spect_plain(*spect[:-2], acc, 64, 1000)[1])


def test_tiles_sm90_plan_is_the_kernels_shared_memory(dev):
    """The plan's shared memory is what the kernel's own query gives, at
    widths up to the widest and every dilation's edge, in both roles."""
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    lib = wp.LIB_TILES.get()
    for role, code in wp.PADDED_TILES_ROLES.items():
        for C in (64, 192, 512, 1024, 1280):
            for d in (0, 1, 64, 128):
                p = wp.padded_tiles_plan(C, 6400, 1, d, role)
                assert lib.t2s_wn_padded_tiles_sm90_smem_bytes(
                    code, C, p["nst"]) == p["smem"]


def test_tiles_sm90_counts_one_launch_a_call(dev):
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    spect, padded = tiles_case(dev, 1, 512, 512, 128, 64, 1, 3, False)
    wp.reset_launch_counts()
    wp.wn_layer_spect(*spect[:-2], spect[-2].clone(), 1)
    wp.wn_layer_padded(*padded, 1)
    assert wp.launch_counts() == {"wn_layer_padded": 1, "wn_layer_spect": 1,
                                  "wn_layer_stream": 0,
                                  "wn_layer_stream_final": 0}


def test_tiles_sm90_wrappers_raise_past_the_widest_width(dev):
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    spect, padded = tiles_case(dev, 1, 256, 256, 1472, 32, 1, 6, False)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        wp.wn_layer_spect(*spect[:-2], spect[-2], 1)
    _, padded = tiles_case(dev, 1, 256, 256, 1344, 32, 1, 6, False)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        wp.wn_layer_padded(*padded)


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


# --- data parallelism: the one-rank NCCL form --------------------------------


@pytest.fixture
def nccl_mesh(dev):
    """A data mesh of this one process over an NCCL group (the
    distributed form with one rank: every collective runs and adds
    nothing)."""
    import socket

    import torch.distributed as dist

    from text2speech_tpu_torch.parallel import mesh as pm

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert pm.initialize_distributed(f"tcp://localhost:{port}", 1, 0,
                                     device="cuda")
    assert dist.get_backend() == "nccl"
    yield pm.make_mesh()
    pm.destroy_distributed()


@pytest.mark.parametrize("ga", [1, 2])
def test_one_rank_nccl_waveglow_step_equals_mesh_none(dev, deterministic,
                                                      nccl_mesh, ga):
    """``make_wg_train_step(mesh=)`` on a one-rank NCCL group: loss, norm
    and every updated parameter bit for bit those of ``mesh=None``, with
    the gated kernels launched in both."""
    from text2speech_tpu_torch.data.mel2samp import VocoderBatch
    from text2speech_tpu_torch.ops import gated
    from text2speech_tpu_torch.train.state import create_train_state
    from text2speech_tpu_torch.train.waveglow import make_wg_train_step

    out = []
    for mesh in (None, nccl_mesh):
        cfg, model, mel, audio = _tiny_trainable(dev)
        state = create_train_state(model.params, 1e-3)
        gated.reset_launch_counts()
        _, m = make_wg_train_step(model, cfg.sigma, ga, mesh)(
            state, VocoderBatch(mel, audio))
        assert all(gated.launch_counts().values())
        out.append((m, {n: p.detach().clone()
                        for n, p in model.params.items()}))
    (m0, p0), (m1, p1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    assert all(torch.equal(p0[n], p1[n]) for n in p0)


@pytest.mark.parametrize("ga", [1, 2])
def test_one_rank_nccl_tacotron_step_equals_mesh_none(dev, deterministic,
                                                      nccl_mesh, ga):
    """``make_train_step(mesh=)`` on a one-rank NCCL group, masks drawn
    from a generator seeded alike: metrics, parameters and the BatchNorm
    running statistics (taken through the group's all-reduce) bit for bit
    those of ``mesh=None``."""
    from text2speech_tpu_torch.data.dataset import Batch
    from text2speech_tpu_torch.models.tacotron2 import Tacotron2
    from text2speech_tpu_torch.train.state import create_tacotron_state
    from text2speech_tpu_torch.train.tacotron import make_train_step

    hp, base, (text, in_len, mel, out_len, gate), _ = _small_tacotron()
    batch = Batch(text.to(dev), in_len.to(dev), mel.to(dev), gate.to(dev),
                  torch.zeros(4, dtype=torch.int32, device=dev),
                  out_len.to(dev))
    out = []
    for mesh in (None, nccl_mesh):
        m = Tacotron2(hp, 80, device=dev)
        m.load_state_dict(base.state_dict())
        state = create_tacotron_state(m, hp)
        _, metrics = make_train_step(m, hp, ga, mesh)(
            state, batch, torch.Generator(device=dev).manual_seed(4))
        out.append((metrics, {n: t.clone() for n, t in
                              m.state_dict().items()}))
    (m0, s0), (m1, s1) = out
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(s0[n], s1[n]) for n in s0)


def test_one_rank_nccl_infer_long_equals_mesh_none(dev, nccl_mesh):
    """``infer_long(mesh=)`` on a one-rank NCCL group through the bf16 and
    the int8 kernel vocoders: the audio of ``mesh=None`` bit for bit."""
    from text2speech_tpu_torch.models import chunked
    from text2speech_tpu_torch.models.waveglow_fused import (
        prepare_fused, prepare_fused_int8)

    model, cfg = small_waveglow(dev)
    gen = torch.Generator(device="cuda").manual_seed(2)
    mel = torch.randn(1, 16, 300, generator=gen, device="cuda")
    noise = chunked.draw_noise(cfg, gen, 1, 300 * 2)
    for fw in (prepare_fused(model), prepare_fused_int8(model)):
        kw = dict(sigma=0.7, chunk_frames=64, overlap_frames=32,
                  noise=noise)
        with torch.inference_mode():
            a = chunked.infer_long(fw, mel, **kw)
            b = chunked.infer_long(fw, mel, mesh=nccl_mesh, **kw)
        assert a.shape == (1, 300 * 16) and torch.isfinite(a).all()
        assert torch.equal(a, b)


def test_inference_cli_plot_dir_writes_both_pngs(dev, tmp_path, capsys):
    """``inference.main`` with ``--plot_dir`` on random weights: the WAV
    and ``{stem}_alignment.png`` / ``{stem}_mel.png``; where matplotlib is
    not installed, the flag is refused (exit 2, naming it) before anything
    is synthesized."""
    import importlib.util
    import os

    from text2speech_tpu_torch import inference

    out = tmp_path / "cli.wav"
    argv = ["--random_init", "0", "--fused_vocoder", "--max_steps", "40",
            "--out", str(out), "--plot_dir", str(tmp_path / "plots")]
    if importlib.util.find_spec("matplotlib") is None:
        with pytest.raises(SystemExit) as e:
            inference.main(argv)
        assert e.value.code == 2
        assert "--plot_dir draws with matplotlib" in capsys.readouterr().err
        assert not out.exists()
        return
    inference.main(argv)
    assert out.exists()
    assert sorted(os.listdir(tmp_path / "plots")) == [
        "cli_alignment.png", "cli_mel.png"]


# ---------------------------------------------------------------------------
# tensor-parallel decode and full-chain tensor-parallel serving
# ---------------------------------------------------------------------------


def _tp_synth(dev, **kw):
    """A small synthesizer on the card (WN width 128, the kernels' least;
    LSTMs of 64) and its fused bf16 single-device twin."""
    from text2speech_tpu_torch.config import HParams
    from text2speech_tpu_torch.infer import random_synthesizer

    hp = HParams(embedding_size=32, enc_conv_channels=32,
                 attention_rnn_dim=64, decoder_rnn_dim=64, prenet_dim=16,
                 attention_dim=16, n_mel_channels=16,
                 postnet_embedding_dim=32, max_decoder_steps=300)
    cfg = WaveGlowConfig(n_mel_channels=16, n_flows=4, n_group=8,
                         n_early_every=2, n_early_size=2, wn_n_layers=4,
                         wn_n_channels=128, upsample_kernel=64,
                         upsample_stride=16)
    return random_synthesizer(hp, cfg, 0, device="cuda", **kw)


def _decode_inputs(synth, dev, B=3, steps=32):
    from text2speech_tpu_torch.text import encode_batch

    texts = ["안녕하세요.", "네.", "오늘 날씨가 참 좋네요."][:B]
    ids, lengths = encode_batch(texts)
    lengths = torch.from_numpy(lengths).to(dev)
    with torch.inference_mode():
        memory = synth.taco.encode(torch.from_numpy(ids).long().to(dev),
                                   text_lengths=lengths)
        pmem = synth.taco.process_memory(memory)
    masks = synth.taco.decoder.draw_keep_masks(
        steps, B, torch.Generator(device="cuda").manual_seed(2), dev)
    return memory, pmem, masks, lengths


@pytest.mark.parametrize("p", [2, 4])
def test_tp_decode_on_the_card_matches_the_serving_decode(dev, p):
    """The f32 tensor-parallel decode (all p shards on the card) against
    ``decode_chunk_serve`` over 32 steps: 1e-4 on the mel (chip_smoke's
    bound), active and finished equal; the bf16 decode finite; the int8
    slices' payloads and scales the rows of the whole kernels'."""
    from text2speech_tpu_torch.models import tacotron_serve as ts
    from text2speech_tpu_torch.parallel import tp_tacotron as ttp

    synth = _tp_synth(dev, use_denoiser=False)
    memory, pmem, masks, lengths = _decode_inputs(synth, dev)
    dp = ts.extract_decoder_params(synth.taco)
    with torch.inference_mode():
        (st_r, _, fin_r), mel_r, _, _, act_r = ts.decode_chunk_serve(
            dp, synth.hp, memory, pmem,
            *synth.taco.decoder.initial_carry(memory), masks, lengths)
        for dt in (torch.float32, torch.bfloat16):
            dec = ttp.TPTacotronDecoder(synth.taco, synth.hp, n_model=p,
                                        dtype=dt)
            (st, _, fin), mel, _, _, act = dec(
                memory, pmem, *dec.initial_carry(memory), masks, lengths)
            assert mel.is_cuda and torch.isfinite(mel).all()
            if dt == torch.float32:
                assert (mel - mel_r).abs().max().item() <= 1e-4
                assert torch.equal(act, act_r) and torch.equal(fin, fin_r)
                assert st.decoder_c.shape == st_r.decoder_c.shape
    q = ttp.shard_decoder_params(dp, synth.hp, p, int8=True)
    for wk, _, dim in ttp._LSTM_KEYS:
        whole = ts.quantize_kernel_int8(dp[wk])
        for i in range(p):
            rows = torch.from_numpy(ttp._gate_cols(
                getattr(synth.hp, dim), p, i)).to(dev)
            assert torch.equal(q[wk]["s"][i], whole["s"][rows])
            assert torch.equal(q[wk]["q"][i], whole["q"][rows])


@pytest.mark.parametrize("int8", [False, True])
def test_tp_synthesizer_on_the_card(dev, int8):
    """``TPSynthesizer(n_model=2)``: bf16 by default on the card, the
    partial kernels' launches per vocode (F L p, or F p + F (L - 1) p with
    int8) and no whole-layer wrapper's; its vocoder on the fused path's mel
    and noise within the end-to-end bounds of the kernel path (16 bf16
    steps at the peak, 2e-2 relative L2; int8 32 steps, 5e-2);
    ``synthesize`` finite at the single path's lengths."""
    from text2speech_tpu_torch.infer import Synthesizer
    from text2speech_tpu_torch.parallel import tp
    from text2speech_tpu_torch.parallel.serve import TPSynthesizer

    synth = _tp_synth(dev, use_denoiser=False)
    single = (Synthesizer(synth.hp, synth.taco, synth.wg_cfg,
                          synth.waveglow, use_denoiser=False,
                          int8_vocoder=True) if int8 else synth)
    cfg = synth.wg_cfg
    tps = TPSynthesizer(synth.hp, synth.taco, cfg, synth.waveglow,
                        n_model=2, chunk_steps=32, int8=int8)
    assert tps.compute_dtype == torch.bfloat16
    texts = ["안녕하세요.", "네."]
    mel, lens = single.text_to_mel(texts, seed=1, max_steps=60)
    gpf = cfg.upsample_stride // cfg.n_group
    g = torch.Generator(device="cuda").manual_seed(3)
    noise = tuple(torch.randn(s, generator=g, device="cuda")
                  for s in synth.fused.noise_shapes(2, 60 * gpf))
    with torch.inference_mode():
        want = single.mel_to_audio(mel, 0.7, noise=noise)
    wb.reset_launch_counts()
    wq.reset_launch_counts()
    tp.reset_launch_counts()
    got = tps.mel_to_audio(mel, 0.7, noise=noise)
    F, L = cfg.n_flows, cfg.wn_n_layers
    assert tp.launch_counts() == (
        {"wn_layer_partial": 2 * F, "wn_layer_partial_int8": 2 * F * (L - 1)}
        if int8 else {"wn_layer_partial": 2 * F * L,
                      "wn_layer_partial_int8": 0})
    others = {**wb.launch_counts(), **wq.launch_counts()}
    assert not any(v for k, v in others.items() if "partial" not in k)
    steps, rel = (32, 5e-2) if int8 else (16, 2e-2)
    assert (got - want).abs().max() <= steps * 2.0 ** -8 * want.abs().max()
    assert ((got - want).norm() / want.norm()).item() < rel
    wavs = tps.synthesize(texts, 0.7, seed=1, max_steps=60)
    assert [len(w) for w in wavs] == [int(n) * cfg.upsample_stride
                                      for n in lens.tolist()]
    assert all(np.isfinite(w).all() for w in wavs)


def test_tp_stream_with_the_denoiser_on_the_card(dev):
    """``synthesize_incremental`` with the denoiser against the offline
    denoiser over its own raw stream (the same audio, windowed: 1e-5 on
    the card's FFTs)."""
    from text2speech_tpu_torch.models.denoiser import make_denoiser
    from text2speech_tpu_torch.parallel.serve import TPSynthesizer

    synth = _tp_synth(dev, use_denoiser=False)
    tps = TPSynthesizer(synth.hp, synth.taco, synth.wg_cfg, synth.waveglow,
                        n_model=2, chunk_steps=32)
    kw = dict(sigma=0.7, seed=4, max_steps=100)
    raw = np.concatenate(list(tps.synthesize_incremental("안녕하세요.", **kw)))
    dkw = dict(filter_length=256, n_overlap=4, win_length=256)
    den = np.concatenate(list(tps.synthesize_incremental(
        "안녕하세요.", denoiser_strength=0.1, denoiser_kwargs=dkw, **kw)))
    _, denoise = make_denoiser(synth.waveglow, **dkw)
    with torch.inference_mode():
        ref = denoise(torch.from_numpy(raw[None]).to(dev), 0.1)[0].cpu()
    assert den.shape == tuple(ref.shape)
    np.testing.assert_allclose(den, ref.numpy(), atol=1e-5)


def test_make_server_tp_on_the_card(dev):
    """``make_server_tp`` over two shards: every session of the batch as
    long as ``make_server``'s for the same (text, seed), finite, and the
    partial kernels launched each round."""
    from text2speech_tpu_torch.parallel import tp
    from text2speech_tpu_torch.parallel.serve import TPSynthesizer
    from text2speech_tpu_torch.server import make_server, make_server_tp

    synth = _tp_synth(dev, use_denoiser=False)
    tps = TPSynthesizer(synth.hp, synth.taco, synth.wg_cfg, synth.waveglow,
                        n_model=2, chunk_steps=32)
    texts, seeds = ["안녕하세요.", "네.", "오늘 날씨가 참 좋네요."], [1, 2, 3]
    kw = dict(slots=2, chunk_steps=32, max_steps=120)
    tp.reset_launch_counts()
    got = make_server_tp(tps, **kw).run(texts, seeds=seeds)
    assert tp.launch_counts()["wn_layer_partial"] > 0
    want = make_server(synth, **kw).run(texts, seeds=seeds)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for sid in want:
        assert got[sid].shape == want[sid].shape
        assert np.isfinite(got[sid]).all()


def test_one_rank_nccl_tp_decode_and_server_equal_the_local_form(dev,
                                                                 nccl_mesh):
    """A model group of one NCCL rank: the decoder's gather and the
    server's lockstep check run and add nothing, so the decode and a
    ``make_server_tp`` run equal the one-shard local form bit for bit."""
    import torch.distributed as dist

    from text2speech_tpu_torch.parallel.serve import TPSynthesizer
    from text2speech_tpu_torch.parallel.tp_tacotron import TPTacotronDecoder
    from text2speech_tpu_torch.server import make_server_tp

    synth = _tp_synth(dev, use_denoiser=False)
    memory, pmem, masks, lengths = _decode_inputs(synth, dev)
    with torch.inference_mode():
        outs = []
        for kw in (dict(group=dist.group.WORLD), dict(n_model=1)):
            dec = TPTacotronDecoder(synth.taco, synth.hp, **kw)
            outs.append(dec(memory, pmem, *dec.initial_carry(memory), masks,
                            lengths))
    (c0, *o0), (c1, *o1) = outs
    assert all(torch.equal(a, b) for a, b in zip(o0, o1))
    assert all(torch.equal(a, b) for a, b in zip(c0[0], c1[0]))
    wavs = []
    for kw in (dict(group=dist.group.WORLD), dict(n_model=1)):
        tps = TPSynthesizer(synth.hp, synth.taco, synth.wg_cfg,
                            synth.waveglow, chunk_steps=32, **kw)
        assert len(tps.lockstep_groups) == ("group" in kw)
        wavs.append(make_server_tp(tps, slots=2, chunk_steps=32,
                                   max_steps=96).run(["안녕하세요.", "네."],
                                                     seeds=[5, 6]))
    assert all(np.array_equal(wavs[0][k], wavs[1][k]) for k in wavs[1])


# ---------------------------------------------------------------------------
# reference checkpoints into the port (chip_smoke.py phase 29, step 4)
# ---------------------------------------------------------------------------


def _converted(dev):
    """A reference-format WaveGlow state dict (``examples/
    reference_checkpoints.py``: 4 flows with early outputs, C=128, live end
    convs) and the port modules made from it by the convert conveniences."""
    from text2speech_tpu_torch.convert import waveglow_module_from_torch
    from text2speech_tpu_torch.examples.reference_checkpoints import \
        reference_waveglow_state_dict

    cfg = WaveGlowConfig(n_mel_channels=16, n_flows=4, n_group=8,
                         n_early_every=2, n_early_size=2, wn_n_layers=4,
                         wn_n_channels=128, upsample_kernel=64,
                         upsample_stride=16)
    sd = reference_waveglow_state_dict(cfg, 7)
    return cfg, sd, waveglow_module_from_torch(sd, cfg, device=dev)


@pytest.mark.parametrize("layout", ["fused", "pre_fusion"])
def test_converted_waveglow_launches_rows_1_to_3(dev, layout):
    """One fused vocode of converted reference weights launches the first,
    standard and final layers 1 / L-2 / 1 times a flow and no other
    WN-layer kernel; the pre-fusion layout converts to the same module."""
    from text2speech_tpu_torch.convert import waveglow_module_from_torch
    from text2speech_tpu_torch.examples.reference_checkpoints import \
        pre_fusion_layout
    from text2speech_tpu_torch.models.waveglow_fused import (infer_fused,
                                                             prepare_fused)
    from text2speech_tpu_torch.parallel import tp

    cfg, sd, model = _converted(dev)
    if layout == "pre_fusion":
        old = waveglow_module_from_torch(pre_fusion_layout(sd, cfg), cfg,
                                         device=dev)
        for (n, a), (_, b) in zip(model.state_dict().items(),
                                  old.state_dict().items()):
            assert torch.equal(a, b), n
        model = old
    fw = prepare_fused(model)
    gen = torch.Generator(device="cuda").manual_seed(2)
    mel = torch.randn(2, 16, 64, generator=gen, device="cuda")
    noise = tuple(torch.randn(s, generator=gen, device="cuda")
                  for s in fw.noise_shapes(2, 64 * 2))
    wb.reset_launch_counts()
    wq.reset_launch_counts()
    tp.reset_launch_counts()
    out = infer_fused(fw, mel, 0.7, noise=noise)
    torch.cuda.synchronize()
    assert wb.launch_counts() == {"wn_layer_first": 4, "wn_layer": 8,
                                  "wn_layer_final": 4}
    assert not any(wq.launch_counts().values())
    assert not any(tp.launch_counts().values())
    assert torch.isfinite(out).all()


def test_converted_waveglow_fused_matches_the_plain_module(dev):
    """The fused bf16 vocode of converted weights against the plain f32
    ``WaveGlow.infer`` on the same mel and noise, within chip_smoke's
    phase 4 bound (16 bf16 steps at the peak, 2e-2 relative L2)."""
    from text2speech_tpu_torch.models.waveglow_fused import (infer_fused,
                                                             prepare_fused)

    _, _, model = _converted(dev)
    fw = prepare_fused(model)
    gen = torch.Generator(device="cuda").manual_seed(3)
    mel = torch.randn(2, 16, 77, generator=gen, device="cuda")
    noise = tuple(torch.randn(s, generator=gen, device="cuda")
                  for s in fw.noise_shapes(2, 77 * 2))
    with torch.inference_mode():
        got = infer_fused(fw, mel, 0.7, noise=noise)
        want = model.infer(mel, 0.7, noise=noise)
    assert got.shape == want.shape == (2, 77 * 16)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 16 * 2.0 ** -8 * want.abs().max()
    assert ((got - want).norm() / want.norm()).item() < 2e-2


# ---------------------------------------------------------------------------
# CUDA graphs of the decoder's steps and the encoder's BiLSTM
# ---------------------------------------------------------------------------


def _eagerly(monkeypatch, fn):
    """``fn()`` with the graphs off: the eager loops run."""
    from text2speech_tpu_torch.utils import cuda_graphs

    with monkeypatch.context() as m:
        m.setattr(cuda_graphs, "usable", lambda *t: False)
        return fn()


def _graph_counts(rec) -> tuple:
    return tuple([v for _, v in rec.counters.get(name, [])] for name in
                 ("taco.graph_captures", "taco.graph_replays"))


@pytest.fixture(scope="module")
def full_taco(dev):
    """Tacotron-2 at the reference widths on the card, seeded, in f32."""
    from text2speech_tpu_torch.config import HParams
    from text2speech_tpu_torch.models.tacotron2 import (Tacotron2,
                                                        init_weights_)
    from text2speech_tpu_torch.text import N_SYMBOLS

    taco = Tacotron2(HParams(), N_SYMBOLS, device=dev)
    init_weights_(taco, torch.Generator(device="cuda").manual_seed(11))
    return taco.eval()


def _text_batch(B, T_in, seed, dev):
    """ids [B, T_in] with lengths in [8, T_in], the longest T_in."""
    from text2speech_tpu_torch.text import N_SYMBOLS

    g = torch.Generator(device="cuda").manual_seed(seed)
    lengths = torch.randint(8, T_in + 1, (B,), generator=g, device=dev)
    lengths[0] = T_in
    ids = torch.randint(1, N_SYMBOLS, (B, T_in), generator=g, device=dev)
    ids = torch.where(torch.arange(T_in, device=dev) < lengths[:, None],
                      ids, 0)
    return ids, lengths


def test_graphed_inference_equals_eager_at_the_offline_shape(
        dev, full_taco, monkeypatch):
    """``Tacotron2.inference`` at the offline cell's shape (B = 32, T_in =
    256, 320 steps) replays one encoder graph and five 64-step decoder
    graphs, captured in the first call only, and equals the eager loops
    bit for bit, call after call."""
    from text2speech_tpu_torch.utils.profiling import recording

    ids, lengths = _text_batch(32, 256, 1, dev)
    keep = torch.rand((320, 2, 32, 256), device=dev) < 0.5

    def run():
        with torch.inference_mode():
            return full_taco.inference(ids, text_lengths=lengths,
                                       max_steps=320, keep_masks=keep)

    with recording() as rec:
        got = [run(), run()]
    want = _eagerly(monkeypatch, run)
    for out in got:
        for g, w in zip(out, want):
            assert g.shape == w.shape and torch.equal(g, w)
    captures, replays = _graph_counts(rec)
    assert sum(captures) == 2 and replays == [1, 5, 1, 5]


def test_chunked_graphed_decode_equals_the_whole_decode(dev, full_taco,
                                                        monkeypatch):
    """Five 64-step ``decode_chunk`` calls from the returned carry against
    one 320-step decode, both replayed, and the eager whole decode."""
    from text2speech_tpu_torch.models.tacotron2 import sequence_mask

    taco = full_taco
    ids, lengths = _text_batch(32, 256, 2, dev)
    keep = torch.rand((320, 2, 32, 256), device=dev) < 0.5

    def whole():
        with torch.inference_mode():
            memory = taco.encode(ids, text_lengths=lengths)
            return memory, taco.decoder.run_steps(
                taco.decoder.initial_carry(memory), keep, memory,
                taco.process_memory(memory), sequence_mask(lengths, 256))

    memory, graphed = whole()
    _, eager = _eagerly(monkeypatch, whole)
    with torch.inference_mode():
        carry, parts = taco.decoder.initial_carry(memory), []
        for t0 in range(0, 320, 64):
            carry, *outs = taco.decode_chunk(memory, *carry,
                                             keep[t0:t0 + 64], lengths)
            parts.append(outs)
    for i, d in enumerate((2, 1, 1, 1)):
        chunked = torch.cat([p[i] for p in parts], d)
        assert torch.equal(chunked, graphed[1 + i])
        assert torch.equal(graphed[1 + i], eager[1 + i])
    for a, b in zip((*carry[0], *carry[1:]),
                    (*graphed[0][0], *graphed[0][1:])):
        assert torch.equal(a, b)


def test_server_shaped_chunk_replays_equal_eager(dev, full_taco, monkeypatch):
    """The server's decode: B = ``slots`` = 16 rows padded to 256 symbols,
    per-row keep-masks, two 64-step chunks from the carry, and its
    admissions' BiLSTM at (1, 256): graph and eager bit for bit."""
    taco = full_taco
    ids, lengths = _text_batch(16, 256, 3, dev)
    gens = [torch.Generator(device="cuda").manual_seed(100 + b)
            for b in range(16)]
    masks = [taco.decoder.draw_keep_masks_per_row(64, gens, dev)
             for _ in range(2)]

    def serve():
        with torch.inference_mode():
            admit = taco.encode(ids[:1], text_lengths=lengths[:1])
            memory = taco.encode(ids, text_lengths=lengths)
            carry, outs = taco.decoder.initial_carry(memory), [admit]
            for m in masks:
                carry, *o = taco.decode_chunk(memory, *carry, m, lengths)
                outs += o
            return outs + [*carry[0], *carry[1:]]

    for g, w in zip(serve(), _eagerly(monkeypatch, serve)):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("transposed", [True, False])
@pytest.mark.parametrize("B", [1, 32])
def test_bilstm_graph_with_lengths_equals_eager(dev, B, transposed):
    """The BiLSTM at the server's admission width and the offline batch,
    on the encoder convs' layout (a transpose of [B, C, T]) and on a
    contiguous one."""
    from text2speech_tpu_torch.ops.lstm import BiLSTM
    from text2speech_tpu_torch.utils.profiling import recording

    torch.manual_seed(B)
    mod = BiLSTM(512, 256, device=dev)
    with torch.inference_mode(), recording() as rec:
        for seed in (4, 5):
            xs = (torch.randn(B, 512, 256, device=dev).transpose(1, 2)
                  if transposed else torch.randn(B, 256, 512, device=dev))
            _, lengths = _text_batch(B, 256, seed, dev)
            got = mod(xs, lengths)
            assert torch.equal(got, mod.forward_eager(xs, lengths))
            assert torch.equal(mod(xs), mod.forward_eager(xs))
    captures, replays = _graph_counts(rec)
    assert captures == [1, 1] and replays == [1] * 4


def _graph_synth(dev):
    from text2speech_tpu_torch.config import HParams
    from text2speech_tpu_torch.infer import random_synthesizer

    hp = HParams(embedding_size=64, enc_conv_channels=64,
                 attention_rnn_dim=128, decoder_rnn_dim=128, prenet_dim=32,
                 attention_dim=32, n_mel_channels=16,
                 postnet_embedding_dim=32, max_decoder_steps=100)
    cfg = WaveGlowConfig(n_mel_channels=16, n_flows=4, n_group=8,
                         n_early_every=2, n_early_size=2, wn_n_layers=4,
                         wn_n_channels=128, upsample_kernel=64,
                         upsample_stride=16)
    return random_synthesizer(hp, cfg, 0, device="cuda", use_denoiser=False)


def test_graphs_replay_in_place_weight_swaps(dev, monkeypatch):
    """``Synthesizer.load_weights`` copies a new Tacotron into the live
    parameters: the next replay reads it without a new capture, and
    equals the eager loops on the new weights bit for bit."""
    from text2speech_tpu_torch.convert import variables_from_tacotron
    from text2speech_tpu_torch.models.tacotron2 import (Tacotron2,
                                                        init_weights_)
    from text2speech_tpu_torch.text import N_SYMBOLS
    from text2speech_tpu_torch.utils.profiling import recording

    synth = _graph_synth(dev)
    texts = ["안녕하세요.", "존경하는 사람과 함께 갑니다.", "네."]

    def mel():
        return synth.text_to_mel(texts, seed=3, max_steps=100)[0]

    before = mel()
    other = Tacotron2(synth.hp, N_SYMBOLS, device=dev)
    init_weights_(other, torch.Generator(device="cuda").manual_seed(7))
    synth.load_weights(taco_variables=variables_from_tacotron(other))
    with recording() as rec:
        after = mel()
    assert not torch.equal(after, before)
    assert torch.equal(after, _eagerly(monkeypatch, mel))
    captures, replays = _graph_counts(rec)
    assert captures == [] and replays == [1, 2]   # 64 + a 36-step tail


def test_repeated_calls_capture_once_a_key(dev):
    """Three calls at one shape capture the encoder's graph and the
    decoder's two (a 64-step block, a 36-step tail) once; another batch
    size captures its own three; then no call captures."""
    from text2speech_tpu_torch.utils.profiling import recording

    synth = _graph_synth(dev)
    texts = ["안녕하세요.", "존경하는 사람과 함께 갑니다.", "네."]
    with recording() as rec:
        for batch in (texts, texts, texts, texts[:2], texts[:2], texts):
            synth.text_to_mel(batch, seed=3, max_steps=100)
    captures, replays = _graph_counts(rec)
    assert sum(captures) == 6 and replays == [1, 2] * 6
    assert len(synth.taco.decoder._graphs) == 4
    assert len(synth.taco.encoder.bilstm._graphs) == 2
