"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a CUDA device and ``nvcc``).  Run on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:cacheprovider --noconftest

(``--noconftest``: the suite's conftest imports JAX, which the port's GPU
machine need not have; this file imports none of it).

Each kernel is held against its plain PyTorch version on the same bf16
inputs on the card.  Bound: both accumulate in f32 in another order, so an
activation or output can round to the neighbouring bf16 value (2^-8 of
its magnitude); four such steps at the output's peak, and relative L2
under 5e-3 (flips are rare)."""

import pytest
import torch

from text2speech_tpu.config import WaveGlowConfig
from text2speech_tpu_torch.ops import wn_block as wb

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
    args = (k["x0"], k["spect"], k["start_k"], k["start_b"], k["w_in"],
            k["b_in"], k["w_cond"], k["b_cond"], k["w_rs"], k["b_rs"], d)
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
    args = (k["x"], k["spect"], k["w_in"], k["b_in"], k["w_cond"],
            k["b_cond"], k["w_rs"], k["b_rs"], k["acc"], k["w_end"],
            k["b_end"], d)
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


def test_infer_fused_launches_each_kernel_and_matches_plain(dev):
    """One vocode through the kernels: 1 / L-2 / 1 launches per flow, and
    the audio agrees with the plain-layer path on the same noise."""
    from text2speech_tpu_torch.infer import random_weights_
    from text2speech_tpu_torch.models.waveglow import WaveGlow
    from text2speech_tpu_torch.models.waveglow_fused import (infer_fused,
                                                             prepare_fused)

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
    fw = prepare_fused(model)
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
