"""VITS's generator convolutions channels-last (``ops/vits_conv.py``) and
the generator built on them (``models/vits.py::Generator``).

On the CPU: each role's plain version against today's channels-first
chain (``F.conv1d`` / ``F.conv_transpose1d`` + ``F.leaky_relu`` + adds)
in float32 at small widths for every (k, d) of ``ljs_base.json``, the
transposed convolution at u = 2 and 8, ragged T, the running sum with its
1/3, conv_post's 0.01 slope and tanh; the whole ``Generator`` against the
benchmark's f32 reference generator (``perfbench/reference/vits.py``); a
walk of ``csrc/vits_conv_sm90.cu``'s indexing (the window
slot's 8-channel columns, each tap's A at a row offset, the packed weight
stages, the phases of a transposed convolution) from :func:`pack`'s
images; :func:`plan` at every convolution of the published generator.

On the card (marker ``cuda``; ``python -m pytest
tests/test_torch_vits_conv.py -m cuda -p no:cacheprovider --noconftest``):
each role's kernel against its plain version in bf16 at 256, 128, 64 and
32 channels, a whole pass at published widths against the benchmark's f32
reference generator (``perfbench/reference/vits.py``), the launch count
and its counter, a 12-channel tensor and unpacked weights raising.

Tolerances.  Float32 on both sides in another order of sums: 1e-5
relative (the chain reads ~1e-7).  On the card both sides take bf16
inputs and sum in f32, and round each output once (the kernel) or after
every step (the plain chain): four bf16 steps (2^-8) of the output's peak
and 1e-2 relative L2."""

import copy
import json
import os

import pytest
import torch
import torch.nn.functional as F

from perfbench.reference import vits as ref
from text2speech_tpu_torch.config import VitsConfig
from text2speech_tpu_torch.models import vits as port
from text2speech_tpu_torch.ops import vits_conv as vc
from text2speech_tpu_torch.utils.profiling import recording

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = json.load(open(os.path.join(ROOT, "perfbench", "configs",
                                  "vits-ljs.json"), encoding="utf-8"))
V = CFG["vits"]
KD = sorted({(k, d) for k, dils in zip(V["resblock_kernel_sizes"],
                                       V["resblock_dilation_sizes"])
             for d in dils})
F32_TOL = 1e-5
S = vc.SLOPE


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def rn(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g) * scale


def first_conv_chain(x_cf, w, b, d, role, res_cf=None, acc_cf=None):
    """Today's channels-first chain for a role: [B, C, T] in and out."""
    k = w.shape[-1]
    h = F.leaky_relu(x_cf, S) if role == "first" else x_cf
    y = F.conv1d(h, w, b, padding=(k - 1) * d // 2, dilation=d)
    if role == "first":
        return F.leaky_relu(y, S)
    if role == "pre":
        return y
    y = y + res_cf
    if role in ("sum", "mean"):
        y = y + acc_cf
    return y / 3 if role == "mean" else y


ROLE_ARGS = {"pre": {}, "first": {"pre": True, "post": True},
             "second": {}, "sum": {}, "mean": {"scale": 1 / 3}}


@pytest.mark.parametrize("role", list(ROLE_ARGS))
@pytest.mark.parametrize("k,d", KD)
def test_conv_roles_match_the_channels_first_chain(k, d, role):
    g = torch.Generator().manual_seed(100 * k + 10 * d + len(role))
    B, T, Ci, Co = 2, 37, 12, 12 if role != "pre" else 20
    x = rn(g, B, T, Ci)
    w, b = rn(g, Co, Ci, k, scale=(Ci * k) ** -0.5), rn(g, Co, scale=0.1)
    res = rn(g, B, T, Co) if role in ("second", "sum", "mean") else None
    acc = rn(g, B, T, Co) if role in ("sum", "mean") else None
    got = vc.conv(x, w, b, d, res=res, acc=acc, **ROLE_ARGS[role])
    cf = (lambda t: None if t is None else t.transpose(1, 2))
    want = first_conv_chain(cf(x), w, b, d, role, cf(res), cf(acc))
    assert got.shape == (B, T, Co) and got.is_contiguous()
    assert rel(got, want.transpose(1, 2)) < F32_TOL


@pytest.mark.parametrize("u,T", [(2, 37), (8, 37), (2, 1), (8, 5)])
def test_up_matches_the_transposed_convolution(u, T):
    g = torch.Generator().manual_seed(u + T)
    x = rn(g, 3, T, 16)
    w, b = rn(g, 16, 8, 2 * u, scale=(16 * 2) ** -0.5), rn(g, 8, scale=0.1)
    got = vc.up(x, w, b, u)
    want = F.conv_transpose1d(F.leaky_relu(x.transpose(1, 2), S), w, b,
                              stride=u, padding=u // 2)
    assert got.shape == (3, T * u, 8)
    assert rel(got, want.transpose(1, 2)) < F32_TOL


def test_post_takes_slope_0_01_and_tanh():
    g = torch.Generator().manual_seed(5)
    x = rn(g, 2, 41, 8)
    w = rn(g, 1, 8, 7, scale=0.3)
    got = vc.post(x, w)
    want = torch.tanh(F.conv1d(F.leaky_relu(x.transpose(1, 2)), w,
                               padding=3))[:, 0]
    assert got.dtype == torch.float32 and got.shape == (2, 41)
    assert rel(got, want) < F32_TOL
    # the slope is upstream's default 0.01, not the resblocks' 0.1
    other = torch.tanh(F.conv1d(F.leaky_relu(x.transpose(1, 2), S), w,
                                padding=3))[:, 0]
    assert rel(got, other) > 1e-3


def test_the_running_sum_and_its_third():
    """Resblock 3's last convolution: (conv + b + h + (r1 + r2)) / 3, the
    mean of the three resblocks."""
    g = torch.Generator().manual_seed(6)
    x, h, r1 = (rn(g, 2, 29, 16) for _ in range(3))
    w, b = rn(g, 16, 16, 3, scale=48 ** -0.5), rn(g, 16, scale=0.1)
    s12 = vc.conv(h, w, b, 1, res=h, acc=r1)         # resblock 2: r1 + r2'
    got = vc.conv(x, w, b, 1, res=x, acc=s12, scale=1 / 3)
    cf = x.transpose(1, 2)
    r3 = F.conv1d(cf, w, b, padding=1) + cf
    r2f = F.conv1d(h.transpose(1, 2), w, b, padding=1) + h.transpose(1, 2)
    want = (r1.transpose(1, 2) + r2f + r3) / 3
    assert rel(got, want.transpose(1, 2)) < F32_TOL


def small_generator(c0=32, seed=7):
    v = copy.deepcopy(V)
    v.update(upsample_initial_channel=c0, inter_channels=16)
    cfg = VitsConfig.from_dict(v)
    gen = port.Generator(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in gen.parameters():
            fan = p[0].numel() if p.dim() > 1 else 0
            p.copy_(rn(g, *p.shape, scale=fan ** -0.5 if fan else 0.1))
        for w, u in zip(gen.up_w, cfg.upsample_rates):
            # fan-in C_in k / u, gain sqrt(u C_out / C_in) (weights_vits.py)
            w.mul_(u * w.shape[1] / w.shape[0])
        gen.post_w.mul_(0.3)
    return cfg, gen


def reference_state(gen) -> dict:
    """``gen``'s weights as the upstream state dict the reference reads:
    each weight-normalised convolution as ``weight_v`` = its folded kernel
    and ``weight_g`` = that kernel's norm over all but the first axis."""
    sd = {"dec.conv_pre.weight": gen.pre_w, "dec.conv_pre.bias": gen.pre_b,
          "dec.conv_post.weight": gen.post_w}

    def normed(name, w, b):
        sd[f"{name}.weight_v"] = w
        sd[f"{name}.weight_g"] = w.norm(dim=(1, 2), keepdim=True)
        sd[f"{name}.bias"] = b

    for i, (w, b) in enumerate(zip(gen.up_w, gen.up_b)):
        normed(f"dec.ups.{i}", w, b)
    for r, (ws, bs) in enumerate(zip(gen.res_w, gen.res_b)):
        n = len(ws) // 2                     # convs1 then convs2
        for m in range(2 * n):
            normed(f"dec.resblocks.{r}.convs{1 + m // n}.{m % n}", ws[m],
                   bs[m])
    return sd


@pytest.mark.parametrize("T", [13, 6])
def test_generator_equals_the_reference(T):
    cfg, gen = small_generator()
    z = rn(torch.Generator().manual_seed(T), 2, 16, T)
    with torch.no_grad(), recording() as rec:
        got = gen(z)
    with torch.no_grad():
        want = ref.generator(reference_state(gen), V, z)[:, 0]
    assert got.dtype == torch.float32 and got.shape == (2, T * cfg.hop)
    assert rel(got, want) < F32_TOL
    assert 0.02 < want.pow(2).mean().sqrt() < 0.95   # tanh off its rails
    # the CPU path launches nothing, and says so
    assert [v for _, v in rec.counters["vits.gen_launches"]] == [0]


def test_generator_reads_channels_last_latents():
    """z as the flows leave it (a transposed view of [B, T, C]) and as a
    contiguous [B, C, T] give the same audio."""
    _, gen = small_generator(seed=8)
    zl = rn(torch.Generator().manual_seed(9), 2, 11, 16)
    with torch.no_grad():
        a = gen(zl.transpose(1, 2))
        b = gen(zl.transpose(1, 2).contiguous())
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the kernel's indexing, walked in PyTorch
# ---------------------------------------------------------------------------


def walk(x, pk, b, C_out, taps, d, lo, P, p_shift, pre=False, post=False,
         res=None, acc=None, scale=1.0):
    """``t2s_vits_conv_sm90`` in PyTorch from the packed stages: the window
    slot [C_in / 8][Rs][8], each wgmma's A the two 8-channel columns at
    the tap's row offset, B the stage's two K columns, f32 sums."""
    B, T, C_in = x.shape
    pl = vc.plan(C_in, C_out, (taps - 1) * d + (p_shift < P), P * taps)
    N, KC, BM, Rs = pl.N, pl.KC, pl.BM, pl.Rb * pl.nb
    W = pk.float()
    out = torch.zeros(B, T * P, C_out)
    for nt in range(C_out // N):
        for bi in range(B):
            for t0 in range(0, T, BM):
                rows = torch.arange(t0 - lo, t0 - lo + Rs)
                ok = (rows >= 0) & (rows < T)
                win = torch.zeros(Rs, C_in)
                win[ok] = x[bi, rows[ok]].float()
                if pre:
                    win = F.leaky_relu(win, S)
                slot = win.reshape(Rs, C_in // 8, 8).permute(1, 0, 2)
                for p in range(P):
                    sums = torch.zeros(BM, N)
                    for j in range(taps):
                        r0 = (1 if p >= p_shift else 0) + j * d
                        for kc in range(C_in // KC):
                            for ks in range(KC // 16):
                                c8 = kc * KC // 8 + 2 * ks
                                a = slot[c8:c8 + 2, r0:r0 + BM]
                                bm = W[nt, p, j, kc, 2 * ks:2 * ks + 2]
                                sums += (a.permute(1, 0, 2).reshape(BM, 16)
                                         @ bm.permute(1, 0, 2)
                                         .reshape(N, 16).T)
                    n = slice(nt * N, nt * N + N)
                    v = sums + (b[n].float() if b is not None else 0)
                    if post:
                        v = F.leaky_relu(v, S)
                    t = torch.arange(t0, min(t0 + BM, T))
                    v = v[: len(t)]
                    if res is not None:
                        v = v + res[bi, t][:, n].float()
                    if acc is not None:
                        v = v + acc[bi, t][:, n].float()
                    out[bi, t * P + p, n] = v * scale
    return out


def bf16_exact(t):
    return t.to(torch.bfloat16).float()


@pytest.mark.parametrize("C,k,d", [(32, 11, 5), (32, 3, 1), (64, 7, 3),
                                   (64, 11, 1)])
def test_walk_of_the_kernel_equals_the_convolution(C, k, d):
    g = torch.Generator().manual_seed(C + k + d)
    B, T = 2, 600                      # two 512-row tiles, the second ragged
    x = bf16_exact(rn(g, B, T, C))
    w = bf16_exact(rn(g, C, C, k, scale=(C * k) ** -0.5))
    b = bf16_exact(rn(g, C, scale=0.1))
    res, acc = bf16_exact(rn(g, B, T, C)), bf16_exact(rn(g, B, T, C))
    got = walk(x, vc.pack(w), b, C, k, d, (k - 1) * d // 2, 1, 1, pre=True,
               res=res, acc=acc, scale=1 / 3)
    want = vc.conv(x, w, b, d, pre=True, res=res, acc=acc, scale=1 / 3)
    assert rel(got, want) < F32_TOL
    got = walk(x, vc.pack(w), b, C, k, d, (k - 1) * d // 2, 1, 1, pre=True,
               post=True)
    assert rel(got, vc.conv(x, w, b, d, pre=True, post=True)) < F32_TOL


@pytest.mark.parametrize("Ci,Co,u", [(64, 32, 2), (128, 64, 2), (64, 32, 8)])
def test_walk_of_the_transposed_convolution(Ci, Co, u):
    g = torch.Generator().manual_seed(Ci + u)
    x = bf16_exact(rn(g, 2, 300, Ci))
    w = bf16_exact(rn(g, Ci, Co, 2 * u, scale=(Ci * 2) ** -0.5))
    b = bf16_exact(rn(g, Co, scale=0.1))
    got = walk(x, vc.pack(w, u), b, Co, 2, 1, 1, u, u - u // 2, pre=True)
    assert rel(got, vc.up(x, w, b, u)) < F32_TOL


def test_pack_is_the_stage_order_the_kernel_reads():
    g = torch.Generator().manual_seed(11)
    w = bf16_exact(rn(g, 512, 64, 7))             # two N tiles of 256
    pk = vc.pack(w)
    assert pk.shape == (2, 1, 7, 2, 4, 256, 8) and pk.dtype == torch.bfloat16
    # [nt, p, tap, kc, c8, n, e] = w[nt N + n, kc KC + 8 c8 + e, tap]
    assert pk[1, 0, 5, 1, 3, 17, 6].float() == w[256 + 17, 32 + 24 + 6, 5]
    wt = bf16_exact(rn(g, 64, 32, 16))
    pt = vc.pack(wt, 8)                        # phases 0-3 read t-1, t
    assert pt.shape == (1, 8, 2, 2, 4, 32, 8)
    assert pt[0, 1, 0, 0, 0, 3, 2].float() == wt[2, 3, 1 + 4 + 8]
    assert pt[0, 6, 1, 1, 1, 3, 2].float() == wt[32 + 8 + 2, 3, 6 + 4 - 8]


def published_convs():
    """(C_in, C_out, span, phase x taps) of every generator convolution."""
    c0, out = V["upsample_initial_channel"], []
    out.append((V["inter_channels"], c0, 6, 7))
    for i, u in enumerate(V["upsample_rates"]):
        cin, cout = c0 >> i, c0 >> (i + 1)
        out.append((cin, cout, 2, 2 * u))
        for k, dils in zip(V["resblock_kernel_sizes"],
                           V["resblock_dilation_sizes"]):
            for d in dils:
                out += [(cout, cout, (k - 1) * d, k), (cout, cout, k - 1, k)]
    return out


def test_plan_fits_every_convolution_of_the_published_generator():
    convs = published_convs()
    assert len(convs) == 77                    # + conv_post: 78 a pass
    for C_in, C_out, span, pt in convs:
        pl = vc.plan(C_in, C_out, span, pt)
        assert pl.smem(C_in) + vc.SMEM_STATIC <= vc.SMEM_LIMIT
        assert pl.Rb * pl.nb >= pl.BM + span and pl.Rb <= 256
        assert pl.Rb % 8 == 0 and 1 <= pl.NA <= 2
        assert pl.NW <= vc.MAX_NW and (pl.resident or pl.NW >= 2)
        assert not pl.resident or (pl.NW == pl.S and C_out <= 256)
        assert pl.S == pt * C_in // pl.KC
    # the narrowest stage keeps its weights resident
    assert vc.plan(32, 32, 50, 11).resident


@pytest.mark.parametrize("C_out", [12, 96, 320])
def test_plan_refuses_widths_it_has_no_tile_for(C_out):
    with pytest.raises(ValueError, match="output channels"):
        vc.plan(64, C_out, 2, 3)


def test_plan_refuses_input_widths_off_its_stage():
    with pytest.raises(ValueError, match="input channels"):
        vc.plan(48, 128, 2, 3)


def test_cpu_launches_nothing():
    vc.reset_launch_counts()
    g = torch.Generator().manual_seed(12)
    vc.conv(rn(g, 1, 9, 8), rn(g, 8, 8, 3), None)
    assert vc.total_launches() == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

MAX_ABS_STEPS = 4 * 2.0 ** -8
REL_L2 = 1e-2


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
    assert rel(got, want) <= REL_L2


def card(g, dev, *shape, scale=1.0):
    return rn(g, *shape, scale=scale).to(dev, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("role", list(ROLE_ARGS))
@pytest.mark.parametrize("C", [256, 128, 64, 32])
def test_kernel_roles_match_plain_on_the_card(dev, C, role):
    g = torch.Generator().manual_seed(C + len(role))
    B, T = 2, 1333
    for k, d in ((3, 1), (11, 5), (7, 3)):
        Co = 2 * C if role == "pre" and C == 256 else C
        x = card(g, dev, B, T, C)
        w, b = card(g, dev, Co, C, k, scale=(C * k) ** -0.5), \
            card(g, dev, Co, scale=0.1)
        res = card(g, dev, B, T, Co) if role in ("second", "sum",
                                                 "mean") else None
        acc = card(g, dev, B, T, Co) if role in ("sum", "mean") else None
        vc.reset_launch_counts()
        got = vc.conv(x, w, b, d, packed=vc.pack(w), res=res, acc=acc,
                      **ROLE_ARGS[role])
        assert vc.launch_counts()["vits_conv.conv"] == 1
        close(got, vc.conv_plain(x, w, b, d, res=res, acc=acc,
                                 **ROLE_ARGS[role]))


@pytest.mark.cuda
@pytest.mark.parametrize("Ci,u", [(512, 8), (256, 8), (128, 2), (64, 2)])
def test_up_kernel_matches_plain_on_the_card(dev, Ci, u):
    g = torch.Generator().manual_seed(Ci + u)
    x = card(g, dev, 2, 301, Ci)
    w, b = card(g, dev, Ci, Ci // 2, 2 * u, scale=(Ci * 2) ** -0.5), \
        card(g, dev, Ci // 2, scale=0.1)
    got = vc.up(x, w, b, u, packed=vc.pack(w, u))
    assert got.shape == (2, 301 * u, Ci // 2)
    close(got, vc.up_plain(x, w, b, u))


@pytest.mark.cuda
def test_post_kernel_matches_plain_on_the_card(dev):
    g = torch.Generator().manual_seed(13)
    x = card(g, dev, 3, 1777, 32)
    w = card(g, dev, 1, 32, 7, scale=0.05)
    got = vc.post(x, w, packed=vc.pack_post(w))
    assert got.dtype == torch.float32 and got.shape == (3, 1777)
    close(got, vc.post_plain(x, w))


@pytest.mark.cuda
def test_published_generator_on_the_card(dev):
    from perfbench import weights_vits
    from perfbench.reference import vits as ref_vits
    from text2speech_tpu_torch import convert

    sd = weights_vits.make_weights(CFG, 2 ** 33 + 7, dev)
    cfg = VitsConfig.from_dict(V)
    model = convert.vits_module_from_torch(sd, cfg, dev)
    gen = model.dec
    assert gen.packed is not None
    z = torch.randn(2, cfg.inter_channels, 150, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    vc.reset_launch_counts()
    with torch.inference_mode(), recording() as rec:
        got = gen(z)
    assert vc.total_launches() == 78
    assert vc.launch_counts() == {"vits_conv.conv": 73, "vits_conv.up": 4,
                                  "vits_conv.post": 1}
    assert [v for _, v in rec.counters["vits.gen_launches"]] == [78]
    with torch.inference_mode():
        want = ref_vits.generator(sd, V, z)[:, 0]
    nsr = rel(got, want) ** 2
    assert nsr < 4e-4, nsr                      # the cell's limit: 1.2e-3
    gen.packed = None
    with pytest.raises(ValueError, match="pack"):
        gen(z)


@pytest.mark.cuda
def test_plan_is_the_kernels_shared_memory(dev):
    lib = vc.LIB.get()
    for C_in, C_out, span, pt in published_convs():
        pl = vc.plan(C_in, C_out, span, pt)
        assert pl.smem(C_in) == lib.t2s_vits_conv_smem_bytes(
            C_in, pl.N, pl.MT, pl.Rb * pl.nb, pl.NA, pl.NW)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernel_does_not_take(dev):
    g = torch.Generator().manual_seed(14)
    x = card(g, dev, 1, 64, 12)
    with pytest.raises(ValueError, match="output channels"):
        vc.conv(x, card(g, dev, 12, 12, 3), None)
    with pytest.raises(ValueError, match="bfloat16"):
        x32 = torch.randn(1, 64, 32, device=dev)
        vc.conv(x32, torch.randn(32, 32, 3, device=dev), None)
    x, w = card(g, dev, 1, 64, 32), card(g, dev, 32, 32, 3)
    with pytest.raises(ValueError, match="packed"):
        vc.conv(x, w, None)
    with pytest.raises(ValueError, match="packed"):
        vc.post(x, card(g, dev, 1, 32, 7))
