"""VITS inference (Kim, Kong and Son, "Conditional Variational Autoencoder
with Adversarial Learning for End-to-End Text-to-Speech", ICML 2021,
arXiv:2106.06103; equations as in the authors' ``models.py``,
``attentions.py``, ``modules.py`` and ``transforms.py``): the text encoder
with windowed relative-position attention, the stochastic duration
predictor run in reverse, the expansion of the text to frames by integer
durations, the mean-only coupling flows run in reverse and the HiFi-GAN V1
generator.

Layouts.  Text encoder, duration predictor and flows run channels-last
([B, T, C]) in float32: every convolution of k taps is one GEMM over the
unfolded taps (:func:`conv_cl`), a 1x1 convolution one ``F.linear``, the
depthwise convolutions k shifted products, and the flows' gated
activation the WN kernel of ``ops/gated.py``.  The generator runs
channels-last too, in :data:`GENERATOR_DTYPE` (bfloat16, as the WaveGlow
vocoder serves), on the fused convolutions of ``ops/vits_conv.py`` (its
eager cuDNN form stays as :meth:`Generator.first_design`).  Weight norm is
folded once when the weights are loaded
(``convert.vits_module_from_torch``), and the generator's weights are then
packed once for its kernel (:meth:`Generator.pack`).

Departures from upstream, none of which changes the mathematics:

* the expansion gathers each frame's token (``searchsorted`` of the
  cumulative durations) instead of multiplying by the 0/1 path matrix;
* the spline runs on every element with the inputs clamped into the
  interval and the identity selected outside it (upstream indexes the
  inside elements, which reads the mask on the host); a discriminant
  that rounds below zero is taken as zero where upstream asserts;
* the relative-position logits and weights are read and written on the
  2w + 1 diagonals of the score matrix instead of upstream's
  pad-and-reshape over 2T - 1 positions;
* q, k and v are one [3C, C] product."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VitsConfig
from ..ops import vits_conv
from ..ops.gated import gated_fwd
from ..utils.profiling import annotate, count

F32 = torch.float32
# the generator's weights and activations as loaded to serve
GENERATOR_DTYPE = torch.bfloat16
LRELU_SLOPE = 0.1
LN_EPS = 1e-5


def _p(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device),
                        requires_grad=False)


def layer_norm(x: torch.Tensor, g: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """VITS's ``LayerNorm`` (over channels, eps 1e-5), channels-last."""
    return F.layer_norm(x, (x.shape[-1],), g, b, LN_EPS)


def conv_cl(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
            dilation: int = 1) -> torch.Tensor:
    """A 'same' convolution of channels-last ``x`` [B, T, C_in] with a
    torch-layout kernel ``w`` [C_out, C_in, k] (odd k): one GEMM of the
    unfolded taps [B, T, C_in * k] with w viewed as [C_out, C_in * k]."""
    k = w.shape[-1]
    if k == 1:
        return F.linear(x, w[:, :, 0], b)
    span = dilation * (k - 1)
    xp = F.pad(x, (0, 0, span // 2, span - span // 2))
    taps = xp.unfold(1, span + 1, 1)[..., ::dilation]      # [B, T, C, k]
    return F.linear(taps.reshape(x.shape[0], x.shape[1], -1),
                    w.reshape(w.shape[0], -1), b)


def depthwise_cl(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 dilation: int) -> torch.Tensor:
    """A 'same' depthwise convolution of channels-last ``x`` [B, T, C] with
    ``w`` [C, 1, k]: k shifted products."""
    k, T = w.shape[-1], x.shape[1]
    span = dilation * (k - 1)
    xp = F.pad(x, (0, 0, span // 2, span - span // 2))
    y = b + xp[:, :T] * w[:, 0, 0]
    for t in range(1, k):
        y = y + xp[:, t * dilation: t * dilation + T] * w[:, 0, t]
    return y


# ---------------------------------------------------------------------------
# text encoder
# ---------------------------------------------------------------------------


class EncoderLayer(nn.Module):
    """One post-norm transformer layer: relative-position MHA, then the
    FFN of two k-tap convolutions."""

    def __init__(self, cfg: VitsConfig, device=None):
        super().__init__()
        H, Fc, k = cfg.hidden_channels, cfg.filter_channels, cfg.kernel_size
        dk, W = H // cfg.n_heads, 2 * cfg.window_size + 1
        self.n_heads, self.window = cfg.n_heads, cfg.window_size
        d = device
        self.qkv_w, self.qkv_b = _p(3 * H, H, device=d), _p(3 * H, device=d)
        self.o_w, self.o_b = _p(H, H, device=d), _p(H, device=d)
        self.rel_k, self.rel_v = _p(W, dk, device=d), _p(W, dk, device=d)
        self.ln1_g, self.ln1_b = _p(H, device=d), _p(H, device=d)
        self.ffn1_w, self.ffn1_b = _p(Fc, H, k, device=d), _p(Fc, device=d)
        self.ffn2_w, self.ffn2_b = _p(H, Fc, k, device=d), _p(H, device=d)
        self.ln2_g, self.ln2_b = _p(H, device=d), _p(H, device=d)

    def _diagonals(self, T: int):
        """(offset r, first row, row end) of each relative position the
        window holds at length T."""
        w = self.window
        return [(r, max(0, -r), T - max(0, r)) for r in range(-w, w + 1)
                if abs(r) < T]

    def attention(self, x: torch.Tensor, pair: torch.Tensor) -> torch.Tensor:
        B, T, H = x.shape
        h, w = self.n_heads, self.window
        dk = H // h
        qkv = F.linear(x, self.qkv_w, self.qkv_b).view(B, T, 3, h, dk)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)                 # [B, h, T, dk]
        q = q / math.sqrt(dk)
        scores = q @ k.transpose(-1, -2)                      # [B, h, T, T]
        rel = q @ self.rel_k.t()                              # [B, h, T, 2w+1]
        for r, lo, hi in self._diagonals(T):
            scores.diagonal(r, -2, -1).add_(rel[:, :, lo:hi, w + r])
        p = scores.masked_fill_(~pair, -1e4).softmax(-1)
        out = p @ v
        band = p.new_zeros(B, h, T, 2 * w + 1)
        for r, lo, hi in self._diagonals(T):
            band[:, :, lo:hi, w + r] = p.diagonal(r, -2, -1)
        out = out + band @ self.rel_v
        return F.linear(out.transpose(1, 2).reshape(B, T, H), self.o_w,
                        self.o_b)

    def forward(self, x, m, pair):
        x = layer_norm(x + self.attention(x, pair), self.ln1_g, self.ln1_b)
        y = torch.relu(conv_cl(x * m, self.ffn1_w, self.ffn1_b))
        y = conv_cl(y * m, self.ffn2_w, self.ffn2_b) * m
        return layer_norm(x + y, self.ln2_g, self.ln2_b)


class TextEncoder(nn.Module):
    def __init__(self, cfg: VitsConfig, device=None):
        super().__init__()
        H = cfg.hidden_channels
        self.emb = _p(cfg.n_vocab, H, device=device)
        self.layers = nn.ModuleList(EncoderLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.proj_w = _p(2 * cfg.inter_channels, H, device=device)
        self.proj_b = _p(2 * cfg.inter_channels, device=device)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor):
        """ids [B, T], mask bool [B, T] -> (x [B, T, H], m_p, logs_p
        [B, T, C]), zero past each row's length."""
        m = mask[..., None].to(F32)
        pair = mask[:, None, :, None] & mask[:, None, None, :]
        x = F.embedding(ids, self.emb) * math.sqrt(self.emb.shape[1]) * m
        for layer in self.layers:
            x = layer(x, m, pair)
        x = x * m
        stats = F.linear(x, self.proj_w, self.proj_b) * m
        m_p, logs_p = stats.chunk(2, dim=-1)
        return x, m_p, logs_p


# ---------------------------------------------------------------------------
# stochastic duration predictor
# ---------------------------------------------------------------------------


class DDSConv(nn.Module):
    """Dilated depth-separable convolutions (modules.DDSConv): per layer a
    depthwise k-tap conv at dilation k^i, LN, GELU, 1x1, LN, GELU, residual."""

    def __init__(self, C: int, k: int, n_layers: int, device=None):
        super().__init__()
        self.k = k
        self.sep_w = _p(n_layers, C, 1, k, device=device)
        self.sep_b = _p(n_layers, C, device=device)
        self.pw_w = _p(n_layers, C, C, device=device)
        self.pw_b = _p(n_layers, C, device=device)
        self.ln_g = _p(n_layers, 2, C, device=device)
        self.ln_b = _p(n_layers, 2, C, device=device)

    def forward(self, x, m, g=None):
        if g is not None:
            x = x + g
        for i in range(self.sep_w.shape[0]):
            y = depthwise_cl(x * m, self.sep_w[i], self.sep_b[i], self.k ** i)
            y = F.gelu(layer_norm(y, self.ln_g[i, 0], self.ln_b[i, 0]))
            y = F.linear(y, self.pw_w[i], self.pw_b[i])
            y = F.gelu(layer_norm(y, self.ln_g[i, 1], self.ln_b[i, 1]))
            x = x + y
        return x * m


def rq_spline(x: torch.Tensor, uw: torch.Tensor, uh: torch.Tensor,
              ud: torch.Tensor, bound: float, inverse: bool,
              min_w: float = 1e-3, min_h: float = 1e-3,
              min_d: float = 1e-3) -> torch.Tensor:
    """The unconstrained rational-quadratic spline with linear tails
    (transforms.py), forward or inverse, on every element of ``x`` [...]:
    bins from ``uw``, ``uh`` [..., n], inner derivatives ``ud`` [..., n - 1];
    the identity outside [-bound, bound]."""
    n = uw.shape[-1]
    edge = math.log(math.exp(1 - min_d) - 1)
    d = min_d + F.softplus(F.pad(ud, (1, 1), value=edge))

    def knots(u, lo):
        s = lo + (1 - lo * n) * u.softmax(-1)
        c = F.pad(s.cumsum(-1), (1, 0)) * (2 * bound) - bound
        c[..., 0], c[..., -1] = -bound, bound
        return c, c[..., 1:] - c[..., :-1]

    cw, widths = knots(uw, min_w)
    ch, heights = knots(uh, min_h)
    inside = (x >= -bound) & (x <= bound)
    xc = x.clamp(-bound, bound)
    idx = ((xc[..., None] >= (ch if inverse else cw)[..., :-1]).sum(-1)
           - 1).clamp_(0, n - 1)[..., None]

    def at(t):
        return t.gather(-1, idx)[..., 0]

    x_cw, x_w, x_ch, x_h = at(cw), at(widths), at(ch), at(heights)
    x_delta, x_d0, x_d1 = at(heights / widths), at(d), at(d[..., 1:])
    s = x_d0 + x_d1 - 2 * x_delta
    if inverse:
        t = xc - x_ch
        a = t * s + x_h * (x_delta - x_d0)
        b = x_h * x_d0 - t * s
        c = -x_delta * t
        disc = (b * b - 4 * a * c).clamp_min(0)
        y = (2 * c) / (-b - torch.sqrt(disc)) * x_w + x_cw
    else:
        theta = (xc - x_cw) / x_w
        tt = theta * (1 - theta)
        y = x_ch + x_h * (x_delta * theta * theta + x_d0 * tt) / (
            x_delta + s * tt)
    return torch.where(inside, y, x)


class ConvFlow(nn.Module):
    """modules.ConvFlow on two channels: x1 through the spline whose
    knots a DDSConv net computes from x0 and the conditioning."""

    def __init__(self, cfg: VitsConfig, device=None):
        super().__init__()
        C, nb = cfg.dp_filter_channels, cfg.dp_num_bins
        self.nb, self.bound = nb, cfg.dp_tail_bound
        self.pre_w, self.pre_b = _p(C, 1, device=device), _p(C,
                                                              device=device)
        self.convs = DDSConv(C, cfg.dp_kernel_size, cfg.dp_n_layers, device)
        self.proj_w = _p(3 * nb - 1, C, device=device)
        self.proj_b = _p(3 * nb - 1, device=device)

    def inverse(self, x, m, g):
        x0, x1 = x[..., :1], x[..., 1]
        h = F.linear(x0, self.pre_w, self.pre_b)
        h = self.convs(h, m, g)
        h = F.linear(h, self.proj_w, self.proj_b) * m
        root = math.sqrt(self.pre_w.shape[0])
        nb = self.nb
        x1 = rq_spline(x1, h[..., :nb] / root, h[..., nb: 2 * nb] / root,
                       h[..., 2 * nb:], self.bound, inverse=True)
        return torch.cat([x0, x1[..., None]], -1) * m


class DurationPredictor(nn.Module):
    """The stochastic duration predictor's inference half: the
    conditioning net, then Flip, ConvFlow_n^-1, ..., Flip, ConvFlow_2^-1,
    Flip, ElementwiseAffine^-1 (upstream drops ConvFlow_1 at inference)."""

    def __init__(self, cfg: VitsConfig, device=None):
        super().__init__()
        C = cfg.dp_filter_channels
        self.pre_w = _p(C, cfg.hidden_channels, device=device)
        self.pre_b = _p(C, device=device)
        self.convs = DDSConv(C, cfg.dp_kernel_size, cfg.dp_n_layers, device)
        self.proj_w = _p(C, C, device=device)
        self.proj_b = _p(C, device=device)
        self.ea_m, self.ea_logs = _p(2, device=device), _p(2, device=device)
        # ConvFlow_2 .. ConvFlow_n, in forward order
        self.flows = nn.ModuleList(ConvFlow(cfg, device)
                                   for _ in range(cfg.dp_n_flows - 1))

    def forward(self, x, m, noise):
        """x [B, T, H], m [B, T, 1], noise [B, T, 2] (already scaled) ->
        logw [B, T]."""
        g = F.linear(x, self.pre_w, self.pre_b)
        g = self.convs(g, m)
        g = F.linear(g, self.proj_w, self.proj_b) * m
        z = noise
        for flow in reversed(self.flows):
            z = flow.inverse(z.flip(-1), m, g)
        z = (z.flip(-1) - self.ea_m) * torch.exp(-self.ea_logs) * m
        return z[..., 0]


# ---------------------------------------------------------------------------
# coupling flows
# ---------------------------------------------------------------------------


class CouplingLayer(nn.Module):
    """modules.ResidualCouplingLayer, mean only: x1 -= post(WN(pre(x0)))."""

    def __init__(self, cfg: VitsConfig, device=None):
        super().__init__()
        half, H = cfg.inter_channels // 2, cfg.hidden_channels
        L, k = cfg.flow_n_layers, cfg.flow_kernel_size
        self.rate = cfg.flow_dilation_rate
        self.pre_w = _p(H, half, device=device)
        self.pre_b = _p(H, device=device)
        self.in_w = nn.ParameterList(_p(2 * H, H, k, device=device)
                                     for _ in range(L))
        self.in_b = _p(L, 2 * H, device=device)
        self.rs_w = nn.ParameterList(
            _p(2 * H if i < L - 1 else H, H, device=device) for i in range(L))
        self.rs_b = nn.ParameterList(
            _p(2 * H if i < L - 1 else H, device=device) for i in range(L))
        self.post_w = _p(half, H, device=device)
        self.post_b = _p(half, device=device)

    def wn(self, h, m):
        """modules.WN without conditioning: the gated activation adds the
        zero conditioning upstream adds (its ``g_l``)."""
        H = h.shape[-1]
        zero = h.new_zeros(*h.shape[:-1], 2 * H)
        out = None
        L = len(self.in_w)
        for i in range(L):
            acts = gated_fwd(conv_cl(h, self.in_w[i], self.in_b[i],
                                     self.rate ** i), zero)
            rs = F.linear(acts, self.rs_w[i], self.rs_b[i])
            if i < L - 1:
                h = (h + rs[..., :H]) * m
                rs = rs[..., H:]
            out = rs if out is None else out + rs
        return out * m

    def inverse(self, x, m):
        half = x.shape[-1] // 2
        x0, x1 = x[..., :half], x[..., half:]
        h = F.linear(x0, self.pre_w, self.pre_b) * m
        mean = F.linear(self.wn(h, m), self.post_w, self.post_b) * m
        return torch.cat([x0, (x1 - mean) * m], -1)


# ---------------------------------------------------------------------------
# HiFi-GAN V1 generator
# ---------------------------------------------------------------------------


def _pad(k: int, d: int) -> int:
    return (k * d - d) // 2


class Generator(nn.Module):
    """HiFi-GAN V1 (``resblock "1"``): conv_pre, per stage leaky ReLU, a
    transposed convolution and the mean of the multi-receptive-field
    ResBlock1s, then leaky ReLU (0.01), conv_post and tanh.

    :meth:`forward` runs channels-last, one call of ``ops/vits_conv.py`` a
    convolution (78 a pass at V1's shapes), each with the activations,
    bias, residual, running sum and mean around it; on a card those are
    the kernels, which read the weight images :meth:`pack` made (the
    loaders call it; call it again after changing a weight).
    :meth:`first_design` is the eager channels-first form on cuDNN."""

    def __init__(self, cfg: VitsConfig, device=None):
        super().__init__()
        if cfg.resblock != "1":
            raise ValueError(f"resblock {cfg.resblock!r}: only the V1 "
                             f"generator's ResBlock1 is ported")
        c0 = cfg.upsample_initial_channel
        self.cfg = cfg
        self.pre_w = _p(c0, cfg.inter_channels, 7, device=device)
        self.pre_b = _p(c0, device=device)
        self.up_w, self.up_b, self.res_w, self.res_b = (
            nn.ParameterList(), nn.ParameterList(), nn.ParameterList(),
            nn.ParameterList())
        for i, k in enumerate(cfg.upsample_kernel_sizes):
            cin, cout = c0 >> i, c0 >> (i + 1)
            self.up_w.append(_p(cin, cout, k, device=device))
            self.up_b.append(_p(cout, device=device))
            for rk, dils in zip(cfg.resblock_kernel_sizes,
                                cfg.resblock_dilation_sizes):
                # convs1 then convs2, one [2n, C, C, k] block a ResBlock1
                self.res_w.append(_p(2 * len(dils), cout, cout, rk,
                                     device=device))
                self.res_b.append(_p(2 * len(dils), cout, device=device))
        self.post_w = _p(1, c0 >> len(cfg.upsample_rates), 7, device=device)
        self.packed: dict | None = None

    @torch.no_grad()
    def pack(self) -> dict:
        """The kernels' weight images (``vits_conv.pack``), made from the
        weights as they stand; the loaders call it once weight norm is
        folded and the cast done."""
        cfg = self.cfg
        self.packed = {
            "pre": vits_conv.pack(self.pre_w),
            "up": [vits_conv.pack(w, u)
                   for w, u in zip(self.up_w, cfg.upsample_rates)],
            "res": [[vits_conv.pack(w[i]) for i in range(w.shape[0])]
                    for w in self.res_w],
            "post": vits_conv.pack_post(self.post_w)}
        return self.packed

    def resblock(self, x, r: int, dils, xs, scale: float, pk):
        """ResBlock1 ``r`` on x [B, T, C]; its last convolution adds the
        running sum ``xs`` (when given) and scales: (resblock(x) + xs) *
        scale."""
        w, b, n = self.res_w[r], self.res_b[r], len(dils)
        h = x
        for m, d in enumerate(dils):
            last = m == n - 1
            a = vits_conv.conv(h, w[m], b[m], d, pre=True, post=True,
                               packed=pk and pk["res"][r][m])
            h = vits_conv.conv(a, w[n + m], b[n + m], 1, res=h,
                               acc=xs if last else None,
                               scale=scale if last else 1.0,
                               packed=pk and pk["res"][r][n + m])
        return h

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, C, T] -> audio [B, T * hop] float32."""
        cfg = self.cfg
        x = z.transpose(1, 2).to(self.pre_w.dtype).contiguous()
        pk = None
        if x.is_cuda:
            pk = self.packed
            if pk is None:
                raise ValueError("Generator: no weight images for the "
                                 "kernels; call pack() once the weights "
                                 "are loaded")
        n0 = vits_conv.total_launches()
        x = vits_conv.conv(x, self.pre_w, self.pre_b,
                           packed=pk and pk["pre"])
        nk = len(cfg.resblock_kernel_sizes)
        for i, u in enumerate(cfg.upsample_rates):
            x = vits_conv.up(x, self.up_w[i], self.up_b[i], u,
                             packed=pk and pk["up"][i])
            xs = None
            for j, dils in enumerate(cfg.resblock_dilation_sizes):
                xs = self.resblock(x, i * nk + j, dils, xs,
                                   1.0 / nk if j == nk - 1 else 1.0, pk)
            x = xs
        audio = vits_conv.post(x, self.post_w, packed=pk and pk["post"])
        count("vits.gen_launches", vits_conv.total_launches() - n0)
        return audio

    def first_design(self, z: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` as first written: channels-first on cuDNN's
        convolutions, every activation and add a pass of its own."""
        cfg = self.cfg
        x = F.conv1d(z.to(self.pre_w.dtype), self.pre_w, self.pre_b,
                     padding=3)
        nk = len(cfg.resblock_kernel_sizes)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            x = F.conv_transpose1d(F.leaky_relu(x, LRELU_SLOPE),
                                   self.up_w[i], self.up_b[i], stride=u,
                                   padding=(k - u) // 2)
            xs = None
            for j, dils in enumerate(cfg.resblock_dilation_sizes):
                w, b, n = self.res_w[i * nk + j], self.res_b[i * nk + j], \
                    len(dils)
                r = x
                for m, d in enumerate(dils):
                    xt = F.conv1d(F.leaky_relu(r, LRELU_SLOPE), w[m], b[m],
                                  padding=_pad(w.shape[-1], d), dilation=d)
                    xt = F.conv1d(F.leaky_relu(xt, LRELU_SLOPE), w[n + m],
                                  b[n + m], padding=_pad(w.shape[-1], 1))
                    r = xt + r
                xs = r if xs is None else xs + r
            x = xs / nk
        x = F.conv1d(F.leaky_relu(x), self.post_w, None, padding=3)
        return torch.tanh(x.float())[:, 0]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class Vits(nn.Module):
    """VITS's inference path (``SynthesizerTrn.infer``) on one device; one
    speaker.  Built in float32; the loaders
    (``convert.vits_module_from_torch``, ``infer.random_vits_synthesizer``)
    cast the generator to :data:`GENERATOR_DTYPE`."""

    def __init__(self, cfg: VitsConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.enc = TextEncoder(cfg, device)
        self.dp = DurationPredictor(cfg, device)
        self.flows = nn.ModuleList(CouplingLayer(cfg, device)
                                   for _ in range(cfg.flow_n_flows))
        self.dec = Generator(cfg, device)

    @property
    def device(self) -> torch.device:
        return self.enc.emb.device

    def encode(self, ids: torch.Tensor, lengths: torch.Tensor,
               noise_w: torch.Tensor, noise_scale_w: float):
        """ids [B, T], lengths [B], noise_w [B, 2, >= T] -> (m_p, logs_p
        [B, T, C], logw [B, T], x mask [B, T, 1])."""
        T = ids.shape[1]
        mask = torch.arange(T, device=ids.device)[None] < lengths[:, None]
        m = mask[..., None].to(F32)
        with annotate("vits.encoder"):
            x, m_p, logs_p = self.enc(ids, mask)
        with annotate("vits.duration"):
            logw = self.dp(x, m, noise_w[:, :, :T].transpose(1, 2)
                           * noise_scale_w)
        return m_p, logs_p, logw, m

    @staticmethod
    def durations(logw, m, length_scale: float):
        """(w_ceil [B, T], y_lengths [B] long on the device)."""
        w_ceil = torch.ceil(torch.exp(logw) * m[..., 0] * length_scale)
        return w_ceil, w_ceil.sum(1).clamp_min(1).long()

    @staticmethod
    def expand(m_p, logs_p, w_ceil, T_y: int):
        """Each frame's token statistics: frame t takes token j where
        cum[j - 1] <= t < cum[j] (cum the running sum of ``w_ceil``), and
        zero past the durations' sum -> m, logs [B, T_y, C]."""
        B, T_x, C = m_p.shape
        cum = w_ceil.cumsum(1)
        t = torch.arange(T_y, device=m_p.device, dtype=cum.dtype)
        idx = torch.searchsorted(cum, t.expand(B, T_y).contiguous(),
                                 right=True)
        keep = (t[None] < cum[:, -1:])[..., None].to(F32)
        idx = idx.clamp_(max=T_x - 1)[..., None].expand(B, T_y, C)
        return m_p.gather(1, idx) * keep, logs_p.gather(1, idx) * keep

    def flow_reverse(self, z_p, y_mask):
        with annotate("vits.flow"):
            x = z_p
            for layer in reversed(self.flows):
                x = layer.inverse(x.flip(-1), y_mask)
            return x * y_mask
