"""VITS in plain float32 PyTorch (Kim, Kong and Son, arXiv:2106.06103, as
the authors' ``models.py``, ``attentions.py``, ``modules.py``,
``transforms.py`` and ``commons.py`` write it; ``SynthesizerTrn.infer``
with one speaker), over a state dict in that repository's layout.  Every
convolution runs in TF32-free float32 (:func:`exact`).

Departures from upstream:

* ``infer`` takes the standard-normal draws instead of drawing them: the
  duration predictor's [2, T_text] and the latent's [C, T_y];
* it may be given the integer durations (a ``ceil`` at an integer edge
  flips on the last bit, so the check hands the reference the program's)
  and the padded frame count T_y (the generator's convolutions read the
  padding past a row's end);
* weight norm is folded here, ``g v / ||v||`` over every dimension but the
  first;
* the text ids keep the end-of-sentence symbol of the port's vocabulary
  before the blanks are interspersed (upstream's cleaners add none).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1


def exact() -> None:
    """float32 stays float32: TF32 off for products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def intersperse(ids: list, item: int = 0) -> list:
    """``commons.intersperse``: the blank before, between and after."""
    out = [item] * (2 * len(ids) + 1)
    out[1::2] = ids
    return out


# ---------------------------------------------------------------------------
# the state dict's leaves
# ---------------------------------------------------------------------------


def vits_shapes(v: dict, training: bool = False) -> dict:
    """Every leaf the inference path reads (with ``training``, also those
    of the posterior encoder, the posterior flows and ConvFlow_1): name ->
    (shape, kind).  Kinds: ``weight`` (fan-in scaled), ``bias``,
    ``ln_gamma`` / ``ln_beta``, ``embedding``, ``rel`` (the relative
    embeddings), ``wn_v`` / ``wn_g`` / ``wn_g_up`` (weight norm's direction
    and gain, of a conv and of a transposed conv), ``ea_m`` / ``ea_logs``,
    ``proj_logs`` (the text encoder's projection), ``dp_proj`` (a
    ConvFlow's knot projection), ``conv_post``."""
    H, Fc, C = v["hidden_channels"], v["filter_channels"], v["inter_channels"]
    k, dk = v["kernel_size"], v["hidden_channels"] // v["n_heads"]
    out: dict = {"enc_p.emb.weight": ((v["n_vocab"], H), "embedding")}

    def conv(name, cout, cin, kk, kind="weight", bias=True):
        out[f"{name}.weight"] = ((cout, cin, kk), kind)
        if bias:
            out[f"{name}.bias"] = ((cout,), "bias")

    def wn_conv(name, cout, cin, kk):
        out[f"{name}.weight_v"] = ((cout, cin, kk), "wn_v")
        out[f"{name}.weight_g"] = ((cout, 1, 1), "wn_g")
        out[f"{name}.bias"] = ((cout,), "bias")

    def ln(name, ch):
        out[f"{name}.gamma"] = ((ch,), "ln_gamma")
        out[f"{name}.beta"] = ((ch,), "ln_beta")

    for i in range(v["n_layers"]):
        a = f"enc_p.encoder.attn_layers.{i}"
        for c in "qkvo":
            conv(f"{a}.conv_{c}", H, H, 1)
        W = 2 * v["window_size"] + 1
        out[f"{a}.emb_rel_k"] = ((1, W, dk), "rel")
        out[f"{a}.emb_rel_v"] = ((1, W, dk), "rel")
        ln(f"enc_p.encoder.norm_layers_1.{i}", H)
        conv(f"enc_p.encoder.ffn_layers.{i}.conv_1", Fc, H, k)
        conv(f"enc_p.encoder.ffn_layers.{i}.conv_2", H, Fc, k)
        ln(f"enc_p.encoder.norm_layers_2.{i}", H)
    out["enc_p.proj.weight"] = ((2 * C, H, 1), "proj_logs")
    out["enc_p.proj.bias"] = ((2 * C,), "bias")

    D, dkk = v["dp_filter_channels"], v["dp_kernel_size"]
    nb = v["dp_num_bins"]

    def dds(name):
        for i in range(v["dp_n_layers"]):
            conv(f"{name}.convs_sep.{i}", D, 1, dkk)
            conv(f"{name}.convs_1x1.{i}", D, D, 1)
            ln(f"{name}.norms_1.{i}", D)
            ln(f"{name}.norms_2.{i}", D)

    def conv_flow(name):
        conv(f"{name}.pre", D, 1, 1)
        dds(f"{name}.convs")
        conv(f"{name}.proj", 3 * nb - 1, D, 1, kind="dp_proj")

    conv("dp.pre", D, H, 1)
    dds("dp.convs")
    conv("dp.proj", D, D, 1)
    out["dp.flows.0.m"] = ((2, 1), "ea_m")
    out["dp.flows.0.logs"] = ((2, 1), "ea_logs")
    first = 1 if training else 2
    for j in range(first, v["dp_n_flows"] + 1):
        conv_flow(f"dp.flows.{2 * j - 1}")

    L, fk = v["flow_n_layers"], v["flow_kernel_size"]
    for j in range(v["flow_n_flows"]):
        f = f"flow.flows.{2 * j}"
        conv(f"{f}.pre", H, C // 2, 1)
        for i in range(L):
            wn_conv(f"{f}.enc.in_layers.{i}", 2 * H, H, fk)
            wn_conv(f"{f}.enc.res_skip_layers.{i}",
                    2 * H if i < L - 1 else H, H, 1)
        conv(f"{f}.post", C // 2, H, 1)

    c0 = v["upsample_initial_channel"]
    conv("dec.conv_pre", c0, C, 7)
    nk = len(v["resblock_kernel_sizes"])
    for i, uk in enumerate(v["upsample_kernel_sizes"]):
        cin, cout = c0 >> i, c0 >> (i + 1)
        out[f"dec.ups.{i}.weight_v"] = ((cin, cout, uk), "wn_v")
        out[f"dec.ups.{i}.weight_g"] = ((cin, 1, 1), "wn_g_up")
        out[f"dec.ups.{i}.bias"] = ((cout,), "bias")
        for j, (rk, dils) in enumerate(zip(v["resblock_kernel_sizes"],
                                           v["resblock_dilation_sizes"])):
            for c in (1, 2):
                for d in range(len(dils)):
                    wn_conv(f"dec.resblocks.{i * nk + j}.convs{c}.{d}",
                            cout, cout, rk)
    conv("dec.conv_post", 1, c0 >> len(v["upsample_rates"]), 7,
         kind="conv_post", bias=False)

    if training:
        conv("dp.post_pre", D, 1, 1)
        conv("dp.post_proj", D, D, 1)
        dds("dp.post_convs")
        out["dp.post_flows.0.m"] = ((2, 1), "ea_m")
        out["dp.post_flows.0.logs"] = ((2, 1), "ea_logs")
        for j in range(1, 5):
            conv_flow(f"dp.post_flows.{2 * j - 1}")
        conv("enc_q.pre", H, 513, 1)
        for i in range(16):
            wn_conv(f"enc_q.enc.in_layers.{i}", 2 * H, H, 5)
            wn_conv(f"enc_q.enc.res_skip_layers.{i}",
                    2 * H if i < 15 else H, H, 1)
        conv("enc_q.proj", 2 * C, H, 1)
    return out


def fold(sd: dict, name: str) -> torch.Tensor:
    """A weight-normalized conv's kernel, g v / ||v|| over every dimension
    but the first."""
    v, g = sd[f"{name}.weight_v"], sd[f"{name}.weight_g"]
    return g * v / torch.sqrt((v * v).sum(dim=(1, 2), keepdim=True))


# ---------------------------------------------------------------------------
# text encoder (attentions.py)
# ---------------------------------------------------------------------------


def layer_norm(x, gamma, beta):
    """modules.LayerNorm: over channels of [B, C, T], eps 1e-5."""
    x = x.transpose(1, -1)
    x = F.layer_norm(x, (x.shape[-1],), gamma, beta, 1e-5)
    return x.transpose(1, -1)


def _conv(sd, name, x, **kw):
    return F.conv1d(x, sd[f"{name}.weight"], sd.get(f"{name}.bias"), **kw)


def _relative_embeddings(emb, length, window):
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad > 0:
        emb = F.pad(emb, (0, 0, pad, pad))
    return emb[:, start: start + 2 * length - 1]


def _rel_to_abs(x):
    b, h, n, _ = x.shape
    x = F.pad(x, (0, 1)).view(b, h, n * 2 * n)
    x = F.pad(x, (0, n - 1))
    return x.view(b, h, n + 1, 2 * n - 1)[:, :, :n, n - 1:]


def _abs_to_rel(x):
    b, h, n, _ = x.shape
    x = F.pad(x, (0, n - 1)).view(b, h, n * n + n * (n - 1))
    x = F.pad(x, (n, 0))
    return x.view(b, h, n, 2 * n)[:, :, :, 1:]


def attention(sd, a, x, attn_mask, n_heads, window):
    q, k, v = (_conv(sd, f"{a}.conv_{c}", x) for c in "qkv")
    b, d, t = k.shape
    dk = d // n_heads
    q = q.view(b, n_heads, dk, t).transpose(2, 3)
    k = k.view(b, n_heads, dk, t).transpose(2, 3)
    v = v.view(b, n_heads, dk, t).transpose(2, 3)
    scores = torch.matmul(q / math.sqrt(dk), k.transpose(-2, -1))
    rel_k = _relative_embeddings(sd[f"{a}.emb_rel_k"], t, window)
    rel = torch.matmul(q / math.sqrt(dk),
                       rel_k.unsqueeze(0).transpose(-2, -1))
    scores = scores + _rel_to_abs(rel)
    scores = scores.masked_fill(attn_mask == 0, -1e4)
    p = F.softmax(scores, dim=-1)
    out = torch.matmul(p, v)
    rel_v = _relative_embeddings(sd[f"{a}.emb_rel_v"], t, window)
    out = out + torch.matmul(_abs_to_rel(p), rel_v.unsqueeze(0))
    out = out.transpose(2, 3).contiguous().view(b, d, t)
    return _conv(sd, f"{a}.conv_o", out)


def text_encoder(sd, v, ids):
    """ids [B, T] (every row full length) -> (x [B, H, T], m_p, logs_p
    [B, C, T], x_mask [B, 1, T])."""
    H = v["hidden_channels"]
    x = F.embedding(ids, sd["enc_p.emb.weight"]) * math.sqrt(H)
    x = x.transpose(1, -1)
    x_mask = torch.ones_like(x[:, :1])
    attn_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)
    k = v["kernel_size"]
    for i in range(v["n_layers"]):
        a = f"enc_p.encoder.attn_layers.{i}"
        y = attention(sd, a, x, attn_mask, v["n_heads"], v["window_size"])
        x = layer_norm(x + y, sd[f"enc_p.encoder.norm_layers_1.{i}.gamma"],
                       sd[f"enc_p.encoder.norm_layers_1.{i}.beta"])
        f = f"enc_p.encoder.ffn_layers.{i}"
        y = _conv(sd, f"{f}.conv_1", F.pad(x * x_mask, ((k - 1) // 2, k // 2)))
        y = torch.relu(y)
        y = _conv(sd, f"{f}.conv_2", F.pad(y * x_mask, ((k - 1) // 2, k // 2)))
        x = layer_norm(x + y * x_mask,
                       sd[f"enc_p.encoder.norm_layers_2.{i}.gamma"],
                       sd[f"enc_p.encoder.norm_layers_2.{i}.beta"])
    x = x * x_mask
    stats = _conv(sd, "enc_p.proj", x) * x_mask
    C = v["inter_channels"]
    return x, stats[:, :C], stats[:, C:], x_mask


# ---------------------------------------------------------------------------
# stochastic duration predictor (modules.py, transforms.py)
# ---------------------------------------------------------------------------


def dds_conv(sd, name, x, x_mask, n_layers, kernel_size, g=None):
    if g is not None:
        x = x + g
    for i in range(n_layers):
        d = kernel_size ** i
        w = sd[f"{name}.convs_sep.{i}.weight"]
        y = F.conv1d(x * x_mask, w, sd[f"{name}.convs_sep.{i}.bias"],
                     groups=w.shape[0], dilation=d,
                     padding=(kernel_size * d - d) // 2)
        y = F.gelu(layer_norm(y, sd[f"{name}.norms_1.{i}.gamma"],
                              sd[f"{name}.norms_1.{i}.beta"]))
        y = _conv(sd, f"{name}.convs_1x1.{i}", y)
        y = F.gelu(layer_norm(y, sd[f"{name}.norms_2.{i}.gamma"],
                              sd[f"{name}.norms_2.{i}.beta"]))
        x = x + y
    return x * x_mask


def _searchsorted(bin_locations, inputs, eps=1e-6):
    bin_locations = bin_locations.clone()
    bin_locations[..., -1] += eps
    return torch.sum(inputs[..., None] >= bin_locations, dim=-1) - 1


def rational_quadratic_spline(inputs, uw, uh, ud, inverse, left, right,
                              bottom, top, min_w=1e-3, min_h=1e-3,
                              min_d=1e-3):
    """transforms.rational_quadratic_spline -> (outputs, logabsdet)."""
    n = uw.shape[-1]
    widths = F.softmax(uw, dim=-1)
    widths = min_w + (1 - min_w * n) * widths
    cumwidths = F.pad(torch.cumsum(widths, dim=-1), (1, 0), value=0.0)
    cumwidths = (right - left) * cumwidths + left
    cumwidths[..., 0] = left
    cumwidths[..., -1] = right
    widths = cumwidths[..., 1:] - cumwidths[..., :-1]
    derivatives = min_d + F.softplus(ud)
    heights = F.softmax(uh, dim=-1)
    heights = min_h + (1 - min_h * n) * heights
    cumheights = F.pad(torch.cumsum(heights, dim=-1), (1, 0), value=0.0)
    cumheights = (top - bottom) * cumheights + bottom
    cumheights[..., 0] = bottom
    cumheights[..., -1] = top
    heights = cumheights[..., 1:] - cumheights[..., :-1]
    idx = _searchsorted(cumheights if inverse else cumwidths,
                        inputs)[..., None]
    in_cw = cumwidths.gather(-1, idx)[..., 0]
    in_w = widths.gather(-1, idx)[..., 0]
    in_ch = cumheights.gather(-1, idx)[..., 0]
    delta = heights / widths
    in_delta = delta.gather(-1, idx)[..., 0]
    in_d = derivatives.gather(-1, idx)[..., 0]
    in_d1 = derivatives[..., 1:].gather(-1, idx)[..., 0]
    in_h = heights.gather(-1, idx)[..., 0]
    if inverse:
        a = ((inputs - in_ch) * (in_d + in_d1 - 2 * in_delta)
             + in_h * (in_delta - in_d))
        b = in_h * in_d - (inputs - in_ch) * (in_d + in_d1 - 2 * in_delta)
        c = -in_delta * (inputs - in_ch)
        disc = b.pow(2) - 4 * a * c
        if not bool((disc >= 0).all()):
            raise ValueError("the spline's discriminant went negative")
        root = (2 * c) / (-b - torch.sqrt(disc))
        outputs = root * in_w + in_cw
        tt = root * (1 - root)
        denom = in_delta + (in_d + in_d1 - 2 * in_delta) * tt
        num = in_delta.pow(2) * (in_d1 * root.pow(2) + 2 * in_delta * tt
                                 + in_d * (1 - root).pow(2))
        return outputs, -(torch.log(num) - 2 * torch.log(denom))
    theta = (inputs - in_cw) / in_w
    tt = theta * (1 - theta)
    num = in_h * (in_delta * theta.pow(2) + in_d * tt)
    denom = in_delta + (in_d + in_d1 - 2 * in_delta) * tt
    outputs = in_ch + num / denom
    dnum = in_delta.pow(2) * (in_d1 * theta.pow(2) + 2 * in_delta * tt
                              + in_d * (1 - theta).pow(2))
    return outputs, torch.log(dnum) - 2 * torch.log(denom)


def spline(inputs, uw, uh, ud, inverse, tail_bound, min_d=1e-3):
    """transforms.unconstrained_rational_quadratic_spline, linear tails."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    ud = F.pad(ud, (1, 1))
    constant = float(np.log(np.exp(1 - min_d) - 1))
    ud[..., 0] = constant
    ud[..., -1] = constant
    outputs = inputs.clone()
    logabsdet = torch.zeros_like(inputs)
    if bool(inside.any()):
        outputs[inside], logabsdet[inside] = rational_quadratic_spline(
            inputs[inside], uw[inside, :], uh[inside, :], ud[inside, :],
            inverse, -tail_bound, tail_bound, -tail_bound, tail_bound,
            min_d=min_d)
    return outputs, logabsdet


def conv_flow_reverse(sd, name, v, x, x_mask, g):
    nb, D = v["dp_num_bins"], v["dp_filter_channels"]
    x0, x1 = x[:, :1], x[:, 1:]
    h = _conv(sd, f"{name}.pre", x0)
    h = dds_conv(sd, f"{name}.convs", h, x_mask, v["dp_n_layers"],
                 v["dp_kernel_size"], g=g)
    h = _conv(sd, f"{name}.proj", h) * x_mask
    b, c, t = x0.shape
    h = h.reshape(b, c, -1, t).permute(0, 1, 3, 2)
    x1, _ = spline(x1, h[..., :nb] / math.sqrt(D),
                   h[..., nb: 2 * nb] / math.sqrt(D), h[..., 2 * nb:],
                   inverse=True, tail_bound=v["dp_tail_bound"])
    return torch.cat([x0, x1], 1) * x_mask


def duration_predictor(sd, v, x, x_mask, noise):
    """StochasticDurationPredictor(reverse=True): x [B, H, T], noise
    [B, 2, T] already scaled -> logw [B, 1, T]."""
    h = _conv(sd, "dp.pre", x)
    h = dds_conv(sd, "dp.convs", h, x_mask, v["dp_n_layers"],
                 v["dp_kernel_size"])
    h = _conv(sd, "dp.proj", h) * x_mask
    # reversed(flows)[:-2] + [EA]: Flip, ConvFlow_n, ..., Flip, ConvFlow_2,
    # Flip, ElementwiseAffine
    z = noise
    for j in range(v["dp_n_flows"], 1, -1):
        z = torch.flip(z, [1])
        z = conv_flow_reverse(sd, f"dp.flows.{2 * j - 1}", v, z, x_mask, h)
    z = torch.flip(z, [1])
    z = ((z - sd["dp.flows.0.m"]) * torch.exp(-sd["dp.flows.0.logs"])
         * x_mask)
    return z[:, :1]


# ---------------------------------------------------------------------------
# expansion, flows, generator
# ---------------------------------------------------------------------------


def sequence_mask(length, max_length):
    x = torch.arange(max_length, dtype=length.dtype, device=length.device)
    return x.unsqueeze(0) < length.unsqueeze(1)


def generate_path(duration, mask):
    """commons.generate_path: duration [b, 1, t_x], mask [b, 1, t_y, t_x]."""
    b, _, t_y, t_x = mask.shape
    cum = torch.cumsum(duration, -1).view(b * t_x)
    path = sequence_mask(cum, t_y).to(mask.dtype).view(b, t_x, t_y)
    path = path - F.pad(path, (0, 0, 1, 0, 0, 0))[:, :-1]
    return path.unsqueeze(1).transpose(2, 3) * mask


def wn(sd, name, x, x_mask, n_layers, kernel_size, dilation_rate):
    H = x.shape[1]
    output = torch.zeros_like(x)
    for i in range(n_layers):
        d = dilation_rate ** i
        x_in = F.conv1d(x, fold(sd, f"{name}.in_layers.{i}"),
                        sd[f"{name}.in_layers.{i}.bias"], dilation=d,
                        padding=(kernel_size * d - d) // 2)
        g_l = torch.zeros_like(x_in)
        in_act = x_in + g_l
        acts = torch.tanh(in_act[:, :H]) * torch.sigmoid(in_act[:, H:])
        rs = F.conv1d(acts, fold(sd, f"{name}.res_skip_layers.{i}"),
                      sd[f"{name}.res_skip_layers.{i}.bias"])
        if i < n_layers - 1:
            x = (x + rs[:, :H]) * x_mask
            output = output + rs[:, H:]
        else:
            output = output + rs
    return output * x_mask


def flow_reverse(sd, v, z, y_mask):
    """ResidualCouplingBlock(reverse=True), mean-only couplings."""
    half = v["inter_channels"] // 2
    for j in range(v["flow_n_flows"] - 1, -1, -1):
        z = torch.flip(z, [1])
        f = f"flow.flows.{2 * j}"
        x0, x1 = z[:, :half], z[:, half:]
        h = _conv(sd, f"{f}.pre", x0) * y_mask
        h = wn(sd, f"{f}.enc", h, y_mask, v["flow_n_layers"],
               v["flow_kernel_size"], v["flow_dilation_rate"])
        m = _conv(sd, f"{f}.post", h) * y_mask
        x1 = (x1 - m) * torch.exp(-torch.zeros_like(m)) * y_mask
        z = torch.cat([x0, x1], 1)
    return z


def resblock1(sd, name, x, kernel_size, dilations):
    for j, d in enumerate(dilations):
        xt = F.leaky_relu(x, LRELU_SLOPE)
        xt = F.conv1d(xt, fold(sd, f"{name}.convs1.{j}"),
                      sd[f"{name}.convs1.{j}.bias"], dilation=d,
                      padding=(kernel_size * d - d) // 2)
        xt = F.leaky_relu(xt, LRELU_SLOPE)
        xt = F.conv1d(xt, fold(sd, f"{name}.convs2.{j}"),
                      sd[f"{name}.convs2.{j}.bias"],
                      padding=(kernel_size - 1) // 2)
        x = xt + x
    return x


def generator(sd, v, x):
    """models.Generator: z [B, C, T] -> audio [B, 1, T * hop]."""
    x = _conv(sd, "dec.conv_pre", x, padding=3)
    nk = len(v["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(v["upsample_rates"],
                                   v["upsample_kernel_sizes"])):
        x = F.leaky_relu(x, LRELU_SLOPE)
        x = F.conv_transpose1d(x, fold(sd, f"dec.ups.{i}"),
                               sd[f"dec.ups.{i}.bias"], stride=u,
                               padding=(k - u) // 2)
        xs = None
        for j, (rk, dils) in enumerate(zip(v["resblock_kernel_sizes"],
                                           v["resblock_dilation_sizes"])):
            r = resblock1(sd, f"dec.resblocks.{i * nk + j}", x, rk, dils)
            xs = r if xs is None else xs + r
        x = xs / nk
    x = F.leaky_relu(x)
    x = F.conv1d(x, sd["dec.conv_post.weight"], padding=3)
    return torch.tanh(x)


@torch.no_grad()
def infer(sd: dict, v: dict, ids: list, noise_w: torch.Tensor,
          noise_z: torch.Tensor, noise_scale: float = 0.667,
          noise_scale_w: float = 0.8, length_scale: float = 1.0,
          w_ceil: torch.Tensor | None = None, T_y: int | None = None,
          audio: bool = True) -> dict:
    """One utterance: its symbol ids (blanks already interspersed), the
    duration noise [2, >= T_text] and the latent noise [C, >= T_y]; the
    program's integer durations [T_text] and padded frame count if given
    -> {"logw" [T_text], "w_ceil", "y_len", "z" [C, T_y], "audio"
    [T_y * hop]} float32."""
    exact()
    dev = sd["enc_p.emb.weight"].device
    ids_t = torch.tensor([ids], dtype=torch.long, device=dev)
    T_x = ids_t.shape[1]
    x, m_p, logs_p, x_mask = text_encoder(sd, v, ids_t)
    logw = duration_predictor(sd, v, x, x_mask,
                              noise_w[None, :, :T_x].to(dev) * noise_scale_w)
    if w_ceil is None:
        w_ceil = torch.ceil(torch.exp(logw) * x_mask * length_scale)
    else:
        w_ceil = w_ceil.to(dev, torch.float32).view(1, 1, T_x)
    y_len = torch.clamp_min(torch.sum(w_ceil, [1, 2]), 1).long()
    if T_y is None:
        T_y = int(y_len.max())
    y_mask = sequence_mask(y_len, T_y).unsqueeze(1).to(x_mask.dtype)
    attn_mask = x_mask.unsqueeze(2) * y_mask.unsqueeze(-1)
    attn = generate_path(w_ceil, attn_mask).squeeze(1)
    m_p = torch.matmul(attn, m_p.transpose(1, 2)).transpose(1, 2)
    logs_p = torch.matmul(attn, logs_p.transpose(1, 2)).transpose(1, 2)
    z_p = (m_p + noise_z[None, :, :T_y].to(dev) * torch.exp(logs_p)
           * noise_scale)
    z = flow_reverse(sd, v, z_p, y_mask) * y_mask
    out = {"logw": logw[0, 0], "w_ceil": w_ceil[0, 0], "y_len": int(y_len),
           "z": z[0]}
    if audio:
        out["audio"] = generator(sd, v, z)[0, 0]
    return out
