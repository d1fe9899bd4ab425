"""The VITS cell's yardstick, frozen here: the operations and bytes of
each generator convolution from its shapes, and the model FLOPs of an
utterance (``roofline.py``'s peaks and bound rule: max(operations over the
bf16 peak, bytes over the memory rate), every input read once and every
output written once).

The generator runs in bf16: activations, weights and biases are two bytes
each.  A transposed convolution of k taps at stride u is counted from its
input: every input sample meets k taps of every (input, output) channel
pair."""

from __future__ import annotations

import math

from .roofline import BF16, bound_s


def _conv(B, cin, cout, k, t_in, t_out, ops_t):
    ops = 2 * B * ops_t * cin * cout * k
    bytes_ = (B * cin * t_in + B * cout * t_out + cin * cout * k + cout) * BF16
    return ops, bytes_


def generator_convs(v: dict, B: int, T: int) -> list:
    """(operations, bytes) of every convolution of one generator pass over
    B rows of T frames, in launch order: conv_pre, per stage the
    transposed convolution and the resblocks' 2 x len(dilations) convs
    each, conv_post."""
    c0, C = v["upsample_initial_channel"], v["inter_channels"]
    out = [_conv(B, C, c0, 7, T, T, T)]
    t = T
    for i, (u, k) in enumerate(zip(v["upsample_rates"],
                                   v["upsample_kernel_sizes"])):
        cin, cout = c0 >> i, c0 >> (i + 1)
        out.append(_conv(B, cin, cout, k, t, t * u, t))
        t *= u
        for rk, dils in zip(v["resblock_kernel_sizes"],
                            v["resblock_dilation_sizes"]):
            out += [_conv(B, cout, cout, rk, t, t, t)] * (2 * len(dils))
    out.append(_conv(B, c0 >> len(v["upsample_rates"]), 1, 7, t, t, t))
    return out


def generator_bound_s(v: dict, B: int, T: int) -> float:
    """Sum of the convolutions' bounds over one generator pass."""
    return sum(bound_s(o, b) for o, b in generator_convs(v, B, T))


def utterance_flops(v: dict, n_tokens: int, frames: int) -> float:
    """Model FLOPs of one utterance, unpadded: the text encoder and the
    duration predictor over ``n_tokens`` symbols (blanks included), the
    flows and the generator over ``frames`` frames."""
    H, Fc, k = v["hidden_channels"], v["filter_channels"], v["kernel_size"]
    W = 2 * v["window_size"] + 1
    layer = (3 * H * H + 2 * n_tokens * H + 2 * W * H + H * H
             + 2 * H * Fc * k)
    D, dk, nl = v["dp_filter_channels"], v["dp_kernel_size"], v["dp_n_layers"]
    dds = nl * (D * dk + D * D)
    dp = (H * D + dds + D * D
          + (v["dp_n_flows"] - 1) * (D + dds + D * (3 * v["dp_num_bins"] - 1)))
    text = 2 * n_tokens * (v["n_layers"] * layer + H * 2 * v["inter_channels"]
                           + dp)
    C, L, fk = v["inter_channels"], v["flow_n_layers"], v["flow_kernel_size"]
    coupling = (C // 2 * H + L * H * 2 * H * fk + (L - 1) * H * 2 * H
                + H * H + H * C // 2)
    flow = 2 * frames * v["flow_n_flows"] * coupling
    gen = sum(o for o, _ in generator_convs(v, 1, 1)) * frames
    return text + flow + gen


def hop(v: dict) -> int:
    return math.prod(v["upsample_rates"])
