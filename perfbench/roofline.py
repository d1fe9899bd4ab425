"""The yardstick's arithmetic, frozen here: the H100's published peaks, the
operations and bytes of each WN-layer kernel role from its shapes, and
the model FLOPs of a batch, a served frame and a training step.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
700 W power limit (a card set lower runs slower; the harness prints the
limit beside every number).  A roofline bound is max(operations / peak of
their type, bytes / memory rate), every input read once and every output
written once (``chip_smoke.py``'s ``bound_ms`` and ``work``, copied)."""

from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "fp8": 1979e12, "int8": 1979e12,
              "tf32": 495e12, "f32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
BF16, F32 = 2, 4


def wn_role_work(role: str, B: int, T: int, C: int, M: int,
                 n_half: int) -> tuple:
    """(bf16 operations, bytes) of one launch of a bf16 WN-layer kernel
    role (``first``, ``std``, ``final``) over B rows of T groups, C
    channels, M conditioning channels; ``n_half`` is the flow's coupling
    half, E = 2 n_half the end projection's width."""
    bt = 2 * B * T
    E = 2 * n_half
    taps, cond, rs = bt * 3 * C * 2 * C, bt * M * 2 * C, bt * C * 2 * C
    act = B * T * C * BF16                     # one [B, T, C] bf16 tensor
    spect = B * T * M * BF16
    cond_w = M * 2 * C * BF16 + 2 * C * F32
    if role == "first":
        ops = bt * 3 * n_half * 2 * C + bt * n_half * C + cond + rs
        bytes_ = (B * T * n_half * BF16 + spect + n_half * C * BF16 + C * F32
                  + 3 * n_half * 2 * C * BF16 + 2 * C * F32 + 2 * 2 * C * F32
                  + cond_w + C * 2 * C * BF16 + 2 * C * F32 + 2 * act)
    elif role == "std":
        ops = taps + cond + rs
        bytes_ = (act + spect + 3 * C * 2 * C * BF16 + 2 * C * F32 + cond_w
                  + C * 2 * C * BF16 + 2 * C * F32 + act + 2 * act)
    elif role == "final":
        ops = taps + cond + 2 * bt * C * E
        bytes_ = (act + spect + 3 * C * 2 * C * BF16 + 2 * C * F32 + cond_w
                  + C * E * BF16 + act + C * E * BF16 + E * F32
                  + B * T * E * F32)
    else:
        raise ValueError(f"unknown WN role {role!r}")
    return ops, bytes_


def bound_s(ops: float, bytes_: float, kind: str = "bf16") -> float:
    return max(ops / PEAK_FLOPS[kind], bytes_ / PEAK_BYTES_PER_S)


def flow_halves(wg: dict) -> list:
    out, n_rem = [], wg["n_group"]
    for k in range(wg["n_flows"]):
        if k % wg["n_early_every"] == 0 and k > 0:
            n_rem -= wg["n_early_size"]
        out.append(n_rem // 2)
    return out


def vocode_wn_bound_s(wg: dict, B: int, frames: int) -> float:
    """Sum of the bounds of one fused vocode's WN launches: per flow one
    ``first``, L - 2 ``std`` and one ``final``."""
    T = frames * wg["upsample_stride"] // wg["n_group"]
    C, L = wg["wn_n_channels"], wg["wn_n_layers"]
    M = wg["n_mel_channels"] * wg["n_group"]
    total = 0.0
    for n_half in flow_halves(wg):
        total += bound_s(*wn_role_work("first", B, T, C, M, n_half))
        total += (L - 2) * bound_s(*wn_role_work("std", B, T, C, M, n_half))
        total += bound_s(*wn_role_work("final", B, T, C, M, n_half))
    return total


def wn_flops_per_group(wg: dict, n_half: int) -> float:
    """One flow's coupling net on one sample group: the start projection,
    L dilated taps, L conditioning products, L - 1 res/skip of 2C and one
    of C, the end projection."""
    C, L, K = wg["wn_n_channels"], wg["wn_n_layers"], wg["wn_kernel_size"]
    M = wg["n_mel_channels"] * wg["n_group"]
    return 2 * (n_half * C + L * K * C * 2 * C + L * M * 2 * C
                + (L - 1) * C * 2 * C + C * C + C * 2 * n_half)


def vocoder_flops_per_frame(wg: dict) -> float:
    """The upsampler and the 12 WN nets for one mel frame (the coupling,
    the 1x1 convs and the noise are left out: under 0.1%)."""
    gpf = wg["upsample_stride"] // wg["n_group"]
    M = wg["n_mel_channels"]
    up = 2 * M * M * wg["upsample_kernel"]
    return up + gpf * sum(wn_flops_per_group(wg, h) for h in flow_halves(wg))


def decoder_flops_per_frame(hp: dict, t_in: float) -> float:
    """One decoder step of one row over ``t_in`` encoder positions: the
    prenet, both LSTMs, the location-sensitive attention, the mel and gate
    projections."""
    pre, ch = hp["prenet_dim"], hp["enc_conv_channels"]
    ar, dr, a = hp["attention_rnn_dim"], hp["decoder_rnn_dim"], hp["attention_dim"]
    nf, kl = (hp["attention_location_n_filters"],
              hp["attention_location_kernel_size"])
    macs = (hp["n_mel_channels"] * pre + pre * pre
            + (pre + ch + ar) * 4 * ar + (ar + ch + dr) * 4 * dr
            + ar * a + t_in * (2 * nf * kl + nf * a + a + ch)
            + (dr + ch) * (hp["n_mel_channels"] + 1))
    return 2 * macs


def postnet_flops_per_frame(hp: dict) -> float:
    n, emb, k = (hp["postnet_n_convolutions"], hp["postnet_embedding_dim"],
                 hp["postnet_kernel_size"])
    dims = [hp["n_mel_channels"]] + [emb] * (n - 1) + [hp["n_mel_channels"]]
    return 2 * k * sum(dims[i] * dims[i + 1] for i in range(n))


def encoder_flops_per_symbol(hp: dict) -> float:
    """Convolutions and the BiLSTM per text symbol, and the attention's
    memory projection."""
    ch, k = hp["enc_conv_channels"], hp["enc_conv_kernel_size"]
    convs = (hp["embedding_size"] * ch
             + (hp["enc_conv_num_layers"] - 1) * ch * ch) * k
    lstm = 2 * (ch + ch // 2) * 4 * (ch // 2)
    return 2 * (convs + lstm + ch * hp["attention_dim"])


def utterance_flops(hp: dict, wg: dict, n_symbols: int,
                    frames: int) -> float:
    """Model FLOPs of one utterance: text encoding, ``frames`` decoder
    steps, the postnet and the vocoder over ``frames`` frames."""
    return (encoder_flops_per_symbol(hp) * n_symbols
            + frames * (decoder_flops_per_frame(hp, n_symbols)
                        + postnet_flops_per_frame(hp)
                        + vocoder_flops_per_frame(wg)))


def train_flops_per_row(wg: dict, samples: int) -> float:
    """Three times the forward of one training row of ``samples`` samples
    (forward, and a backward of twice its FLOPs)."""
    groups = samples // wg["n_group"]
    frames = samples // wg["upsample_stride"] + 1
    M = wg["n_mel_channels"]
    up = 2 * M * M * wg["upsample_kernel"] * frames
    wn = groups * sum(wn_flops_per_group(wg, h) for h in flow_halves(wg))
    return 3 * (up + wn)
