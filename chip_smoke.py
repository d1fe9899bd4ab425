#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which passes or raises (the script then exits non-zero):

1. require CUDA; print the card's name and power limit; turn TF32 off;
2. build the hand-written WN-layer kernels from ``csrc/`` (bf16 and int8
   libraries, one ``nvcc`` each, started together) and print the times;
3. compare each of the six kernels with its plain PyTorch version on the
   card at the reference width (C=512, M=640) over batch sizes, dilations,
   valid lengths and flow widths; time both with CUDA events at one
   vocode's shapes and compute the card's bound for the same work;
4. bf16 main path: synthesize a small batch of Korean texts end to end at
   full reference width (seeded random weights) through the fused vocoder
   and the denoiser, write the WAVs, check the audio, the launch counts
   per vocode and the kernel path against the plain path; print the decode
   and vocoder rates;
5. int8 main path: the same through ``Synthesizer(int8_vocoder=True)``;
   the int8 wrappers' launch counts (and none of the bf16 ones), the
   kernel path against the int8 plain path and against the f32 vocoder;
6. long-form: one mel of three 256-frame chunks through
   ``mel_to_audio_long`` with the int8 and the bf16 fused vocoder; length,
   launch counts (the windows are one batch) and agreement with the single
   pass;
7. run the port's CLI (``python -m text2speech_tpu_torch.inference``) on
   random weights with ``--fused_vocoder`` and with ``--int8_vocoder``.

The line before the last is a JSON object with one record per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# bf16 bounds for a kernel against its plain version on the same bf16
# inputs.  Both accumulate in f32 but in another order, so a gated
# activation or an output can round to the neighbouring bf16 value: one
# bf16 step is 2^-8 of the value's magnitude.  The bound allows four steps
# at the output's peak; the relative L2 bound says that such flips are
# rare.  FINAL emits f32 but reads bf16 activations, so the same holds.
KERNEL_MAX_ABS_STEPS = 4 * 2.0 ** -8
KERNEL_REL_L2 = 5e-3
# int8 bounds, the JAX package's own for its kernels against an emulation
# (tests/test_int8_vocoder.py:127-137, 256-258).  The integer products are
# exact on both sides; the f32 operations around them run in another order
# (and with the card's tanhf / expf), which can move a value across a
# round-half-even knife edge: payloads within 1 count with a mean absolute
# difference under 0.01, row scales to 1e-3 relative, the bf16 skip sum to
# 0.09, the final layer's f32 output to 0.02.
INT8_MEAN_COUNTS = 0.01
INT8_SCALE_RTOL = 1e-3
INT8_SKIP_ATOL = 0.09
INT8_FINAL_ATOL = 0.02

PALLAS = "text2speech_tpu/ops/pallas/"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "wn_layer_first": ("wn_block.cu", PALLAS + "wn_block.py:459"),
    "wn_layer": ("wn_block.cu", PALLAS + "wn_block.py:398"),
    "wn_layer_final": ("wn_block.cu", PALLAS + "wn_block.py:528"),
    "wn_layer_first_int8": ("wn_block_int8.cu", PALLAS + "wn_block_int8.py:338"),
    "wn_layer_int8": ("wn_block_int8.cu", PALLAS + "wn_block_int8.py:268"),
    "wn_layer_final_int8": ("wn_block_int8.cu", PALLAS + "wn_block_int8.py:510"),
}
CSRC = "text2speech_tpu_torch/csrc/"

# NVIDIA's data sheet for the H100 SXM: dense tensor-core rates and HBM3
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12


def gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(ops: dict, tensors) -> tuple:
    """The least time the card could take: operations over the peak rate of
    their type against bytes (every input read once, every output written
    once) over the memory rate.  Returns (ms, which binds)."""
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items())
    t_bytes = sum(t.numel() * t.element_size() for t in tensors) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite kernel output")
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
    bound = KERNEL_MAX_ABS_STEPS * max(peak, 1.0)
    print(f"  {name}: max_abs_err={err:.6g} (bound {bound:.4g}) "
          f"rel_l2={rel:.3g} (bound {KERNEL_REL_L2}) peak={peak:.4g}")
    if err > bound or rel > KERNEL_REL_L2:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return err


def compare_int8(name: str, got, want, nv: int) -> float:
    """(payload, row scale, skip) of an int8 layer against its plain
    version; returns the max abs error over the dequantized hidden state
    and the valid rows of the skip sum."""
    (gq, gs, gk), (pq, ps, pk) = got, want
    counts = (gq.int() - pq.int()).abs()
    scale_rel = ((gs - ps).abs() / ps).max().item()
    skip_err = (gk[:, :nv].float() - pk[:, :nv].float()).abs().max().item()
    hid_err = (gq.float() * gs - pq.float() * ps).abs().max().item()
    print(f"  {name}: payload max {counts.max().item()} count, mean "
          f"{counts.float().mean().item():.3g} (bound 1, {INT8_MEAN_COUNTS}); "
          f"scale rel {scale_rel:.3g} (bound {INT8_SCALE_RTOL}); skip "
          f"{skip_err:.4g} (bound {INT8_SKIP_ATOL}); hidden {hid_err:.4g}")
    if not (torch.isfinite(gs).all() and torch.isfinite(gk.float()).all()):
        raise RuntimeError(f"{name}: non-finite kernel output")
    if (counts.max().item() > 1
            or counts.float().mean().item() >= INT8_MEAN_COUNTS
            or scale_rel > INT8_SCALE_RTOL or skip_err > INT8_SKIP_ATOL):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return max(hid_err, skip_err)


def layer_inputs(B, T, n_valid, C, M, seed, dev, n_half=None, E=None):
    """Seeded bf16 activations and weights at one layer's shapes; rows past
    n_valid of the hidden input are zero, as the serving path leaves them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    mask = (torch.arange(T) < n_valid)[None, :, None].to(dev)
    k = {
        "spect": rn(B, T, M),
        "w_in": rn(3, C, 2 * C, scale=(3 * C) ** -0.5),
        "b_in": rn(2 * C, scale=0.1, dtype=torch.float32),
        "w_cond": rn(M, 2 * C, scale=M ** -0.5),
        "b_cond": rn(2 * C, scale=0.1, dtype=torch.float32),
        "skip_acc": rn(B, T, C, scale=0.5) * mask,
    }
    if n_half is not None:
        k["x0"] = rn(B, T, n_half) * mask
        k["start_k"] = rn(n_half, C, scale=n_half ** -0.5)
        k["start_b"] = rn(C, scale=0.1, dtype=torch.float32)
        k["w_rs"] = rn(C, 2 * C, scale=C ** -0.5)
        k["b_rs"] = rn(2 * C, scale=0.1, dtype=torch.float32)
    else:
        k["x"] = rn(B, T, C) * mask
        rs_out = C if E is not None else 2 * C
        k["w_rs"] = rn(C, rs_out, scale=C ** -0.5)
        k["b_rs"] = rn(rs_out, scale=0.1, dtype=torch.float32)
    if E is not None:
        k["w_end"] = rn(C, E, scale=C ** -0.5)
        k["b_end"] = rn(E, scale=0.1, dtype=torch.float32)
    return k


def layer_args(k: dict, d: int) -> dict:
    """One layer's inputs -> the argument tuples of the bf16 and the int8
    wrapper of its role (the same tuples go to the plain versions), with
    everything that is prepared once per checkpoint (folds, weight
    quantization) and once per vocode (conditioning quantization) done
    here, outside any timed loop.  Keys: role name -> args, without the
    trailing ``n_valid``.  The standard layer's skip sum comes last before
    the dilation and is cloned by the caller (updated in place)."""
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_int8 as wq

    def quant(w):
        q, s = wq.quantize_cols(w)
        return wq.to_output_major(q), s

    qspect, sspect = wq.quantize_rows(k["spect"])
    cond = (k["w_cond"], k["b_cond"])
    qcond = (*quant(k["w_cond"]), k["b_cond"])
    out = {}
    if "x0" in k:
        fold = wb.fold_first_taps(k["start_k"], k["start_b"], k["w_in"],
                                  k["b_in"])
        head = (k["start_k"], k["start_b"], *fold)
        out["wn_layer_first"] = (k["x0"], k["spect"], *head, *cond,
                                 k["w_rs"], k["b_rs"], d)
        out["wn_layer_first_int8"] = (k["x0"], qspect, sspect, *head, *qcond,
                                      *quant(k["w_rs"]), k["b_rs"], d)
        return out
    qx, sx = wq.quantize_rows(k["x"])
    taps = (k["w_in"], k["b_in"])
    qtaps = (*quant(k["w_in"]), k["b_in"])
    if "w_end" in k:
        w_eff, b_eff = wb.fold_end(k["w_rs"], k["b_rs"], k["w_end"],
                                   k["b_end"])
        tail = (w_eff, k["skip_acc"], k["w_end"], b_eff, d)
        out["wn_layer_final"] = (k["x"], k["spect"], *taps, *cond, *tail)
        out["wn_layer_final_int8"] = (qx, sx, qspect, sspect, *qtaps, *qcond,
                                      *tail)
        return out
    out["wn_layer"] = (k["x"], k["spect"], *taps, *cond, k["w_rs"],
                       k["b_rs"], k["skip_acc"], d)
    if k["w_rs"].shape[1] == 2 * k["x"].shape[2]:   # int8 always has both
        out["wn_layer_int8"] = (qx, sx, qspect, sspect, *qtaps, *qcond,
                                *quant(k["w_rs"]), k["b_rs"], k["skip_acc"],
                                d)
    return out


def call_std(fn, args, nv):
    """A standard layer on a fresh copy of the skip sum (args[-2])."""
    return fn(*args[:-2], args[-2].clone(), args[-1], n_valid=nv)


def work(name: str, B, T, C, M, n_half=4, E=8) -> dict:
    """Operations of one call by type, from its shapes."""
    bt = 2 * B * T
    taps, cond, rs = bt * 3 * C * 2 * C, bt * M * 2 * C, bt * C * 2 * C
    small_first = bt * 3 * n_half * 2 * C + bt * n_half * C
    small_final = 2 * bt * C * E
    return {
        "wn_layer_first": {"bf16": small_first + cond + rs},
        "wn_layer": {"bf16": taps + cond + rs},
        "wn_layer_final": {"bf16": taps + cond + small_final},
        "wn_layer_first_int8": {"int8": cond + rs, "bf16": small_first},
        "wn_layer_int8": {"int8": taps + cond + rs},
        "wn_layer_final_int8": {"int8": taps + cond, "bf16": small_final},
    }[name]


def check_kernels(C: int = 512, M: int = 640) -> dict:
    """Phase 3: every kernel against its plain version at reference width,
    then kernel and plain times and the card's bound at one main-path
    shape.  Returns {name: {"max_abs_err", "ms", "plain_ms", "bound_ms",
    "bound_by"}}."""
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_int8 as wq

    fns = {n: (getattr(m, n), getattr(m, n + "_plain"))
           for m in (wb, wq) for n in KERNELS if hasattr(m, n)}
    dev = torch.device("cuda")
    rec = {n: {"max_abs_err": 0.0} for n in KERNELS}

    def note(name, err):
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)

    def check_pair(name, args, nv, tag):
        kern, plain = fns[name]
        std = name in ("wn_layer", "wn_layer_int8")
        got = call_std(kern, args, nv) if std else kern(*args, n_valid=nv)
        want = call_std(plain, args, nv) if std else plain(*args, n_valid=nv)
        tag = f"{name} {tag}"
        if name.endswith("final"):
            note(name, compare(tag, got, want))
        elif name.endswith("final_int8"):
            err = (got - want).abs().max().item()
            print(f"  {tag}: max_abs_err={err:.6g} (bound {INT8_FINAL_ATOL})")
            if not torch.isfinite(got).all() or err > INT8_FINAL_ATOL:
                raise RuntimeError(f"{tag}: kernel disagrees with its plain "
                                   f"version")
            note(name, err)
        elif name.endswith("int8"):
            note(name, compare_int8(tag, got, want, nv))
        else:
            note(name, compare(tag + " x", got[0], want[0]))
            note(name, compare(tag + " skip", got[1][:, :nv],
                               want[1][:, :nv]))

    cases = [(1, 1000, 937), (2, 1000, 1000), (2, 777, 700)]
    seed = 0
    for B, T, nv in cases:
        shape = f"B={B} T={T} n_valid={nv}"
        for n_half in (2, 3, 4):
            seed += 1
            k = layer_inputs(B, T, nv, C, M, seed, dev, n_half=n_half)
            for name, args in layer_args(k, 1).items():
                check_pair(name, args, nv, f"{shape} n_half={n_half}")
        for d in (1, 64, 128):
            for rs_full in (True, False):
                seed += 1
                k = layer_inputs(B, T, nv, C, M, seed, dev)
                if not rs_full:
                    k["w_rs"] = k["w_rs"][:, :C].contiguous()
                    k["b_rs"] = k["b_rs"][:C].contiguous()
                for name, args in layer_args(k, d).items():
                    check_pair(name, args, nv, f"{shape} d={d} "
                               f"rs_out={k['w_rs'].shape[1]}")
            for E in (4, 6, 8):
                seed += 1
                k = layer_inputs(B, T, nv, C, M, seed, dev, E=E)
                for name, args in layer_args(k, d).items():
                    check_pair(name, args, nv, f"{shape} d={d} E={E}")

    # times at one vocode's shapes: B=1, 200 mel frames = 6400 groups
    B, T = 1, 6400
    timed = {}
    timed.update(layer_args(
        layer_inputs(B, T, T, C, M, 99, dev, n_half=4), 1))
    timed.update(layer_args(layer_inputs(B, T, T, C, M, 98, dev), 64))
    timed.update(layer_args(layer_inputs(B, T, T, C, M, 97, dev, E=8), 128))
    for name in KERNELS:
        kern, plain = fns[name]
        args = timed[name]
        outs = kern(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        tensors = [t for t in (*args, *outs) if torch.is_tensor(t)]
        r = rec[name]
        r["bound_ms"], r["bound_by"] = bound_ms(work(name, B, T, C, M),
                                                tensors)
        r["ms"] = time_ms(lambda: kern(*args))
        r["plain_ms"] = time_ms(lambda: plain(*args))
        print(f"  {name} B={B} T={T}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (by "
              f"{r['bound_by']})")

    # yardsticks of the tensor-core rates: the standard layer's largest
    # product as one library call each (the port calls neither)
    a8 = torch.randint(-127, 128, (T, C), dtype=torch.int8, device=dev)
    b8 = torch.randint(-127, 128, (C, 2 * C), dtype=torch.int8, device=dev)
    a16 = torch.randn(T, 3 * C + M, device=dev, dtype=torch.bfloat16)
    b16 = torch.randn(3 * C + M, 2 * C, device=dev, dtype=torch.bfloat16)
    print(f"[yardstick] torch._int_mm [{T},{C}]x[{C},{2 * C}] s8: "
          f"{time_ms(lambda: torch._int_mm(a8, b8)):.4f} ms; torch.matmul "
          f"[{T},{3 * C + M}]x[{3 * C + M},{2 * C}] bf16: "
          f"{time_ms(lambda: a16 @ b16):.4f} ms")
    return rec


TEXTS = [
    "이 것은 제작되고 있는 중입니다.",
    "안녕하세요. 만나서 반갑습니다.",
    "오늘 날씨가 참 좋네요.",
]
MAX_STEPS = 200
SIGMA = 0.666
DENOISER_STRENGTH = 0.1
# Kernel path against plain path over one whole vocode at full width.  The
# audio is held in bf16 between the 12 flows, and the kernel and the plain
# version sum in another order, so single bf16 steps (2^-8 of a value) flip
# in the hidden state and the audio and are carried through later flows.
# Bounds: 16 bf16 steps at the audio's peak, 2e-2 relative L2.
E2E_MAX_ABS_STEPS = 16 * 2.0 ** -8
E2E_REL_L2 = 2e-2
# The int8 path adds payload flips of one count (1/127 of a row's peak,
# twice a bf16 step) in the gate and the hidden state of 96 layers, each
# carried through the later layers and flows: 32 bf16 steps at the peak,
# 5e-2 relative L2.
E2E_INT8_MAX_ABS_STEPS = 32 * 2.0 ** -8
E2E_INT8_REL_L2 = 5e-2


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def all_counts() -> dict:
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_int8 as wq

    return {**wb.launch_counts(), **wq.launch_counts()}


def reset_counts() -> None:
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_int8 as wq

    wb.reset_launch_counts()
    wq.reset_launch_counts()


def want_counts(wg_cfg, int8: bool) -> dict:
    """Launches of one vocode: 1 / L - 2 / 1 per flow of the path's own
    wrappers, none of the other family's."""
    per = (wg_cfg.n_flows, wg_cfg.n_flows * (wg_cfg.wn_n_layers - 2),
           wg_cfg.n_flows)
    names = list(KERNELS)
    mine, other = (names[3:], names[:3]) if int8 else (names[:3], names[3:])
    return {**dict(zip(mine, per)), **dict.fromkeys(other, 0)}


def main_path(tag: str, int8: bool, rel32_bf16: float | None = None) -> dict:
    """Phases 4 and 5: text -> mel -> fused vocoder (bf16 or int8) ->
    denoiser -> WAV at the reference config on seeded random weights.
    Returns the launch counts of the main-path run, the synthesizer, the
    decoded mel and the path's relative L2 against the f32 vocoder."""
    from scipy.io import wavfile

    from text2speech_tpu_torch.config import HParams, WaveGlowConfig
    from text2speech_tpu_torch.infer import random_synthesizer

    hp, wg_cfg = HParams(), WaveGlowConfig()
    synth, t_build = sync_time(lambda: random_synthesizer(
        hp, wg_cfg, seed=0, device="cuda", use_denoiser=True,
        use_fused_vocoder=True, int8_vocoder=int8))
    print(f"[{tag}] random_synthesizer (C={wg_cfg.wn_n_channels}, "
          f"L={wg_cfg.wn_n_layers}, flows={wg_cfg.n_flows}, "
          f"decoder_rnn={hp.decoder_rnn_dim}, int8_vocoder={int8}) built in "
          f"{t_build:.2f} s")
    hop = wg_cfg.upsample_stride
    with tempfile.TemporaryDirectory() as d:
        paths = [f"{d}/smoke_{i}.wav" for i in range(len(TEXTS))]
        reset_counts()
        wavs, t_main = sync_time(lambda: synth.synthesize_to_files(
            TEXTS, paths, seed=0, sigma=SIGMA, max_steps=MAX_STEPS,
            denoiser_strength=DENOISER_STRENGTH))
        launches = all_counts()
        print(f"[{tag}] main path (batch {len(TEXTS)}, {MAX_STEPS} decoder "
              f"steps) in {t_main:.3f} s; launches {launches}")
        if launches != want_counts(wg_cfg, int8):
            raise RuntimeError(f"launch counts {launches}, want "
                               f"{want_counts(wg_cfg, int8)} for one vocode")
        mel, lens = synth.text_to_mel(TEXTS, seed=0, max_steps=MAX_STEPS)
        lens = lens.cpu().numpy()
        for path, wav, n in zip(paths, wavs, lens):
            sr, data = wavfile.read(path)
            if not (np.isfinite(wav).all() and wav.std() > 1e-4):
                raise RuntimeError(f"{path}: audio not finite or silent")
            if wav.shape != (int(n) * hop,) or data.shape != wav.shape:
                raise RuntimeError(f"{path}: {wav.shape[0]} samples, want "
                                   f"{int(n) * hop}")
            if data.dtype != np.int16 or sr != wg_cfg.sampling_rate:
                raise RuntimeError(f"{path}: not PCM16 at {sr} Hz")
        print(f"[{tag}] wrote {len(paths)} WAVs, lengths {lens.tolist()} "
              f"frames x {hop}, peak {max(np.abs(w).max() for w in wavs):.4g}")

    # steady-state rates (warm)
    _, t_dec = sync_time(lambda: synth.text_to_mel(TEXTS, seed=1,
                                                   max_steps=MAX_STEPS))
    T = int(lens.max())
    mel = mel[:, :, :T].contiguous()
    audio, t_voc = sync_time(lambda: synth.mel_to_audio(
        mel, SIGMA, seed=0, denoiser_strength=DENOISER_STRENGTH))
    print(f"[{tag}] decode: {MAX_STEPS / t_dec:.2f} steps/s "
          f"({len(TEXTS) * MAX_STEPS / t_dec:.2f} frames/s at batch "
          f"{len(TEXTS)}); vocode+denoise: {audio.numel() / t_voc:.6g} "
          f"output samples/s ({t_voc * 1e3:.3f} ms for {audio.shape[1]} "
          f"samples x {audio.shape[0]})")

    # kernel path vs plain path: same weights, mel and noise, on the card
    fw = synth.fused
    gen = torch.Generator(device="cuda").manual_seed(123)
    Tg = T * hop // wg_cfg.n_group
    noise = tuple(torch.randn(s, generator=gen, device="cuda")
                  for s in fw.noise_shapes(len(TEXTS), Tg))
    with torch.inference_mode():
        got = fw.infer(mel, SIGMA, noise=noise)
        plain = fw.infer(mel, SIGMA, noise=noise, plain=True)
        exact = synth.waveglow.infer(mel, SIGMA, noise=noise)
    steps, rel_bound = ((E2E_INT8_MAX_ABS_STEPS, E2E_INT8_REL_L2) if int8
                        else (E2E_MAX_ABS_STEPS, E2E_REL_L2))
    err = (got - plain).abs().max().item()
    peak = plain.abs().max().item()
    rel = ((got - plain).norm() / plain.norm()).item()
    rel32 = ((got - exact).norm() / exact.norm()).item()
    print(f"[{tag}] kernels vs plain layers: max_abs_err={err:.6g} (bound "
          f"{steps * peak:.4g}) rel_l2={rel:.4g} (bound {rel_bound}); vs "
          f"plain f32 WaveGlow.infer: rel_l2={rel32:.4g}")
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{tag}: non-finite audio")
    if err > steps * peak or rel > rel_bound:
        raise RuntimeError(f"{tag}: kernel path disagrees with the plain "
                           f"path")
    if int8:
        # the JAX package's bound for its int8 path against f32
        # (tests/test_int8_vocoder.py:301-310)
        bound32 = max(5 * rel32_bf16, 0.05)
        print(f"[{tag}] int8 vs f32 bound: {rel32:.4g} < max(5 x "
              f"{rel32_bf16:.4g}, 0.05) = {bound32:.4g}")
        if rel32 >= bound32:
            raise RuntimeError("int8 vocoder: too far from the f32 vocoder")
    return {"launches": launches, "synth": synth, "mel": mel, "rel32": rel32,
            "vocode_ms": t_voc * 1e3}


def long_form(synth, mel: torch.Tensor, tag: str, int8: bool) -> None:
    """Phase 6: one utterance of 3 chunks of 256 frames (a decoded mel,
    tiled) through ``mel_to_audio_long``.  Windows are position-clamped and
    of one width (256 + 2 * 99 frames), so the three are ONE batch: one
    vocode's launch counts.  Against the single pass on the same noise the
    kept interiors differ only where the library matmuls around the kernels
    (upsample, 1x1 convs) round differently at another batch shape, carried
    through the flows: the bounds of the path's own end-to-end check."""
    from text2speech_tpu_torch.models.chunked import (draw_noise,
                                                      receptive_overlap_frames)

    cfg = synth.wg_cfg
    chunk, n_chunks = 256, 3
    frames = chunk * n_chunks - 56
    reps = -(-frames // mel.shape[2])
    long_mel = mel[:1].repeat(1, 1, reps)[:, :, :frames].contiguous()
    width = chunk + 2 * receptive_overlap_frames(cfg)
    n_windows = -(-frames // chunk)
    if frames <= width or n_windows < 3:
        raise RuntimeError(f"{frames} frames are no 3 windows of {width}")
    gpf = cfg.upsample_stride // cfg.n_group
    noise = draw_noise(cfg, torch.Generator(device="cuda").manual_seed(7), 1,
                       frames * gpf)
    def chunked():
        return synth.mel_to_audio_long(long_mel, SIGMA, chunk_frames=chunk,
                                       noise=noise)

    def one_pass():
        return synth.mel_to_audio(long_mel, SIGMA, noise=noise)

    reset_counts()
    audio, t_cold = sync_time(chunked)     # first call at these shapes
    launches = all_counts()
    single, _ = sync_time(one_pass)
    _, t_long = sync_time(chunked)         # warm
    _, t_single = sync_time(one_pass)
    steps, rel_bound = ((E2E_INT8_MAX_ABS_STEPS, E2E_INT8_REL_L2) if int8
                        else (E2E_MAX_ABS_STEPS, E2E_REL_L2))
    err = (audio - single).abs().max().item()
    peak = single.abs().max().item()
    rel = ((audio - single).norm() / single.norm()).item()
    print(f"[{tag}] long-form {frames} frames = {n_windows} windows of "
          f"{width}: {audio.numel() / t_long:.6g} samples/s "
          f"({t_long * 1e3:.3f} ms warm, {t_cold * 1e3:.3f} ms the first "
          f"call; single pass {t_single * 1e3:.3f} ms warm); "
          f"launches {launches}; vs single pass max_abs_err={err:.6g} "
          f"(bound {steps * peak:.4g}) rel_l2={rel:.4g} (bound {rel_bound})")
    if audio.shape != (1, frames * cfg.upsample_stride):
        raise RuntimeError(f"{tag}: long-form audio {tuple(audio.shape)}")
    if not torch.isfinite(audio).all():
        raise RuntimeError(f"{tag}: long-form audio not finite")
    if launches != want_counts(cfg, int8):
        raise RuntimeError(f"{tag}: long-form launch counts {launches}")
    if err > steps * peak or rel > rel_bound:
        raise RuntimeError(f"{tag}: long-form disagrees with the single pass")


def cli_run(flag: str) -> None:
    """Phase 7: the port's CLI writes a WAV on the card."""
    with tempfile.TemporaryDirectory() as d:
        out = f"{d}/cli.wav"
        cmd = [sys.executable, "-m", "text2speech_tpu_torch.inference",
               "--random_init", "0", flag, "-d", "0.1",
               "--max_steps", "100", "--out", out]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        print(f"[cli] {' '.join(cmd[1:])} -> rc {r.returncode}: "
              f"{r.stdout.strip()}")
        if r.returncode != 0:
            raise RuntimeError(f"CLI failed:\n{r.stderr}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    info = gpu_info()
    print(info)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_int8 as wq

    t0 = time.perf_counter()
    libs = (wb.LIB, wq.LIB)
    with ThreadPoolExecutor(len(libs)) as pool:   # one nvcc per source
        for f in [pool.submit(lib.build) for lib in libs]:
            f.result()
    for lib in libs:
        lib.get()
        print(f"[build] {lib.source.name}: nvcc {lib.build_seconds:.2f} s")
        print(lib.build_log.strip())
    print(f"[build] both libraries built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")

    print("[kernels] kernel vs plain at C=512, M=640")
    rec = check_kernels()
    bf16 = main_path("bf16", int8=False)
    int8 = main_path("int8", int8=True, rel32_bf16=bf16["rel32"])
    print(f"[e2e] vocode+denoise, batch {len(TEXTS)} x {MAX_STEPS} frames: "
          f"bf16 {bf16['vocode_ms']:.3f} ms, int8 {int8['vocode_ms']:.3f} ms")
    long_form(int8["synth"], int8["mel"], "int8", int8=True)
    long_form(bf16["synth"], bf16["mel"], "bf16", int8=False)
    cli_run("--fused_vocoder")
    cli_run("--int8_vocoder")

    launches = {**{n: bf16["launches"][n] for n in list(KERNELS)[:3]},
                **{n: int8["launches"][n] for n in list(KERNELS)[3:]}}
    kernels = [{
        "name": n, "route": "cuda", "source": CSRC + src, "replaces": repl,
        "launches": launches[n], "max_abs_err": rec[n]["max_abs_err"],
        "ms": rec[n]["ms"], "plain_ms": rec[n]["plain_ms"],
        "bound_ms": rec[n]["bound_ms"], "bound_by": rec[n]["bound_by"],
        "library_ms": None,   # no one PyTorch call computes a fused WN layer
    } for n, (src, repl) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
