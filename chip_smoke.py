#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which passes or raises (the script then exits non-zero):

1. require CUDA; print the card's name and power limit; turn TF32 off;
2. build the hand-written WN-layer kernels from ``csrc/`` and print the
   build time;
3. compare each kernel with its plain PyTorch version on the card at the
   reference width (C=512, M=640) over batch sizes, dilations, valid
   lengths and flow widths; time both with CUDA events;
4. synthesize a small batch of Korean texts end to end at full reference
   width (seeded random weights) through the fused vocoder and the
   denoiser, write the WAVs, check the audio, the launch counts per vocode
   and the kernel path against the plain path; print the decode and
   vocoder rates;
5. run the port's CLI (``python -m text2speech_tpu_torch.inference``) on
   random weights with the fused vocoder and the denoiser.

The line before the last is a JSON object with one record per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

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

REPLACES = {
    "wn_layer_first": "text2speech_tpu/ops/pallas/wn_block.py:459",
    "wn_layer": "text2speech_tpu/ops/pallas/wn_block.py:398",
    "wn_layer_final": "text2speech_tpu/ops/pallas/wn_block.py:528",
}
SOURCE = "text2speech_tpu_torch/csrc/wn_block.cu"


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


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> tuple:
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
    return err, rel


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


def check_kernels(C: int = 512, M: int = 640) -> dict:
    """Phase 3: every kernel against its plain version at reference width,
    then kernel and plain times at one main-path shape.  Returns
    {name: {"max_abs_err", "ms", "plain_ms"}}."""
    from text2speech_tpu_torch.ops import wn_block as wb

    dev = torch.device("cuda")
    rec = {n: {"max_abs_err": 0.0} for n in REPLACES}

    def note(name, err):
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)

    cases = [(1, 1000, 937), (2, 1000, 1000), (2, 777, 700)]
    seed = 0
    for B, T, nv in cases:
        for n_half in (2, 3, 4):
            seed += 1
            k = layer_inputs(B, T, nv, C, M, seed, dev, n_half=n_half)
            args = (k["x0"], k["spect"], k["start_k"], k["start_b"],
                    k["w_in"], k["b_in"], k["w_cond"], k["b_cond"],
                    k["w_rs"], k["b_rs"], 1)
            gx, gs = wb.wn_layer_first(*args, n_valid=nv)
            px, ps = wb.wn_layer_first_plain(*args, n_valid=nv)
            tag = f"wn_layer_first B={B} T={T} n_valid={nv} n_half={n_half}"
            note("wn_layer_first", compare(tag + " x", gx, px)[0])
            note("wn_layer_first",
                 compare(tag + " skip", gs[:, :nv], ps[:, :nv])[0])
        for d in (1, 64, 128):
            for rs_full in (True, False):
                seed += 1
                k = layer_inputs(B, T, nv, C, M, seed, dev)
                w_rs, b_rs = k["w_rs"], k["b_rs"]
                if not rs_full:
                    w_rs, b_rs = w_rs[:, :C].contiguous(), b_rs[:C].contiguous()
                args = (k["x"], k["spect"], k["w_in"], k["b_in"],
                        k["w_cond"], k["b_cond"], w_rs, b_rs)
                px, ps = wb.wn_layer_plain(*args, k["skip_acc"], d,
                                           n_valid=nv)
                gx, gs = wb.wn_layer(*args, k["skip_acc"].clone(), d,
                                     n_valid=nv)
                tag = (f"wn_layer B={B} T={T} n_valid={nv} d={d} "
                       f"rs_out={w_rs.shape[1]}")
                note("wn_layer", compare(tag + " x", gx, px)[0])
                note("wn_layer",
                     compare(tag + " skip", gs[:, :nv], ps[:, :nv])[0])
            for E in (4, 6, 8):
                seed += 1
                k = layer_inputs(B, T, nv, C, M, seed, dev, E=E)
                args = (k["x"], k["spect"], k["w_in"], k["b_in"],
                        k["w_cond"], k["b_cond"], k["w_rs"], k["b_rs"],
                        k["skip_acc"], k["w_end"], k["b_end"], d)
                got = wb.wn_layer_final(*args, n_valid=nv)
                want = wb.wn_layer_final_plain(*args, n_valid=nv)
                tag = f"wn_layer_final B={B} T={T} n_valid={nv} d={d} E={E}"
                note("wn_layer_final", compare(tag, got, want)[0])

    # times at one vocode's shapes: B=1, 200 mel frames = 6400 groups
    B, T = 1, 6400
    k = layer_inputs(B, T, T, C, M, 99, dev, n_half=4)
    first = (k["x0"], k["spect"], k["start_k"], k["start_b"], k["w_in"],
             k["b_in"], k["w_cond"], k["b_cond"], k["w_rs"], k["b_rs"], 1)
    k = layer_inputs(B, T, T, C, M, 98, dev)
    std = (k["x"], k["spect"], k["w_in"], k["b_in"], k["w_cond"],
           k["b_cond"], k["w_rs"], k["b_rs"], k["skip_acc"], 64)
    k = layer_inputs(B, T, T, C, M, 97, dev, E=8)
    fin = (k["x"], k["spect"], k["w_in"], k["b_in"], k["w_cond"],
           k["b_cond"], k["w_rs"], k["b_rs"], k["skip_acc"], k["w_end"],
           k["b_end"], 128)
    for name, kern, plain, args in (
        ("wn_layer_first", wb.wn_layer_first, wb.wn_layer_first_plain, first),
        ("wn_layer", wb.wn_layer, wb.wn_layer_plain, std),
        ("wn_layer_final", wb.wn_layer_final, wb.wn_layer_final_plain, fin),
    ):
        rec[name]["ms"] = time_ms(lambda: kern(*args))
        rec[name]["plain_ms"] = time_ms(lambda: plain(*args))
        print(f"  {name} B={B} T={T}: kernel {rec[name]['ms']:.4f} ms, "
              f"plain {rec[name]['plain_ms']:.4f} ms")
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


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def end_to_end() -> dict:
    """Phase 4: text -> mel -> fused vocoder -> denoiser -> WAV at the
    reference config on seeded random weights.  Returns the launch counts
    of the main-path run."""
    from scipy.io import wavfile

    from text2speech_tpu_torch.infer import (HParams, WaveGlowConfig,
                                             random_synthesizer)
    from text2speech_tpu_torch.models.waveglow_fused import infer_fused
    from text2speech_tpu_torch.ops import wn_block as wb

    hp, wg_cfg = HParams(), WaveGlowConfig()
    synth, t_build = sync_time(lambda: random_synthesizer(
        hp, wg_cfg, seed=0, device="cuda", use_denoiser=True,
        use_fused_vocoder=True))
    print(f"[e2e] random_synthesizer (C={wg_cfg.wn_n_channels}, "
          f"L={wg_cfg.wn_n_layers}, flows={wg_cfg.n_flows}, "
          f"decoder_rnn={hp.decoder_rnn_dim}) built in {t_build:.2f} s")
    hop = wg_cfg.upsample_stride
    with tempfile.TemporaryDirectory() as d:
        paths = [f"{d}/smoke_{i}.wav" for i in range(len(TEXTS))]
        wb.reset_launch_counts()
        wavs, t_main = sync_time(lambda: synth.synthesize_to_files(
            TEXTS, paths, seed=0, sigma=SIGMA, max_steps=MAX_STEPS,
            denoiser_strength=DENOISER_STRENGTH))
        launches = wb.launch_counts()
        print(f"[e2e] main path (batch {len(TEXTS)}, {MAX_STEPS} decoder "
              f"steps) in {t_main:.3f} s; launches {launches}")
        want = {"wn_layer_first": wg_cfg.n_flows,
                "wn_layer": wg_cfg.n_flows * (wg_cfg.wn_n_layers - 2),
                "wn_layer_final": wg_cfg.n_flows}
        if launches != want:
            raise RuntimeError(f"launch counts {launches}, want {want} for "
                               f"one vocode")
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
        print(f"[e2e] wrote {len(paths)} WAVs, lengths {lens.tolist()} "
              f"frames x {hop}, peak {max(np.abs(w).max() for w in wavs):.4g}")

    # steady-state rates (warm)
    _, t_dec = sync_time(lambda: synth.text_to_mel(TEXTS, seed=1,
                                                   max_steps=MAX_STEPS))
    T = int(lens.max())
    mel = mel[:, :, :T].contiguous()
    audio, t_voc = sync_time(lambda: synth.mel_to_audio(
        mel, SIGMA, seed=0, denoiser_strength=DENOISER_STRENGTH))
    print(f"[e2e] decode: {MAX_STEPS / t_dec:.2f} steps/s "
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
        got = infer_fused(fw, mel, SIGMA, noise=noise)
        plain = infer_fused(fw, mel, SIGMA, noise=noise, plain=True)
        exact = synth.waveglow.infer(mel, SIGMA, noise=noise)
    err = (got - plain).abs().max().item()
    peak = plain.abs().max().item()
    rel = ((got - plain).norm() / plain.norm()).item()
    rel32 = ((got - exact).norm() / exact.norm()).item()
    print(f"[e2e] fused kernels vs fused plain (bf16): max_abs_err={err:.6g} "
          f"(bound {E2E_MAX_ABS_STEPS * peak:.4g}) rel_l2={rel:.4g} (bound "
          f"{E2E_REL_L2}); vs plain f32 WaveGlow.infer: rel_l2={rel32:.4g}")
    if not torch.isfinite(got).all():
        raise RuntimeError("fused vocoder: non-finite audio")
    if err > E2E_MAX_ABS_STEPS * peak or rel > E2E_REL_L2:
        raise RuntimeError("fused vocoder: kernel path disagrees with the "
                           "plain path")
    return launches


def cli_run() -> None:
    """Phase 5: the port's CLI writes a WAV on the card."""
    with tempfile.TemporaryDirectory() as d:
        out = f"{d}/cli.wav"
        cmd = [sys.executable, "-m", "text2speech_tpu_torch.inference",
               "--random_init", "0", "--fused_vocoder", "-d", "0.1",
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

    t0 = time.perf_counter()
    wb.LIB.build()
    wb.LIB.get()
    print(f"[build] nvcc {wb.LIB.build_seconds:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s)")
    print(wb.LIB.build_log.strip())

    print("[kernels] kernel vs plain at C=512, M=640")
    rec = check_kernels()
    launches = end_to_end()
    cli_run()

    kernels = [{
        "name": n, "route": "cuda", "source": SOURCE, "replaces": REPLACES[n],
        "launches": launches[n], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"],
    } for n, r in rec.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
