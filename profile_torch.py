#!/usr/bin/env python
"""Where the time goes in the PyTorch port on one NVIDIA GPU.

    python3 profile_torch.py [--batch 3] [--steps 200] [--stages serve train]

Builds the reference-width synthesizers on seeded random weights (bf16 fused
and int8 vocoders, as ``chip_smoke.py`` does) and runs each stage of the
main paths once warm and once under ``torch.profiler``: decode, vocode with
and without the denoiser through either vocoder, and long-form vocoding of
a 712-frame mel.  The ``train`` stages are one WaveGlow optimizer step at
reference width (batch 3 x 16,000 samples of seeded noise, the seeded
initialisation with live ``end`` convs) in f32, f32 with remat, and bf16,
each with its peak device memory.  For each stage it prints the wall time of the profiled
call, the device-busy time (the union of the kernels' intervals in the
trace), the idle share (1 - busy / wall), the number of kernels and the
kernels that took most of the device time.  One JSON line per stage, then
the card's name and power limit.  Needs a GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import torch

TEXTS = [
    "이 것은 제작되고 있는 중입니다.",
    "안녕하세요. 만나서 반갑습니다.",
    "오늘 날씨가 참 좋네요.",
    "내일은 비가 온다고 합니다.",
]
SIGMA = 0.666


def kernel_events(trace_path: str) -> list:
    """(name, start us, duration us) of every GPU kernel in a chrome trace."""
    with open(trace_path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["dur"]) for e in events
            if e.get("cat") == "kernel" and e.get("ph") == "X"]


def busy_us(kernels: list) -> float:
    """Length of the union of the kernels' intervals."""
    busy, end = 0.0, float("-inf")
    for _, ts, dur in sorted(kernels, key=lambda k: k[1]):
        if ts + dur > end:
            busy += ts + dur - max(ts, end)
            end = ts + dur
    return busy


def profile_stage(name: str, fn, also: tuple = ()) -> dict:
    """``also``: substrings of kernel names whose calls and time are
    reported under "named" whether or not they are among the top."""
    from torch.profiler import ProfilerActivity, profile

    fn()                                   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        kernels = kernel_events(f"{d}/trace.json")
    if not kernels:
        raise RuntimeError(f"{name}: the trace holds no GPU kernel")
    by_name: dict = {}
    for kname, _, dur in kernels:
        n, t = by_name.get(kname, (0, 0.0))
        by_name[kname] = (n + 1, t + dur)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    busy_ms = busy_us(kernels) / 1e3
    walls = []
    for _ in range(3):                     # unprofiled walls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(round((time.perf_counter() - t0) * 1e3, 3))
    named = {k[:60]: {"calls": n, "ms": round(t / 1e3, 3)}
             for k, (n, t) in by_name.items() if any(a in k for a in also)}
    return {
        "stage": name, "wall_ms_profiled": round(wall_ms, 3),
        "device_busy_ms": round(busy_ms, 3),
        "idle_share": round(1 - busy_ms / wall_ms, 4),
        "kernels": len(kernels), "wall_ms_unprofiled": walls,
        "top": [{"name": k[:60], "calls": n, "ms": round(t / 1e3, 3)}
                for k, (n, t) in top],
        **({"named": named} if also else {}),
    }


def train_stages() -> list:
    """(name, build) for one optimizer step in each training mode;
    ``build()`` makes the model, its optimizer and the step function, so
    the caller holds one model at a time (each keeps its parameters,
    gradients and Adam moments on the card)."""
    from text2speech_tpu_torch.config import WaveGlowConfig
    from text2speech_tpu_torch.data.mel2samp import VocoderBatch
    from text2speech_tpu_torch.dsp.mel import MelFrontend
    from text2speech_tpu_torch.models.waveglow import TrainableWaveGlow
    from text2speech_tpu_torch.train.state import create_train_state
    from text2speech_tpu_torch.train.waveglow import make_wg_train_step

    cfg = WaveGlowConfig()
    g = torch.Generator().manual_seed(0)
    audio = (0.2 * torch.randn(cfg.batch_size, cfg.segment_length,
                               generator=g)).cuda()
    batch = VocoderBatch(MelFrontend().mel_spectrogram(audio), audio)

    def build(bf16: bool, remat: bool):
        model = TrainableWaveGlow(
            cfg, compute_dtype=torch.bfloat16 if bf16 else torch.float32,
            remat=remat, generator=torch.Generator().manual_seed(cfg.seed),
            device="cuda")
        with torch.no_grad():
            for name, p in sorted(model.params.items()):
                if "/end/" in name:
                    p.add_(0.01 * torch.randn(p.shape, generator=g).cuda())
        state = create_train_state(model.params, cfg.learning_rate)
        step = make_wg_train_step(model, cfg.sigma)
        return lambda: step(state, batch)

    return [("train step f32", lambda: build(False, False)),
            ("train step f32 remat", lambda: build(False, True)),
            ("train step bf16", lambda: build(True, False))]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stages", nargs="+", default=["serve", "train"],
                   choices=("serve", "train"))
    p.add_argument("--batch", type=int, default=3, choices=range(1, 5))
    p.add_argument("--steps", type=int, default=200,
                   help="decoder steps = mel frames per utterance")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if "serve" in args.stages:
        serve_stages(args)
    if "train" in args.stages:
        print("WaveGlow training, reference width, batch 3 x 16000")
        for name, build in train_stages():
            fn = build()
            fn()                           # first call: cuDNN picks its plans
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rec = profile_stage(name, fn, also=("gated_",))
            rec["peak_memory_gb"] = round(
                torch.cuda.max_memory_allocated() / 1e9, 3)
            print(json.dumps(rec, ensure_ascii=False))
            del fn
            torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())
    return 0


def serve_stages(args) -> None:
    from text2speech_tpu_torch.config import HParams, WaveGlowConfig
    from text2speech_tpu_torch.infer import random_synthesizer

    texts = TEXTS[: args.batch]
    synths = {
        "bf16": random_synthesizer(HParams(), WaveGlowConfig(), 0,
                                   device="cuda"),
        "int8": random_synthesizer(HParams(), WaveGlowConfig(), 0,
                                   device="cuda", int8_vocoder=True),
    }
    bf16 = synths["bf16"]
    mel, _ = bf16.text_to_mel(texts, seed=0, max_steps=args.steps)
    mel = mel[:, :, : args.steps].contiguous()
    long_mel = mel[:1].repeat(1, 1, -(-712 // args.steps))[:, :, :712]
    long_mel = long_mel.contiguous()

    stages = [("decode", lambda: bf16.text_to_mel(texts, seed=1,
                                                  max_steps=args.steps))]
    for tag, s in synths.items():
        stages += [
            (f"vocode {tag}", lambda s=s: s.mel_to_audio(mel, SIGMA)),
            (f"vocode+denoise {tag}",
             lambda s=s: s.mel_to_audio(mel, SIGMA, denoiser_strength=0.1)),
            (f"long-form 712 frames {tag}",
             lambda s=s: s.mel_to_audio_long(long_mel, SIGMA)),
        ]
    print(f"batch {len(texts)} x {args.steps} frames, reference width")
    for name, fn in stages:
        print(json.dumps(profile_stage(name, fn), ensure_ascii=False))


if __name__ == "__main__":
    sys.exit(main())
