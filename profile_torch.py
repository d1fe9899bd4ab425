#!/usr/bin/env python
"""Where the time goes in the PyTorch port on one NVIDIA GPU.

    python3 profile_torch.py [--batch 3] [--steps 200]

Builds the reference-width synthesizers on seeded random weights (bf16 fused
and int8 vocoders, as ``chip_smoke.py`` does) and runs each stage of the
main paths once warm and once under ``torch.profiler``: decode, vocode with
and without the denoiser through either vocoder, and long-form vocoding of
a 712-frame mel.  For each stage it prints the wall time of the profiled
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


def profile_stage(name: str, fn) -> dict:
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
    busy_ms = busy_us(kernels) / 1e3
    walls = []
    for _ in range(3):                     # unprofiled walls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(round((time.perf_counter() - t0) * 1e3, 3))
    return {
        "stage": name, "wall_ms_profiled": round(wall_ms, 3),
        "device_busy_ms": round(busy_ms, 3),
        "idle_share": round(1 - busy_ms / wall_ms, 4),
        "kernels": len(kernels), "wall_ms_unprofiled": walls,
        "top": [{"name": k[:60], "calls": n, "ms": round(t / 1e3, 3)}
                for k, (n, t) in top],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=3, choices=range(1, 5))
    p.add_argument("--steps", type=int, default=200,
                   help="decoder steps = mel frames per utterance")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
