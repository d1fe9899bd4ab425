#!/usr/bin/env python
"""Where the time goes in the PyTorch port on one NVIDIA GPU.

    python3 profile_torch.py [--batch 3] [--steps 200]
                             [--stages serve server train tacotron_train]

Builds the reference-width synthesizers on seeded random weights (bf16 fused
and int8 vocoders, as ``chip_smoke.py`` does) and runs each stage of the
main paths once warm and once under ``torch.profiler``: decode, vocode with
and without the denoiser through either vocoder, the composed-conditioning
vocode beside the bf16 one, long-form vocoding of a 712-frame mel, and one
``synthesize_incremental`` call (``stream``: wall, device busy, idle share
and the time to the first chunk, at ``--stream_steps`` decoder steps in
chunks of 64).  The ``server`` stages are the tensor-parallel vocode of the
same mel with 2 and 4 shards on the one card, bf16 and int8, beside the
single-device vocode, and one whole run of the continuous-batching server
(six sessions of ``--server_steps`` decoder steps through 4 slots, chunks of
64, two with the denoiser): wall, device busy and idle share of the run and
per scheduling round.  The ``train`` stages are one WaveGlow optimizer step at
reference width (batch 3 x 16,000 samples of seeded noise, the seeded
initialisation with live ``end`` convs) in f32, f32 with remat, and bf16,
each with its peak device memory.  The ``tacotron_train`` stages are one
Tacotron-2 optimizer step at reference width (batch 32 of seeded text and
mels, 64 text positions and 448 frames, unequal lengths) in f32, f32 with
the decoder rematerialized, and bf16, each with its peak device memory.
For each stage it prints the wall time of the profiled
call, the device-busy time (the union of the kernels' intervals in the
trace), the idle share (1 - busy / wall), the number of kernels and the
kernels that took most of the device time, and under "named" the WN-layer
kernels by their (mangled) names: ``wn_sm90_kernel<ROLE, NWG, BK, DCOND>``
of ``csrc/wn_block_sm90.cu`` (ROLE 0 standard, 1 final, 2 partial, 3
first, 4 the partial layer's layer-0 form; DCOND 1 for the composed
vocoder's layers) and ``wn_int8_sm90_kernel<ROLE, NC>`` of
``csrc/wn_block_int8_sm90.cu`` (ROLE 0 the int8 standard layer, 1 the int8
tensor-parallel partial layer, 2 the int8 final layer, 3 the int8 first
layer).  One JSON line per stage, then the card's name and power limit.
Needs a GPU; imports nothing of JAX.
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


def tacotron_train_stages() -> list:
    """(name, build) for one Tacotron optimizer step in each training mode
    at batch 32 x 448 frames (the bucket of a 2.5 s utterance at 44.8 kHz);
    ``build()`` makes the model, its optimizer and the step function."""
    from text2speech_tpu_torch.config import HParams
    from text2speech_tpu_torch.data.dataset import Batch
    from text2speech_tpu_torch.models.tacotron2 import (Tacotron2,
                                                        init_weights_)
    from text2speech_tpu_torch.text import N_SYMBOLS
    from text2speech_tpu_torch.train.state import create_tacotron_state
    from text2speech_tpu_torch.train.tacotron import (make_train_step,
                                                      step_generator)

    hp = HParams()
    B, T_in, T_out = hp.batch_size, 64, 448
    g = torch.Generator().manual_seed(0)
    i32 = torch.int32
    in_len = torch.randint(20, T_in + 1, (B,), generator=g,
                           dtype=i32).sort(descending=True).values
    out_len = torch.randint(175, T_out + 1, (B,), generator=g, dtype=i32)
    frames = torch.arange(T_out)[None, :] < out_len[:, None]
    batch = Batch(*(t.cuda() for t in (
        torch.randint(2, 70, (B, T_in), generator=g, dtype=i32), in_len,
        torch.randn(B, hp.n_mel_channels, T_out, generator=g)
        * frames[:, None], (~frames).float(), torch.zeros(B, dtype=i32),
        out_len)))

    def build(bf16: bool, remat: bool):
        model = init_weights_(Tacotron2(
            hp, N_SYMBOLS, device="cuda",
            compute_dtype=torch.bfloat16 if bf16 else None,
            decoder_remat=remat), torch.Generator().manual_seed(hp.seed))
        state = create_tacotron_state(model, hp)
        step = make_train_step(model, hp)
        return lambda: step(state, batch, step_generator(hp.seed, 0, "cuda"))

    return [("tacotron step f32", lambda: build(False, False)),
            ("tacotron step f32 remat", lambda: build(False, True)),
            ("tacotron step bf16", lambda: build(True, False))]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stages", nargs="+",
                   default=["serve", "server", "train", "tacotron_train"],
                   choices=("serve", "server", "train", "tacotron_train"))
    p.add_argument("--batch", type=int, default=3, choices=range(1, 5))
    p.add_argument("--steps", type=int, default=200,
                   help="decoder steps = mel frames per utterance")
    p.add_argument("--stream_steps", type=int, default=600,
                   help="decoder steps of the stream stage's utterance")
    p.add_argument("--server_steps", type=int, default=400,
                   help="decoder steps of each served session")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if "serve" in args.stages:
        serve_stages(args)
    if "server" in args.stages:
        server_stages(args)
    runs = []
    if "train" in args.stages:
        runs.append(("WaveGlow training, reference width, batch 3 x 16000",
                     train_stages(), ("gated_",)))
    if "tacotron_train" in args.stages:
        runs.append(("Tacotron training, reference width, batch 32 x 448 "
                     "frames", tacotron_train_stages(), ()))
    for title, stages, also in runs:
        print(title)
        for name, build in stages:
            fn = build()
            fn()                           # first call: cuDNN picks its plans
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rec = profile_stage(name, fn, also=also)
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
    from text2speech_tpu_torch.models.waveglow_fused import (
        infer_fused, precompute_composed_cond)

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
    cc = precompute_composed_cond(bf16.waveglow)
    gen = torch.Generator(device="cuda")
    stages.insert(2, ("vocode composed", lambda: infer_fused(
        bf16.fused, mel, SIGMA, generator=gen.manual_seed(1),
        composed_cond=cc)))
    print(f"batch {len(texts)} x {args.steps} frames, reference width")
    for name, fn in stages:
        also = (("wn_sm90_kernel", "wn_int8_sm90_kernel")
                if name.startswith("vocode") else ())
        print(json.dumps(profile_stage(name, fn, also), ensure_ascii=False))
    del cc

    # one streamed utterance: the first chunk's latency beside the whole
    first: list = []

    def stream(s):
        t0 = time.perf_counter()
        first.clear()
        for _ in s.synthesize_incremental(
                texts[0], sigma=SIGMA, seed=0, chunk_steps=64,
                max_steps=args.stream_steps, denoiser_strength=0.1):
            if not first:
                first.append((time.perf_counter() - t0) * 1e3)

    print(f"one utterance of {args.stream_steps} decoder steps, streamed in "
          f"chunks of 64, denoiser on")
    for tag, s in synths.items():
        rec = profile_stage(f"stream {tag}", lambda s=s: stream(s))
        rec["first_chunk_ms_last_run"] = round(first[0], 3)
        print(json.dumps(rec, ensure_ascii=False))
        single = profile_stage(
            f"single pass {tag}, {args.stream_steps} steps",
            lambda s=s: s.synthesize(texts[:1], sigma=SIGMA, seed=0,
                                     max_steps=args.stream_steps,
                                     denoiser_strength=0.1))
        print(json.dumps(single, ensure_ascii=False))


def server_stages(args) -> None:
    """The tensor-parallel vocode and one run of the continuous-batching
    server, each profiled whole."""
    from text2speech_tpu_torch.config import HParams, WaveGlowConfig
    from text2speech_tpu_torch.infer import random_synthesizer
    from text2speech_tpu_torch.parallel.tp import TPWaveGlowServer
    from text2speech_tpu_torch.server import make_server

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
    gen = torch.Generator(device="cuda")
    print(f"tensor-parallel vocode, batch {len(texts)} x {args.steps} frames, "
          f"every shard on this card")
    for tag, s in synths.items():
        rec = profile_stage(f"vocode {tag} single device",
                            lambda s=s: s.mel_to_audio(mel, SIGMA),
                            ("wn_layer", "wn_sm90_kernel",
                             "wn_int8_sm90_kernel"))
        print(json.dumps(rec, ensure_ascii=False))
        for p in (2, 4):
            tps = TPWaveGlowServer(bf16.waveglow, p, int8=tag == "int8")
            rec = profile_stage(
                f"vocode {tag} tp p={p}",
                lambda: tps(mel, SIGMA, generator=gen.manual_seed(1)),
                ("wn_layer", "wn_sm90_kernel", "wn_int8_sm90_kernel"))
            print(json.dumps(rec, ensure_ascii=False))
            del tps
            torch.cuda.empty_cache()

    sigmas = [0.666, 0.5, 0.8, 0.666, 1.0, 0.6]
    strengths = [None, 0.1, None, None, 0.1, None]
    print(f"continuous-batching server: 6 sessions x {args.server_steps} "
          f"decoder steps through 4 slots, chunks of 64")
    for tag, s in synths.items():
        rounds: list = []

        def run(s=s):
            srv = make_server(s, slots=4, chunk_steps=64,
                              max_steps=args.server_steps)
            for i in range(3):
                srv.submit(TEXTS[i % len(TEXTS)], seed=10 + i,
                           sigma=sigmas[i], denoiser_strength=strengths[i])
            srv.step()
            srv.step()
            for i in range(3, 6):
                srv.submit(TEXTS[i % len(TEXTS)], seed=10 + i,
                           sigma=sigmas[i], denoiser_strength=strengths[i])
            while not srv.idle:
                srv.step()
            rounds[:] = [srv.stats["rounds"], srv.stats["emitted_samples"],
                         srv.stats["active_row_steps"]
                         / srv.stats["row_steps"]]

        rec = profile_stage(f"server {tag}", run,
                            ("wn_layer", "wn_sm90_kernel",
                             "wn_int8_sm90_kernel"))
        n, samples, occupancy = rounds
        rec.update(rounds=n, slot_occupancy=round(occupancy, 3),
                   wall_ms_per_round=round(rec["wall_ms_profiled"] / n, 3),
                   busy_ms_per_round=round(rec["device_busy_ms"] / n, 3),
                   audio_s_per_wall_s=[round(samples / 22050 / (w / 1e3), 3)
                                       for w in rec["wall_ms_unprofiled"]])
        print(json.dumps(rec, ensure_ascii=False))


if __name__ == "__main__":
    sys.exit(main())
