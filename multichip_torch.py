#!/usr/bin/env python
"""Walls of the port's multi-card paths: one process per card, NCCL.

    python3 multichip_torch.py [--nproc 4] [--reps 5]
    python3 multichip_torch.py --device cpu --tiny --nproc 4   # rehearsal

Without ``--worker`` it builds the hand-written kernels in this process
(the ranks then load them, so no two ranks race one build directory) and
starts ``--nproc`` ranks of itself under ``torch.distributed.run``.  Each
rank joins the group through ``parallel.mesh.initialize_distributed`` (NCCL
when every rank has a card of its own) and holds the same seeded weights
(drawn on the CPU, then moved).  Rank 0 prints one JSON line per
measurement, each warm and timed ``--reps`` times (host clock around work
that ends in a synchronise and a barrier), then the cards' names and power
limits:

1. ``allreduce``: one ``all_reduce`` of the WaveGlow step's gradients as
   one flat f32 buffer (every parameter of the model), and of one TP WN
   layer's partial sum at batch 3 x 200 frames ([3, 6400, 2C] f32, 78.6
   MB): ms and bus bandwidth (2 (n - 1) / n bytes over the time);
2. ``waveglow_step``: one WaveGlow optimizer step at the reference width,
   3 rows a card (global 3 n), data-parallel over the n cards, against
   rank 0's step alone at batch 3 (``mesh=None``): samples per second;
3. ``tp_vocode``: the tensor-parallel vocoder with one shard a card, and
   on a 2 x n/2 data x model grid, bf16 and int8, batch 4 x 200 frames,
   against rank 0's single-card fused vocoder on the same batch, with the
   audio's distance from it;
4. ``infer_long``: a 2400-frame mel (10 windows of 256, padded to a
   multiple of n) through ``infer_long(mesh=)`` over the n cards against
   rank 0 alone, bf16 and int8, with the audio's distance;
5. ``gather``: one hidden-state gather of the tensor-parallel decoder
   (``parallel.mesh.gather_cols`` of a [B, 1024 / n] slice, B = 1 and 3);
6. ``tp_decode``: the tensor-parallel Tacotron decode with one shard a
   card (``TPTacotronDecoder(group=WORLD)``), 200 steps at batch 1 and 3,
   f32 and bf16, against rank 0's ``decode_chunk_serve`` alone: steps per
   second and the mel's distance;
7. ``tp_server``: ``make_server_tp`` over a ``TPSynthesizer`` with one
   shard a card (bf16), every rank running the batcher in lockstep, 6
   texts x 400 steps through 4 slots, against rank 0's ``make_server``
   over the fused ``Synthesizer`` alone on the same masks and noise:
   audio seconds per wall second and each session's distance.

``--measures`` picks some of them (default all, in this order).

Needs the cards unless ``--device cpu`` (``--tiny``: a small configuration
for the rehearsal, its numbers no rate).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

import torch

SIGMA = 0.666
TINY_WG = dict(n_mel_channels=16, n_flows=4, n_group=8, n_early_every=2,
               n_early_size=2, wn_n_layers=3, wn_n_channels=32,
               upsample_kernel=64, upsample_stride=16, segment_length=1024,
               hop_length=16, filter_length=64, win_length=64)
TINY_HP = dict(sample_rate=22050, embedding_size=16, enc_conv_num_layers=1,
               enc_conv_channels=16, attention_rnn_dim=32, decoder_rnn_dim=32,
               attention_dim=8, attention_location_n_filters=4,
               attention_location_kernel_size=7, prenet_dim=8,
               n_mel_channels=16, postnet_embedding_dim=8,
               postnet_n_convolutions=2, max_decoder_steps=400)
TEXTS = ["이 것은 제작되고 있는 중입니다.", "안녕하세요. 만나서 반갑습니다.",
         "오늘 날씨가 참 좋네요."]
MEASURES = ("allreduce", "waveglow_step", "tp_vocode", "infer_long",
            "gather", "tp_decode", "tp_server")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=4)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--tiny", action="store_true",
                   help="a small configuration (the CPU rehearsal)")
    p.add_argument("--measures", default=",".join(MEASURES),
                   help="comma-separated subset of " + ",".join(MEASURES))
    p.add_argument("--worker", action="store_true",
                   help="run as one rank (set by the launcher)")
    return p.parse_args(argv)


def launch(args) -> int:
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("multichip_torch: no CUDA device", file=sys.stderr)
            return 1
        if torch.cuda.device_count() < args.nproc:
            print(f"multichip_torch: {args.nproc} ranks need as many cards; "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 1
        from concurrent.futures import ThreadPoolExecutor

        from text2speech_tpu_torch.ops import gated
        from text2speech_tpu_torch.ops import wn_block as wb
        from text2speech_tpu_torch.ops import wn_block_int8 as wq

        libs = (wb.LIB_SM90, wq.LIB_SM90, gated.LIB)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(libs)) as pool:
            for f in [pool.submit(lib.build) for lib in libs]:
                f.result()
        print(f"built {len(libs)} libraries in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(args.nproc), "--master_port", str(port),
           os.path.abspath(__file__), "--worker", "--reps", str(args.reps),
           "--device", args.device, "--measures", args.measures] + (
               ["--tiny"] if args.tiny else [])
    rc = subprocess.run(cmd, timeout=3000).returncode
    if rc == 0 and args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    return rc


class Rank:
    """This process's rank, device and timers."""

    def __init__(self, args):
        import torch.distributed as dist

        from text2speech_tpu_torch.parallel import mesh as pm

        assert pm.initialize_distributed(device=args.device)
        self.dist, self.pm = dist, pm
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.device = pm.rank_device()
        self.reps = args.reps
        self.backend = dist.get_backend()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def times(self, fn, everyone: bool = True) -> list:
        """Milliseconds of ``reps`` calls of ``fn`` after one warm-up; with
        ``everyone`` each call ends in a barrier of all ranks."""
        out = []
        for i in range(self.reps + 1):
            self.sync()
            if everyone:
                self.dist.barrier()
            t0 = time.perf_counter()
            fn()
            self.sync()
            if everyone:
                self.dist.barrier()
            if i:
                out.append((time.perf_counter() - t0) * 1e3)
        return out

    def alone(self, fn):
        """``fn`` on rank 0 while the others wait; its result on rank 0."""
        out = fn() if self.rank == 0 else None
        self.dist.barrier()
        return out

    def emit(self, record: dict) -> None:
        if self.rank == 0:
            ms = record.get("ms")
            if ms:
                record["median_ms"] = statistics.median(ms)
            print(json.dumps({"world": self.world, "backend": self.backend,
                              **record}), flush=True)


def seeded_waveglow(cfg, device):
    """The same WaveGlow on every rank: weights drawn on the CPU from seed
    0 (orthogonal 1x1 convs, small end convs), then moved."""
    from text2speech_tpu_torch.infer import random_weights_
    from text2speech_tpu_torch.models.waveglow import WaveGlow

    gen = torch.Generator().manual_seed(0)
    wg = WaveGlow(cfg)
    random_weights_(wg, gen, out_first=False)
    with torch.no_grad():
        for w in wg.convinv:
            q, _ = torch.linalg.qr(torch.randn(w.shape, generator=gen))
            if torch.linalg.det(q) < 0:
                q[:, 0] = -q[:, 0]
            w.copy_(q)
        for wn in wg.wn:
            wn.end_w.mul_(0.02)
            wn.end_b.mul_(0.02)
    return wg.to(device).eval()


def rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def measure_allreduce(r: Rank, cfg) -> None:
    from text2speech_tpu_torch.models.waveglow import TrainableWaveGlow

    n_params = sum(p.numel() for p in TrainableWaveGlow(cfg).params.values())
    T = 200 * cfg.upsample_stride // cfg.n_group
    for name, numel in (("gradients", n_params),
                        ("tp_layer", 3 * T * 2 * cfg.wn_n_channels)):
        buf = torch.randn(numel, device=r.device)
        ms = r.times(lambda: r.dist.all_reduce(buf))
        mb = numel * 4 / 1e6
        r.emit({"measure": "allreduce", "what": name, "mbytes": mb, "ms": ms,
                "bus_GBps": 2 * (r.world - 1) / r.world * mb / 1e3
                / (statistics.median(ms) / 1e3)})
        del buf


def measure_waveglow_step(r: Rank, cfg) -> None:
    from text2speech_tpu_torch.data.mel2samp import VocoderBatch
    from text2speech_tpu_torch.models.waveglow import TrainableWaveGlow
    from text2speech_tpu_torch.train.state import create_train_state
    from text2speech_tpu_torch.train.waveglow import make_wg_train_step

    g = torch.Generator().manual_seed(1)
    B = 3 * r.world
    frames = cfg.segment_length // cfg.hop_length + 1
    batch = VocoderBatch(
        torch.randn(B, cfg.n_mel_channels, frames, generator=g),
        0.1 * torch.randn(B, cfg.segment_length, generator=g))
    model = TrainableWaveGlow(cfg, generator=torch.Generator().manual_seed(2),
                              device=r.device)
    with torch.no_grad():
        for name, p in sorted(model.params.items()):
            if "/end/" in name:
                p.add_(0.01 * torch.randn(p.shape, generator=g).to(p.device))
    state = create_train_state(model.params, cfg.learning_rate)
    on_dev = VocoderBatch(*(t.to(r.device) for t in batch))
    step = make_wg_train_step(model, cfg.sigma, mesh=r.pm.make_mesh())
    ms = r.times(lambda: step(state, on_dev))
    r.emit({"measure": "waveglow_step", "what": f"data-parallel, 3 rows a "
            f"rank, global batch {B}", "ms": ms,
            "samples_per_s": B * cfg.segment_length
            / (statistics.median(ms) / 1e3)})
    one = make_wg_train_step(model, cfg.sigma)
    first3 = VocoderBatch(*(t[:3] for t in on_dev))
    ms1 = r.alone(lambda: r.times(lambda: one(state, first3),
                                  everyone=False))
    r.emit({"measure": "waveglow_step", "what": "one card, batch 3",
            "ms": ms1, "samples_per_s": None if ms1 is None else
            3 * cfg.segment_length / (statistics.median(ms1) / 1e3)})
    del model, state, step, one


def measure_tp_vocode(r: Rank, wg, cfg, tiny: bool) -> None:
    from text2speech_tpu_torch.models.waveglow import noise_shapes
    from text2speech_tpu_torch.models.waveglow_fused import (
        prepare_fused, prepare_fused_int8)
    from text2speech_tpu_torch.parallel.tp import TPWaveGlowServer

    cd = torch.float32 if tiny else torch.bfloat16
    g = torch.Generator().manual_seed(3)
    B, frames = 4, 200
    mel = torch.randn(B, cfg.n_mel_channels, frames, generator=g)
    Tg = frames * cfg.upsample_stride // cfg.n_group
    noise = tuple(torch.randn(s, generator=g).to(r.device)
                  for s in noise_shapes(cfg, B, Tg))
    mel = mel.to(r.device)
    grid = None
    if r.world % 2 == 0 and r.world > 2:
        grid = r.pm.make_mesh((2, r.world // 2),
                              (r.pm.DATA_AXIS, r.pm.MODEL_AXIS))
    for tag, int8 in (("bf16", False), ("int8", True)):
        fw = (prepare_fused_int8 if int8 else prepare_fused)(wg, cd)

        def single():
            with torch.inference_mode():
                return fw.infer(mel, SIGMA, noise=noise)

        ref = r.alone(single)
        ms1 = r.alone(lambda: r.times(single, everyone=False))
        r.emit({"measure": "tp_vocode", "what": f"{tag} single card",
                "batch": [B, frames], "ms": ms1})
        layouts = [("one shard a card",
                    dict(group=r.dist.group.WORLD))]
        if grid is not None:
            layouts.append((f"2 x {r.world // 2} data x model grid",
                            dict(mesh=grid)))
        for what, kw in layouts:
            server = TPWaveGlowServer(wg, int8=int8, compute_dtype=cd, **kw)

            def call():
                return server(mel, SIGMA, noise=noise)

            audio = call()
            ms = r.times(call)
            r.emit({"measure": "tp_vocode", "what": f"{tag} {what}",
                    "batch": [B, frames], "ms": ms,
                    "max_abs_vs_single": None if ref is None else
                    (audio - ref).abs().max().item(),
                    "rel_l2_vs_single": None if ref is None else
                    rel_l2(audio, ref)})
            del server
        del fw


def measure_infer_long(r: Rank, wg, cfg, tiny: bool) -> None:
    from text2speech_tpu_torch.models import chunked
    from text2speech_tpu_torch.models.waveglow_fused import (
        prepare_fused, prepare_fused_int8)

    cd = torch.float32 if tiny else torch.bfloat16
    frames, chunk = (400, 32) if tiny else (2400, 256)
    g = torch.Generator().manual_seed(4)
    mel = torch.randn(1, cfg.n_mel_channels, frames, generator=g)
    gpf = cfg.upsample_stride // cfg.n_group
    noise = tuple(z.to(r.device) for z in chunked.draw_noise(
        cfg, g, 1, frames * gpf))
    mel = mel.to(r.device)
    mesh = r.pm.make_mesh()
    for tag, prep in (("bf16", prepare_fused), ("int8", prepare_fused_int8)):
        fw = prep(wg, cd)

        def run(m=None):
            with torch.inference_mode():
                return chunked.infer_long(fw, mel, SIGMA, chunk_frames=chunk,
                                          noise=noise, mesh=m)

        ref = r.alone(run)
        ms1 = r.alone(lambda: r.times(run, everyone=False))
        audio = run(mesh)
        ms = r.times(lambda: run(mesh))
        r.emit({"measure": "infer_long", "what": tag, "frames": frames,
                "ms_single": ms1, "ms": ms,
                "max_abs_vs_single": None if ref is None else
                (audio - ref).abs().max().item()})
        del fw


def seeded_synthesizer(hp, cfg, device, fused: bool):
    """The same Tacotron-2 and WaveGlow on every rank: weights drawn on the
    CPU from seed 0 (``infer.random_synthesizer``: the stop gate biased
    shut), then moved; a ``Synthesizer`` over them on ``device``."""
    from text2speech_tpu_torch.infer import Synthesizer, random_synthesizer

    cpu = random_synthesizer(hp, cfg, seed=0, device="cpu",
                             use_fused_vocoder=False, use_denoiser=False)
    return Synthesizer(hp, cpu.taco.to(device), cfg,
                       cpu.waveglow.to(device), use_denoiser=False,
                       use_fused_vocoder=fused)


def measure_gather(r: Rank, hp) -> None:
    """One gather alone between barriers (``ms``), and 100 enqueued back to
    back, as the decode issues them (``back_to_back_ms``, per gather)."""
    from text2speech_tpu_torch.parallel.mesh import gather_cols

    for B in (1, 3):
        h = torch.randn(B, hp.decoder_rnn_dim // r.world, device=r.device)
        ms = r.times(lambda: gather_cols(h, r.dist.group.WORLD))

        def hundred():
            for _ in range(100):
                gather_cols(h, r.dist.group.WORLD)

        b2b = [t / 100 for t in r.times(hundred)]
        r.emit({"measure": "gather", "what": f"hidden state [{B}, "
                f"{hp.decoder_rnn_dim}] from {r.world} column blocks",
                "bytes": B * hp.decoder_rnn_dim * 4, "ms": ms,
                "back_to_back_ms": statistics.median(b2b)})


def trace_kernels(r: Rank, fn) -> dict | None:
    """One call of ``fn`` on every rank, rank 0's under ``torch.profiler``:
    its GPU kernels, the NCCL kernels' share, device busy and wall."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    if r.rank != 0:
        r.sync()
        r.dist.barrier()
        fn()
        r.sync()
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r.sync()
        r.dist.barrier()
        t0 = time.perf_counter()
        fn()
        r.sync()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        with open(f"{d}/trace.json", encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    ks = sorted((e["ts"], e["dur"], e["name"]) for e in events
                if e.get("cat") == "kernel" and e.get("ph") == "X")
    busy, end = 0.0, float("-inf")
    for ts, dur, _ in ks:
        if ts + dur > end:
            busy += ts + dur - max(ts, end)
            end = ts + dur
    nccl = [dur for _, dur, name in ks if "nccl" in name.lower()]
    # the host's time inside the all-reduce calls (their CPU op events)
    host = [e["dur"] for e in events if e.get("cat") == "cpu_op"
            and e.get("ph") == "X" and "allreduce" in
            e["name"].lower().replace("_", "")]
    return {"kernels": len(ks), "nccl_kernels": len(nccl),
            "nccl_ms": sum(nccl) / 1e3, "busy_ms": busy / 1e3,
            "wall_ms": wall, "host_allreduce_calls": len(host),
            "host_allreduce_ms": sum(host) / 1e3}


def decode_inputs(synth, B: int, steps: int, device):
    from text2speech_tpu_torch.text import encode_batch

    texts = [TEXTS[i % len(TEXTS)] for i in range(B)]
    ids, lengths = encode_batch(texts)
    lengths = torch.from_numpy(lengths).to(device)
    taco = synth.taco
    with torch.inference_mode():
        memory = taco.encode(torch.from_numpy(ids).long().to(device),
                             text_lengths=lengths)
        pmem = taco.process_memory(memory)
    masks = taco.decoder.draw_keep_masks(
        steps, B, torch.Generator().manual_seed(B), device)
    return memory, pmem, masks, lengths


def measure_tp_decode(r: Rank, synth, tiny: bool) -> None:
    from text2speech_tpu_torch.models import tacotron_serve as ts
    from text2speech_tpu_torch.parallel.tp_tacotron import TPTacotronDecoder

    hp, steps = synth.hp, 200
    dp = ts.extract_decoder_params(synth.taco)
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        dec = TPTacotronDecoder(synth.taco, hp, group=r.dist.group.WORLD,
                                dtype=dt)
        for B in (1, 3):
            memory, pmem, masks, lengths = decode_inputs(synth, B, steps,
                                                         r.device)

            def single():
                with torch.inference_mode():
                    return ts.decode_chunk_serve(
                        dp, hp, memory, pmem,
                        *synth.taco.decoder.initial_carry(memory), masks,
                        lengths, dtype=dt)[1]

            def tp():
                with torch.inference_mode():
                    return dec(memory, pmem, *dec.initial_carry(memory),
                               masks, lengths)[1]

            ref = r.alone(single)
            ms1 = r.alone(lambda: r.times(single, everyone=False))
            mel = tp()
            ms = r.times(tp)
            trace = trace_kernels(r, tp)
            r.emit({"measure": "tp_decode", "what": f"{name} batch {B}, "
                    f"{steps} steps, one shard a card", "ms": ms,
                    "rank0_trace": trace,
                    "ms_single": ms1,
                    "steps_per_s": steps / (statistics.median(ms) / 1e3),
                    "steps_per_s_single": None if ms1 is None else
                    steps / (statistics.median(ms1) / 1e3),
                    "mel_max_abs_vs_single": None if ref is None else
                    (mel - ref).abs().max().item(),
                    "mel_rel_l2_vs_single": None if ref is None else
                    rel_l2(mel, ref)})
        del dec


def measure_tp_server(r: Rank, synth, tiny: bool) -> None:
    import numpy as np

    from text2speech_tpu_torch.parallel.serve import TPSynthesizer
    from text2speech_tpu_torch.server import make_server, make_server_tp

    cfg = synth.wg_cfg
    steps = 100 if tiny else 400
    tps = TPSynthesizer(synth.hp, synth.taco, cfg, synth.waveglow,
                        group=r.dist.group.WORLD)
    texts = [TEXTS[i % len(TEXTS)] for i in range(6)]
    seeds = [10 + i for i in range(6)]
    kw = dict(slots=4, chunk_steps=64, max_steps=steps)

    def run(srv):
        srv.warm_window_widths()
        r.sync()
        t0 = time.perf_counter()
        wavs = srv.run(texts, seeds=seeds)
        r.sync()
        return wavs, time.perf_counter() - t0, srv.stats["rounds"]

    ref = r.alone(lambda: run(make_server(synth, **kw)))
    r.dist.barrier()
    wavs, wall, rounds = run(make_server_tp(tps, **kw))
    seconds = sum(len(w) for w in wavs.values()) / cfg.sampling_rate
    rec = {"measure": "tp_server", "what": f"make_server_tp, one shard a "
           f"card, {len(texts)} texts x {steps} steps, 4 slots, lockstep",
           "wall_s": wall, "rounds": rounds,
           "audio_s_per_wall_s": seconds / wall}
    if ref is not None:
        ref_wavs, ref_wall, ref_rounds = ref
        rec.update({
            "single_wall_s": ref_wall, "single_rounds": ref_rounds,
            "single_audio_s_per_wall_s": seconds / ref_wall,
            "rel_l2_vs_single": {
                sid: float(np.linalg.norm(wavs[sid] - w)
                           / np.linalg.norm(w))
                for sid, w in ref_wavs.items()}})
    r.emit(rec)
    del tps


def worker(args) -> int:
    from text2speech_tpu_torch.config import HParams, WaveGlowConfig

    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    measures = args.measures.split(",")
    unknown = sorted(set(measures) - set(MEASURES))
    if unknown:
        raise ValueError(f"unknown measures {unknown}; known {MEASURES}")
    r = Rank(args)
    try:
        cfg = WaveGlowConfig(**TINY_WG) if args.tiny else WaveGlowConfig()
        hp = HParams(**TINY_HP) if args.tiny else HParams()
        if r.rank == 0:
            print(json.dumps({"ranks": r.world, "backend": r.backend,
                              "device": str(r.device),
                              "name": torch.cuda.get_device_name(r.device)
                              if r.device.type == "cuda" else "cpu"}),
                  flush=True)
        if "allreduce" in measures:
            measure_allreduce(r, cfg)
        if "waveglow_step" in measures:
            measure_waveglow_step(r, cfg)
        if {"tp_vocode", "infer_long"} & set(measures):
            wg = seeded_waveglow(cfg, r.device)
            if "tp_vocode" in measures:
                measure_tp_vocode(r, wg, cfg, args.tiny)
            if "infer_long" in measures:
                measure_infer_long(r, wg, cfg, args.tiny)
            del wg
        if "gather" in measures:
            measure_gather(r, hp)
        if {"tp_decode", "tp_server"} & set(measures):
            synth = seeded_synthesizer(hp, cfg, r.device,
                                       fused=args.device == "cuda")
            if "tp_decode" in measures:
                measure_tp_decode(r, synth, args.tiny)
            if "tp_server" in measures:
                measure_tp_server(r, synth, args.tiny)
    finally:
        r.pm.destroy_distributed()
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    return worker(args) if args.worker else launch(args)


if __name__ == "__main__":
    sys.exit(main())
