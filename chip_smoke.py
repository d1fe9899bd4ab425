#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which passes or raises (the script then exits non-zero):

1. require CUDA; print the card's name and power limit; turn TF32 off;
2. build the hand-written kernels from ``csrc/`` (the bf16 WN-layer
   library and its Hopper redesign of the standard, final and ``dcond``
   standard layers, the int8 and padded WN-layer libraries, the gated
   activation, the k=3 conv backward and its Hopper redesign, one ``nvcc``
   each, all started together) and print the times, and for the two
   Hopper files the ``HGMMA`` count per kernel and the registers and
   spills ``-Xptxas -v`` reports;
3. compare each of the six projecting kernels with its plain PyTorch version on the
   card at the reference width (C=512, M=640) over batch sizes, dilations,
   valid lengths and flow widths, and the standard and final layers also at
   the edges of their 128-row tile (T and n_valid off the tile grid, a
   halo of a whole tile, batch 3, nothing valid); time both with CUDA
   events at one vocode's shapes and compute the card's bound for the same
   work; time the standard and final layers at batch 1 and 3 beside their
   first design (``wn_block.first_design``), and the two products of the
   standard layer as one library call each;
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
   random weights with ``--fused_vocoder`` and with ``--int8_vocoder``;
8. training kernels: the gated activation's forward and backward kernel
   and the k=3 dilated conv's backward kernel against their plain versions
   (the last also against autograd of ``F.conv1d`` and its first design,
   ``wn_backward.first_design``, two runs bitwise equal) at the training
   shapes and at odd ones, f32 and bf16; times, bounds and the library's
   time, the conv backward beside its first design in turns at d = 1, 8,
   128 in both dtypes;
   then the conv backward's own path, a chain of calls down the WN
   dilation ladder (it is a probe beside the trainer, as in the JAX
   package, and no training step launches it);
9. one WaveGlow training step at full width (12 flows, 8 layers, C=512,
   batch 3 x 16,000 samples) through the gated kernels against the same
   step with the plain gated activation: loss and gradient norm;
10. the trainer through its CLI entry (``waveglow_train.main``) on
    synthetic wavs written from a numpy seed: 12 steps from the real
    initialisation, every loss finite, 96 + 96 gated launches per step, the
    loss on one fixed batch lower than before, a checkpoint; ``python -m
    text2speech_tpu_torch.waveglow_train`` in a process of its own resumes
    from it; ``--remat`` (192 + 96 launches per step), ``--bf16`` and
    ``--grad_accum 3`` each resume and take steps; step rates and peak
    device memory are printed;
11. the trained parameters through ``variables_from_trainable`` ->
    ``load_waveglow`` -> the fused bf16 vocoder of a ``Synthesizer``;
12. the three composed-conditioning (``dcond``) kernels against their plain
    versions at C=512, L=8: batches 1 and 3, every dilation 1..128,
    ``n_valid < T``, the first and the last ``cond_index``, flow widths;
    the standard one (the sm90 kernel) also at the edges of its tile and
    against its first design; times and bounds, the standard one at batch
    1 and 3 beside its first design in turns;
13. the composed vocoder at full width on the main path's mel
    (``precompute_composed_cond`` once, ``infer_fused(composed_cond=...)``):
    12/72/12 launches of the ``dcond`` wrappers and none of the projecting
    ones; audio against its plain path, the in-kernel fused path and the
    f32 vocoder; wall time beside the in-kernel path's at batch 1 and 3;
    peak memory;
14. streaming at full width: ``text_to_mel_stream`` bit-equal to
    ``text_to_mel`` (200 requested steps in chunks of 64, so 256 decoded);
    ``synthesize_incremental`` through the bf16 and the int8 vocoder, with
    and without the denoiser, against the single pass over the final mel
    with the same noise; ``synthesize_incremental_batch`` row by row; time
    to the first chunk and in all;
15. quantized decode: the floating-point ``decode_chunk_serve`` bit-equal
    to ``decode_chunk``, the int8 mel against it, steps per second of both
    at batches 1, 8 and 32;
16. the CLI with ``--stream`` in a process of its own;
17. the two tensor-parallel partial kernels against their plain versions
    at C=512, M=640 for p = 2, 4, 8 ranks: batches 1 and 3, every dilation
    1..128, ``n_valid < T``, ``rs_out`` 2C and C, the layer-0 form (n_half
    2..4 with the edge-bias rows); the sum of the p partials plus the bias
    against the whole layer's plain res/skip product; times and bounds at
    B=1, T=6400 for p = 2 and 4;
18. the tensor-parallel vocoder at full width on the main path's mel, p = 2
    and 4, all shards on the one card, bf16 and int8: 96 p launches of the
    bf16 partial kernel (12 p + 84 p with int8) and none of the whole-layer
    wrappers; audio against the plain TP path, the single-device fused
    vocoders and the f32 vocoder; wall beside the single-device vocode; the
    distributed form on an NCCL group of one rank equal to the local form;
19. the continuous-batching server at full width over the bf16 and the int8
    synthesizer (4 slots, chunks of 64, 400 decoder steps): six requests
    with their own seeds and sigmas, two with the denoiser, three of them
    joining mid-flight; every session against the single pass over its own
    mel and noise; one session alone in a one-slot server against the same
    in the full batch; a second server whose sessions are shorter than one
    window; ``load_weights`` between two sessions; rounds, time to first
    audio, audio seconds per wall second, slot occupancy;
20. the CLI with ``--serve_slots 2 --texts_file`` in a process of its own;
21. the CLI with ``--serve_slots 2 --http_port 0`` in a process of its own:
    two concurrent ``POST /synthesize`` clients, header bytes, PCM length,
    ``/stats``, ``/healthz``, then an interrupt;
22. the four padded-layout kernels (the oracle family, kernels 12-15)
    against their plain versions at B=1, T=6400 (``pad_tiles``: Tp =
    6656), C=512, M=640, E=8 for d = 1, 64, 128 at full and short
    ``n_valid``, pad tiles exactly zero; times and bounds;
23. their own path, the parity ladder across kernels: the unpadded
    standard layer (kernel 2) against the stream kernel (14), the unpadded
    final layer (3) against the stream final (15), the ``dcond`` layer (9)
    against the padded one (12) on the same stacked conditioning, spect
    (13) against stream (14); the padded kernels' launches of this run;
24. Tacotron-2 training at full width on 40 synthetic wavs of 1-2.5 s at
    44.8 kHz with Korean transcripts: one f32 and one bf16 step on the
    card against the f32 step on the CPU (loss, the gradient as a whole
    and, in bf16, each leaf); 4 steps at batch 32 through
    ``tacotron_train.main``, then its warm steps/s, samples/s and peak
    memory; a resume in a process of its own; 2 steps each with
    ``--remat``, ``--bf16`` and ``--grad_accum 2``; the trained checkpoint
    through ``Synthesizer.load_checkpoints(taco_ckpt_dir=)`` into a decode
    and the fused vocoder.  Phases 22-24 print the seconds they take.

Phases 12-21 run between phases 7 and 8, phases 22-24 after phase 11.  The line before the last is a
JSON object with one record per kernel; the last line is ``{"ok": true,
"device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import http.client
import json
import os
import queue
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
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
    "wn_layer": ("wn_block_sm90.cu", PALLAS + "wn_block.py:398"),
    "wn_layer_final": ("wn_block_sm90.cu", PALLAS + "wn_block.py:528"),
    "wn_layer_first_int8": ("wn_block_int8.cu", PALLAS + "wn_block_int8.py:338"),
    "wn_layer_int8": ("wn_block_int8.cu", PALLAS + "wn_block_int8.py:268"),
    "wn_layer_final_int8": ("wn_block_int8.cu", PALLAS + "wn_block_int8.py:510"),
}
# the composed-conditioning flavours (the DCOND instantiations)
DCOND_KERNELS = {
    "wn_layer_first_dcond": ("wn_block.cu", PALLAS + "wn_block_dcond.py:100"),
    "wn_layer_dcond": ("wn_block_sm90.cu", PALLAS + "wn_block_dcond.py:43"),
    "wn_layer_final_dcond": ("wn_block.cu", PALLAS + "wn_block_dcond.py:162"),
}
# the tensor-parallel partial layers (one rank's share of a layer)
PARTIAL_KERNELS = {
    "wn_layer_partial": ("wn_block.cu", PALLAS + "wn_block.py:642"),
    "wn_layer_partial_int8": ("wn_block_int8.cu",
                              PALLAS + "wn_block_int8.py:447"),
}
# the training kernels, same columns
TRAIN_KERNELS = {
    "gated_fwd": ("gated.cu", PALLAS + "gated.py:64"),
    "gated_bwd": ("gated.cu", PALLAS + "gated.py:76"),
    "conv_k3_bwd": ("wn_backward_sm90.cu", PALLAS + "wn_backward.py:83"),
}
CSRC = "text2speech_tpu_torch/csrc/"

# NVIDIA's data sheet for the H100 SXM: dense tensor-core rates, the f32
# rate outside the tensor cores (TF32 is off here) and HBM3
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


def gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def demangled(names) -> dict:
    """Each mangled kernel name -> its C++ name without parameter types, by
    the toolkit's ``cu++filt`` beside ``nvcc``; the names stay mangled
    where the toolkit has none or it fails."""
    from text2speech_tpu_torch.ops.build import find_nvcc

    names = list(dict.fromkeys(names))
    tool = os.path.join(os.path.dirname(find_nvcc()), "cu++filt")
    out = []
    if names and os.path.exists(tool):
        r = subprocess.run([tool, "-p", *names], capture_output=True,
                           text=True, timeout=60)
        out = r.stdout.splitlines() if r.returncode == 0 else []
    if len(out) != len(names):
        out = names
    return dict(zip(names, out))


def hgmma_counts(so) -> str:
    """``HGMMA`` (wgmma) instructions per kernel in a built library's SASS,
    by ``cuobjdump`` beside ``nvcc``; "no cuobjdump" where the toolkit has
    none."""
    from text2speech_tpu_torch.ops.build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return "no cuobjdump"
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    names = demangled(counts)
    counts = {names[n]: c for n, c in counts.items()}
    return f"{sum(counts.values())} HGMMA instructions; per kernel: {counts}"


def ptxas_registers(log: str) -> str:
    """Registers and spill bytes per kernel from a build's ``-Xptxas -v``
    output."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (f", spills {m.group(1)}/{m.group(2)} B" if m.group(1)
                     != "0" or m.group(2) != "0" else "")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, f"{m.group(1)}{spill}"))
            name, spill = None, ""
    names = demangled(n for n, _ in out)
    return "; ".join(f"{names[n]}: {regs}" for n, regs in out)


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

    def check_pair(name, args, nv, tag, skip_rows=None):
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
            rows = nv if skip_rows is None else skip_rows
            note(name, compare(tag + " x", got[0], want[0]))
            note(name, compare(tag + " skip", got[1][:, :rows],
                               want[1][:, :rows]))

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

    # the edges of the sm90 kernels' 128-row tile: T and n_valid off the
    # tile grid, a halo of a whole tile (d=128), batch 3, nothing valid, a
    # grid of 128-row tiles that fills the card; the skip sum on every row
    # (rows past n_valid too are computed alike)
    for B, T, nv in ((1, 1000, 937), (1, 1000, 128), (1, 1000, 129),
                     (3, 1000, 1000), (3, 777, 700), (2, 1000, 0),
                     (3, 6450, 6401)):   # the last: 128-row tiles
        shape = f"edge B={B} T={T} n_valid={nv}"
        for d in (1, 128):
            seed += 1
            k = layer_inputs(B, T, nv, C, M, seed, dev)
            check_pair("wn_layer", layer_args(k, d)["wn_layer"], nv,
                       f"{shape} d={d}", skip_rows=T)
            seed += 1
            k = layer_inputs(B, T, nv, C, M, seed, dev, E=8)
            check_pair("wn_layer_final", layer_args(k, d)["wn_layer_final"],
                       nv, f"{shape} d={d} E=8")

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

    time_beside_first_design(rec, C, M)

    # yardsticks of the tensor-core rates: the standard layer's two
    # products (in-act, res/skip) as one library call each, at batch 1 and
    # 3, and its in-act product in s8 (the port calls none of them)
    a8 = torch.randint(-127, 128, (T, C), dtype=torch.int8, device=dev)
    b8 = torch.randint(-127, 128, (C, 2 * C), dtype=torch.int8, device=dev)
    print(f"[yardstick] torch._int_mm [{T},{C}]x[{C},{2 * C}] s8: "
          f"{time_ms(lambda: torch._int_mm(a8, b8)):.4f} ms")
    for rows in (T, 3 * T):
        for K in (3 * C + M, C):
            a16 = torch.randn(rows, K, device=dev, dtype=torch.bfloat16)
            b16 = torch.randn(K, 2 * C, device=dev, dtype=torch.bfloat16)
            print(f"[yardstick] torch.matmul [{rows},{K}]x[{K},{2 * C}] "
                  f"bf16: {time_ms(lambda: a16 @ b16):.4f} ms")
    return rec


def time_beside_first_design(rec: dict, C: int, M: int) -> None:
    """The sm90 standard and final layers and their first design on the
    same inputs at one vocode's shapes, batch 1 and 3 x 6400 groups, timed
    in turns (first, sm90, sm90, first); the two agree within the kernel
    bounds.  Adds ``prev_ms`` (the first design at batch 1), ``ms_b3`` and
    ``prev_ms_b3`` to the two rows of ``rec``."""
    from text2speech_tpu_torch.ops import wn_block as wb

    dev = torch.device("cuda")
    T = 6400
    for B in (1, 3):
        runs = {
            "wn_layer": layer_args(layer_inputs(B, T, T, C, M, 96, dev),
                                   64)["wn_layer"],
            "wn_layer_final": layer_args(layer_inputs(
                B, T, T, C, M, 95, dev, E=8), 128)["wn_layer_final"],
        }
        for name, args in runs.items():
            kern = getattr(wb, name)
            if name == "wn_layer":
                got = call_std(kern, args, T)
                want = call_std(lambda *a, n_valid: wb.first_design(
                    name, *a, n_valid=n_valid), args, T)
                compare(f"{name} sm90 vs first design B={B} x", got[0],
                        want[0])
                compare(f"{name} sm90 vs first design B={B} skip", got[1],
                        want[1])
            else:
                compare(f"{name} sm90 vs first design B={B}", kern(*args),
                        wb.first_design(name, *args))
            outs = kern(*args)
            outs = outs if isinstance(outs, tuple) else (outs,)
            tensors = [t for t in (*args, *outs) if torch.is_tensor(t)]
            bound, by = bound_ms(work(name, B, T, C, M), tensors)
            first, sm90 = [], []
            for fn, acc in ((lambda: wb.first_design(name, *args), first),
                            (lambda: kern(*args), sm90),
                            (lambda: kern(*args), sm90),
                            (lambda: wb.first_design(name, *args), first)):
                acc.append(time_ms(fn))
            ms, prev = sum(sm90) / 2, sum(first) / 2
            plan = wb.sm90_plan(C, T, B)
            blocks = plan["grid"][0] * plan["grid"][1]
            smem = wb.LIB_SM90.get().t2s_wn_sm90_smem_bytes(
                plan["nwg"], plan["bk"], C, plan["stages"])
            if smem != plan["smem"]:
                raise RuntimeError(f"sm90 plan: {plan['smem']} B of shared "
                                   f"memory, the kernel asks {smem}")
            print(f"  {name} B={B} T={T}: sm90 {sm90[0]:.4f} / {sm90[1]:.4f}"
                  f" ms ({bound / ms:.1%} of the {bound:.4f} ms bound by "
                  f"{by}), first design {first[0]:.4f} / {first[1]:.4f} ms "
                  f"({bound / prev:.1%}); sm90 tile {plan['bm']} rows, "
                  f"{plan['stages']} stages of K={plan['bk']}, "
                  f"{plan['smem']} B shared, {blocks} blocks = "
                  f"{blocks / wb.SM90_SMS:.2f} per SM (1 resident); first design "
                  f"{-(-T // 64) * B} blocks")
            if B == 1:
                rec[name]["prev_ms"] = prev
            else:
                rec[name]["ms_b3"], rec[name]["prev_ms_b3"] = ms, prev


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
    """Launch counts of the serving kernels and the gated activation (the
    conv backward keeps its own, read on its own path)."""
    from text2speech_tpu_torch.ops import gated
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_dcond as wd
    from text2speech_tpu_torch.ops import wn_block_int8 as wq

    return {**wb.launch_counts(), **wq.launch_counts(),
            **wd.launch_counts(), **gated.launch_counts()}


def reset_counts() -> None:
    from text2speech_tpu_torch.ops import gated
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_dcond as wd
    from text2speech_tpu_torch.ops import wn_block_int8 as wq

    from text2speech_tpu_torch.parallel import tp

    wb.reset_launch_counts()
    wq.reset_launch_counts()
    wd.reset_launch_counts()
    gated.reset_launch_counts()
    tp.reset_launch_counts()


def want_counts(wg_cfg, int8: bool, dcond: bool = False) -> dict:
    """Launches of one vocode: 1 / L - 2 / 1 per flow of the path's own
    wrappers, none of the other families'."""
    per = (wg_cfg.n_flows, wg_cfg.n_flows * (wg_cfg.wn_n_layers - 2),
           wg_cfg.n_flows)
    names = [*KERNELS, *DCOND_KERNELS]
    first = 6 if dcond else 3 if int8 else 0
    mine = names[first: first + 3]
    return {**dict.fromkeys(names, 0), **dict(zip(mine, per)),
            "gated_fwd": 0, "gated_bwd": 0}


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


# ---------------------------------------------------------------------------
# the composed-conditioning vocoder: kernels 9-11 and their path
# ---------------------------------------------------------------------------

# Composed path against f32 WaveGlow.infer: cond_all is rounded to bf16 once
# more than the in-kernel projection's f32 sums, so allow three times the
# in-kernel path's distance, and no less than 2e-2.
COMPOSED_REL32_FACTOR = 3.0
COMPOSED_REL32_FLOOR = 2e-2


def dcond_args(k: dict, cond_all: torch.Tensor, li: int, d: int) -> dict:
    """One layer's inputs -> the argument tuple of its role's dcond wrapper
    (the same tuple goes to the plain version), folds done here."""
    from text2speech_tpu_torch.ops import wn_block as wb

    if "x0" in k:
        fold = wb.fold_first_taps(k["start_k"], k["start_b"], k["w_in"],
                                  k["b_in"])
        return {"wn_layer_first_dcond": (
            k["x0"], cond_all, k["start_k"], k["start_b"], *fold, k["w_rs"],
            k["b_rs"], d)}
    if "w_end" in k:
        w_eff, b_eff = wb.fold_end(k["w_rs"], k["b_rs"], k["w_end"],
                                   k["b_end"])
        return {"wn_layer_final_dcond": (
            k["x"], cond_all, li, k["w_in"], k["b_in"], w_eff, k["skip_acc"],
            k["w_end"], b_eff, d)}
    return {"wn_layer_dcond": (k["x"], cond_all, li, k["w_in"], k["b_in"],
                               k["w_rs"], k["b_rs"], k["skip_acc"], d)}


def check_dcond_kernels(C: int = 512, L: int = 8) -> dict:
    """Phase 12: kernels 9-11 against their plain versions at reference
    width, then kernel and plain times and the card's bound at one
    main-path shape (B=1, T=6400, cond_all [1, 6400, 8192])."""
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_dcond as wd

    fns = {n: (getattr(wd, n), getattr(wd, n + "_plain"))
           for n in DCOND_KERNELS}
    dev = torch.device("cuda")
    rec = {n: {"max_abs_err": 0.0} for n in DCOND_KERNELS}

    def note(name, err):
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)

    def cond_for(B, T, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(B, T, 2 * C * L, generator=g).to(
            dev, torch.bfloat16)

    def check_pair(name, args, nv, tag):
        kern, plain = fns[name]
        std = name == "wn_layer_dcond"
        got = call_std(kern, args, nv) if std else kern(*args, n_valid=nv)
        want = call_std(plain, args, nv) if std else plain(*args, n_valid=nv)
        tag = f"{name} {tag}"
        r = rec[name]
        if name == "wn_layer_final_dcond":
            r["max_abs_err"] = max(r["max_abs_err"], compare(tag, got, want))
            return
        if got[0][:, nv:].any():
            raise RuntimeError(f"{tag}: rows past n_valid are not zero")
        r["max_abs_err"] = max(
            r["max_abs_err"], compare(tag + " x", got[0], want[0]),
            compare(tag + " skip", got[1][:, :nv], want[1][:, :nv]))

    seed = 500
    for B, T, nv in ((1, 1000, 937), (3, 777, 700)):
        shape = f"B={B} T={T} n_valid={nv}"
        cond_all = cond_for(B, T, seed)
        for n_half in (2, 3, 4):
            seed += 1
            k = layer_inputs(B, T, nv, C, 64, seed, dev, n_half=n_half)
            for name, args in dcond_args(k, cond_all, 0, 1).items():
                check_pair(name, args, nv, f"{shape} n_half={n_half}")
        for i in range(8):
            d = 2 ** i
            seed += 1
            k = layer_inputs(B, T, nv, C, 64, seed, dev)
            if i % 3 == 2:      # a skip-only layer
                k["w_rs"] = k["w_rs"][:, :C].contiguous()
                k["b_rs"] = k["b_rs"][:C].contiguous()
            for li in (0, L - 1) if i % 2 else (L - 1, 3):
                for name, args in dcond_args(k, cond_all, li, d).items():
                    check_pair(name, args, nv, f"{shape} d={d} li={li} "
                               f"rs_out={k['w_rs'].shape[1]}")
            seed += 1
            k = layer_inputs(B, T, nv, C, 64, seed, dev, E=(4, 6, 8)[i % 3])
            li = (0, L - 1)[i % 2]
            for name, args in dcond_args(k, cond_all, li, d).items():
                check_pair(name, args, nv, f"{shape} d={d} li={li} "
                           f"E={k['w_end'].shape[1]}")

    # the sm90 standard layer at the edges of its tile (as phase 3 does
    # for the in-kernel projection: T and n_valid off the tile grid, a halo
    # of a whole tile, batch 3, nothing valid, 128-row tiles) against its
    # plain version and its first design, the skip sum on every row
    for B, T, nv in ((1, 1000, 129), (3, 777, 700), (2, 1000, 0),
                     (3, 6450, 6401)):
        cond_all = cond_for(B, T, seed)
        for d, li, rs_full in ((1, 0, True), (128, L - 1, False)):
            seed += 1
            k = layer_inputs(B, T, nv, C, 64, seed, dev)
            if not rs_full:
                k["w_rs"] = k["w_rs"][:, :C].contiguous()
                k["b_rs"] = k["b_rs"][:C].contiguous()
            args = dcond_args(k, cond_all, li, d)["wn_layer_dcond"]
            got = call_std(wd.wn_layer_dcond, args, nv)
            tag = (f"wn_layer_dcond edge B={B} T={T} n_valid={nv} d={d} "
                   f"li={li} rs_out={k['w_rs'].shape[1]}")
            for ref, want in (
                    ("plain", call_std(wd.wn_layer_dcond_plain, args, nv)),
                    ("first design", call_std(
                        lambda *a, n_valid: wb.first_design(
                            "wn_layer_dcond", *a, n_valid=n_valid),
                        args, nv))):
                if got[0][:, nv:].any() or want[0][:, nv:].any():
                    raise RuntimeError(f"{tag}: rows past n_valid are not "
                                       f"zero")
                if nv:
                    err = compare(f"{tag} vs {ref} x", got[0], want[0])
                    if ref == "plain":
                        note("wn_layer_dcond", err)
                err = compare(f"{tag} vs {ref} skip", got[1], want[1])
                if ref == "plain":
                    note("wn_layer_dcond", err)

    B, T = 1, 6400
    cond_all = cond_for(B, T, 77)
    timed = {}
    timed.update(dcond_args(
        layer_inputs(B, T, T, C, 64, 96, dev, n_half=4), cond_all, 0, 1))
    timed.update(dcond_args(layer_inputs(B, T, T, C, 64, 95, dev), cond_all,
                            3, 64))
    timed.update(dcond_args(layer_inputs(B, T, T, C, 64, 94, dev, E=8),
                            cond_all, L - 1, 128))
    bt = 2 * B * T
    taps, rs = bt * 3 * C * 2 * C, bt * C * 2 * C
    ops = {"wn_layer_first_dcond": bt * 3 * 4 * 2 * C + bt * 4 * C + rs,
           "wn_layer_dcond": taps + rs,
           "wn_layer_final_dcond": taps + 2 * bt * C * 8}
    for name in DCOND_KERNELS:
        kern, plain = fns[name]
        args = timed[name]
        outs = kern(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        # the function reads its 2C-wide slice of cond_all, not all of it
        tensors = [t[..., : 2 * C] if t is cond_all else t
                   for t in (*args, *outs) if torch.is_tensor(t)]
        r = rec[name]
        r["bound_ms"], r["bound_by"] = bound_ms({"bf16": ops[name]}, tensors)
        r["ms"] = time_ms(lambda: kern(*args))
        r["plain_ms"] = time_ms(lambda: plain(*args))
        print(f"  {name} B={B} T={T}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (by "
              f"{r['bound_by']})")
    time_dcond_beside_first_design(rec["wn_layer_dcond"], C, L)
    return rec


def time_dcond_beside_first_design(r: dict, C: int, L: int) -> None:
    """The sm90 dcond standard layer and its first design on the same
    inputs at the composed vocode's shapes, batch 1 and 3 x 6400 groups,
    timed in turns (first, sm90, sm90, first); the two agree within the
    kernel bounds.  Adds ``prev_ms`` (the first design at batch 1),
    ``ms_b3`` and ``prev_ms_b3`` to the row ``r``."""
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_dcond as wd

    dev = torch.device("cuda")
    T = 6400
    for B in (1, 3):
        g = torch.Generator().manual_seed(78 + B)
        cond_all = torch.randn(B, T, 2 * C * L, generator=g).to(
            dev, torch.bfloat16)
        args = dcond_args(layer_inputs(B, T, T, C, 64, 93, dev), cond_all,
                          3, 64)["wn_layer_dcond"]

        def first(*a, n_valid=None):
            return wb.first_design("wn_layer_dcond", *a, n_valid=n_valid)

        got = call_std(wd.wn_layer_dcond, args, T)
        want = call_std(first, args, T)
        compare(f"wn_layer_dcond sm90 vs first design B={B} x", got[0],
                want[0])
        compare(f"wn_layer_dcond sm90 vs first design B={B} skip", got[1],
                want[1])
        x_out = got[0]
        bt = 2 * B * T
        bound, by = bound_ms(
            {"bf16": bt * 3 * C * 2 * C + bt * C * 2 * C},
            [t[..., 3 * 2 * C: 4 * 2 * C] if t is cond_all else t
             for t in (*args, x_out, args[-2]) if torch.is_tensor(t)])
        firsts, sm90 = [], []
        for fn, acc in ((lambda: first(*args), firsts),
                        (lambda: wd.wn_layer_dcond(*args), sm90),
                        (lambda: wd.wn_layer_dcond(*args), sm90),
                        (lambda: first(*args), firsts)):
            acc.append(time_ms(fn))
        ms, prev = sum(sm90) / 2, sum(firsts) / 2
        plan = wb.sm90_plan(C, T, B)
        blocks = plan["grid"][0] * plan["grid"][1]
        print(f"  wn_layer_dcond B={B} T={T}: sm90 {sm90[0]:.4f} / "
              f"{sm90[1]:.4f} ms ({bound / ms:.1%} of the {bound:.4f} ms "
              f"bound by {by}), first design {firsts[0]:.4f} / "
              f"{firsts[1]:.4f} ms ({bound / prev:.1%}); sm90 tile "
              f"{plan['bm']} rows, {plan['stages']} stages of K={plan['bk']}"
              f" ({3 * C // plan['bk']} per gate-pair chunk), "
              f"{plan['smem']} B shared, {blocks} blocks")
        if B == 1:
            r["prev_ms"] = prev
        else:
            r["ms_b3"], r["prev_ms_b3"] = ms, prev


def composed_path(synth, mel: torch.Tensor, rel32_bf16: float) -> dict:
    """Phase 13: the composed-conditioning vocoder at full width on the
    main path's mel.  Returns the dcond launch counts of its run."""
    from text2speech_tpu_torch.models.waveglow_fused import (
        infer_fused, precompute_composed_cond)

    cfg, fw = synth.wg_cfg, synth.fused
    B, _, T = mel.shape
    Tg = T * cfg.upsample_stride // cfg.n_group
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cc, t_pre = sync_time(lambda: precompute_composed_cond(synth.waveglow))
    held = torch.cuda.memory_allocated() - base
    Wc, b_eff = cc[0]
    print(f"[composed] precompute_composed_cond: {len(cc)} flows, Wc "
          f"{tuple(Wc.shape)} {str(Wc.dtype)[6:]}, b_eff "
          f"{tuple(b_eff.shape)}, {held / 1e9:.3f} GB held, {t_pre:.2f} s")

    reset_counts()
    audio, t_main = sync_time(lambda: infer_fused(
        fw, mel, SIGMA, composed_cond=cc,
        generator=torch.Generator(device="cuda").manual_seed(1)))
    launches = all_counts()
    print(f"[composed] infer_fused(composed_cond=...) batch {B} x {T} "
          f"frames in {t_main * 1e3:.3f} ms (first call); launches "
          f"{launches}")
    if launches != want_counts(cfg, False, dcond=True):
        raise RuntimeError(f"composed launch counts {launches}, want "
                           f"{want_counts(cfg, False, dcond=True)}")
    if tuple(audio.shape) != (B, T * cfg.upsample_stride) or \
            not torch.isfinite(audio).all() or audio.std().item() < 1e-4:
        raise RuntimeError(f"composed audio {tuple(audio.shape)}: wrong "
                           f"shape, not finite or silent")

    gen = torch.Generator(device="cuda").manual_seed(123)
    noise = tuple(torch.randn(s, generator=gen, device="cuda")
                  for s in fw.noise_shapes(B, Tg))
    with torch.inference_mode():
        got = infer_fused(fw, mel, SIGMA, noise=noise, composed_cond=cc)
        plain = infer_fused(fw, mel, SIGMA, noise=noise, composed_cond=cc,
                            plain=True)
        inkernel = infer_fused(fw, mel, SIGMA, noise=noise)
        exact = synth.waveglow.infer(mel, SIGMA, noise=noise)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    peak = plain.abs().max().item()
    err_p, err_k = ((got - plain).abs().max().item(),
                    (got - inkernel).abs().max().item())
    rel_p, rel_k, rel32 = rel(got, plain), rel(got, inkernel), rel(got, exact)
    bound32 = max(COMPOSED_REL32_FACTOR * rel32_bf16, COMPOSED_REL32_FLOOR)
    print(f"[composed] kernels vs plain dcond layers: max_abs_err="
          f"{err_p:.6g} (bound {E2E_MAX_ABS_STEPS * peak:.4g}) rel_l2="
          f"{rel_p:.4g} (bound {E2E_REL_L2}); vs the in-kernel fused path: "
          f"max_abs_err={err_k:.6g} rel_l2={rel_k:.4g} (same bounds); vs "
          f"plain f32 WaveGlow.infer: rel_l2={rel32:.4g} (bound max("
          f"{COMPOSED_REL32_FACTOR:g} x {rel32_bf16:.4g}, "
          f"{COMPOSED_REL32_FLOOR}) = {bound32:.4g})")
    if not torch.isfinite(got).all():
        raise RuntimeError("composed: non-finite audio")
    if max(err_p, err_k) > E2E_MAX_ABS_STEPS * peak or \
            max(rel_p, rel_k) > E2E_REL_L2 or rel32 > bound32:
        raise RuntimeError("composed vocoder disagrees with its plain path, "
                           "the in-kernel path or the f32 vocoder")

    # wall time and peak memory beside the in-kernel path's, warm, in turns
    for b in (1, B):
        m = mel[:b].contiguous()
        nz = tuple(z[:b].contiguous() for z in noise)
        runs = {"in-kernel": lambda: infer_fused(fw, m, SIGMA, noise=nz),
                "composed": lambda: infer_fused(fw, m, SIGMA, noise=nz,
                                                composed_cond=cc)}
        times = {k: [] for k in runs}
        peaks = {}
        with torch.inference_mode():
            for name in ("in-kernel", "composed", "composed", "in-kernel",
                         "in-kernel", "composed"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                _, t = sync_time(runs[name])
                times[name].append(t * 1e3)
                peaks[name] = torch.cuda.max_memory_allocated() - before
        print(f"[composed] vocode batch {b} x {T} frames, wall ms: in-kernel "
              f"{[round(t, 3) for t in times['in-kernel']]}, composed "
              f"{[round(t, 3) for t in times['composed']]}; peak memory above "
              f"the resident weights: in-kernel {peaks['in-kernel'] / 1e9:.3f}"
              f" GB, composed {peaks['composed'] / 1e9:.3f} GB (+ "
              f"{held / 1e9:.3f} GB of Wc resident)")
    del cc
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# streaming synthesis and the quantized decode
# ---------------------------------------------------------------------------

STREAM_CHUNK = 64
# Streamed mel against text_to_mel after the postnet: the decode is equal bit
# for bit; the postnet's five convs run on windows of other lengths, where
# the library may sum in another order.  The JAX package's own bound for the
# pair (tests/test_streaming.py:41).
STREAM_MEL_ATOL = 2e-5
# int8 decode against the floating-point decode over 64 steps on random
# weights: the JAX package's own bound for the pair
# (tests/test_quantized_decode.py:98-100), mean |diff| under 0.2 of mean |mel|
INT8_DECODE_REL_MEAN = 0.2


def stream_reference(synth, texts, seed, max_steps):
    """Replay the chunked mel stream and draw the engine's noise stream
    (one draw per emitted mel chunk from a generator seeded ``seed + 1``)
    -> (final mel [B, n_mel, F], noise tuple [B, F * gpf, .], true_len)."""
    from text2speech_tpu_torch.models.chunked import draw_noise

    cfg = synth.wg_cfg
    gpf = cfg.upsample_stride // cfg.n_group
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    mels, noise, lens = [], None, None
    for mel_c, out_len, _final in synth.text_to_mel_stream(
            texts, chunk_steps=STREAM_CHUNK, seed=seed, max_steps=max_steps):
        mels.append(mel_c)
        nz = draw_noise(cfg, gen, mel_c.shape[0], mel_c.shape[-1] * gpf)
        noise = (list(nz) if noise is None
                 else [torch.cat([a, z], 1) for a, z in zip(noise, nz)])
        lens = out_len
    mel = torch.cat(mels, dim=-1)
    return mel, noise, np.minimum(lens, mel.shape[-1])


def check_stream_audio(tag, got: np.ndarray, want: torch.Tensor, int8: bool):
    """Streamed audio against the single pass over the final mel with the
    same noise: the windows are other batch shapes to the library matmuls
    around the kernels, so the path's own end-to-end bounds hold."""
    want = want.cpu().numpy()
    steps, rel_bound = ((E2E_INT8_MAX_ABS_STEPS, E2E_INT8_REL_L2) if int8
                        else (E2E_MAX_ABS_STEPS, E2E_REL_L2))
    if got.shape != want.shape:
        raise RuntimeError(f"{tag}: {got.shape} samples, want {want.shape}")
    err = np.abs(got - want).max()
    peak = np.abs(want).max()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"[stream] {tag}: {got.shape[0]} samples, max_abs_err={err:.6g} "
          f"(bound {steps * peak:.4g}) rel_l2={rel:.4g} (bound {rel_bound})")
    if not np.isfinite(got).all() or err > steps * peak or rel > rel_bound:
        raise RuntimeError(f"{tag}: streamed audio disagrees with the single "
                           f"pass")


def streaming(synth, tag: str, int8: bool) -> None:
    """Phase 14 for one vocoder."""
    cfg = synth.wg_cfg
    hop = cfg.upsample_stride
    gpf = hop // cfg.n_group
    seed = 0
    if not int8:
        mel_ref, len_ref = synth.text_to_mel(TEXTS, seed=seed,
                                             max_steps=MAX_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks, lens = [], None
        for mel_c, lens, _final in synth.text_to_mel_stream(
                TEXTS, chunk_steps=STREAM_CHUNK, seed=seed,
                max_steps=MAX_STEPS):
            chunks.append(mel_c)
        torch.cuda.synchronize()
        t_stream = time.perf_counter() - t0
        mel_s = torch.cat(chunks, dim=-1)
        limit = -(-MAX_STEPS // STREAM_CHUNK) * STREAM_CHUNK
        valid = [int(n) for n in len_ref.tolist()]
        diff = max((mel_s[b, :, :n] - mel_ref[b, :, :n]).abs().max().item()
                   for b, n in enumerate(valid))
        equal = all(torch.equal(mel_s[b, :, :n], mel_ref[b, :, :n])
                    for b, n in enumerate(valid))
        print(f"[stream] text_to_mel_stream ({MAX_STEPS} requested steps in "
              f"chunks of {STREAM_CHUNK}: {limit} decoded) in {t_stream:.3f} "
              f"s, {len(chunks)} emissions, lengths {lens.tolist()} vs "
              f"{valid}; against text_to_mel on the valid frames: bit-equal "
              f"{equal}, max_abs_err={diff:.3g} (bound {STREAM_MEL_ATOL}: "
              f"the postnet's convs run on windows of other lengths)")
        if diff > STREAM_MEL_ATOL or lens.tolist() != valid or \
                mel_s.shape[-1] != MAX_STEPS:
            raise RuntimeError("the mel stream differs from text_to_mel")

        # the decode itself, before the postnet: bit for bit, with masks
        # drawn for 256 steps against masks drawn for 200
        from text2speech_tpu_torch.text import encode_batch

        taco = synth.taco
        ids, lengths = encode_batch(TEXTS)
        lengths = torch.from_numpy(lengths).cuda()
        with torch.inference_mode():
            memory = taco.encode(torch.from_numpy(ids).long().cuda(),
                                 text_lengths=lengths)
            whole = taco.decoder.autoregressive(
                memory, lengths, MAX_STEPS, generator=synth._generator(seed))
            masks = taco.decoder.draw_keep_masks(
                limit, len(TEXTS), synth._generator(seed), "cuda")
            carry, parts = taco.decoder.initial_carry(memory), []
            for i in range(0, limit, STREAM_CHUNK):
                carry, *outs = taco.decode_chunk(
                    memory, *carry, masks[i: i + STREAM_CHUNK], lengths)
                parts.append(outs)
        names = ("mel", "gate", "align")
        same = {n: torch.equal(
            torch.cat([p[j] for p in parts], dim=2 if j == 0 else 1)
            .narrow(2 if j == 0 else 1, 0, MAX_STEPS), whole[j].float())
            for j, n in enumerate(names)}
        print(f"[stream] chunked decode ({limit} steps, masks drawn for "
              f"{limit}) against the batch decode ({MAX_STEPS} steps, masks "
              f"drawn for {MAX_STEPS}), bit for bit: {same}")
        if not all(same.values()):
            raise RuntimeError("chunked decode differs from the batch decode")

    mel, noise, tl = stream_reference(synth, TEXTS[0], seed, MAX_STEPS)
    n = int(tl[0])
    nz = tuple(z[:, : n * gpf] for z in noise)
    for strength in (0.0, DENOISER_STRENGTH):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts, t_first = [], None
        for chunk in synth.synthesize_incremental(
                TEXTS[0], sigma=SIGMA, seed=seed, chunk_steps=STREAM_CHUNK,
                max_steps=MAX_STEPS, denoiser_strength=strength):
            if t_first is None:
                t_first = time.perf_counter() - t0
            parts.append(chunk)
        t_all = time.perf_counter() - t0
        counts = {k: v for k, v in all_counts().items() if v}
        want = synth.mel_to_audio(mel[:, :, :n].contiguous(), SIGMA,
                                  noise=nz, denoiser_strength=strength)[0]
        print(f"[stream] {tag} synthesize_incremental denoiser={strength}: "
              f"{len(parts)} chunks {[len(p) for p in parts]}, first after "
              f"{t_first:.3f} s, all after {t_all:.3f} s; launches {counts}")
        check_stream_audio(f"{tag} incremental denoiser={strength}",
                           np.concatenate(parts), want, int8)

    mel, noise, tl = stream_reference(synth, TEXTS, seed, MAX_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, t_first = {r: [] for r in range(len(TEXTS))}, None
    for r, chunk in synth.synthesize_incremental_batch(
            TEXTS, sigma=SIGMA, seed=seed, chunk_steps=STREAM_CHUNK,
            max_steps=MAX_STEPS):
        if t_first is None:
            t_first = time.perf_counter() - t0
        rows[r].append(chunk)
    t_all = time.perf_counter() - t0
    print(f"[stream] {tag} synthesize_incremental_batch x {len(TEXTS)}: "
          f"first chunk after {t_first:.3f} s, all after {t_all:.3f} s")
    for r in rows:
        n = int(tl[r])
        want = synth.mel_to_audio(
            mel[r: r + 1, :, :n].contiguous(), SIGMA,
            noise=tuple(z[r: r + 1, : n * gpf] for z in noise))[0]
        check_stream_audio(f"{tag} batch row {r}", np.concatenate(rows[r]),
                           want, int8)


def quantized_decode(synth) -> None:
    """Phase 15: ``decode_chunk_serve`` in floating point against
    ``Tacotron2.decode_chunk`` (bit for bit), in int8 against floating
    point, and the steps per second of both at batches 1, 8 and 32."""
    from text2speech_tpu_torch.models import tacotron_serve as ts
    from text2speech_tpu_torch.text import encode_batch

    taco, hp = synth.taco, synth.hp
    dp = ts.extract_decoder_params(taco)
    dpq = ts.quantize_decoder_params(dp)
    quantized = sorted(k for k, v in dpq.items() if isinstance(v, dict))
    print(f"[qdecode] int8 kernels: {quantized}")
    if quantized != ["att_hh_w", "att_ih_w", "dec_hh_w", "dec_ih_w"]:
        raise RuntimeError("expected the four LSTM kernels to be quantized")
    steps = STREAM_CHUNK
    rates = {}
    with torch.inference_mode():
        for B in (1, 8, 32):
            texts = [TEXTS[i % len(TEXTS)] for i in range(B)]
            ids, lengths = encode_batch(texts)
            lengths = torch.from_numpy(lengths).cuda()
            memory = taco.encode(torch.from_numpy(ids).long().cuda(),
                                 text_lengths=lengths)
            pmem = taco.process_memory(memory)
            carry = taco.decoder.initial_carry(memory)
            masks = taco.decoder.draw_keep_masks(
                steps, B, torch.Generator(device="cuda").manual_seed(B),
                "cuda")
            runs = {
                "module": lambda: taco.decode_chunk(memory, *carry, masks,
                                                    lengths),
                "fp": lambda: ts.decode_chunk_serve(
                    dp, hp, memory, pmem, *carry, masks, lengths),
                "int8": lambda: ts.decode_chunk_serve(
                    dpq, hp, memory, pmem, *carry, masks, lengths)}
            out = {k: fn() for k, fn in runs.items()}     # also the warm-up
            (st_m, fr_m, fin_m), mel_m, gate_m, align_m, act_m = out["module"]
            (st_f, fr_f, fin_f), mel_f, gate_f, align_f, act_f = out["fp"]
            same = (torch.equal(mel_m, mel_f) and torch.equal(gate_m, gate_f)
                    and torch.equal(align_m, align_f)
                    and torch.equal(act_m, act_f)
                    and torch.equal(fin_m, fin_f)
                    and all(torch.equal(a, b) for a, b in zip(st_m, st_f)))
            mel_q = out["int8"][1]
            err = ((mel_q - mel_f).abs().mean()
                   / (mel_f.abs().mean() + 1e-6)).item()
            times = {k: [] for k in runs}
            for name in ("fp", "int8", "module", "int8", "fp", "module"):
                _, t = sync_time(runs[name])
                times[name].append(steps / t)
            rates[B] = {k: max(v) for k, v in times.items()}
            print(f"[qdecode] batch {B}, {steps} steps: fp serve bit-equal "
                  f"to decode_chunk: {same}; int8 mel vs fp mean |diff| / "
                  f"mean |mel| = {err:.4g} (bound {INT8_DECODE_REL_MEAN}); "
                  f"steps/s (two runs each): module "
                  f"{[round(v, 1) for v in times['module']]}, fp serve "
                  f"{[round(v, 1) for v in times['fp']]}, int8 serve "
                  f"{[round(v, 1) for v in times['int8']]}")
            if not same:
                raise RuntimeError("fp decode_chunk_serve differs from "
                                   "decode_chunk")
            if not torch.isfinite(mel_q).all() or err > INT8_DECODE_REL_MEAN:
                raise RuntimeError("int8 decode too far from floating point")
    wins = [B for B, r in rates.items() if r["int8"] > r["fp"]]
    print(f"[qdecode] int8 / fp steps/s (best of two): "
          f"{ {B: round(r['int8'] / r['fp'], 3) for B, r in rates.items()} }"
          f"; int8 faster at batches {wins}; the port's threshold "
          f"INT8_DECODE_MIN_BATCH = {ts.INT8_DECODE_MIN_BATCH}")


def cli_stream() -> None:
    """Phase 16: the CLI with --stream writes a WAV on the card."""
    from scipy.io import wavfile

    with tempfile.TemporaryDirectory() as d:
        out = f"{d}/stream.wav"
        cmd = [sys.executable, "-m", "text2speech_tpu_torch.inference",
               "--random_init", "0", "--int8_vocoder", "-d", "0.1",
               "--stream", "--stream_chunk_steps", "32", "--max_steps", "150",
               "--out", out]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        print(f"[cli] {' '.join(cmd[1:])} -> rc {r.returncode}: "
              f"{' | '.join(r.stdout.strip().splitlines())}")
        if r.returncode != 0:
            raise RuntimeError(f"CLI --stream failed:\n{r.stderr}")
        sr, data = wavfile.read(out)
        if data.dtype != np.int16 or data.shape[0] < 100 * 256:
            raise RuntimeError(f"CLI --stream wrote {data.shape} {data.dtype}")


# ---------------------------------------------------------------------------
# the tensor-parallel vocoder: kernels 4 and 8 and their path
# ---------------------------------------------------------------------------

# int8 partial against its plain version: the integer products are exact on
# both sides; a gated value on a rounding knife edge may land one count
# apart, which moves an output by at most that column's weight scale.  The
# f32 partial is held to the final int8 layer's bound and to the bf16
# kernels' relative L2.
INT8_PARTIAL_ATOL = INT8_FINAL_ATOL
# TP audio against f32: the hidden state and the skip sum stay f32 between
# the layers, so the bf16 TP path is held to the fused path's own distance
# from f32 (3 x, at least 2e-2, as the composed path); the int8 TP path to
# the JAX package's band for int8 against f32 (5 x the bf16 distance, at
# least 0.05).
TP_REL32_FACTOR, TP_REL32_FLOOR = 3.0, 2e-2
TP_INT8_REL32_FACTOR, TP_INT8_REL32_FLOOR = 5.0, 0.05


def rank_share(k: dict, p: int, i: int, int8: bool) -> tuple:
    """Rank i's weights of a whole layer's inputs ``k`` as the partial
    wrapper takes them (after x/spect, before the dilation)."""
    from text2speech_tpu_torch.ops import wn_block_int8 as wq
    from text2speech_tpu_torch.parallel.tp import pair_cols

    C = k["w_in"].shape[1]
    Cp = C // p
    cols = torch.from_numpy(pair_cols(C, p, i)).to(k["w_in"].device)
    w_in, b_in = k["w_in"][..., cols], k["b_in"][cols].contiguous()
    w_c, b_c = k["w_cond"][:, cols], k["b_cond"][cols].contiguous()
    w_rs = k["w_rs"][i * Cp:(i + 1) * Cp]
    if not int8:
        return (w_in.contiguous(), b_in, w_c.contiguous(), b_c,
                w_rs.contiguous())

    def quant(w):
        q, sc = wq.quantize_cols(w)
        return wq.to_output_major(q), sc

    return (*quant(w_in), b_in, *quant(w_c), b_c, *quant(w_rs))


def check_partial_kernels(C: int = 512, M: int = 640) -> dict:
    """Phase 17: kernels 4 and 8 against their plain versions at reference
    width, then kernel and plain times and the card's bound at B=1, T=6400
    for p = 2 and 4 (the record holds p = 4's)."""
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_int8 as wq

    dev = torch.device("cuda")
    rec = {n: {"max_abs_err": 0.0} for n in PARTIAL_KERNELS}

    def note(name, err):
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)

    def check_bf16(tag, args, kw, nv):
        got = wb.wn_layer_partial(*args, n_valid=nv, **kw)
        want = wb.wn_layer_partial_plain(*args, n_valid=nv, **kw)
        if got.dtype != torch.float32 or got[:, nv:].any():
            raise RuntimeError(f"{tag}: not f32, or rows past n_valid not 0")
        note("wn_layer_partial", compare(f"wn_layer_partial {tag}", got, want))
        return got

    def check_int8(tag, args, nv):
        got = wq.wn_layer_partial_int8(*args, n_valid=nv)
        want = wq.wn_layer_partial_int8_plain(*args, n_valid=nv)
        err = (got - want).abs().max().item()
        rel = ((got - want).norm() / want.norm()).item()
        print(f"  wn_layer_partial_int8 {tag}: max_abs_err={err:.6g} (bound "
              f"{INT8_PARTIAL_ATOL}) rel_l2={rel:.3g} (bound {KERNEL_REL_L2})")
        if not torch.isfinite(got).all() or got[:, nv:].any() \
                or err > INT8_PARTIAL_ATOL or rel > KERNEL_REL_L2:
            raise RuntimeError(f"wn_layer_partial_int8 {tag}: kernel "
                               f"disagrees with its plain version")
        note("wn_layer_partial_int8", err)

    seed = 700
    for p in (2, 4, 8):
        for B, T, nv in ((1, 1000, 937), (3, 777, 700)):
            shape = f"p={p} B={B} T={T} n_valid={nv}"
            for n_half in (2, 3, 4):      # the layer-0 form, first/last rank
                seed += 1
                k = layer_inputs(B, T, nv, C, M, seed, dev, n_half=n_half)
                for i in (0, p - 1):
                    w_in, b_in, w_c, b_c, w_rs = rank_share(k, p, i, False)
                    wp, b_all, b_edge = wb.fold_first_taps(
                        k["start_k"], k["start_b"], w_in, b_in)
                    check_bf16(f"{shape} n_half={n_half} rank {i}",
                               (k["x0"], k["spect"], wp, b_all, w_c, b_c,
                                w_rs, 1), {"b_edge": b_edge}, nv)
            for li in range(8):           # every dilation of the WN ladder
                d = 2 ** li
                seed += 1
                k = layer_inputs(B, T, nv, C, M, seed, dev)
                if li % 3 == 2:           # a skip-only layer: rs_out = C
                    k["w_rs"] = k["w_rs"][:, :C].contiguous()
                    k["b_rs"] = k["b_rs"][:C].contiguous()
                qx, sx = wq.quantize_rows(k["x"])
                qsp, ssp = wq.quantize_rows(k["spect"])
                tag = f"{shape} d={d} rs_out={k['w_rs'].shape[1]}"
                whole = li in (1, 5)      # every rank, and their sum
                total = None
                for i in range(p) if whole else (0, p - 1):
                    got = check_bf16(
                        f"{tag} rank {i}",
                        (k["x"], k["spect"], *rank_share(k, p, i, False), d),
                        {}, nv)
                    total = got if total is None else total + got
                    check_int8(f"{tag} rank {i}",
                               (qx, sx, qsp, ssp,
                                *rank_share(k, p, i, True), d), nv)
                if whole:
                    # sum of the p partials + bias == the whole layer's
                    # plain res/skip product
                    in_act = (wb._taps(k["x"], k["w_in"], d, nv) + k["b_in"]
                              + wb._cond(k["spect"], k["w_cond"],
                                         k["b_cond"]))
                    rs = (wb._gate(in_act, torch.bfloat16).float()
                          @ k["w_rs"].float() + k["b_rs"])
                    note("wn_layer_partial", compare(
                        f"sum of {p} partials + bias vs the whole layer {tag}",
                        (total + k["b_rs"])[:, :nv], rs[:, :nv]))

    B, T, d = 1, 6400, 64
    k = layer_inputs(B, T, T, C, M, 93, dev)
    qx, sx = wq.quantize_rows(k["x"])
    qsp, ssp = wq.quantize_rows(k["spect"])
    bt = 2 * B * T
    for p in (2, 4):
        Cp = C // p
        ops = bt * (3 * C + M) * 2 * Cp + bt * Cp * 2 * C
        for name, kern, plain, args, kind in (
                ("wn_layer_partial", wb.wn_layer_partial,
                 wb.wn_layer_partial_plain,
                 (k["x"], k["spect"], *rank_share(k, p, 0, False), d), "bf16"),
                ("wn_layer_partial_int8", wq.wn_layer_partial_int8,
                 wq.wn_layer_partial_int8_plain,
                 (qx, sx, qsp, ssp, *rank_share(k, p, 0, True), d), "int8")):
            out = kern(*args)
            tensors = [t for t in (*args, out) if torch.is_tensor(t)]
            r = {}
            r["bound_ms"], r["bound_by"] = bound_ms({kind: ops}, tensors)
            r["ms"] = time_ms(lambda: kern(*args))
            r["plain_ms"] = time_ms(lambda: plain(*args))
            print(f"  {name} p={p} B={B} T={T}: kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
                  f"ms (by {r['bound_by']}); {ops / 1e9:.2f} G operations, "
                  f"{sum(t.numel() * t.element_size() for t in tensors) / 1e6:.1f}"
                  f" MB")
            if p == 4:
                rec[name].update(r)
    return rec


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm()).item()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def tp_path(bf16_synth, int8_synth, mel: torch.Tensor,
            rel32_bf16: float) -> dict:
    """Phase 18: the tensor-parallel vocoder at full width on the main
    path's mel, every shard on this card.  Returns the partial kernels'
    launch counts of its p = 2 runs."""
    import torch.distributed as dist

    from text2speech_tpu_torch.parallel import tp

    wg, cfg = bf16_synth.waveglow, bf16_synth.wg_cfg
    B, _, T = mel.shape
    L, F = cfg.wn_n_layers, cfg.n_flows
    Tg = T * cfg.upsample_stride // cfg.n_group
    gen = torch.Generator(device="cuda").manual_seed(123)
    noise = tuple(torch.randn(sh, generator=gen, device="cuda")
                  for sh in bf16_synth.fused.noise_shapes(B, Tg))
    with torch.inference_mode():
        exact = wg.infer(mel, SIGMA, noise=noise)
        single = {False: bf16_synth.fused.infer(mel, SIGMA, noise=noise),
                  True: int8_synth.fused.infer(mel, SIGMA, noise=noise)}
    peak = exact.abs().max().item()
    launches = {}
    for p in (2, 4):
        plain_tp, t_plain = sync_time(lambda: tp.TPWaveGlowServer(
            wg, p, fused=False)(mel, SIGMA, noise=noise))
        r_plain = rel_l2(plain_tp, exact)
        print(f"[tp] p={p} plain TP path (f32, fused=False) vs f32 "
              f"WaveGlow.infer: rel_l2={r_plain:.4g} (bound 1e-4; "
              f"{t_plain * 1e3:.1f} ms with the sharding)")
        if r_plain > 1e-4:
            raise RuntimeError("plain TP path differs from WaveGlow.infer")
        for int8 in (False, True):
            tag = f"p={p} {'int8' if int8 else 'bf16'}"
            server, t_build = sync_time(lambda: tp.TPWaveGlowServer(
                wg, p, fused=True, int8=int8))
            reset_counts()
            audio, t_first = sync_time(
                lambda: server(mel, SIGMA, noise=noise))
            got, other = tp.launch_counts(), all_counts()
            want = ({"wn_layer_partial": F * p,
                     "wn_layer_partial_int8": F * (L - 1) * p} if int8 else
                    {"wn_layer_partial": F * L * p,
                     "wn_layer_partial_int8": 0})
            print(f"[tp] {tag}: shards prepared in {t_build:.2f} s; vocode "
                  f"batch {B} x {T} frames in {t_first * 1e3:.1f} ms (first "
                  f"call); launches {got}, whole-layer wrappers "
                  f"{sum(other.values())}")
            if got != want or any(other.values()):
                raise RuntimeError(f"TP launch counts {got} (+ {other}), "
                                   f"want {want} and none other")
            if p == 2:
                launches[("wn_layer_partial_int8" if int8
                          else "wn_layer_partial")] = got[
                    "wn_layer_partial_int8" if int8 else "wn_layer_partial"]
            if tuple(audio.shape) != (B, T * cfg.upsample_stride) or \
                    not torch.isfinite(audio).all():
                raise RuntimeError(f"TP audio {tuple(audio.shape)}")
            steps, rel_bound = ((E2E_INT8_MAX_ABS_STEPS, E2E_INT8_REL_L2)
                                if int8 else (E2E_MAX_ABS_STEPS, E2E_REL_L2))
            r_tp, r_single, r32 = (rel_l2(audio, plain_tp),
                                   rel_l2(audio, single[int8]),
                                   rel_l2(audio, exact))
            err_single = (audio - single[int8]).abs().max().item()
            bound32 = (max(TP_INT8_REL32_FACTOR * rel32_bf16,
                           TP_INT8_REL32_FLOOR) if int8 else
                       max(TP_REL32_FACTOR * rel32_bf16, TP_REL32_FLOOR))
            print(f"[tp] {tag}: vs the plain TP path rel_l2={r_tp:.4g}, vs "
                  f"f32 WaveGlow.infer rel_l2={r32:.4g} (bound {bound32:.4g}; "
                  f"the single-device fused bf16 path: {rel32_bf16:.4g}); vs "
                  f"the single-device infer_fused{'_int8' if int8 else ''}: "
                  f"max_abs_err={err_single:.6g} (bound {steps * peak:.4g}) "
                  f"rel_l2={r_single:.4g} (bound {rel_bound})")
            if max(r_tp, r32) > bound32 or err_single > steps * peak \
                    or r_single > rel_bound:
                raise RuntimeError(f"TP vocoder {tag}: audio out of bounds")
            # wall beside the single-device vocode, warm, in turns
            fw = (int8_synth if int8 else bf16_synth).fused
            runs = {"tp": lambda: server(mel, SIGMA, noise=noise),
                    "single": lambda: fw.infer(mel, SIGMA, noise=noise)}
            times = {n: [] for n in runs}
            with torch.inference_mode():
                for n in ("single", "tp", "tp", "single", "single", "tp"):
                    times[n].append(sync_time(runs[n])[1] * 1e3)
            print(f"[tp] {tag}: vocode wall ms, TP on one card "
                  f"{[round(t, 2) for t in times['tp']]}, single-device fused "
                  f"{[round(t, 2) for t in times['single']]}")
            del server
            torch.cuda.empty_cache()

    # the distributed form: an NCCL group of this one rank
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        for int8 in (False, True):
            grouped = tp.TPWaveGlowServer(wg, group=dist.group.WORLD,
                                          int8=int8)
            local = tp.TPWaveGlowServer(wg, 1, int8=int8)
            a = grouped(mel[:1], SIGMA, noise=tuple(z[:1] for z in noise))
            b = local(mel[:1], SIGMA, noise=tuple(z[:1] for z in noise))
            same = torch.equal(a, b)
            print(f"[tp] NCCL group of 1 rank (int8={int8}): ranks "
                  f"{grouped.ranks} of {grouped.n_model}, audio equal to the "
                  f"local form: {same}")
            if not same or grouped.ranks != [0]:
                raise RuntimeError("the distributed form differs from the "
                                   "local form")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the continuous-batching server, its CLI and its HTTP front end
# ---------------------------------------------------------------------------

SERVE_SLOTS, SERVE_STEPS = 4, 400
SERVE_SIGMAS = [0.666, 0.5, 0.8, 0.666, 1.0, 0.6]
SERVE_STRENGTHS = [None, DENOISER_STRENGTH, None, None, DENOISER_STRENGTH,
                   None]


def session_reference(synth, srv, sid) -> torch.Tensor:
    """One pass over the session's own final mel with its own noise,
    pre-scaled by its sigma as the scheduler scales it, then the offline
    denoiser at its strength."""
    s = srv.sessions[sid]
    tl = min(s.out_len, srv.requested)
    nz = tuple((s.sigma * c[None, : tl * srv.gpf]).contiguous()
               for c in srv._sess_noise(s, tl))
    return synth.mel_to_audio(s.post_cat()[None, :, :tl].contiguous(), 1.0,
                              noise=nz, denoiser_strength=s.den_strength)[0]


def drive(srv, waves):
    """Submit ``waves`` = [(rounds to step first, [submit kwargs])] and step
    until idle -> ({sid: audio}, {sid: seconds to first audio}, seconds)."""
    parts, first, t_sub = {}, {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def step():
        for ev in srv.step():
            if ev.audio is not None:
                first.setdefault(ev.sid, time.perf_counter() - t_sub[ev.sid])
                parts.setdefault(ev.sid, []).append(ev.audio)

    for rounds, requests in waves:
        for _ in range(rounds):
            step()
        for kw in requests:
            t_sub[srv.submit(**kw)] = time.perf_counter()
    while not srv.idle:
        step()
    torch.cuda.synchronize()
    return ({sid: np.concatenate(p) for sid, p in parts.items()}, first,
            time.perf_counter() - t0)


def server_path(synth, tag: str, int8: bool) -> None:
    """Phase 19 for one vocoder."""
    from text2speech_tpu_torch.server import make_server

    cfg = synth.wg_cfg
    hop, sr = cfg.upsample_stride, cfg.sampling_rate
    requests = [dict(request=TEXTS[i % len(TEXTS)], seed=10 + i,
                     sigma=SERVE_SIGMAS[i],
                     denoiser_strength=SERVE_STRENGTHS[i]) for i in range(6)]
    srv = make_server(synth, slots=SERVE_SLOTS, chunk_steps=STREAM_CHUNK,
                      max_steps=SERVE_STEPS, retain_sessions=True)
    srv.warm_window_widths()
    srv.warm_short_pass()
    reset_counts()
    # three sessions start; after two rounds three more arrive: one takes
    # the free slot mid-flight, two wait for slots to free
    wavs, first, wall = drive(srv, [(0, requests[:3]), (2, requests[3:])])
    counts = {k: v for k, v in all_counts().items() if v}
    st = srv.stats
    seconds = sum(len(w) for w in wavs.values()) / sr
    joins = sorted((s.sid, s.slot, s.admit_round)
                   for s in srv.sessions.values())
    print(f"[serve] {tag}: 6 sessions x {SERVE_STEPS} steps through "
          f"{SERVE_SLOTS} slots in {st['rounds']} rounds, {wall:.3f} s: "
          f"{seconds:.2f} s of audio = {seconds / wall:.3f} audio seconds per "
          f"wall second; slot occupancy "
          f"{st['active_row_steps'] / st['row_steps']:.3f}; first audio after "
          f"{ {sid: round(t, 3) for sid, t in sorted(first.items())} } s; "
          f"(sid, slot, admit round) {joins}; calls: postnet "
          f"{st['postnet_calls']}, vocoder {st['vocoder_calls']}, denoiser "
          f"{st['denoiser_calls']}; launches {counts}")
    mine = list(KERNELS)[3:] if int8 else list(KERNELS)[:3]
    if sorted(counts) != sorted(mine):
        raise RuntimeError(f"server {tag}: launches {counts}, want only the "
                           f"{mine} wrappers")
    mid_flight = [j for j in joins if j[2] > 0]
    reused = {j[1] for j in mid_flight} & {j[1] for j in joins if j[2] == 0}
    if len(mid_flight) != 3 or not reused or sorted(wavs) != list(range(6)):
        raise RuntimeError(f"server {tag}: sessions did not join mid-flight")
    if (st["admitted"], st["completed"], st["cancelled"]) != (6, 6, 0) \
            or st["row_steps"] != st["rounds"] * SERVE_SLOTS * STREAM_CHUNK \
            or st["emitted_samples"] != sum(len(w) for w in wavs.values()) \
            or not srv.idle or st["denoiser_calls"] == 0:
        raise RuntimeError(f"server {tag}: inconsistent stats {st}")
    for sid, wav in wavs.items():
        want = session_reference(synth, srv, sid)
        n = SERVE_STEPS * hop
        if srv.sessions[sid].den_strength == 0 and len(wav) != n:
            raise RuntimeError(f"session {sid}: {len(wav)} samples, want {n}")
        check_stream_audio(f"serve {tag} session {sid} (sigma "
                           f"{srv.sessions[sid].sigma}, denoiser "
                           f"{srv.sessions[sid].den_strength})", wav, want,
                           int8)

    # one (text, seed) alone in a one-slot server against the full batch
    solo = make_server(synth, slots=1, chunk_steps=STREAM_CHUNK,
                       max_steps=SERVE_STEPS)
    alone, first1, wall1 = drive(solo, [(0, [requests[4]])])
    print(f"[serve] {tag}: session 4 alone in a one-slot server: first audio "
          f"after {first1[0]:.3f} s, all after {wall1:.3f} s")
    check_stream_audio(f"serve {tag} session 4 in the batch vs alone",
                       wavs[4], torch.from_numpy(alone[0]), int8)

    # sessions shorter than one vocoder window: the exact pass
    short_steps = 150
    short = make_server(synth, slots=2, chunk_steps=STREAM_CHUNK,
                        max_steps=short_steps, retain_sessions=True)
    if short_steps > short.Wv:
        raise RuntimeError("the short server's sessions span a window")
    swavs, sfirst, swall = drive(short, [(0, requests[:3])])
    print(f"[serve] {tag}: 3 sessions x {short_steps} steps (under one window "
          f"of {short.Wv} frames) through 2 slots: {short.stats['rounds']} "
          f"rounds, {swall:.3f} s, vocoder calls "
          f"{short.stats['vocoder_calls']}, first audio after "
          f"{ {sid: round(t, 3) for sid, t in sorted(sfirst.items())} } s")
    for sid, wav in swavs.items():
        check_stream_audio(f"serve {tag} short session {sid}", wav,
                           session_reference(synth, short, sid), int8)


def server_reload(synth, tag: str, int8: bool) -> None:
    """Phase 19, the live weight swap: ``load_weights`` between two sessions
    of a running server changes the next session's audio and raises
    nothing.  Leaves ``synth`` on the new vocoder weights."""
    from text2speech_tpu_torch.convert import variables_from_trainable
    from text2speech_tpu_torch.models.waveglow import TrainableWaveGlow
    from text2speech_tpu_torch.server import make_server

    cfg = synth.wg_cfg
    srv = make_server(synth, slots=2, chunk_steps=STREAM_CHUNK,
                      max_steps=SERVE_STEPS, retain_sessions=True)
    req = dict(request=TEXTS[0], seed=3, denoiser_strength=DENOISER_STRENGTH)
    before, _, _ = drive(srv, [(0, [req])])
    fresh = TrainableWaveGlow(
        cfg, generator=torch.Generator(device="cuda").manual_seed(9),
        device="cuda")
    bias0 = synth._denoise_bias.clone()
    _, t_swap = sync_time(lambda: synth.load_weights(
        wg_variables=variables_from_trainable(fresh)))
    del fresh
    after, _, _ = drive(srv, [(0, [req])])
    diff = np.abs(after[1] - before[0]).max()
    want = session_reference(synth, srv, 1)
    print(f"[serve] {tag}: load_weights (a fresh WaveGlow initialisation) "
          f"under a running server in {t_swap:.2f} s; the same (text, seed) "
          f"before and after: max |diff| {diff:.4g}; denoiser bias changed: "
          f"{not torch.equal(bias0, synth._denoise_bias)}")
    if diff < 1e-3 or torch.equal(bias0, synth._denoise_bias) \
            or not np.isfinite(after[1]).all():
        raise RuntimeError("load_weights did not show on the next session")
    check_stream_audio(f"serve {tag} session after load_weights", after[1],
                       want, int8)


def cli_serve_batch() -> None:
    """Phase 20: the CLI serves a texts file through two slots."""
    from scipy.io import wavfile

    with tempfile.TemporaryDirectory() as d:
        with open(f"{d}/texts.txt", "w", encoding="utf-8") as f:
            f.write("\n".join(TEXTS) + "\n")
        cmd = [sys.executable, "-m", "text2speech_tpu_torch.inference",
               "--random_init", "0", "--int8_vocoder", "-d", "0.1",
               "--serve_slots", "2", "--texts_file", f"{d}/texts.txt",
               "--max_steps", "150", "--out", f"{d}/served.wav"]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        print(f"[cli] {' '.join(cmd[1:])} -> rc {r.returncode}: "
              f"{' | '.join(r.stdout.strip().splitlines())}")
        if r.returncode != 0:
            raise RuntimeError(f"CLI --serve_slots failed:\n{r.stderr}")
        for sid in range(len(TEXTS)):
            sr, data = wavfile.read(f"{d}/served_{sid}.wav")
            if data.dtype != np.int16 or sr != 22050 or \
                    not 149 * 256 <= data.shape[0] <= 150 * 256:
                raise RuntimeError(f"served_{sid}.wav: {data.shape} "
                                   f"{data.dtype} at {sr} Hz")
        if f"served {len(TEXTS)} sessions through 2 slots" not in r.stdout:
            raise RuntimeError("CLI --serve_slots: no summary line")


def cli_serve_http() -> None:
    """Phase 21: the CLI's HTTP server in a process of its own, two clients
    at once, then an interrupt."""
    from text2speech_tpu_torch.http_serve import wav_stream_header

    steps = 150
    cmd = [sys.executable, "-u", "-m", "text2speech_tpu_torch.inference",
           "--random_init", "0", "--int8_vocoder", "--serve_slots", "2",
           "--http_port", "0", "--max_steps", str(steps),
           "--http_reload_token", "smoke"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines: queue.Queue = queue.Queue()
    errs: list = []
    readers = [threading.Thread(target=lambda: [lines.put(ln) for ln in
                                                proc.stdout], daemon=True),
               threading.Thread(target=lambda: errs.extend(proc.stderr),
                                daemon=True)]
    for t in readers:
        t.start()
    try:
        port, seen, deadline = None, [], time.monotonic() + 300
        while port is None:
            try:
                ln = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise RuntimeError(f"the HTTP server did not come up: {seen}"
                                   f"\n{''.join(errs)}") from None
            seen.append(ln.strip())
            if "HTTP TTS server on :" in ln:
                port = int(ln.split(" on :")[1].split()[0])
            if proc.poll() is not None and port is None:
                raise RuntimeError(f"the HTTP server exited: {seen}\n"
                                   f"{''.join(errs)}")
        print(f"[http] {' '.join(cmd[2:])}: {' | '.join(seen)}")

        def request(method, path, body=None, headers=None):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
            return resp, data

        results, t0 = {}, time.perf_counter()

        def client(i):
            resp, data = request("POST", "/synthesize", json.dumps(
                {"text": TEXTS[i], "seed": 20 + i,
                 "denoiser_strength": 0.1 if i else None}))
            results[i] = (resp.status, resp.getheader("Content-Type"),
                          resp.getheader("X-Session-Id"), data,
                          time.perf_counter() - t0)

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        header = wav_stream_header(22050)
        for i in range(2):
            if i not in results:
                raise RuntimeError(f"HTTP client {i} did not finish")
            status, ctype, sid, data, secs = results[i]
            n_pcm = len(data) - len(header)
            print(f"[http] client {i}: status {status}, {ctype}, session "
                  f"{sid}, {n_pcm // 2} samples in {secs:.3f} s")
            # a denoised stream ends at a whole number of STFT hops
            lo = (steps - 1) * 256 * 2
            if status != 200 or ctype != "audio/wav" or sid is None \
                    or data[: len(header)] != header \
                    or not lo <= n_pcm <= steps * 256 * 2 or n_pcm % 2 \
                    or not np.frombuffer(data[len(header):], "<i2").any():
                raise RuntimeError(f"HTTP client {i}: bad response")
        resp, data = request("GET", "/stats")
        stats = json.loads(data)
        resp_h, data_h = request("GET", "/healthz")
        resp_b, data_b = request("POST", "/synthesize", b"not json")
        resp_r, _ = request("POST", "/reload", b"{}")
        print(f"[http] /stats {stats}; /healthz {resp_h.status} "
              f"{json.loads(data_h)}; bad JSON -> {resp_b.status}; /reload "
              f"without its token -> {resp_r.status}")
        if resp.status != 200 or stats["slots"] != 2 \
                or stats["completed"] < 2 or stats["open_streams"] != 0 \
                or resp_h.status != 200 or json.loads(data_h) != {"ok": True} \
                or resp_b.status != 400 or resp_r.status != 403:
            raise RuntimeError("HTTP server: bad /stats, /healthz or errors")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
    print(f"[http] the server exited with code {proc.returncode} after the "
          f"interrupt")


# ---------------------------------------------------------------------------
# training: the gated activation and conv backward kernels, one step, the CLI
# ---------------------------------------------------------------------------

# Gated kernels against their plain versions: the same f32 arithmetic on the
# same rounded sum, with the card's tanhf / expf against the library's (last
# bits): 1e-6 on the f32 forward (|out| < 1), 1e-5 on the f32 backward
# (cotangents of a few units); in bf16 one step of the output's type, which
# is at most 2^-7 of the value.
GATED_F32_ATOL = {"fwd": 1e-6, "bwd": 1e-5}
BF16_STEP = 2.0 ** -7
# Conv backward against its plain version and against autograd of F.conv1d:
# f32 sums of 6C (dx) and B * T (dW) products in another order.  f32 dx to
# 1e-4 absolute, dW to 2e-5 of its peak; a bf16 dx is rounded once more, one
# bf16 step of its peak.
CONV_DX_F32_ATOL = 1e-4
CONV_DW_REL = 2e-5
# One training step through the gated kernels against the same step with
# the plain gated activation (f32, TF32 off): 96 activations and 96 of
# their backwards differ in the last bits of tanhf / expf.  The loss is a
# sum of per-element terms of about 0.1: 1e-6 absolute; the gradient's
# global norm 1e-4 relative.
STEP_LOSS_ATOL = 1e-6
STEP_GNORM_RTOL = 1e-4
TRAIN_STEPS = 12
N_WAVS = 8


def gated_counts() -> dict:
    from text2speech_tpu_torch.ops import gated

    return gated.launch_counts()


def check_train_kernels() -> dict:
    """Phase 8, first half: kernels 16-18 against their plain versions,
    then kernel, plain and library times and the card's bound at the
    training shapes ([3, 2000, 1024] pairs; B=3, T=2000, C=512)."""
    import torch.nn.functional as F

    from text2speech_tpu_torch.ops import gated
    from text2speech_tpu_torch.ops import wn_backward as twb

    dev = torch.device("cuda")
    rec = {n: {"max_abs_err": 0.0} for n in TRAIN_KERNELS}
    f32, bf16 = torch.float32, torch.bfloat16

    def gated_inputs(shape, dtype, strided, seed, L=8):
        """a, b [..., 2C], cotangent [..., C]; ``strided``: b is layer 3's
        column slice of the fused [..., 2C * L] projection."""
        g = torch.Generator().manual_seed(seed)
        C2 = shape[-1]
        a = torch.randn(*shape, generator=g).to(dev, dtype)
        fused = torch.randn(*shape[:-1], L * C2, generator=g).to(dev, dtype)
        b = fused[..., 3 * C2: 4 * C2]
        cot = torch.randn(*shape[:-1], C2 // 2, generator=g).to(dev, dtype)
        return a, (b if strided else b.contiguous()), cot

    seed = 0
    for dtype in (f32, bf16):
        for shape in ((3, 2000, 1024), (2, 37, 6), (1, 5, 48)):
            for strided in (False, True):
                seed += 1
                a, b, cot = gated_inputs(shape, dtype, strided, seed)
                pairs = {
                    "fwd": (gated.gated_fwd(a, b), gated.gated_plain(a, b)),
                    "bwd": (gated.gated_bwd(a, b, cot),
                            gated.gated_bwd_plain(a, b, cot))}
                for which, (got, want) in pairs.items():
                    got, want = got.float(), want.float()
                    err = (got - want).abs().max().item()
                    bound = (GATED_F32_ATOL[which] if dtype == f32 else
                             BF16_STEP * max(want.abs().max().item(), 1.0))
                    tag = (f"gated_{which} {str(dtype)[6:]} {shape} "
                           f"b {'strided' if strided else 'dense'}")
                    print(f"  {tag}: max_abs_err={err:.4g} (bound "
                          f"{bound:.4g})")
                    if not torch.isfinite(got).all() or err > bound:
                        raise RuntimeError(f"{tag}: kernel disagrees with "
                                           f"its plain version")
                    r = rec[f"gated_{which}"]
                    r["max_abs_err"] = max(r["max_abs_err"], err)

    def conv_inputs(B, T, C, dtype, seed):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(B, T, C, generator=g).to(dev, dtype)
        w = (torch.randn(3, C, 2 * C, generator=g) * (3 * C) ** -0.5)
        cot = torch.randn(B, T, 2 * C, generator=g).to(dev, dtype)
        return x, cot, w.to(dev, dtype)

    for dtype in (bf16, f32):
        for B, T, C, d in ((3, 2000, 512, 1), (3, 2000, 512, 8),
                           (3, 2000, 512, 128), (2, 77, 128, 3),
                           (2, 50, 24, 5)):
            seed += 1
            x, cot, w = conv_inputs(B, T, C, dtype, seed)
            dx, dw = twb.conv_k3_bwd(x, cot, w, d)
            dx2, dw2 = twb.conv_k3_bwd(x, cot, w, d)
            if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
                raise RuntimeError("conv_k3_bwd: two runs differ")
            xr = x.float().requires_grad_()
            wr = w.float().requires_grad_()
            F.conv1d(xr.transpose(1, 2), wr.permute(2, 1, 0), padding=d,
                     dilation=d).transpose(1, 2).backward(cot.float())
            refs = {"plain": twb.conv_k3_bwd_plain(x, cot, w, d),
                    "autograd": (xr.grad, wr.grad),
                    "first design": twb.first_design(x, cot, w, d)}
            for ref, (want_dx, want_dw) in refs.items():
                want_dx = want_dx.float()
                e_x = (dx.float() - want_dx).abs().max().item()
                e_w = (dw - want_dw).abs().max().item()
                b_x = CONV_DX_F32_ATOL + (
                    0.0 if dtype == f32
                    else BF16_STEP * want_dx.abs().max().item())
                b_w = CONV_DW_REL * max(want_dw.abs().max().item(), 1.0)
                tag = (f"conv_k3_bwd {str(dtype)[6:]} B={B} T={T} C={C} "
                       f"d={d} vs {ref}")
                print(f"  {tag}: dx max_abs_err={e_x:.4g} (bound {b_x:.4g}) "
                      f"dW {e_w:.4g} (bound {b_w:.4g})")
                ok = torch.isfinite(dx.float()).all() and \
                    torch.isfinite(dw).all()
                if not ok or e_x > b_x or e_w > b_w:
                    raise RuntimeError(f"{tag}: kernel disagrees")
                if ref == "plain":
                    r = rec["conv_k3_bwd"]
                    key = "max_abs_err" + ("_f32" if dtype == f32 else "")
                    r[key] = max(r.get(key, 0.0), e_x, e_w)

    # times at the training shapes.  The gated pair as a WN layer gives it:
    # f32, b a column slice of the fused projection.
    for dtype in (f32, bf16):
        a, b, cot = gated_inputs((3, 2000, 1024), dtype, True, 90)
        out, dx = gated.gated_fwd(a, b), gated.gated_bwd(a, b, cot)
        n = out.numel()
        timed = {
            "gated_fwd": (lambda: gated.gated_fwd(a, b),
                          lambda: gated.gated_plain(a, b),
                          {"f32": 8 * n}, (a, b, out)),
            "gated_bwd": (lambda: gated.gated_bwd(a, b, cot),
                          lambda: gated.gated_bwd_plain(a, b, cot),
                          {"f32": 18 * n}, (a, b, cot, dx))}
        for name, (kern, plain, ops, tensors) in timed.items():
            t = {"ms": time_ms(kern), "plain_ms": time_ms(plain),
                 "library_ms": None}   # no one PyTorch call: plain_ms is
            #                            the eager chain
            t["bound_ms"], t["bound_by"] = bound_ms(ops, tensors)
            print(f"  {name} {str(dtype)[6:]} [3, 2000, 1024] b strided: "
                  f"kernel {t['ms']:.4f} ms, plain (the eager chain) "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"(by {t['bound_by']})")
            if dtype == f32:
                rec[name].update(t)
    # times at the training shape, both dtypes, beside the first design in
    # turns (first, sm90, sm90, first); the record holds bf16 at d=8, and
    # the f32 form's numbers under "f32"
    B, T, C = 3, 2000, 512
    r = rec["conv_k3_bwd"]
    for dtype, kind in ((bf16, "bf16"), (f32, "f32")):
        for d in (1, 8, 128):
            x, cot, w = conv_inputs(B, T, C, dtype, 91)
            dx, dw = twb.conv_k3_bwd(x, cot, w, d)
            plan = twb.bwd_plan(B, T, C, dtype)

            def library():
                return torch.ops.aten.convolution_backward(
                    cot.transpose(1, 2), x.transpose(1, 2),
                    w.permute(2, 1, 0), None, [1], [d], [d], False, [0], 1,
                    [True, True, False])

            firsts, sm90 = [], []
            for fn, acc in ((lambda: twb.first_design(x, cot, w, d), firsts),
                            (lambda: twb.conv_k3_bwd(x, cot, w, d), sm90),
                            (lambda: twb.conv_k3_bwd(x, cot, w, d), sm90),
                            (lambda: twb.first_design(x, cot, w, d),
                             firsts)):
                acc.append(time_ms(fn))
            t = {"ms": sum(sm90) / 2, "prev_ms": sum(firsts) / 2,
                 "plain_ms": time_ms(
                     lambda: twb.conv_k3_bwd_plain(x, cot, w, d)),
                 "library_ms": time_ms(library)}
            t["bound_ms"], t["bound_by"] = bound_ms(
                {kind: 12 * B * T * C * 2 * C}, (x, cot, w, dx, dw))
            print(f"  conv_k3_bwd {kind} B={B} T={T} C={C} d={d}: sm90 "
                  f"{sm90[0]:.4f} / {sm90[1]:.4f} ms ({t['bound_ms'] / t['ms']:.1%} "
                  f"of the {t['bound_ms']:.4f} ms bound by {t['bound_by']}), "
                  f"first design {firsts[0]:.4f} / {firsts[1]:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms, aten.convolution_backward "
                  f"{t['library_ms']:.4f} ms; route {plan['route']}, "
                  f"{plan['dx_blocks']} dx + {plan['dw_blocks']} dW blocks "
                  f"({plan['splits']} splits)")
            if d == 8:
                if kind == "bf16":
                    r.update(t)
                else:
                    r["f32"] = {**t, "max_abs_err": r.pop("max_abs_err_f32")}
    conv_split_and_widths(twb, conv_inputs)
    return rec


def conv_split_and_widths(twb, conv_inputs) -> None:
    """Row 18's launch plan on the card: the kernel's tiles against
    ``bwd_plan``'s restatement of them, the dW split the plan picks beside
    others at the training shape (the entry called directly, d=8), and
    bf16 at a width the tensor-core route does not take (C % 128 != 0:
    the FMA route) beside the first design, in turns."""
    import ctypes

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    lib = twb.LIB_SM90.get()
    for route, tile in twb.BWD_TILES.items():
        got = (ctypes.c_int * 4)()
        lib.t2s_conv_k3_bwd_sm90_tile(int(route == "wgmma"),
                                      ctypes.addressof(got))
        if tuple(got) != tile:
            raise RuntimeError(f"bwd_plan: {route} tile {tile}, the kernel "
                               f"has {tuple(got)}")
    B, T, C, d = 3, 2000, 512, 8
    for dtype, kind in ((bf16, "bf16"), (torch.float32, "f32")):
        x, cot, w = conv_inputs(B, T, C, dtype, 92)
        plan = twb.bwd_plan(B, T, C, dtype)
        dx = torch.empty_like(x)
        dw = torch.empty((3, C, 2 * C), dtype=torch.float32, device=dev)
        times = []
        for S in sorted({1, 2, 3, 4, 8, plan["splits"]}):
            part = dw if S == 1 else torch.empty(
                (3 * S, C, 2 * C), dtype=torch.float32, device=dev)

            def launch(S=S, part=part):
                twb._run(lib.t2s_conv_k3_bwd_sm90, dev, x.data_ptr(),
                         cot.data_ptr(), w.data_ptr(), dx.data_ptr(),
                         dw.data_ptr(), part.data_ptr(), B, T, C, d, S,
                         int(dtype == bf16), int(plan["route"] == "wgmma"))
            times.append(f"S={S} {time_ms(launch):.4f}")
        print(f"  conv_k3_bwd {kind} dW split at B={B} T={T} C={C} d={d}: "
              f"{', '.join(times)} ms; the plan's S={plan['splits']}")
    B, T, C = 3, 2000, 320
    x, cot, w = conv_inputs(B, T, C, bf16, 93)
    twb.conv_k3_bwd(x, cot, w, d)
    firsts, sm90 = [], []
    for fn, acc in ((lambda: twb.first_design(x, cot, w, d), firsts),
                    (lambda: twb.conv_k3_bwd(x, cot, w, d), sm90),
                    (lambda: twb.conv_k3_bwd(x, cot, w, d), sm90),
                    (lambda: twb.first_design(x, cot, w, d), firsts)):
        acc.append(time_ms(fn))
    plan = twb.bwd_plan(B, T, C, bf16)
    plain = time_ms(lambda: twb.conv_k3_bwd_plain(x, cot, w, d))
    library = time_ms(lambda: torch.ops.aten.convolution_backward(
        cot.transpose(1, 2), x.transpose(1, 2), w.permute(2, 1, 0), None,
        [1], [d], [d], False, [0], 1, [True, True, False]))
    print(f"  conv_k3_bwd bf16 B={B} T={T} C={C} d={d} (route "
          f"{plan['route']}, {plan['splits']} splits): sm90 {sm90[0]:.4f} / "
          f"{sm90[1]:.4f} ms, first design {firsts[0]:.4f} / "
          f"{firsts[1]:.4f} ms, plain {plain:.4f} ms, "
          f"aten.convolution_backward {library:.4f} ms")


def conv_backward_path() -> int:
    """Phase 8, second half: the conv backward kernel's own path.  It is a
    probe beside the trainer (whose convs differentiate through the
    library): a chain of calls down the WN dilation ladder at the training
    shape, each call's dx the next one's x.  Returns its launch count."""
    from text2speech_tpu_torch.ops import wn_backward as twb

    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 2000, 512, generator=g).to("cuda", torch.bfloat16)
    cot = torch.randn(3, 2000, 1024, generator=g).to("cuda", torch.bfloat16)
    w = (torch.randn(3, 512, 1024, generator=g) * 1536 ** -0.5).to(
        "cuda", torch.bfloat16)
    twb.reset_launch_counts()
    for i in range(8):
        x, dw = twb.conv_k3_bwd(x, cot, w, 2 ** i)
    launches = twb.launch_counts()["conv_k3_bwd"]
    if not (torch.isfinite(x.float()).all() and torch.isfinite(dw).all()):
        raise RuntimeError("conv backward chain: non-finite")
    if launches != 8:
        raise RuntimeError(f"conv backward chain: {launches} launches")
    print(f"[train] conv_k3_bwd chain over dilations 1..128: {launches} "
          f"launches, |dx| peak {x.float().abs().max().item():.4g}")
    return launches


# the padded-layout family: the port's second implementation of the WN
# layer, the oracle side of the parity ladder (no serving or training path
# runs it, as in the JAX package)
PADDED_KERNELS = {
    "wn_layer_padded": ("wn_block_padded.cu",
                        PALLAS + "wn_block_padded.py:104"),
    "wn_layer_spect": ("wn_block_padded.cu", PALLAS + "wn_block_padded.py:165"),
    "wn_layer_stream": ("wn_block_padded.cu",
                        PALLAS + "wn_block_padded.py:302"),
    "wn_layer_stream_final": ("wn_block_padded.cu",
                              PALLAS + "wn_block_padded.py:353"),
}
# Rungs of the ladder between two kernels.  Both sides take the same bf16
# inputs and accumulate in f32 in another order; the final-layer rung also
# rounds at other places (kernel 3 folds w_rs into the end projection once
# per checkpoint, kernel 15 rounds the skip sum to bf16 before it), so its
# bounds are twice the kernel-vs-plain ones.
LADDER_MAX_ABS_STEPS = 8 * 2.0 ** -8
LADDER_REL_L2 = 1e-2


def padded_inputs(B, T, nv, C, M, E, seed, dev, n_cond=2) -> dict:
    """``layer_inputs`` plus a pre-materialized conditioning [B, T, 2C
    n_cond] (b_cond folded in) and the last layer's [C, C] res/skip weights
    and end projection."""
    k = layer_inputs(B, T, nv, C, M, seed, dev)
    g = torch.Generator(device="cpu").manual_seed(seed + 1000)

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    mask = (torch.arange(T) < nv)[None, :, None].to(dev)
    k["cond"] = rn(B, T, 2 * C * n_cond) * mask
    k["w_rs_last"] = rn(C, C, scale=C ** -0.5)
    k["b_rs_last"] = rn(C, scale=0.1, dtype=torch.float32)
    k["w_end"] = rn(C, E, scale=C ** -0.5)
    k["b_end"] = rn(E, scale=0.1, dtype=torch.float32)
    return k


def padded_args(k: dict, d: int, cond_index: int = 1) -> dict:
    """The four padded wrappers' argument tuples (without ``n_valid``) on
    the ``pad_tiles`` layout of ``k``'s activations."""
    from text2speech_tpu_torch.ops.wn_block_padded import pad_tiles

    xp, sp, acc = (pad_tiles(k[n]) for n in ("x", "spect", "skip_acc"))
    head = (k["w_in"], k["b_in"], k["w_cond"], k["b_cond"])
    std = (xp, sp, *head, k["w_rs"], k["b_rs"], acc, d)
    return {
        "wn_layer_padded": (xp, pad_tiles(k["cond"]), k["w_in"], k["b_in"],
                            k["w_rs"], k["b_rs"], d, cond_index),
        "wn_layer_spect": std,
        "wn_layer_stream": std,
        "wn_layer_stream_final": (xp, sp, *head, k["w_rs_last"],
                                  k["b_rs_last"], acc, k["w_end"],
                                  k["b_end"], d),
    }


def call_padded(fn, name: str, args, nv):
    """One padded call; the spect and stream kernels get a fresh copy of
    the skip sum (args[-2], updated in place)."""
    if name in ("wn_layer_spect", "wn_layer_stream"):
        return fn(*args[:-2], args[-2].clone(), args[-1], n_valid=nv)
    return fn(*args, n_valid=nv)


def padded_work(name: str, B, T, C, M, E) -> dict:
    """Operations of one padded call on its T real rows, by type."""
    bt = 2 * B * T
    taps, cond, rs = bt * 3 * C * 2 * C, bt * M * 2 * C, bt * C * 2 * C
    return {"bf16": {
        "wn_layer_padded": taps + rs,
        "wn_layer_spect": taps + cond + rs,
        "wn_layer_stream": taps + cond + rs,
        "wn_layer_stream_final": taps + cond + bt * C * C + bt * C * E,
    }[name]}


def check_padded_kernels(C: int = 512, M: int = 640, E: int = 8) -> dict:
    """The four padded kernels against their plain versions at B=1,
    T=6400 (Tp = 6656), C=512, M=640, E=8 for d in {1, 64, 128} at full
    and short ``n_valid``; pad tiles exactly zero; then times and bounds
    at d=64."""
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    dev = torch.device("cuda")
    bt = wp.BT_PAD
    rec = {n: {"max_abs_err": 0.0, "library_ms": None}
           for n in PADDED_KERNELS}
    B, T, seed = 1, 6400, 300
    for d in (1, 64, 128):
        for nv in (T, T - 301):
            seed += 1
            k = padded_inputs(B, T, nv, C, M, E, seed, dev)
            for name, args in padded_args(k, d).items():
                got = call_padded(getattr(wp, name), name, args, nv)
                want = call_padded(getattr(wp, name + "_plain"), name, args,
                                   nv)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                for i, (g, w) in enumerate(zip(got, want)):
                    tag = f"{name}[{i}] d={d} n_valid={nv}"
                    if g[:, :bt].any() or g[:, -bt:].any():
                        raise RuntimeError(f"{tag}: pad tiles not zero")
                    err = compare(tag, g, w)
                    rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"],
                                                   err)
    k = padded_inputs(B, T, T, C, M, E, 399, dev)
    for name, args in padded_args(k, 64).items():
        kern, plain = getattr(wp, name), getattr(wp, name + "_plain")
        outs = kern(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        tensors = [t for t in (*args, *outs) if torch.is_tensor(t)]
        r = rec[name]
        r["bound_ms"], r["bound_by"] = bound_ms(
            padded_work(name, B, T, C, M, E), tensors)
        r["ms"] = time_ms(lambda: kern(*args))
        r["plain_ms"] = time_ms(lambda: plain(*args))
        print(f"  {name} B={B} T={T} (Tp={T + 2 * bt}): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms (by {r['bound_by']})")
    return rec


def ladder_path(C: int = 512, M: int = 640, E: int = 8) -> dict:
    """The padded kernels' own path, the parity ladder across kernels on
    the card (``tests/test_pallas.py:81-250`` in the JAX package): kernel 2
    (the unpadded standard layer) against 14 and kernel 3 (the unpadded
    final layer, end projection folded) against 15 on the valid rows,
    kernel 9 (``dcond``) against 12 on the same stacked conditioning, and
    13 against 14 (two loop structures, and two sets of GEMM, gate and
    epilogue code in ``csrc/wn_block_padded.cu``).  Returns the padded
    kernels' launch counts of this run."""
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_dcond as wd
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    dev = torch.device("cuda")
    B, T, li = 1, 6400, 1

    def rung(tag, got, want, nv):
        return compare(f"ladder {tag}", got[:, :nv], want[:, :nv])

    worst = 0.0
    wp.reset_launch_counts()
    for i, (d, nv) in enumerate(((1, T), (64, T - 301), (128, T))):
        k = padded_inputs(B, T, nv, C, M, E, 500 + i, dev)
        a = padded_args(k, d, li)
        un = wp.unpad_tiles
        tag = f"d={d} n_valid={nv}"
        head = (k["w_in"], k["b_in"], k["w_cond"], k["b_cond"])
        x2, s2 = wb.wn_layer(k["x"], k["spect"], *head, k["w_rs"],
                             k["b_rs"], k["skip_acc"].clone(), d, n_valid=nv)
        x14, s14 = call_padded(wp.wn_layer_stream, "wn_layer_stream",
                               a["wn_layer_stream"], nv)
        x13, s13 = call_padded(wp.wn_layer_spect, "wn_layer_spect",
                               a["wn_layer_spect"], nv)
        worst = max(worst, rung(f"2 vs 14 x {tag}", x2, un(x14), nv),
                    rung(f"2 vs 14 skip {tag}", s2, un(s14), nv),
                    rung(f"13 vs 14 x {tag}", x13, x14, x13.shape[1]),
                    rung(f"13 vs 14 skip {tag}", s13, s14, s13.shape[1]))
        w_eff, b_eff = wb.fold_end(k["w_rs_last"], k["b_rs_last"],
                                   k["w_end"], k["b_end"])
        o3 = wb.wn_layer_final(k["x"], k["spect"], *head, w_eff,
                               k["skip_acc"], k["w_end"], b_eff, d,
                               n_valid=nv)
        o15 = call_padded(wp.wn_layer_stream_final, "wn_layer_stream_final",
                          a["wn_layer_stream_final"], nv)
        err = (o3[:, :nv] - un(o15)[:, :nv]).abs().max().item()
        rel = ((o3[:, :nv] - un(o15)[:, :nv]).norm()
               / o3[:, :nv].norm()).item()
        bound = LADDER_MAX_ABS_STEPS * max(o3.abs().max().item(), 1.0)
        print(f"  ladder 3 vs 15 {tag}: max_abs_err={err:.6g} (bound "
              f"{bound:.4g}) rel_l2={rel:.3g} (bound {LADDER_REL_L2})")
        if err > bound or rel > LADDER_REL_L2:
            raise RuntimeError("ladder 3 vs 15: kernels disagree")
        worst = max(worst, err)
        x9, s9 = wd.wn_layer_dcond(k["x"], k["cond"], li, k["w_in"],
                                   k["b_in"], k["w_rs"], k["b_rs"],
                                   torch.zeros_like(k["x"]), d, n_valid=nv)
        x12, s12 = call_padded(wp.wn_layer_padded, "wn_layer_padded",
                               a["wn_layer_padded"], nv)
        worst = max(worst, rung(f"9 vs 12 x {tag}", x9, un(x12), nv),
                    rung(f"9 vs 12 skip {tag}", s9, un(s12), nv))
    torch.cuda.synchronize()
    launches = wp.launch_counts()
    print(f"[ladder] launches {launches}; worst max_abs_err {worst:.4g}")
    if not all(launches.values()):
        raise RuntimeError(f"ladder: a padded kernel was not launched: "
                           f"{launches}")
    return launches


def write_corpus(root: str, cfg) -> str:
    """N_WAVS synthetic wavs (tones in noise, ~1.5 s) and their file list,
    from a numpy seed."""
    from scipy.io import wavfile

    rng = np.random.RandomState(0)
    names = []
    for i in range(N_WAVS):
        n = 30000 + 1000 * i
        t = np.arange(n) / cfg.sampling_rate
        sig = (0.3 * np.sin(2 * np.pi * (150 + 35 * i) * t)
               + 0.1 * np.sin(2 * np.pi * (900 + 110 * i) * t)
               + 0.02 * rng.randn(n))
        names.append(f"u{i}.wav")
        wavfile.write(os.path.join(root, names[-1]), cfg.sampling_rate,
                      (sig * 32767).astype(np.int16))
    path = os.path.join(root, "files.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(names))
    return path


def train_step_check(cfg, batch) -> None:
    """Phase 9: one optimizer step at full width through the gated kernels
    against the same step with the plain gated activation, from the same
    parameters (the seeded initialisation with the zero ``end`` convs
    perturbed, so that the WN layers carry gradient)."""
    from text2speech_tpu_torch.models.waveglow import TrainableWaveGlow
    from text2speech_tpu_torch.ops.gated import gated_activation, gated_plain
    from text2speech_tpu_torch.train.state import create_train_state
    from text2speech_tpu_torch.train.waveglow import make_wg_train_step

    results = {}
    for tag, fn in (("kernels", gated_activation), ("plain", gated_plain)):
        model = TrainableWaveGlow(
            cfg, gated=fn, generator=torch.Generator().manual_seed(cfg.seed),
            device="cuda")
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for name, p in sorted(model.params.items()):
                if "/end/" in name:
                    p.add_(0.01 * torch.randn(p.shape, generator=g).cuda())
        state = create_train_state(model.params, cfg.learning_rate)
        step = make_wg_train_step(model, cfg.sigma)
        reset_counts()
        _, m = step(state, batch)
        results[tag] = (m["loss"].item(), m["grad_norm"].item(),
                        gated_counts())
        del model, state, step
        torch.cuda.empty_cache()
    (l_k, g_k, c_k), (l_p, g_p, c_p) = results["kernels"], results["plain"]
    n = cfg.n_flows * cfg.wn_n_layers
    print(f"[train] one f32 step, kernels vs plain gated activation: loss "
          f"{l_k:.8g} vs {l_p:.8g} (bound {STEP_LOSS_ATOL}), grad norm "
          f"{g_k:.8g} vs {g_p:.8g} (bound {STEP_GNORM_RTOL} relative); "
          f"launches {c_k} vs {c_p}")
    if c_k != {"gated_fwd": n, "gated_bwd": n} or any(c_p.values()):
        raise RuntimeError("train step: wrong gated launch counts")
    if not (np.isfinite(l_k) and np.isfinite(g_k)):
        raise RuntimeError("train step: non-finite loss or gradient")
    if abs(l_k - l_p) > STEP_LOSS_ATOL or \
            abs(g_k - g_p) > STEP_GNORM_RTOL * g_p:
        raise RuntimeError("train step: kernels disagree with the plain "
                           "gated activation")


def fixed_batch_loss(model, cfg, batch) -> float:
    from text2speech_tpu_torch.models.losses import waveglow_loss

    with torch.no_grad():
        return waveglow_loss(*model(batch.mel, batch.audio),
                             cfg.sigma).item()


def cli_train(files: str, out: str, num_steps: int, *flags):
    """``waveglow_train.main`` with the CLI's arguments, in this process (so
    that the launch counts can be read); returns (trainer, gated launch
    counts, seconds, peak device bytes, [(step, loss, grad norm)])."""
    from text2speech_tpu_torch import waveglow_train

    argv = ["--training_files", files, "--output_directory", out,
            "--num_steps", str(num_steps), *flags]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer = waveglow_train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = gated_counts()
    other = {k: v for k, v in all_counts().items() if k not in counts and v}
    if other:
        raise RuntimeError(f"training launched serving kernels: {other}")
    losses = [(s, m["loss"].item(), m["grad_norm"].item())
              for s, m in trainer.recent]
    if not losses or not all(np.isfinite(v) for _, *vs in losses for v in vs):
        raise RuntimeError(f"training {flags}: no or non-finite losses "
                           f"{losses}")
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] waveglow_train {' '.join(argv[4:])}: steps "
          f"{losses[0][0]}..{losses[-1][0]} in {seconds:.2f} s (model build, "
          f"data and checkpoint included); losses "
          f"{[round(l, 6) for _, l, _ in losses]}; launches {counts}; peak "
          f"device memory {peak / 1e9:.3f} GB")
    return trainer, counts, seconds, peak, losses


def keep_newest(out: str) -> None:
    """Delete all but the newest checkpoint in ``out`` (each holds the
    parameters and both Adam moments, 3.3 GB at full width)."""
    names = sorted(f for f in os.listdir(out) if f.endswith(".pt"))
    for name in names[:-1]:
        os.unlink(os.path.join(out, name))


def step_rate(trainer, batch, n: int = 4) -> float:
    """Seconds per optimizer step of ``trainer`` on one batch already on
    the card, warm, the host clock around ``n`` steps and a synchronise."""
    trainer._train_step(trainer.state, batch)
    _, t = sync_time(lambda: [trainer._train_step(trainer.state, batch)
                              for _ in range(n)])
    return t / n


def train_path(synth, mel: torch.Tensor) -> dict:
    """Phases 9-11.  Returns the gated launch counts of the main training
    run."""
    from text2speech_tpu_torch.config import WaveGlowConfig
    from text2speech_tpu_torch.convert import (load_waveglow,
                                               variables_from_trainable)
    from text2speech_tpu_torch.data.mel2samp import Mel2Samp, files_to_list
    from text2speech_tpu_torch.infer import Synthesizer
    from text2speech_tpu_torch.models.waveglow import TrainableWaveGlow

    cfg = WaveGlowConfig()
    n = cfg.n_flows * cfg.wn_n_layers
    samples = cfg.batch_size * cfg.segment_length
    with tempfile.TemporaryDirectory() as d:
        files = write_corpus(d, cfg)
        paths = files_to_list(files)
        data = Mel2Samp(paths, cfg, device="cuda")
        batch = data.make_batch(paths[: cfg.batch_size],
                                list(range(cfg.batch_size)))
        if batch.audio.shape != (cfg.batch_size, cfg.segment_length) or \
                batch.mel.shape != (cfg.batch_size, cfg.n_mel_channels,
                                    cfg.segment_length // cfg.hop_length + 1):
            raise RuntimeError(f"batch shapes {batch.audio.shape} "
                               f"{batch.mel.shape}")
        train_step_check(cfg, batch)

        fresh = TrainableWaveGlow(
            cfg, generator=torch.Generator().manual_seed(cfg.seed),
            device="cuda")
        loss0 = fixed_batch_loss(fresh, cfg, batch)
        del fresh
        torch.cuda.empty_cache()

        out = os.path.join(d, "ckpt")
        trainer, counts, _, peak, losses = cli_train(files, out, TRAIN_STEPS)
        if trainer.state.step != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
            raise RuntimeError(f"trainer at step {trainer.state.step}")
        if counts != {"gated_fwd": n * TRAIN_STEPS,
                      "gated_bwd": n * TRAIN_STEPS}:
            raise RuntimeError(f"gated launches {counts}, want {n} + {n} per "
                               f"step")
        if trainer.ckpt.all_steps() != [TRAIN_STEPS]:
            raise RuntimeError(f"checkpoints {trainer.ckpt.all_steps()}")
        loss1 = fixed_batch_loss(trainer.model, cfg, batch)
        print(f"[train] loss on one fixed batch: {loss0:.6f} at the "
              f"initialisation, {loss1:.6f} after {TRAIN_STEPS} steps")
        if not loss1 < loss0:
            raise RuntimeError("training did not lower the fixed batch's loss")
        s = step_rate(trainer, batch)
        print(f"[train] f32 step (warm, batch on the card): {s * 1e3:.1f} ms "
              f"= {1 / s:.3f} steps/s = {samples / s:.6g} samples/s; peak "
              f"device memory of the run {peak / 1e9:.3f} GB")

        # the trained parameters serve: convert -> load_waveglow -> fused
        flat = variables_from_trainable(trainer.model)
        del trainer
        torch.cuda.empty_cache()
        served = Synthesizer(synth.hp, synth.taco, cfg,
                             load_waveglow(flat, cfg, device="cuda"),
                             use_denoiser=False, use_fused_vocoder=True)
        reset_counts()
        audio = served.mel_to_audio(mel, SIGMA, seed=0)
        want = (mel.shape[0], mel.shape[2] * cfg.upsample_stride)
        print(f"[train] trained weights through load_waveglow and the fused "
              f"vocoder: audio {tuple(audio.shape)}, peak "
              f"{audio.abs().max().item():.4g}, launches {all_counts()}")
        if tuple(audio.shape) != want or not torch.isfinite(audio).all() \
                or audio.std().item() < 1e-6:
            raise RuntimeError(f"served audio {tuple(audio.shape)}, want "
                               f"{want}, finite and not silent")
        if all_counts() != want_counts(cfg, False):
            raise RuntimeError("served vocode: wrong launch counts")
        del served, flat
        torch.cuda.empty_cache()

        # a process of its own resumes from the checkpoint
        cmd = [sys.executable, "-m", "text2speech_tpu_torch.waveglow_train",
               "--training_files", files, "--output_directory", out,
               "--num_steps", str(TRAIN_STEPS + 2)]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        print(f"[train] {' '.join(cmd[1:4])} ... --num_steps "
              f"{TRAIN_STEPS + 2} -> rc {r.returncode}: "
              f"{' | '.join(r.stdout.strip().splitlines()[-3:])}")
        if r.returncode != 0:
            raise RuntimeError(f"training CLI failed:\n{r.stderr}")
        if f"Resumed WaveGlow from step {TRAIN_STEPS}" not in r.stdout or \
                not os.path.exists(os.path.join(
                    out, f"ckpt_{TRAIN_STEPS + 2:08d}.pt")):
            raise RuntimeError("the CLI did not resume from the checkpoint")
        keep_newest(out)

        # the options: each resumes at step 14 and takes two steps
        at = TRAIN_STEPS + 2
        per_step = {"--remat": (2 * n, n), "--bf16": (n, n),
                    "--grad_accum": (3 * n, 3 * n)}
        for flags in (("--remat",), ("--bf16",), ("--grad_accum", "3")):
            at += 2
            trainer, c, _, peak, losses = cli_train(files, out, at, *flags)
            fwd, bwd = per_step[flags[0]]
            if [s_ for s_, _, _ in losses] != [at - 1, at]:
                raise RuntimeError(f"{flags}: steps {losses}")
            if c != {"gated_fwd": 2 * fwd, "gated_bwd": 2 * bwd}:
                raise RuntimeError(f"{flags}: gated launches {c}, want "
                                   f"{fwd} + {bwd} per step")
            s = step_rate(trainer, batch, n=2)
            print(f"[train] {' '.join(flags)} step (warm): {s * 1e3:.1f} ms "
                  f"= {1 / s:.3f} steps/s = {samples / s:.6g} samples/s; "
                  f"peak device memory of the run {peak / 1e9:.3f} GB")
            del trainer
            torch.cuda.empty_cache()
            keep_newest(out)
    return counts


# Tacotron training at full width (the reference HParams) on synthetic wavs
TACO_WAVS = 40
TACO_STEPS = 4
TACO_TEXTS = [
    "이 것은 제작되고 있는 중입니다.",
    "안녕하세요. 만나서 반갑습니다.",
    "오늘 날씨가 참 좋네요.",
    "존경하는 사람과 함께 갑니다.",
    "내일은 비가 올 것 같습니다.",
]
# One step on the card against the same step on the CPU (TF32 off): the
# same f32 products in another order through 64 decoder steps, and cuDNN's
# convolution algorithms against the CPU's: loss within 1e-4 relative,
# the gradient as a whole within 1e-3 relative L2.
TACO_STEP_LOSS_RTOL = 1e-4
TACO_STEP_GRAD_REL_L2 = 1e-3
# The bf16 step on the card (autocast's CUDA op lists, the decoder step's
# weights cast once through _SharedCast) against the f32 step on the CPU:
# products of bf16-rounded operands (2^-8 each) through 64 decoder steps.
# The same comparison under the CPU's autocast at this width reads a loss
# 1.8e-5 relative apart, the gradient 0.035 relative L2 apart and each leaf
# at most 0.085 apart; the bounds leave about three times that.  A conv
# bias that feeds a BatchNorm has a zero gradient in exact arithmetic and
# returns rounding noise on both sides, so those leaves are left out of the
# per-leaf bound (they count in the whole).
TACO_BF16_LOSS_RTOL = 1e-3
TACO_BF16_GRAD_REL_L2 = 0.1
TACO_BF16_LEAF_REL_L2 = 0.25


def write_taco_corpus(root: str) -> str:
    """TACO_WAVS synthetic wavs of 1-2.5 s at 44.8 kHz (tones in noise)
    with Korean transcripts, in the KSS layout, from a numpy seed."""
    from scipy.io import wavfile

    rng = np.random.RandomState(1)
    os.makedirs(os.path.join(root, "1"), exist_ok=True)
    sr, lines = 44800, []
    for i in range(TACO_WAVS):
        n = int(sr * (1.0 + 1.5 * i / (TACO_WAVS - 1)))
        t = np.arange(n) / sr
        sig = (0.3 * np.sin(2 * np.pi * (140 + 9 * i) * t)
               + 0.02 * rng.randn(n))
        name = f"1/{i:03d}.wav"
        wavfile.write(os.path.join(root, name), sr,
                      (sig * 32767).astype(np.int16))
        lines.append(f"{name}|{TACO_TEXTS[i % len(TACO_TEXTS)]}|x|1.0")
    with open(os.path.join(root, "transcript.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return root


def taco_step_check(hp, corpus: str) -> None:
    """One Tacotron training step at full width on the card, in f32 and in
    bf16, against the same f32 step on the CPU: the same seeded weights,
    batch (two rows cut to 64 frames) and hand-built dropout masks."""
    from text2speech_tpu_torch.data.dataset import Batch, TextMelDataset
    from text2speech_tpu_torch.models.losses import tacotron2_loss
    from text2speech_tpu_torch.models.tacotron2 import (Tacotron2,
                                                        init_weights_)
    from text2speech_tpu_torch.text import N_SYMBOLS

    data = TextMelDataset([corpus], hp, device="cpu")
    b = data.make_batch(data.items[:2])
    b = Batch(b.text, b.input_lengths, b.mel[:, :, :64].contiguous(),
              b.gate[:, :64].contiguous(), b.speaker_id,
              b.output_lengths.clamp(max=64))
    model = init_weights_(Tacotron2(hp, N_SYMBOLS),
                          torch.Generator().manual_seed(3))
    masks = model.draw_train_masks(2, b.text.shape[1], 64,
                                   torch.Generator().manual_seed(4))
    out = {}
    for tag, dev, dtype in (("cpu", "cpu", None), ("f32", "cuda", None),
                            ("bf16", "cuda", torch.bfloat16)):
        m = Tacotron2(hp, N_SYMBOLS, device=dev, compute_dtype=dtype)
        m.load_state_dict(model.state_dict())
        mb = Batch(*(t.to(dev) for t in b))
        mk = type(masks)(*([x.to(dev) for x in f] if isinstance(f, list)
                           else f.to(dev) for f in masks))
        preds = m(mb.text, mb.input_lengths, mb.mel, mb.output_lengths,
                  train=True, masks=mk)
        if any(p.dtype != torch.float32 for p in preds):
            raise RuntimeError(f"taco step {tag}: outputs not f32")
        loss, _ = tacotron2_loss(*preds[:3], mb.mel, mb.gate)
        loss.backward()
        out[tag] = (loss.item(), {n: p.grad.cpu()
                                  for n, p in m.named_parameters()})

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    def flat(g):
        return torch.cat([v.flatten() for v in g.values()])

    l_c, g_c = out["cpu"]
    for tag, l_rtol, g_bound in (
            ("f32", TACO_STEP_LOSS_RTOL, TACO_STEP_GRAD_REL_L2),
            ("bf16", TACO_BF16_LOSS_RTOL, TACO_BF16_GRAD_REL_L2)):
        l_g, g_g = out[tag]
        whole = rel(flat(g_g), flat(g_c))
        leaves = {n: rel(g_g[n], g_c[n]) for n in g_c
                  if not (".convs." in n and n.endswith(".bias"))}
        worst = max(leaves, key=leaves.get)
        print(f"[taco] one {tag} step on the card vs the f32 step on the CPU "
              f"at full width (B=2, T_out=64, the same masks): loss {l_g:.8g}"
              f" vs {l_c:.8g} ({abs(l_g - l_c) / l_c:.3g} relative, bound "
              f"{l_rtol}), gradient relative L2 {whole:.3g} (bound "
              f"{g_bound}), worst leaf {worst} {leaves[worst]:.3g}"
              + (f" (bound {TACO_BF16_LEAF_REL_L2})" if tag == "bf16"
                 else ""))
        if not np.isfinite(l_g) or abs(l_g - l_c) > l_rtol * l_c \
                or whole > g_bound:
            raise RuntimeError(f"taco {tag} step: the card disagrees with "
                               f"the CPU")
        if tag == "bf16" and leaves[worst] > TACO_BF16_LEAF_REL_L2:
            raise RuntimeError(f"taco bf16 step: leaf {worst} disagrees "
                               f"with the CPU's f32")


def cli_taco(corpus: str, log_dir: str, num_steps: int, *flags):
    """``tacotron_train.main`` in this process; returns (trainer, seconds,
    peak device bytes)."""
    from text2speech_tpu_torch import tacotron_train

    argv = ["--data_paths", corpus, "--log_dir", log_dir, "--num_steps",
            str(num_steps), "--checkpoint_interval", "1000", "--device", "cuda",
            *flags]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer = tacotron_train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if any(all_counts().values()):
        raise RuntimeError(f"Tacotron training launched vocoder kernels: "
                           f"{all_counts()}")
    loss = float(trainer.last_metrics["loss"])
    peak = torch.cuda.max_memory_allocated()
    print(f"[taco] tacotron_train {' '.join(argv[4:])}: at step "
          f"{trainer.state.step} in {seconds:.2f} s (model build, data and "
          f"checkpoint included), last loss {loss:.6f}, grad norm "
          f"{float(trainer.last_metrics['grad_norm']):.4f}; peak device "
          f"memory {peak / 1e9:.3f} GB")
    if trainer.state.step != num_steps or not np.isfinite(loss):
        raise RuntimeError(f"tacotron_train {flags}: step "
                           f"{trainer.state.step}, loss {loss}")
    return trainer, seconds, peak


def taco_rate(trainer, batch, n: int = 2) -> float:
    """Seconds per optimizer step of ``trainer`` on one batch already on
    the card, warm: the host clock around ``n`` steps and a synchronise."""
    from text2speech_tpu_torch.train.tacotron import step_generator

    def steps():
        for i in range(n):
            trainer._train_step(trainer.state, batch,
                                step_generator(0, i, "cuda"))

    _, t = sync_time(steps)
    return t / n


def tacotron_train_path(synth, info: str) -> None:
    """Tacotron-2 training at full width (embedding 512, encoder convs 512,
    attention and decoder LSTMs 1024, postnet 5 x 512) on a synthetic
    corpus: one f32 and one bf16 step on the card against the f32 step on
    the CPU; 4 steps at batch 32 through ``tacotron_train.main``; a resume
    in a process of its own; 2 steps each with ``--remat``, ``--bf16`` and
    ``--grad_accum 2``; the trained checkpoint through
    ``Synthesizer.load_checkpoints(taco_ckpt_dir=)`` into a decode and the
    fused vocoder.  Prints the seconds of each part."""
    from text2speech_tpu_torch.config import HParams

    hp = HParams()
    secs = {}

    def part(tag, fn):
        out, secs[tag] = sync_time(fn)
        return out

    with tempfile.TemporaryDirectory() as d:
        corpus = part("corpus", lambda: write_taco_corpus(
            os.path.join(d, "kss")))
        part("one step f32 and bf16 vs CPU",
             lambda: taco_step_check(hp, corpus))
        logs = os.path.join(d, "logs")
        trainer, _, peak = part(f"CLI {TACO_STEPS} steps",
                                lambda: cli_taco(corpus, logs, TACO_STEPS))
        run_dir = trainer.run_dir
        ckpt = os.path.join(run_dir, "checkpoints")
        batch = next(iter(trainer.dataset.epoch(0)))
        B, T_out = batch.mel.shape[0], batch.mel.shape[2]
        s = part("warm rate, 2 steps", lambda: taco_rate(trainer, batch))
        print(f"[taco] f32 step (warm, batch {B} x {T_out} frames on the "
              f"card): {s * 1e3:.1f} ms = {1 / s:.4f} steps/s = "
              f"{B / s:.3f} samples/s; peak device memory of the run "
              f"{peak / 1e9:.3f} GB ({info})")
        del trainer
        torch.cuda.empty_cache()

        cmd = [sys.executable, "-m", "text2speech_tpu_torch.tacotron_train",
               "--data_paths", corpus, "--load_path", run_dir,
               "--num_steps", str(TACO_STEPS + 1), "--checkpoint_interval",
               "1000", "--device", "cuda"]
        r = part("resume in its own process", lambda: subprocess.run(
            cmd, capture_output=True, text=True, timeout=600))
        print(f"[taco] python -m text2speech_tpu_torch.tacotron_train "
              f"--load_path ... --num_steps {TACO_STEPS + 1} -> rc "
              f"{r.returncode}: "
              f"{' | '.join(r.stdout.strip().splitlines()[-2:])}")
        if r.returncode != 0:
            raise RuntimeError(f"Tacotron CLI failed:\n{r.stderr}")
        if f"Resumed from checkpoint at step {TACO_STEPS}" not in r.stdout \
                or not os.path.exists(os.path.join(
                    ckpt, f"ckpt_{TACO_STEPS + 1:08d}.pt")):
            raise RuntimeError("the Tacotron CLI did not resume")

        # the options' warm step rates are profile_torch.py's
        # (--stages tacotron_train); here each resumes and takes two steps
        at = TACO_STEPS + 1
        for flags in (("--remat",), ("--bf16",), ("--grad_accum", "2")):
            at += 2
            part(f"CLI {' '.join(flags)} 2 steps", lambda: cli_taco(
                corpus, logs, at, "--load_path", run_dir, *flags))
            torch.cuda.empty_cache()

        def decode():
            synth.load_checkpoints(taco_ckpt_dir=ckpt)
            reset_counts()
            mel, _ = synth.text_to_mel(TEXTS[:1], max_steps=MAX_STEPS)
            return mel, synth.mel_to_audio(mel, SIGMA, seed=0)

        mel, audio = part("checkpoint into a decode and the vocoder", decode)
        print(f"[taco] checkpoint of step {at} through load_checkpoints("
              f"taco_ckpt_dir=): mel {tuple(mel.shape)}, audio "
              f"{tuple(audio.shape)}, peak {audio.abs().max().item():.4g}, "
              f"launches {all_counts()}")
        if not (torch.isfinite(mel).all() and torch.isfinite(audio).all()) \
                or audio.shape[-1] != mel.shape[-1] * \
                synth.wg_cfg.upsample_stride:
            raise RuntimeError("trained Tacotron: bad decode or audio")
        if all_counts() != want_counts(synth.wg_cfg, False):
            raise RuntimeError("trained Tacotron: wrong vocoder launches")
    print(f"[time] phase 24 parts, seconds: "
          f"{ {k: round(v, 2) for k, v in secs.items()} }; in all "
          f"{sum(secs.values()):.2f}")


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

    from text2speech_tpu_torch.ops import gated, wn_backward
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_int8 as wq
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    t0 = time.perf_counter()
    libs = (wb.LIB, wb.LIB_SM90, wq.LIB, gated.LIB, wn_backward.LIB,
            wn_backward.LIB_SM90, wp.LIB)
    with ThreadPoolExecutor(len(libs)) as pool:   # one nvcc per source
        for f in [pool.submit(lib.build) for lib in libs]:
            f.result()
    for lib in libs:
        lib.get()
        print(f"[build] {lib.source.name}: nvcc {lib.build_seconds:.2f} s")
        print(lib.build_log.strip())
    print(f"[build] {len(libs)} libraries built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in (wb.LIB_SM90, wn_backward.LIB_SM90):
        print(f"[build] {lib.source.name} SASS: {hgmma_counts(lib.path)}")
        print(f"[build] {lib.source.name} registers (-Xptxas -v): "
              f"{ptxas_registers(lib.build_log)}")

    print("[kernels] kernel vs plain at C=512, M=640")
    rec = check_kernels()
    bf16 = main_path("bf16", int8=False)
    int8 = main_path("int8", int8=True, rel32_bf16=bf16["rel32"])
    print(f"[e2e] vocode+denoise, batch {len(TEXTS)} x {MAX_STEPS} frames: "
          f"bf16 {bf16['vocode_ms']:.3f} ms, int8 {int8['vocode_ms']:.3f} ms")
    int8_launches = int8["launches"]
    long_form(int8["synth"], int8["mel"], "int8", int8=True)
    long_form(bf16["synth"], bf16["mel"], "bf16", int8=False)
    cli_run("--fused_vocoder")
    cli_run("--int8_vocoder")

    print("[kernels] composed-conditioning kernels vs plain at C=512, L=8")
    rec.update(check_dcond_kernels())
    dcond_launches = composed_path(bf16["synth"], bf16["mel"], bf16["rel32"])
    streaming(bf16["synth"], "bf16", int8=False)
    streaming(int8["synth"], "int8", int8=True)
    quantized_decode(bf16["synth"])
    cli_stream()

    print("[kernels] tensor-parallel partial kernels vs plain at C=512, "
          "M=640, p=2,4,8")
    rec.update(check_partial_kernels())
    tp_launches = tp_path(bf16["synth"], int8["synth"], bf16["mel"],
                          bf16["rel32"])
    server_path(bf16["synth"], "bf16", int8=False)
    server_path(int8["synth"], "int8", int8=True)
    server_reload(int8["synth"], "int8", int8=True)
    cli_serve_batch()
    cli_serve_http()

    print("[kernels] training kernels vs plain")
    rec.update(check_train_kernels())
    chain_launches = conv_backward_path()
    del int8
    torch.cuda.empty_cache()
    trained = train_path(bf16["synth"], bf16["mel"])

    print("[kernels] padded-layout kernels vs plain at C=512, M=640, E=8")
    padded, t = sync_time(check_padded_kernels)
    rec.update(padded)
    print(f"[time] phase 22: {t:.2f} s")
    ladder_launches, t = sync_time(ladder_path)
    print(f"[time] phase 23: {t:.2f} s")
    tacotron_train_path(bf16["synth"], info)

    launches = {**{n: bf16["launches"][n] for n in list(KERNELS)[:3]},
                **{n: int8_launches[n] for n in list(KERNELS)[3:]},
                **{n: dcond_launches[n] for n in DCOND_KERNELS},
                **tp_launches, **trained, "conv_k3_bwd": chain_launches,
                **ladder_launches}
    if not all(launches.values()):
        raise RuntimeError(f"a kernel was launched on no path: {launches}")
    kernels = [{
        "name": n, "route": "cuda", "source": CSRC + src, "replaces": repl,
        "launches": launches[n], "max_abs_err": rec[n]["max_abs_err"],
        "ms": rec[n]["ms"], "plain_ms": rec[n]["plain_ms"],
        "bound_ms": rec[n]["bound_ms"], "bound_by": rec[n]["bound_by"],
        # no one PyTorch call computes a fused WN layer or the gated
        # activation; the conv backward has aten.convolution_backward
        "library_ms": rec[n].get("library_ms"),
        # the redesigned kernels: their first design's time, both at batch
        # 3 (the WN layers) and the conv backward's f32 form
        **{k: rec[n][k] for k in ("prev_ms", "ms_b3", "prev_ms_b3", "f32")
           if k in rec[n]},
    } for n, (src, repl) in {**KERNELS, **DCOND_KERNELS, **PARTIAL_KERNELS,
                             **TRAIN_KERNELS, **PADDED_KERNELS}.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
