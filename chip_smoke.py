#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which passes or raises (the script then exits non-zero):

1. require CUDA; print the card's name and power limit; turn TF32 off;
2. build the hand-written kernels from ``csrc/`` (the bf16 WN-layer
   library and its Hopper redesign of the first, standard, final, ``dcond``
   first, standard and final and tensor-parallel partial layers (both
   forms), the int8
   WN-layer library and its Hopper redesign of the standard, the
   tensor-parallel partial, the final and the first layer on s8
   ``wgmma``, the padded WN-layer library and the Hopper redesigns of its
   stream pair and of its spect / padded pair, the gated activation, the
   k=3 conv backward and its Hopper redesign, VITS's generator
   convolutions (phase 33), one ``nvcc`` each, all
   started together) and print the times, and for the five Hopper files
   the ``HGMMA`` / ``IGMMA`` count per kernel and the registers, stack
   frames and spills ``-Xptxas -v`` reports (the bf16 first layers, the
   partial layer's layer-0 form, the s8 final and first layers and both
   roles of each padded Hopper kernel must show neither);
3. compare each of the six projecting kernels with its plain PyTorch version on the
   card at the reference width (C=512, M=640) over batch sizes, dilations,
   valid lengths and flow widths, and the standard and final layers also at
   the edges of their 128-row tile (T and n_valid off the tile grid, a
   halo of a whole tile, batch 3, nothing valid), the s8 standard, final
   and first layers there also against their first design and run twice
   (bitwise equal), the bf16 first layer against its plain version and its
   first design over n_half 2-4, d 1, 64, 128, n_valid = T, < T, < d and
   0, batch 1 and 3, C 512 and 256; time them with CUDA events at one
   vocode's shapes and compute the card's bound for the same work; time
   the first, standard and final and s8 standard, first and final layers
   at batch 1 and 3 beside their first design (``wn_block.first_design``,
   ``wn_block_int8.first_design``), with ``structure`` lines (the bf16 and
   s8 standard layers at n_valid = 0: the first layers' skeletons), and
   the two products of the standard layer as one library call each;
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
   then phase 25;
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
    all three (the sm90 kernel) also at the edges of their tile and
    against their first design (the final one leaving ``skip_acc``
    untouched; the first one over n_half, d, n_valid < d and 0, C 512 and
    256); times and bounds, all three at batch 1 and 3 beside their first
    design in turns, and a ``structure`` line (the standard one at n_valid
    = 0: the first one's skeleton);
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
    2..4 with the edge-bias rows; the sm90 ``PART_FIRST`` role, also at p
    = 1, d 1 and 64, n_valid = T, < T, 1 and 0, T = 6400 and off the tile,
    M 640 and 96, and the ranks' sum against the whole first layer); all
    three sm90 forms (``PART``, ``PART_FIRST``, s8 ``PART``) also against
    their first design, the int8 one equal to its plain version bit for bit,
    also at the edges of its tile (nothing valid, T - 1, off the tile, d
    = 400, batch 3); the sum of the p partials plus the bias against the
    whole layer's plain res/skip product; times and bounds at B=1, T=6400
    for p = 2 and 4, both beside their first design in turns at batch 1
    and 3, the layer-0 form so too at d = 1 with its bound and share, after
    a ``structure`` line (the sm90 ``PART`` form at n_valid = 0: the
    layer-0 role's skeleton), and the bf16 one's 64- against its 128-row
    tile at batch 1;
    the s8 standard and final layers with one against two column groups
    at batch 1 and 3, and the s8 partial layer so at p = 8, and at p = 4,
    2 its wrapper against the kernel alone;
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
    ``n_valid``, pad tiles exactly zero; then rows 13 and 12
    (``csrc/wn_block_padded_tiles_sm90.cu`` SPECT and PADDED) and rows
    14-15 (``csrc/wn_block_padded_sm90.cu`` STREAM and STREAM_FINAL)
    against their plain versions and their first design over d = 0, 1,
    63, 64, 128, n_valid = T, T - 301, 1, 0, batch 1 and 3, rs_out 2C and
    C (cond_index 0 and 1, E 8 and 1) and C=192, M=96, and each kernel at
    the widest width its plan takes; the in-place skip sums between guard
    rows, the final layer's skip sum and row 12's ``cond_p`` untouched;
    all four timed at batch 1 and 3 beside the first design in turns,
    with the plain version and the bound;
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
    and the fused vocoder; that checkpoint alone through the inference
    CLI's Griffin-Lim path (``--taco_checkpoint DIR --griffin_lim_iters 8``,
    in this process with no WN-layer launch, then in a process of its own:
    a WAV of hop x (frames - 1) samples).  Phases 22-24 print the seconds
    they take;
25. the vocoder CLIs at full width: ``python -m text2speech_tpu_torch.
    mel2samp`` on a synthetic wav, ``python -m text2speech_tpu_torch.
    waveglow_inference --int8`` and ``--fused`` (with the denoiser) on its
    mel and a port checkpoint saved from seeded weights, each WAV's
    format and length; ``waveglow_inference.main --int8`` in this process
    launching the s8 standard, first and final layers 72 / 12 / 12 times;
26. corpus preprocessing: ``python -m text2speech_tpu_torch.preprocess`` on
    a KSS-shaped corpus of 200 synthetic WAVs of 1-10 s at 44,100 Hz with
    silent lead-ins and tails, in a process of its own with ``--trim_impl
    device`` and then ``host``: equal npz arrays and ``train.txt``, the
    native WAV decoder built and used for every load, the port's npz
    feeder batching the output on the card, mel frames per second of each.

27. data parallelism (``parallel/mesh.py``) at full width: on an NCCL
    group of this one rank, a WaveGlow and a Tacotron training step
    (``grad_accum`` 1 and 2, deterministic kernels) and ``infer_long`` of a
    600-frame mel through the bf16 and the int8 fused vocoder, each bit for
    bit its ``mesh=None`` call; then two processes on this card over gloo
    (CUDA tensors): one WaveGlow step on a global batch of 4 x 16,000
    samples (2 rows a rank, 96 + 96 gated launches each), the Tacotron
    step at ``grad_accum`` 1 and 2 on 4 rows of unequal lengths and
    ``infer_long(mesh=)`` with both fused vocoders (3 windows padded to 4,
    12 / 72 / 12 WN launches a rank), each against the one-process call on
    the card; ``python -m torch.distributed.run --nproc_per_node 2 -m
    text2speech_tpu_torch.waveglow_train`` for 2 steps (one checkpoint)
    and a resume to 3; a 2 x 2 (data x model) TP grid in four processes on
    a 64-frame mel, bf16 and int8, against the one-process two-shard
    server and the single-device fused vocoders, 96 (12 + 84) partial
    launches a rank.  Gloo on one card copies through the host: the walls
    measure correctness, not a rate;
28. tensor-parallel decode and full-chain tensor-parallel serving at full
    width (``parallel/tp_tacotron.py``, ``parallel/serve.py``,
    ``server.make_server_tp``) on seeded random weights: the f32
    ``TPTacotronDecoder`` at p = 2 and 4 (all shards on this card) against
    ``decode_chunk_serve`` over 64 steps at batch 3 on the same masks (1e-4
    on the mel), bf16 beside it, the int8 slices' payloads and scales equal
    to the whole kernels' rows, steps per second and kernels per step (the
    profiler's trace) of each; ``TPSynthesizer(n_model=2)`` in bf16 and
    int8 against the fused ``Synthesizer`` on the same masks and noise
    (3 texts x 200 frames) and its vocoder alone on the same mel, both
    within phase 18's bounds, 12 p + 84 p partial launches per vocode (12
    p of the bf16 and 84 p of the int8 one with ``int8``) and none of the
    whole-layer wrappers; ``synthesize_incremental`` with the denoiser
    against the offline denoiser over its raw stream; ``make_server_tp``
    (4 slots, 6 texts x 400 steps) against ``make_server`` on the same
    masks and noise within the same bounds, audio seconds per wall second
    of both; two processes on this card over gloo (a model group of two):
    the decode (f32 and bf16) and one ``make_server_tp`` run of 3 texts x
    128 steps, each bit for bit the one-process two-shard run.
29. reference checkpoints into the port, the profiling tools and the
    worked example (``convert.py``'s torch loaders,
    ``convert_checkpoint``, ``utils/profiling.py``,
    ``examples/demo.py``): reference-format state dicts of seeded weights
    at full width (a Tacotron at ``HParams()`` in the ``train.py:72``
    format, a WaveGlow at ``WaveGlowConfig()``, its early outputs shrinking
    the flows to 8, 6 and 4 channels, live ``end`` convs, as a bare state
    dict and again in the pre-fusion ``res_layers`` / ``skip_layers``
    layout) through ``python -m text2speech_tpu_torch.convert_checkpoint``
    in processes of their own (the two WaveGlow conversions equal bit for
    bit, each printed count the state dict's), ``python -m
    text2speech_tpu_torch.inference --taco_checkpoint T
    --waveglow_checkpoint W --fused_vocoder`` writing a WAV of frames x hop
    samples; in this process ``load_torch_checkpoint`` and the module
    conveniences: one fused vocode launching rows 1-3 12 / 72 / 12 times
    and no other WN-layer kernel, held to the f32 ``WaveGlow.infer`` on
    the same mel and noise by phase 4's bound, its f32 mel bit for bit a
    ``Synthesizer`` of the converted checkpoint directories'; the same
    vocode under ``trace_capture`` / ``annotate("vocode")`` /
    ``StepTimer`` (the Chrome trace names the ``wn_sm90_kernel`` launches
    and the region), and one ``synthesize`` under ``trace_capture`` (the
    trace names the program's ``taco.decoder`` and ``wg.flows`` spans);
    row 4 at the demo's widths (C = 128 in two shares of
    64 columns, layer 0's ``PART_FIRST`` and layer 1's ``PART``, each rank
    against its plain version by phase 17's bound, the ranks' sum against
    the whole layer), which no other phase reaches; then ``python -m
    text2speech_tpu_torch.examples.demo --steps 2`` in a process of its
    own (rc 0, both WAVs, its wall and launches).  The corpus drill is not run here: its inference stage
    always draws plots, and the card's machine has no matplotlib.
30. what the program's spans cost when a recorder listens
    (``utils/profiling.py::recording``): ``Synthesizer.synthesize`` at the
    offline benchmark's shapes (32 texts x 320 frames, fused bf16 vocoder,
    denoiser) on seeded weights, in two sets of batches with the same
    seeds, each batch once with and once without a recorder (in turns,
    the order swapped every batch); both walls of every batch, each set's
    medians and their ratio, the spans and counter values a batch
    records, and the audio bit for bit the same either way; then one
    span's own cost, with and without a recorder, over 100,000 empty
    spans, and that cost times a batch's spans as a share of its wall.
31. the text-to-mel layer's two loops replayed from CUDA graphs
    (``utils/cuda_graphs.py``; ``Decoder.run_steps``, ``BiLSTM.forward``):
    ``Synthesizer.text_to_mel`` at the offline benchmark's shape (32 of
    its texts, padded to 256 symbols, 320 frames) on seeded weights, the
    eager loops and the graphs in turns over the same seeds: both walls
    of every batch and their medians, the first graphed call's wall (the
    two captures), the mels and lengths bit for bit the same, and the
    counters ``taco.graph_captures`` / ``taco.graph_replays``; then the
    benchmark's open-loop serve schedule (16 slots, 3.5 req/s, 50 s, one
    seed) through ``make_server`` under a recorder, eager then graphed:
    rounds, requests done, and the medians of the ``serve.admit`` /
    ``serve.decode`` spans.
32. VITS's coupling flows on the gated activation kernel
    (``models/vits.py::CouplingLayer.wn``): ``gated_fwd`` against
    ``gated_plain`` at the benchmark cell ``vits-offline-b32``'s shapes
    (f32 [32, T_y, 384] with a dense zero ``b``, T_y 1,088 and 1,061, one
    launch each), then one ``VitsSynthesizer.synthesize`` of 32 of the
    cell's texts on its seeded weights, the counts reset just before: 16
    ``gated_fwd`` launches (4 flows x 4 WN layers), the generator's 73
    ``vits_conv.conv`` (by role: conv_pre 1, a pair's first conv 36, its
    second 28, with the running sum 8), 4 ``vits_conv.up`` and 1
    ``vits_conv.post``, no ``gated_bwd`` and no WN-layer kernel, 32 finite
    waveforms of whole frames.
33. VITS's generator channels-last on the fused convolution kernels of
    ``csrc/vits_conv_sm90.cu`` (``ops/vits_conv.py``): the library's
    ``-Xptxas -v`` registers and ``HGMMA`` counts, no tile with a stack
    frame that could hold an accumulator tile; each role at the cell's
    shapes (B = 32, T
    = 1,216 frames: conv_pre, the four transposed convolutions, per stage
    a pair's first convolution at (k, d) = (3, 1), (7, 3), (11, 5), its
    second at k 11 with the residual, resblock 3's last with the running
    sum and 1/3, conv_post) against its plain version on the card, its
    kernel ms beside the bound from ``perfbench/roofline_vits.py``'s
    counts, the plain chain's ms and cuDNN's ms for the same convolution
    on channels-first input (``library_ms``; the port never calls it);
    then whole generator passes at that shape, ``Generator.first_design``
    and the kernels in turns, with 78 launches and the
    ``vits.gen_launches`` counter a pass and the audio's noise against
    the benchmark's f32 reference generator
    (``perfbench/reference/vits.py``), the first design's beside it.

Phase 25 runs right after phase 7, phases 12-21 between it and phase 8,
phases 22-24 after phase 11, phases 26, 27, 28, 29, 30, 31, 32 and 33
last.  The line
before the last is a JSON object with one record per kernel (its
``paths``: the launches on phase 29's convert path and in its demo; the
generator's rows V1-V6 take their launches from phase 32's ``synthesize``
and their times, per case, from phase 33); the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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
    "wn_layer_first": ("wn_block_sm90.cu", PALLAS + "wn_block.py:459"),
    "wn_layer": ("wn_block_sm90.cu", PALLAS + "wn_block.py:398"),
    "wn_layer_final": ("wn_block_sm90.cu", PALLAS + "wn_block.py:528"),
    "wn_layer_first_int8": ("wn_block_int8_sm90.cu",
                            PALLAS + "wn_block_int8.py:338"),
    "wn_layer_int8": ("wn_block_int8_sm90.cu",
                      PALLAS + "wn_block_int8.py:268"),
    "wn_layer_final_int8": ("wn_block_int8_sm90.cu",
                            PALLAS + "wn_block_int8.py:510"),
}
# the composed-conditioning flavours (the DCOND instantiations)
DCOND_KERNELS = {
    "wn_layer_first_dcond": ("wn_block_sm90.cu",
                             PALLAS + "wn_block_dcond.py:100"),
    "wn_layer_dcond": ("wn_block_sm90.cu", PALLAS + "wn_block_dcond.py:43"),
    "wn_layer_final_dcond": ("wn_block_sm90.cu",
                             PALLAS + "wn_block_dcond.py:162"),
}
# the tensor-parallel partial layers (one rank's share of a layer)
PARTIAL_KERNELS = {
    "wn_layer_partial": ("wn_block_sm90.cu", PALLAS + "wn_block.py:642"),
    "wn_layer_partial_int8": ("wn_block_int8_sm90.cu",
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
    """``wgmma`` instructions per kernel in a built library's SASS (``HGMMA``
    for bf16, ``IGMMA`` for s8), by ``cuobjdump`` beside ``nvcc``; "no
    cuobjdump" where the toolkit has none."""
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
        elif name and re.search(r"\b[HI]GMMA\b", line):
            counts[name] += 1
    names = demangled(counts)
    counts = {names[n]: c for n, c in counts.items()}
    return (f"{sum(counts.values())} HGMMA / IGMMA instructions; per kernel: "
            f"{counts}")


def ptxas_registers(log: str) -> str:
    """Registers, stack frame and spill bytes per kernel from a build's
    ``-Xptxas -v`` output (a stack frame in a ``wgmma`` kernel means an
    array in local memory)."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spill = (f", stack {m.group(1)} B" if m.group(1) != "0" else "")
            spill += (f", spills {m.group(2)}/{m.group(3)} B" if m.group(2)
                      != "0" or m.group(3) != "0" else "")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, f"{m.group(1)}{spill}"))
            name, spill = None, ""
    names = demangled(n for n, _ in out)
    return "; ".join(f"{names[n]}: {regs}" for n, regs in out)


def require_no_local_memory(lib, roles: dict) -> None:
    """Raise when an instantiation of ``lib``'s ``kernel`` template whose
    first template argument is in ``roles`` ({code: name}) has a stack
    frame or spills in the build's ``-Xptxas -v`` output: in a ``wgmma``
    kernel that means an array in local memory (read from the mangled
    names, ``...kernelILi<role>ELi<nc>E...`` or ``...kernelILi<role>EE...``).
    Raises too when no instantiation of a role in ``roles`` was reported."""
    name, found = None, set()
    for line in lib.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        r = re.search(r"kernelILi(\d+)E(?:Li(\d+)E)?", name or "")
        if m and r and int(r.group(1)) in roles:
            found.add(int(r.group(1)))
            if any(int(v) for v in m.groups()):
                form = (f" with {r.group(2)} column group(s) or "
                        f"warpgroup(s)" if r.group(2) else "")
                raise RuntimeError(
                    f"{lib.source.name}: the {roles[int(r.group(1))]} role"
                    f"{form} has a {m.group(1)} B stack frame and "
                    f"{m.group(2)}/{m.group(3)} B of spills")
    if set(roles) - found:
        raise RuntimeError(f"{lib.source.name}: no -Xptxas -v report of the "
                           f"roles {sorted(set(roles) - found)}")


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
    # (rows past n_valid too are computed alike).  The s8 kernel also
    # against its first design, and run twice: bitwise equal
    def first_int8(*a, n_valid):
        return wq.first_design("wn_layer_int8", *a, n_valid=n_valid)

    for B, T, nv in ((1, 1000, 937), (1, 1000, 128), (1, 1000, 129),
                     (3, 1000, 1000), (3, 777, 700), (2, 1000, 0),
                     (3, 6450, 6401)):   # the last: 128-row tiles
        shape = f"edge B={B} T={T} n_valid={nv}"
        for d in (1, 128):
            seed += 1
            k = layer_inputs(B, T, nv, C, M, seed, dev)
            args = layer_args(k, d)
            check_pair("wn_layer", args["wn_layer"], nv, f"{shape} d={d}",
                       skip_rows=T)
            a8 = args["wn_layer_int8"]
            got = call_std(wq.wn_layer_int8, a8, nv)
            tag = f"wn_layer_int8 {shape} d={d}"
            note("wn_layer_int8", compare_int8(
                f"{tag} vs plain", got, call_std(wq.wn_layer_int8_plain, a8,
                                                 nv), T))
            compare_int8(f"{tag} vs first design", got,
                         call_std(first_int8, a8, nv), T)
            again = call_std(wq.wn_layer_int8, a8, nv)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise RuntimeError(f"{tag}: two runs differ")
            seed += 1
            k = layer_inputs(B, T, nv, C, M, seed, dev, E=8)
            args = layer_args(k, d)
            check_pair("wn_layer_final", args["wn_layer_final"], nv,
                       f"{shape} d={d} E=8")
            # the s8 final layer: against its plain version (every row) and
            # its first design; run twice, bitwise equal
            a8 = args["wn_layer_final_int8"]
            got = wq.wn_layer_final_int8(*a8, n_valid=nv)
            tag = f"wn_layer_final_int8 {shape} d={d} E=8"
            for ref, want in (
                    ("plain", wq.wn_layer_final_int8_plain(*a8, n_valid=nv)),
                    ("first design", wq.first_design(
                        "wn_layer_final_int8", *a8, n_valid=nv))):
                err = (got - want).abs().max().item()
                print(f"  {tag} vs {ref}: max_abs_err={err:.6g} (bound "
                      f"{INT8_FINAL_ATOL})")
                if not torch.isfinite(got).all() or err > INT8_FINAL_ATOL:
                    raise RuntimeError(f"{tag}: disagrees with its {ref}")
                if ref == "plain":
                    note("wn_layer_final_int8", err)
            if not torch.equal(got, wq.wn_layer_final_int8(*a8, n_valid=nv)):
                raise RuntimeError(f"{tag}: two runs differ")
            # the s8 first layer likewise, the skip on every row
            seed += 1
            n_half = 4 if d == 1 else 3
            k = layer_inputs(B, T, nv, C, M, seed, dev, n_half=n_half)
            a8 = layer_args(k, d)["wn_layer_first_int8"]
            got = wq.wn_layer_first_int8(*a8, n_valid=nv)
            tag = f"wn_layer_first_int8 {shape} d={d} n_half={n_half}"
            note("wn_layer_first_int8", compare_int8(
                f"{tag} vs plain", got,
                wq.wn_layer_first_int8_plain(*a8, n_valid=nv), T))
            compare_int8(f"{tag} vs first design", got, wq.first_design(
                "wn_layer_first_int8", *a8, n_valid=nv), T)
            again = wq.wn_layer_first_int8(*a8, n_valid=nv)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise RuntimeError(f"{tag}: two runs differ")

    # the sm90 first layer at its edges against its plain version and its
    # first design, the skip on every row: n_half 2-4, d 1, 64 and the
    # config's largest (128), n_valid = T, < T, < d and 0, batch 1 and 3,
    # the reference width and a narrower one the plan takes
    def first_bf16(*a, n_valid):
        return wb.first_design("wn_layer_first", *a, n_valid=n_valid)

    for width in (C, 256):
        for B, T, nv, d, n_half in ((1, 1000, 1000, 1, 2),
                                    (3, 777, 700, 64, 3),
                                    (1, 1000, 50, 64, 4),
                                    (2, 1000, 0, 128, 2),
                                    (3, 6450, 6401, 128, 4),
                                    (1, 1000, 937, 128, 3)):
            seed += 1
            k = layer_inputs(B, T, nv, width, M, seed, dev, n_half=n_half)
            args = layer_args(k, d)["wn_layer_first"]
            got = wb.wn_layer_first(*args, n_valid=nv)
            tag = (f"wn_layer_first edge C={width} B={B} T={T} n_valid={nv}"
                   f" d={d} n_half={n_half}")
            for ref, fn in (("plain", wb.wn_layer_first_plain),
                            ("first design", first_bf16)):
                want = fn(*args, n_valid=nv)
                if got[0][:, nv:].any() or want[0][:, nv:].any():
                    raise RuntimeError(f"{tag}: rows past n_valid are not "
                                       f"zero")
                errs = [compare(f"{tag} vs {ref} skip", got[1], want[1])]
                if nv:
                    errs.append(compare(f"{tag} vs {ref} x", got[0],
                                        want[0]))
                if ref == "plain" and width == C:
                    note("wn_layer_first", max(errs))

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
    """The sm90 first, standard and final layers and the s8 standard, first
    and final layers beside their first design on the same inputs at one
    vocode's shapes, batch 1 and 3 x 6400 groups, timed in turns (first,
    sm90, sm90, first); the two agree within the kernel bounds.  Adds
    ``prev_ms`` (the first design at batch 1), ``ms_b3``, ``prev_ms_b3``
    and ``bound_ms_b3`` to the six rows of ``rec``.  The ``structure``
    lines time the skeletons the first layers share with the standard
    ones: the sm90 standard layer at n_valid = 0 (the bf16 first layer's
    products without its tap stage, residual base or edge take-back) and
    the s8 standard and final layers there."""
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_int8 as wq

    dev = torch.device("cuda")
    T = 6400
    for B in (1, 3):
        # inputs of their own for each layer: the timing loops update the
        # standard layers' skip sums in place
        runs = {
            "wn_layer_first": layer_args(layer_inputs(
                B, T, T, C, M, 91, dev, n_half=4), 1)["wn_layer_first"],
            "wn_layer": layer_args(layer_inputs(B, T, T, C, M, 96, dev),
                                   64)["wn_layer"],
            "wn_layer_final": layer_args(layer_inputs(
                B, T, T, C, M, 95, dev, E=8), 128)["wn_layer_final"],
            "wn_layer_int8": layer_args(layer_inputs(B, T, T, C, M, 94, dev),
                                        64)["wn_layer_int8"],
            "wn_layer_first_int8": layer_args(layer_inputs(
                B, T, T, C, M, 93, dev, n_half=4), 1)["wn_layer_first_int8"],
            "wn_layer_final_int8": layer_args(layer_inputs(
                B, T, T, C, M, 92, dev, E=8), 128)["wn_layer_final_int8"],
        }
        for name, args in runs.items():
            mod = wq if name.endswith("int8") else wb
            kern = getattr(mod, name)

            def first(*a, n_valid=None, name=name, mod=mod):
                return mod.first_design(name, *a, n_valid=n_valid)

            tag = f"{name} sm90 vs first design B={B}"
            if name == "wn_layer":
                got, want = call_std(kern, args, T), call_std(first, args, T)
                compare(f"{tag} x", got[0], want[0])
                compare(f"{tag} skip", got[1], want[1])
            elif name == "wn_layer_first":
                got, want = kern(*args), first(*args)
                compare(f"{tag} x", got[0], want[0])
                compare(f"{tag} skip", got[1], want[1])
            elif name == "wn_layer_int8":
                compare_int8(tag, call_std(kern, args, T),
                             call_std(first, args, T), T)
            elif name == "wn_layer_first_int8":
                compare_int8(tag, kern(*args), first(*args), T)
            elif name == "wn_layer_final_int8":
                err = (kern(*args) - first(*args)).abs().max().item()
                print(f"  {tag}: max_abs_err={err:.6g} (bound "
                      f"{INT8_FINAL_ATOL})")
                if err > INT8_FINAL_ATOL:
                    raise RuntimeError(f"{tag}: the designs disagree")
            else:
                compare(tag, kern(*args), first(*args))
            outs = kern(*args)
            outs = outs if isinstance(outs, tuple) else (outs,)
            tensors = [t for t in (*args, *outs) if torch.is_tensor(t)]
            bound, by = bound_ms(work(name, B, T, C, M), tensors)
            times = {"first": [], "sm90": []}
            for tag_, fn in (("first", lambda: first(*args)),
                             ("sm90", lambda: kern(*args)),
                             ("sm90", lambda: kern(*args)),
                             ("first", lambda: first(*args))):
                times[tag_].append(time_ms(fn))
            first_ms, sm90 = times["first"], times["sm90"]
            ms, prev = sum(sm90) / 2, sum(first_ms) / 2
            if mod is wq:
                role = {"wn_layer_first_int8": "first",
                        "wn_layer_final_int8": "final"}.get(name, "std")
                plan = wq.int8_sm90_plan(C, T, B, role=role)
                smem = wq.LIB_SM90.get().t2s_wn_int8_sm90_smem_bytes(
                    plan["nc"], C, plan["stages"], wq.INT8_SM90_ROLES[role])
                ring = (f"{plan['nc']} column groups, {plan['stages']} "
                        f"stages of K=128 bytes")
            else:
                role = "first" if name == "wn_layer_first" else "std"
                plan = wb.sm90_plan(C, T, B, role=role)
                smem = wb.LIB_SM90.get().t2s_wn_sm90_smem_bytes(
                    plan["nwg"], plan["bk"], C, plan["stages"],
                    wb.SM90_ROLES["final" if name == "wn_layer_final"
                                  else role])
                ring = f"{plan['stages']} stages of K={plan['bk']}"
            if smem != plan["smem"]:
                raise RuntimeError(f"{name} plan: {plan['smem']} B of shared "
                                   f"memory, the kernel asks {smem}")
            blocks = plan["grid"][0] * plan["grid"][1]
            print(f"  {name} B={B} T={T}: sm90 {sm90[0]:.4f} / {sm90[1]:.4f}"
                  f" ms ({bound / ms:.1%} of the {bound:.4f} ms bound by "
                  f"{by}), first design {first_ms[0]:.4f} / "
                  f"{first_ms[1]:.4f} ms ({bound / prev:.1%}); sm90 tile "
                  f"{plan['bm']} rows, {ring}, {plan['smem']} B shared, "
                  f"{blocks} blocks = {blocks / wb.SM90_SMS:.2f} per SM (1 "
                  f"resident); first design {-(-T // 64) * B} blocks")
            if B == 1:
                rec[name]["prev_ms"] = prev
            else:
                rec[name]["ms_b3"], rec[name]["prev_ms_b3"] = ms, prev
                rec[name]["bound_ms_b3"] = bound
        # what FIRST's structure costs without its taps: the sm90 standard
        # layer at n_valid = 0 runs the bf16 first layer's products (in-act
        # K = M, the res/skip product) without its tap stage, residual base
        # or edge take-back; the s8 standard layer there runs the same
        # products as the s8 FIRST and the requantization; the s8 final
        # layer there is the conditioning's product and the end projection
        # alone
        std, fin = runs["wn_layer_int8"], runs["wn_layer_final_int8"]
        bstd = runs["wn_layer"]
        print(f"  structure B={B} T={T}: wn_layer at n_valid=0 "
              f"{time_ms(lambda: call_std(wb.wn_layer, bstd, 0)):.4f} ms "
              f"(the bf16 first layer's skeleton)")
        print(f"  structure B={B} T={T}: wn_layer_int8 at n_valid=0 "
              f"{time_ms(lambda: wq.wn_layer_int8(*std, n_valid=0)):.4f} ms, "
              f"wn_layer_final_int8 at n_valid=0 "
              f"{time_ms(lambda: wq.wn_layer_final_int8(*fin, n_valid=0)):.4f}"
              f" ms")


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
    """Launch counts of the serving kernels, the gated activation and
    VITS's generator convolutions (the conv backward keeps its own, read
    on its own path)."""
    from text2speech_tpu_torch.ops import gated, vits_conv
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_dcond as wd
    from text2speech_tpu_torch.ops import wn_block_int8 as wq

    return {**wb.launch_counts(), **wq.launch_counts(),
            **wd.launch_counts(), **gated.launch_counts(),
            **vits_conv.launch_counts()}


def reset_counts() -> None:
    from text2speech_tpu_torch.ops import gated, vits_conv
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_dcond as wd
    from text2speech_tpu_torch.ops import wn_block_int8 as wq

    from text2speech_tpu_torch.parallel import tp

    wb.reset_launch_counts()
    wq.reset_launch_counts()
    wd.reset_launch_counts()
    gated.reset_launch_counts()
    vits_conv.reset_launch_counts()
    tp.reset_launch_counts()


def want_counts(wg_cfg, int8: bool, dcond: bool = False) -> dict:
    """Launches of one vocode: 1 / L - 2 / 1 per flow of the path's own
    wrappers, none of the other families'."""
    from text2speech_tpu_torch.ops import vits_conv

    per = (wg_cfg.n_flows, wg_cfg.n_flows * (wg_cfg.wn_n_layers - 2),
           wg_cfg.n_flows)
    names = [*KERNELS, *DCOND_KERNELS]
    first = 6 if dcond else 3 if int8 else 0
    mine = names[first: first + 3]
    return {**dict.fromkeys(names, 0), **dict(zip(mine, per)),
            "gated_fwd": 0, "gated_bwd": 0,
            **dict.fromkeys(vits_conv.launch_counts(), 0)}


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


def cli_vocoder() -> None:
    """Phase 25: the vocoder CLIs at full width.  A port WaveGlow training
    checkpoint saved from seeded weights (the end convs perturbed, so that
    every coupling moves the audio); ``python -m
    text2speech_tpu_torch.mel2samp`` writes the log-mel of a synthetic
    2 s wav; ``python -m text2speech_tpu_torch.waveglow_inference`` vocodes
    it with ``--int8`` and with ``--fused`` (and the denoiser) in processes
    of their own, each writing a PCM16 WAV of frames x hop samples; then
    ``waveglow_inference.main`` with ``--int8`` in this process, whose one
    vocode launches rows 5-7 (the s8 standard, first and final layers)
    72 / 12 / 12 times and no other WN-layer kernel."""
    from scipy.io import wavfile

    from text2speech_tpu_torch import waveglow_inference
    from text2speech_tpu_torch.config import WaveGlowConfig
    from text2speech_tpu_torch.models.waveglow import TrainableWaveGlow
    from text2speech_tpu_torch.train.checkpoint import CheckpointManager
    from text2speech_tpu_torch.train.state import create_train_state

    cfg = WaveGlowConfig()
    sr, hop = cfg.sampling_rate, cfg.hop_length
    with tempfile.TemporaryDirectory() as d:
        g = torch.Generator().manual_seed(11)
        model = TrainableWaveGlow(cfg, generator=g, device="cuda")
        with torch.no_grad():
            for k in range(cfg.n_flows):
                w = model.params[f"wn{k}/end/kernel"]
                w.copy_(0.01 * torch.randn(w.shape, generator=g))
        CheckpointManager(f"{d}/ckpt").save(
            1, create_train_state(model.params, cfg.learning_rate))
        del model
        torch.cuda.empty_cache()
        rng = np.random.RandomState(11)
        t = np.arange(2 * sr) / sr
        wav = (0.3 * np.sin(2 * np.pi * (200 + 300 * t) * t)
               + 0.01 * rng.randn(t.size))
        wavfile.write(f"{d}/chirp.wav", sr, (wav * 32767).astype(np.int16))
        with open(f"{d}/wavs.txt", "w") as f:
            f.write("chirp.wav\n")
        cmd = [sys.executable, "-m", "text2speech_tpu_torch.mel2samp", "-f",
               f"{d}/wavs.txt", "-o", f"{d}/mels"]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        print(f"[cli] {' '.join(cmd[1:3])} -> rc {r.returncode}: "
              f"{r.stdout.strip()}")
        if r.returncode != 0:
            raise RuntimeError(f"mel2samp CLI failed:\n{r.stderr}")
        mel = np.load(f"{d}/mels/chirp.npy")
        frames = 1 + t.size // hop
        if mel.shape != (cfg.n_mel_channels, frames) or \
                not np.isfinite(mel).all():
            raise RuntimeError(f"mel2samp wrote {mel.shape}, want "
                               f"({cfg.n_mel_channels}, {frames})")
        with open(f"{d}/mels.txt", "w") as f:
            f.write(f"{d}/mels/chirp.npy\n")
        base = ["-f", f"{d}/mels.txt", "-w", f"{d}/ckpt", "-s", "0.6"]
        for flag in ("--int8", "--fused"):
            out = f"{d}/out{flag}"
            cmd = [sys.executable, "-m",
                   "text2speech_tpu_torch.waveglow_inference", *base, "-o",
                   out, "-d", "0.1", flag]
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600)
            print(f"[cli] {' '.join(cmd[1:3])} {flag} -d 0.1 -> rc "
                  f"{r.returncode}: {r.stdout.strip()}")
            if r.returncode != 0:
                raise RuntimeError(f"waveglow_inference CLI failed:\n"
                                   f"{r.stderr}")
            rate, pcm = wavfile.read(f"{out}/chirp_synthesis.wav")
            if (rate != sr or pcm.dtype != np.int16
                    or pcm.shape != (frames * hop,)
                    or np.abs(pcm).max() < 16000):
                raise RuntimeError(f"waveglow_inference {flag}: {pcm.dtype} "
                                   f"{pcm.shape} at {rate} Hz, peak "
                                   f"{np.abs(pcm).max()}")
        reset_counts()
        waveglow_inference.main([*base, "-o", f"{d}/in_process", "--int8"])
        launches = all_counts()
        print(f"[cli] waveglow_inference.main --int8: launches {launches}")
        if launches != want_counts(cfg, int8=True):
            raise RuntimeError(f"waveglow_inference --int8 launched "
                               f"{launches}, want {want_counts(cfg, True)}")


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

    # the sm90 standard and final layers at the edges of their tile (as
    # phase 3 does for the in-kernel projection: T and n_valid off the tile
    # grid, a halo of a whole tile, batch 3, nothing valid, 128-row tiles)
    # against their plain versions and their first design, the skip sum
    # and the final layer's output on every row; the final layer leaves
    # skip_acc as it found it
    for B, T, nv in ((1, 1000, 129), (3, 777, 700), (2, 1000, 0),
                     (3, 6450, 6401)):
        cond_all = cond_for(B, T, seed)
        for d, li, E in ((1, 0, 8), (400, L - 1, 1)):
            seed += 1
            k = layer_inputs(B, T, nv, C, 64, seed, dev, E=E)
            args = dcond_args(k, cond_all, li, d)["wn_layer_final_dcond"]
            skip_before = k["skip_acc"].clone()
            got = wd.wn_layer_final_dcond(*args, n_valid=nv)
            tag = (f"wn_layer_final_dcond edge B={B} T={T} n_valid={nv} d={d}"
                   f" li={li} E={E}")
            note("wn_layer_final_dcond", compare(
                f"{tag} vs plain", got,
                wd.wn_layer_final_dcond_plain(*args, n_valid=nv)))
            compare(f"{tag} vs first design", got, wb.first_design(
                "wn_layer_final_dcond", *args, n_valid=nv))
            if not torch.equal(k["skip_acc"], skip_before):
                raise RuntimeError(f"{tag}: skip_acc was written")
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

    # the sm90 dcond first layer likewise (as phase 3 does for the bf16
    # one): n_half 2-4, d 1, 64, 128, n_valid = T, < T, < d and 0, batch 1
    # and 3, the reference width and a narrower one
    for width in (C, 256):
        for B, T, nv, d, n_half in ((1, 1000, 1000, 1, 2),
                                    (3, 777, 700, 64, 3),
                                    (1, 1000, 50, 64, 4),
                                    (2, 1000, 0, 128, 2),
                                    (3, 6450, 6401, 128, 4),
                                    (1, 1000, 937, 128, 3)):
            seed += 1
            g = torch.Generator().manual_seed(seed)
            cond_all = torch.randn(B, T, 2 * width * L, generator=g).to(
                dev, torch.bfloat16)
            k = layer_inputs(B, T, nv, width, 64, seed, dev, n_half=n_half)
            args = dcond_args(k, cond_all, 0, d)["wn_layer_first_dcond"]
            got = wd.wn_layer_first_dcond(*args, n_valid=nv)
            tag = (f"wn_layer_first_dcond edge C={width} B={B} T={T} "
                   f"n_valid={nv} d={d} n_half={n_half}")
            for ref, want in (
                    ("plain", wd.wn_layer_first_dcond_plain(*args,
                                                            n_valid=nv)),
                    ("first design", wb.first_design(
                        "wn_layer_first_dcond", *args, n_valid=nv))):
                if got[0][:, nv:].any() or want[0][:, nv:].any():
                    raise RuntimeError(f"{tag}: rows past n_valid are not "
                                       f"zero")
                errs = [compare(f"{tag} vs {ref} skip", got[1], want[1])]
                if nv:
                    errs.append(compare(f"{tag} vs {ref} x", got[0],
                                        want[0]))
                if ref == "plain" and width == C:
                    note("wn_layer_first_dcond", max(errs))

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
    for name in DCOND_KERNELS:
        time_dcond_beside_first_design(name, rec[name], C, L)
    return rec


def time_dcond_beside_first_design(name: str, r: dict, C: int,
                                   L: int) -> None:
    """The sm90 dcond first, standard or final layer and its first design
    on the same inputs at the composed vocode's shapes, batch 1 and 3 x
    6400 groups, timed in turns (first, sm90, sm90, first); the two agree
    within the kernel bounds.  Adds ``prev_ms`` (the first design at batch
    1), ``ms_b3``, ``prev_ms_b3`` and ``bound_ms_b3`` to the row ``r``.
    With the standard layer, a ``structure`` line: it at n_valid = 0 is the
    dcond first layer's skeleton (the gate of b_in + cond and the whole
    res/skip ring, without the tap stage or the residual base)."""
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_dcond as wd

    dev = torch.device("cuda")
    T = 6400
    std = name == "wn_layer_dcond"
    first_layer = name == "wn_layer_first_dcond"
    kern = getattr(wd, name)
    for B in (1, 3):
        g = torch.Generator().manual_seed(78 + B)
        cond_all = torch.randn(B, T, 2 * C * L, generator=g).to(
            dev, torch.bfloat16)
        li = 3 if std else 0 if first_layer else L - 1
        d = 64 if std else 1 if first_layer else 128
        args = dcond_args(layer_inputs(
            B, T, T, C, 64, 93, dev, n_half=4 if first_layer else None,
            E=8 if name == "wn_layer_final_dcond" else None),
            cond_all, li, d)[name]

        def first(*a, n_valid=None):
            return wb.first_design(name, *a, n_valid=n_valid)

        bt = 2 * B * T
        if first_layer:
            got, want = kern(*args), first(*args)
            compare(f"{name} sm90 vs first design B={B} x", got[0], want[0])
            compare(f"{name} sm90 vs first design B={B} skip", got[1],
                    want[1])
            outs = got
            ops = bt * 3 * 4 * 2 * C + bt * 4 * C + bt * C * 2 * C
        elif std:
            got = call_std(kern, args, T)
            want = call_std(first, args, T)
            compare(f"{name} sm90 vs first design B={B} x", got[0], want[0])
            compare(f"{name} sm90 vs first design B={B} skip", got[1],
                    want[1])
            outs, ops = (got[0], args[-2]), bt * 3 * C * 2 * C + bt * C * 2 * C
        else:
            got = kern(*args)
            compare(f"{name} sm90 vs first design B={B}", got, first(*args))
            outs, ops = (got,), bt * 3 * C * 2 * C + 2 * bt * C * 8
        # the function reads its 2C-wide slice of cond_all, not all of it
        bound, by = bound_ms(
            {"bf16": ops},
            [t[..., li * 2 * C: (li + 1) * 2 * C] if t is cond_all else t
             for t in (*args, *outs) if torch.is_tensor(t)])
        firsts, sm90 = [], []
        for fn, acc in ((lambda: first(*args), firsts),
                        (lambda: kern(*args), sm90),
                        (lambda: kern(*args), sm90),
                        (lambda: first(*args), firsts)):
            acc.append(time_ms(fn))
        ms, prev = sum(sm90) / 2, sum(firsts) / 2
        plan = wb.sm90_plan(C, T, B, role="first" if first_layer else "std")
        blocks = plan["grid"][0] * plan["grid"][1]
        chunk = ("1 tap stage" if first_layer
                 else f"{3 * C // plan['bk']}")
        print(f"  {name} B={B} T={T}: sm90 {sm90[0]:.4f} / "
              f"{sm90[1]:.4f} ms ({bound / ms:.1%} of the {bound:.4f} ms "
              f"bound by {by}), first design {firsts[0]:.4f} / "
              f"{firsts[1]:.4f} ms ({bound / prev:.1%}); sm90 tile "
              f"{plan['bm']} rows, {plan['stages']} stages of K={plan['bk']}"
              f" ({chunk} per gate-pair chunk), "
              f"{plan['smem']} B shared, {blocks} blocks")
        if std:
            print(f"  structure B={B} T={T}: wn_layer_dcond at n_valid=0 "
                  f"{time_ms(lambda: call_std(kern, args, 0)):.4f} ms (the "
                  f"dcond first layer's skeleton)")
        if B == 1:
            r["prev_ms"] = prev
        else:
            r["ms_b3"], r["prev_ms_b3"], r["bound_ms_b3"] = ms, prev, bound


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
    width (their sm90 forms also against their first design; kernel 8's
    equal to its plain version bit for bit), then kernel and plain times
    and the card's bound at B=1, T=6400 for p = 2 and 4 (the record holds p
    = 4's), and both beside their first design in turns at batch 1 and
    3."""
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_int8 as wq

    dev = torch.device("cuda")
    rec = {n: {"max_abs_err": 0.0} for n in PARTIAL_KERNELS}

    def note(name, err):
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)

    def check_bf16(tag, args, kw, nv):
        """Either sm90 form (``PART``, or ``PART_FIRST`` with ``b_edge`` in
        ``kw``) against its plain version and its first design; one launch
        a call, none for the first design."""
        n0 = wb.wn_layer_partial.launches
        got = wb.wn_layer_partial(*args, n_valid=nv, **kw)
        want = wb.wn_layer_partial_plain(*args, n_valid=nv, **kw)
        first = wb.first_design("wn_layer_partial", *args, n_valid=nv, **kw)
        if wb.wn_layer_partial.launches != n0 + 1:
            raise RuntimeError(f"{tag}: {wb.wn_layer_partial.launches - n0}"
                               f" launches counted, want 1")
        if got.dtype != torch.float32 or got[:, nv:].any():
            raise RuntimeError(f"{tag}: not f32, or rows past n_valid not 0")
        note("wn_layer_partial", compare(f"wn_layer_partial {tag}", got, want))
        compare(f"wn_layer_partial {tag} vs first design", got, first)
        return got

    def layer0(k, p, i, d, nv, tag):
        """Rank i of p's layer-0 form on ``k``'s first-layer inputs."""
        w_in, b_in, w_c, b_c, w_rs = rank_share(k, p, i, False)
        wp, b_all, b_edge = wb.fold_first_taps(k["start_k"], k["start_b"],
                                               w_in, b_in)
        return check_bf16(f"{tag} rank {i}", (k["x0"], k["spect"], wp, b_all,
                                              w_c, b_c, w_rs, d),
                          {"b_edge": b_edge}, nv)

    def check_int8(tag, args, nv):
        """The s8 wgmma form: equal to the plain version bit for bit, and
        to the first design within the int8 partial bound."""
        got = wq.wn_layer_partial_int8(*args, n_valid=nv)
        want = wq.wn_layer_partial_int8_plain(*args, n_valid=nv)
        first = wq.first_design("wn_layer_partial_int8", *args, n_valid=nv)
        err = (got - want).abs().max().item()
        err_first = (got - first).abs().max().item()
        same = torch.equal(got, want)
        print(f"  wn_layer_partial_int8 {tag}: equal to plain {same} "
              f"(max_abs_err={err:.6g}); vs first design max_abs_err="
              f"{err_first:.6g} (bound {INT8_PARTIAL_ATOL})")
        if not torch.isfinite(got).all() or got[:, nv:].any() or not same \
                or err_first > INT8_PARTIAL_ATOL:
            raise RuntimeError(f"wn_layer_partial_int8 {tag}: kernel "
                               f"disagrees with its plain version or its "
                               f"first design")
        note("wn_layer_partial_int8", err)

    seed = 700
    for p in (2, 4, 8):
        for B, T, nv in ((1, 1000, 937), (3, 777, 700)):
            shape = f"p={p} B={B} T={T} n_valid={nv}"
            for n_half in (2, 3, 4):      # the layer-0 form, first/last rank
                seed += 1
                k = layer_inputs(B, T, nv, C, M, seed, dev, n_half=n_half)
                for i in (0, p - 1):
                    layer0(k, p, i, 1, nv, f"{shape} n_half={n_half}")
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

    # the layer-0 form (sm90 PART_FIRST) over rank widths Cp = 512 .. 64,
    # n_half 2-4, d 1 (layer 0's) and 64, n_valid = T, < T, 1 and 0, batch
    # 1 and 3, T = 6400 and off the 128-row tile, M 640 and a narrower 96;
    # the first and the last rank
    for p in (1, 2, 4, 8):
        for B, T, nv, d, m, n_half in ((1, 6400, 6400, 1, M, 4),
                                       (3, 6400, 6321, 1, M, 3),
                                       (3, 777, 700, 64, M, 2),
                                       (1, 777, 1, 64, M, 3),
                                       (3, 1000, 0, 1, M, 4),
                                       (2, 333, 50, 1, 96, 2)):
            seed += 1
            k = layer_inputs(B, T, nv, C, m, seed, dev, n_half=n_half)
            for i in (0, p - 1) if p > 1 else (0,):
                layer0(k, p, i, d, nv, f"layer 0 p={p} B={B} T={T} "
                       f"n_valid={nv} d={d} M={m} n_half={n_half}")
        # the ranks' layer-0 partials + the res/skip bias against the whole
        # first layer's plain res/skip term (its residual half before the
        # base x0 start_k + start_b)
        B, T, nv = 3, 777, 700
        seed += 1
        k = layer_inputs(B, T, nv, C, M, seed, dev, n_half=4)
        total = sum(layer0(k, p, i, 1, nv, f"layer 0 sum p={p}")
                    for i in range(p))
        wp, b_all, b_edge = wb.fold_first_taps(k["start_k"], k["start_b"],
                                               k["w_in"], k["b_in"])
        in_act = wb._edge_bias_suppress(
            wb._taps(k["x0"], wp, 1, nv) + b_all
            + wb._cond(k["spect"], k["w_cond"], k["b_cond"]), b_edge, 1, nv)
        rs = (wb._gate(in_act, torch.bfloat16).float() @ k["w_rs"].float()
              + k["b_rs"])
        note("wn_layer_partial", compare(
            f"sum of {p} layer-0 partials + bias vs the whole first layer",
            (total + k["b_rs"])[:, :nv], rs[:, :nv]))

    # kernel 8's s8 form at the edges of its 64-row tile: nothing valid,
    # n_valid = T - 1 and off the tile, a halo past a tile (d = 400), the
    # 6400-row grids of batch 3, every rank width
    for p in (2, 4, 8):
        for B, T, nv, d, rs_full in ((2, 1000, 0, 1, True),
                                     (1, 1000, 999, 64, False),
                                     (1, 333, 200, 400, True),
                                     (3, 6450, 6401, 128, False)):
            seed += 1
            k = layer_inputs(B, T, nv, C, M, seed, dev)
            if not rs_full:
                k["w_rs"] = k["w_rs"][:, :C].contiguous()
            qx, sx = wq.quantize_rows(k["x"])
            qsp, ssp = wq.quantize_rows(k["spect"])
            for i in (0, p - 1):
                check_int8(f"edge p={p} B={B} T={T} n_valid={nv} d={d} "
                           f"rs_out={k['w_rs'].shape[1]} rank {i}",
                           (qx, sx, qsp, ssp, *rank_share(k, p, i, True), d),
                           nv)

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
    for name in PARTIAL_KERNELS:
        time_partial_beside_first_design(name, rec[name], C, M)
    time_partial_first_beside_first_design(C, M)
    return rec


def time_partial_beside_first_design(name: str, r: dict, C: int,
                                     M: int) -> None:
    """Kernel 4's or 8's sm90 form and its first design on the same inputs,
    rank 0 of p = 2 and 4, d=64, batch 1 and 3 x 6400 groups, in turns
    (first, sm90, sm90, first).  Adds ``prev_ms`` (p = 4, batch 1),
    ``ms_b3``, ``prev_ms_b3`` and ``bound_ms_b3`` (p = 4) to ``r``."""
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_int8 as wq

    dev = torch.device("cuda")
    T, d = 6400, 64
    int8 = name == "wn_layer_partial_int8"
    mod = wq if int8 else wb
    kern = getattr(mod, name)
    for B in (1, 3):
        k = layer_inputs(B, T, T, C, M, 92, dev)
        acts = ((*wq.quantize_rows(k["x"]), *wq.quantize_rows(k["spect"]))
                if int8 else (k["x"], k["spect"]))
        for p in (2, 4):
            Cp = C // p
            args = (*acts, *rank_share(k, p, 0, int8), d)

            def first(args=args):
                return mod.first_design(name, *args)

            out = kern(*args)
            tag = f"{name} sm90 vs first design p={p} B={B}"
            if int8:
                err = (out - first()).abs().max().item()
                print(f"  {tag}: max_abs_err={err:.6g} (bound "
                      f"{INT8_PARTIAL_ATOL})")
                if err > INT8_PARTIAL_ATOL:
                    raise RuntimeError(f"{tag}: the designs disagree")
            else:
                compare(tag, out, first())
            ops = 2 * B * T * ((3 * C + M) * 2 * Cp + Cp * 2 * C)
            tensors = [t for t in (*args, out) if torch.is_tensor(t)]
            bound, by = bound_ms({"int8" if int8 else "bf16": ops}, tensors)
            times = {"first": [], "sm90": []}
            for tag, fn in (("first", first),
                            ("sm90", lambda: kern(*args)),
                            ("sm90", lambda: kern(*args)),
                            ("first", first)):
                times[tag].append(time_ms(fn))
            ms, prev = sum(times["sm90"]) / 2, sum(times["first"]) / 2
            if int8:
                plan = wq.int8_sm90_plan(Cp, T, B)
                tile = (f"{plan['nc']} column groups, {plan['stages']} "
                        f"stages of K=128 bytes")
            else:
                plan = wb.sm90_plan(Cp, T, B)
                tile = f"{plan['stages']} stages of K={plan['bk']}"
            print(f"  {name} p={p} B={B} T={T}: sm90 "
                  f"{times['sm90'][0]:.4f} / {times['sm90'][1]:.4f} ms "
                  f"({bound / ms:.1%} of the {bound:.4f} ms bound by {by}), "
                  f"first design {times['first'][0]:.4f} / "
                  f"{times['first'][1]:.4f} ms ({bound / prev:.1%}); tile "
                  f"{plan['bm']} rows, {tile}, {plan['grid'][0] * B} blocks")
            if p == 4 and B == 1:
                r["prev_ms"] = prev
            elif p == 4:
                r["ms_b3"], r["prev_ms_b3"], r["bound_ms_b3"] = (ms, prev,
                                                                 bound)


def time_partial_first_beside_first_design(C: int, M: int) -> None:
    """Kernel 4's layer-0 form, the sm90 ``PART_FIRST`` role, and its first
    design (``csrc/wn_block.cu`` ``PART_FIRST``) on the same inputs, rank 0
    of p = 2 and 4, d = 1 (layer 0's), n_half = 4, rs_out = 2C, batch 1
    and 3 x 6400 groups, in turns (first, sm90, sm90, first), with the
    card's bound, each one's share of it, the plain version's time and the
    kernel alone (raw launches, without the wrapper's host work); before
    it a ``structure``
    line: the sm90 ``PART`` form at n_valid = 0 (no tap stage, so the
    conditioning's stages, the gate, the res/skip product and the f32
    write: the layer-0 role without its tap stage and edge take-back)."""
    from text2speech_tpu_torch.ops import wn_block as wb

    dev = torch.device("cuda")
    T = 6400
    for B in (1, 3):
        k = layer_inputs(B, T, T, C, M, 89, dev, n_half=4)
        ks = layer_inputs(B, T, T, C, M, 88, dev)
        for p in (2, 4):
            Cp = C // p
            skel = (ks["x"], ks["spect"], *rank_share(ks, p, 0, False), 1)
            skel_ms = time_ms(lambda: wb.wn_layer_partial(*skel, n_valid=0))
            print(f"  structure p={p} B={B} T={T}: wn_layer_partial (PART) "
                  f"at n_valid=0 {skel_ms:.4f} ms (the layer-0 form's "
                  f"skeleton)")
            w_in, b_in, w_c, b_c, w_rs = rank_share(k, p, 0, False)
            wp, b_all, b_edge = wb.fold_first_taps(k["start_k"],
                                                   k["start_b"], w_in, b_in)
            args = (k["x0"], k["spect"], wp, b_all, w_c, b_c, w_rs, 1)

            def sm90(args=args, b_edge=b_edge):
                return wb.wn_layer_partial(*args, b_edge=b_edge)

            def first(args=args, b_edge=b_edge):
                return wb.first_design("wn_layer_partial", *args,
                                       b_edge=b_edge)

            out = sm90()
            tag = f"wn_layer_partial layer 0 sm90 vs first design p={p} B={B}"
            compare(tag, out, first())
            # taps (K = 16 on the tensor cores), conditioning, res/skip
            ops = 2 * B * T * ((16 + M) * 2 * Cp + Cp * 2 * C)
            tensors = [t for t in (*args, b_edge, out) if torch.is_tensor(t)]
            bound, by = bound_ms({"bf16": ops}, tensors)
            times = {"first": [], "sm90": []}
            for n, fn in (("first", first), ("sm90", sm90), ("sm90", sm90),
                          ("first", first)):
                times[n].append(time_ms(fn))
            ms, prev = sum(times["sm90"]) / 2, sum(times["first"]) / 2
            plain_ms = time_ms(lambda: wb.wn_layer_partial_plain(
                *args, b_edge=b_edge))
            plan = wb.sm90_plan(Cp, T, B, role="part_first")
            # the kernel alone: raw launches into one output buffer (the
            # wrapper's host work per call can outlast the kernel at B=1)
            stream = torch.cuda.current_stream().cuda_stream
            ptrs = [t.data_ptr() for t in (*args[:4], b_edge, *args[4:7],
                                           out)]

            def alone(ptrs=ptrs, plan=plan, Cp=Cp):
                return wb.LIB_SM90.get().t2s_wn_layer_partial_first_sm90(
                    *ptrs, B, T, T, 4, Cp, M, 2 * C, 1, plan["nwg"],
                    plan["bk"], plan["stages"], stream)

            if alone():
                raise RuntimeError("part_first: launch failed")
            alone_ms = time_ms(alone)
            smem = wb.LIB_SM90.get().t2s_wn_sm90_smem_bytes(
                plan["nwg"], plan["bk"], Cp, plan["stages"],
                wb.SM90_ROLES["part_first"])
            if smem != plan["smem"]:
                raise RuntimeError(f"part_first plan: {plan['smem']} B of "
                                   f"shared memory, the kernel asks {smem}")
            print(f"  wn_layer_partial layer 0 (PART_FIRST) p={p} B={B} "
                  f"T={T}: sm90 {times['sm90'][0]:.4f} / "
                  f"{times['sm90'][1]:.4f} ms ({bound / ms:.1%} of the "
                  f"{bound:.4f} ms bound by {by}), kernel alone "
                  f"{alone_ms:.4f} ms, first design "
                  f"{times['first'][0]:.4f} / {times['first'][1]:.4f} ms "
                  f"({bound / prev:.1%}), plain {plain_ms:.4f} ms; tile "
                  f"{plan['bm']} rows, {plan['stages']} stages of "
                  f"K={plan['bk']}, {plan['smem']} B shared, "
                  f"{plan['grid'][0] * B} blocks")


def tile_alternatives(C: int = 512, M: int = 640) -> None:
    """What the plans' tiles buy, on the same inputs, timed in turns (each
    tile, then each in reverse): the s8 standard layer with one and two
    column groups (consumer warpgroups on its 64 rows) at batch 1 and 3 x
    6400 groups, and the s8 final layer so; kernel 8's s8 form at p = 8
    (Cp = 64: one gate chunk, so the second column group sits out the
    in-act product) with one and two
    column groups at batch 1 and 3, the choice of ``wn_block_int8.
    int8_sm90_plan`` there, and at p = 4 and 2 its wrapper back to back
    against the kernel alone (raw launches into one output buffer: the
    wrapper's host work per call can outlast the kernel); kernel 4's sm90 form (rank 0 of p = 2, 4) at
    batch 1 with 64- and 128-row blocks (one utterance: 50 blocks of 128
    rows would leave 82 of 132 SMs idle)."""
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_int8 as wq

    dev = torch.device("cuda")
    T, d = 6400, 64
    stream = torch.cuda.current_stream().cuda_stream

    def in_turns(name, fns):
        for fn in fns.values():
            if fn():
                raise RuntimeError(f"{name}: launch failed")
        times = {n: [] for n in fns}
        for n in [*fns, *reversed(fns)]:
            times[n].append(time_ms(lambda: fns[n]() and None))
        print(f"[kernels] tiles, {name}: " + "; ".join(
            f"{n} {t[0]:.4f} / {t[1]:.4f} ms" for n, t in times.items()))

    for B in (1, 3):
        k = layer_inputs(B, T, T, C, M, 91, dev)
        a8 = layer_args(k, d)["wn_layer_int8"]
        skip = a8[13].clone()
        xn = torch.empty(B, T, C, device=dev)
        q_out, s_out = torch.empty_like(a8[0]), torch.empty_like(a8[1])
        ptrs = [t.data_ptr() for t in (*a8[:13], skip, xn, q_out, s_out)]
        plan = wq.int8_sm90_plan(C, T, B)

        def s8(nc):
            stages = wq.int8_sm90_tile(C, nc, T, B)["stages"]
            return lambda: wq.LIB_SM90.get().t2s_wn_layer_int8_sm90(
                *ptrs, B, T, T, C, M, d, nc, stages, stream)

        in_turns(f"wn_layer_int8 B={B} (the plan's: {plan['nc']} column "
                 f"groups)", {f"{nc} column groups": s8(nc) for nc in (1, 2)})

        # the s8 final layer: two column groups split its chunks and the
        # skip_acc w_end term with them; one group takes them all
        af = layer_args(layer_inputs(B, T, T, C, M, 87, dev, E=8),
                        128)["wn_layer_final_int8"]
        fout = torch.empty(B, T, 8, device=dev)
        fptrs = [t.data_ptr() for t in (*af[:14], fout)]

        def final8(nc):
            stages = wq.int8_sm90_tile(C, nc, T, B, role="final")["stages"]
            return lambda: wq.LIB_SM90.get().t2s_wn_layer_final_int8_sm90(
                *fptrs, B, T, T, C, M, 8, 128, nc, stages, stream)

        plan = wq.int8_sm90_plan(C, T, B, role="final")
        in_turns(f"wn_layer_final_int8 B={B} (the plan's: {plan['nc']} "
                 f"column groups, {plan['stages']} stages)",
                 {f"{nc} column groups": final8(nc) for nc in (1, 2)})

        qx, sx = wq.quantize_rows(k["x"])
        qsp, ssp = wq.quantize_rows(k["spect"])
        a8 = (qx, sx, qsp, ssp, *rank_share(k, 8, 0, True))
        out = torch.empty(B, T, 2 * C, device=dev)
        pptrs = [t.data_ptr() for t in (*a8, out)]
        plan = wq.int8_sm90_plan(C // 8, T, B)

        def part8(nc):
            stages = wq.int8_sm90_tile(C // 8, nc, T, B)["stages"]
            return lambda: wq.LIB_SM90.get().t2s_wn_layer_partial_int8_sm90(
                *pptrs, B, T, T, C, C // 8, M, 2 * C, d, nc, stages, stream)

        in_turns(f"wn_layer_partial_int8 p=8 B={B} (the plan's: "
                 f"{plan['nc']} column groups)",
                 {f"{nc} column groups": part8(nc) for nc in (1, 2)})

        # kernel 8 at p = 4 and 2: its wrapper back to back (as the
        # kernel rows time it) against the kernel alone, raw launches into
        # one output buffer: at batch 1 the wrapper's host work per call
        # (checks, plan, allocation, device guard) can outlast the kernel
        for p in (4, 2):
            Cp = C // p
            a8 = (qx, sx, qsp, ssp, *rank_share(k, p, 0, True))
            plan = wq.int8_sm90_plan(Cp, T, B)
            aptrs = [t.data_ptr() for t in (*a8, out)]

            def alone(aptrs=aptrs, plan=plan, Cp=Cp):
                return wq.LIB_SM90.get().t2s_wn_layer_partial_int8_sm90(
                    *aptrs, B, T, T, C, Cp, M, 2 * C, d, plan["nc"],
                    plan["stages"], stream)

            def wrapper(a8=a8):
                return wq.wn_layer_partial_int8(*a8, d)

            if alone():
                raise RuntimeError("wn_layer_partial_int8: launch failed")
            times = {"wrapper": [], "kernel alone": []}
            for n, fn in (("wrapper", wrapper), ("kernel alone", alone),
                          ("kernel alone", alone), ("wrapper", wrapper)):
                times[n].append(time_ms(fn))
            print(f"[kernels] host, wn_layer_partial_int8 p={p} B={B}: " +
                  "; ".join(f"{n} {t[0]:.4f} / {t[1]:.4f} ms"
                            for n, t in times.items()))

    B = 1
    k = layer_inputs(B, T, T, C, M, 90, dev)
    for p in (2, 4):
        Cp = C // p
        args = (k["x"], k["spect"], *rank_share(k, p, 0, False))
        out = torch.empty(B, T, 2 * C, device=dev)
        ptrs = [t.data_ptr() for t in (*args, out)]

        def part(plan):
            return lambda: wb.LIB_SM90.get().t2s_wn_layer_partial_sm90(
                *ptrs, B, T, T, C, Cp, M, 2 * C, d, plan["nwg"], plan["bk"],
                plan["stages"], stream)

        # the 128-row tile with its own ring (the plan's at batch 3)
        in_turns(f"wn_layer_partial p={p} B=1", {
            "64 rows (the plan's)": part(wb.sm90_plan(Cp, T, B)),
            "128 rows": part(wb.sm90_plan(Cp, T, 3))})


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
    "wn_layer_padded": ("wn_block_padded_tiles_sm90.cu",
                        PALLAS + "wn_block_padded.py:104"),
    "wn_layer_spect": ("wn_block_padded_tiles_sm90.cu",
                       PALLAS + "wn_block_padded.py:165"),
    "wn_layer_stream": ("wn_block_padded_sm90.cu",
                        PALLAS + "wn_block_padded.py:302"),
    "wn_layer_stream_final": ("wn_block_padded_sm90.cu",
                              PALLAS + "wn_block_padded.py:353"),
}
# rows 14-15's roles in csrc/wn_block_padded_sm90.cu
PADDED_SM90_ROLES = {"wn_layer_stream": "STREAM",
                     "wn_layer_stream_final": "STREAM_FINAL"}
# rows 13 and 12's roles in csrc/wn_block_padded_tiles_sm90.cu (the name's
# role in ``wn_block_padded.padded_tiles_plan``, and in the source)
PADDED_TILES_ROLES = {"wn_layer_spect": ("spect", "SPECT"),
                      "wn_layer_padded": ("padded", "PADDED")}
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


def tiles_case_args(B, T, nv, C, M, seed, dev, d, rs_half=False,
                    n_cond=2) -> dict:
    """Rows 13 and 12's argument tuples (without ``n_valid``; row 12's
    without ``cond_index``) on the ``pad_tiles`` layout, drawn on the card
    from one seed for both: hidden state, mel, skip sum and a conditioning
    of ``n_cond`` 2C slices zero past ``nv``; res/skip weights [C, 2C] or,
    with ``rs_half``, [C, C]."""
    from text2speech_tpu_torch.ops.wn_block_padded import pad_tiles

    g = torch.Generator(device=dev).manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(dtype)

    mask = (torch.arange(T, device=dev) < nv)[None, :, None]
    rs_out = C if rs_half else 2 * C
    xp, sp, acc = (pad_tiles(rn(B, T, w, scale=s) * mask)
                   for w, s in ((C, 1.0), (M, 1.0), (C, 0.5)))
    cond = pad_tiles(rn(B, T, 2 * C * n_cond) * mask)
    w_in = rn(3, C, 2 * C, scale=(3 * C) ** -0.5)
    b_in = rn(2 * C, scale=0.1, dtype=f32)
    w_cond = rn(M, 2 * C, scale=M ** -0.5)
    b_cond = rn(2 * C, scale=0.1, dtype=f32)
    w_rs = rn(C, rs_out, scale=C ** -0.5)
    b_rs = rn(rs_out, scale=0.1, dtype=f32)
    return {"wn_layer_spect": (xp, sp, w_in, b_in, w_cond, b_cond, w_rs,
                               b_rs, acc, d),
            "wn_layer_padded": (xp, cond, w_in, b_in, w_rs, b_rs, d)}


def stream_case_args(B, T, nv, C, M, E, seed, dev, d, rs_half=False):
    """Rows 14 and 15's argument tuples (without ``n_valid``): row 13's
    draw on the card (``tiles_case_args``), then the final layer's [C, C]
    res/skip weights and end projection from the next seed; the stream
    layer takes the final layer's res/skip weights with ``rs_half``."""
    t = tiles_case_args(B, T, nv, C, M, seed, dev, d,
                        n_cond=1)["wn_layer_spect"]
    g = torch.Generator(device=dev).manual_seed(seed + 1)

    def rn(*shape, scale, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(dtype)

    w_last = rn(C, C, scale=C ** -0.5)
    b_last = rn(C, scale=0.1, dtype=torch.float32)
    w_end = rn(C, E, scale=C ** -0.5)
    b_end = rn(E, scale=0.1, dtype=torch.float32)
    head, rs, acc = t[:6], ((w_last, b_last) if rs_half else t[6:8]), t[8]
    return {"wn_layer_stream": (*head, *rs, acc, d),
            "wn_layer_stream_final": (*head, w_last, b_last, acc, w_end,
                                      b_end, d)}


def check_tiles_sm90(rec: dict, C: int = 512, M: int = 640) -> dict:
    """Rows 13 and 12 (``csrc/wn_block_padded_tiles_sm90.cu`` SPECT and
    PADDED) against their plain versions on the same inputs: d = 0, 1, 63,
    64, 128 at n_valid = T - 301, T, 1 and 0 (B=1, T=6400), batch 3 at d =
    1, 64, 128, a width with C % 128 == 64 (C=192, M=96, T=1024, B 1 and
    3) and the widest widths the plan takes, with two stages (SPECT alone
    at C=1408, both at C=1280); rs_out 2C and C and cond_index 0 and 1
    alternate, and each case's seeded inputs serve both roles.  The first
    case of each batch, width and dilation is also held against the first
    design (``wn_block_padded.first_design``).  Pad tiles exactly zero;
    SPECT's skip sum is updated in place in a buffer with guard rows on
    both sides, which stay as they were; PADDED leaves ``cond_p`` as it
    found it; the plan's shared memory is the kernel's own
    (``t2s_wn_padded_tiles_sm90_smem_bytes``).  Then the two times at B=1
    and 3, d=64, beside the first design in turns (first, sm90, sm90,
    first), the plain version and the bound (``ms``, ``prev_ms``,
    ``plain_ms``, ``bound_ms`` and their ``_b3`` forms in ``rec``).
    Returns the seconds of the cases and of the times."""
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    dev = torch.device("cuda")
    bt, T, bf = wp.BT_PAD, 6400, torch.bfloat16
    lib = wp.LIB_TILES.get()
    both = tuple(PADDED_TILES_ROLES)
    cases = [(1, T, C, M, d, nv, both) for d in (0, 1, 63, 64, 128)
             for nv in (T - 301, T, 1, 0)]
    cases += [(3, T, C, M, d, nv, both) for d in (1, 64, 128)
              for nv in (T - 301, T)]
    cases += [(1, 1024, 192, 96, 0, 1024, both),
              (3, 1024, 192, 96, 63, 723, both),
              (1, 1024, 192, 96, 128, 1, both),
              (3, 1024, 192, 96, 1, 0, both)]
    cases += [(1, 512, 1408, 64, 128, 450, ("wn_layer_spect",)),
              (3, 512, 1280, 64, 127, 512, both)]
    guard = 64                     # bf16 values of guard on each side
    seen = set()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (B, Tc, Cc, Mc, d, nv, names) in enumerate(cases):
        rs_half, ci = i % 2 == 1, i // 2 % 2
        vs_first = (B, Cc, d) not in seen
        seen.add((B, Cc, d))
        for name in names:
            role, _ = PADDED_TILES_ROLES[name]
            plan = wp.padded_tiles_plan(Cc, Tc, B, d, role)
            smem = lib.t2s_wn_padded_tiles_sm90_smem_bytes(
                wp.PADDED_TILES_ROLES[role], Cc, plan["nst"])
            if smem != plan["smem"]:
                raise RuntimeError(f"{name} C={Cc} plan: {plan['smem']} B "
                                   f"of shared memory, the kernel asks "
                                   f"{smem}")
        a = tiles_case_args(B, Tc, nv, Cc, Mc, 900 + i, dev, d, rs_half)
        tag = (f"B={B} T={Tc} C={Cc} M={Mc} d={d} n_valid={nv} rs_out="
               f"{Cc if rs_half else 2 * Cc}")
        outs = []
        if "wn_layer_spect" in names:
            args = a["wn_layer_spect"]
            acc = args[-2]
            buf = torch.full((acc.numel() + 2 * guard,), 7.0, dtype=bf,
                             device=dev)
            skip = buf[guard:guard + acc.numel()].view_as(acc)
            skip.copy_(acc)
            got = wp.wn_layer_spect(*args[:-2], skip, d, n_valid=nv)
            if got[1].data_ptr() != skip.data_ptr():
                raise RuntimeError(f"wn_layer_spect {tag}: skip not in "
                                   f"place")
            if (buf[:guard] != 7).any() or (buf[-guard:] != 7).any():
                raise RuntimeError(f"wn_layer_spect {tag}: the in-place "
                                   f"skip sum wrote outside its rows")
            want = wp.wn_layer_spect_plain(*args[:-2], acc, d, nv)
            first = (wp.first_design("wn_layer_spect", *args[:-2],
                                     acc.clone(), d, n_valid=nv)
                     if vs_first else (None,) * 2)
            outs += [(f"wn_layer_spect[{j}]", g, w, f)
                     for j, (g, w, f) in enumerate(zip(got, want, first))]
        if "wn_layer_padded" in names:
            args = a["wn_layer_padded"]
            keep = args[1].clone()
            got = wp.wn_layer_padded(*args, ci, n_valid=nv)
            if not torch.equal(args[1], keep):
                raise RuntimeError(f"wn_layer_padded {tag}: cond_p changed")
            want = wp.wn_layer_padded_plain(*args, ci, nv)
            first = (wp.first_design("wn_layer_padded", *args, ci,
                                     n_valid=nv)
                     if vs_first else (None,) * 2)
            outs += [(f"wn_layer_padded[{j}] cond_index={ci}", g, w, f)
                     for j, (g, w, f) in enumerate(zip(got, want, first))]
        for name, g, w, f in outs:
            if g[:, :bt].any() or g[:, -bt:].any():
                raise RuntimeError(f"{name} {tag}: pad tiles not zero")
            err = compare(f"{name} {tag}", g, w)
            if f is not None:
                compare(f"{name} {tag} vs first design", g, f)
            r = rec[name.split("[")[0]]
            r["max_abs_err"] = max(r["max_abs_err"], err)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for B in (1, 3):
        a = tiles_case_args(B, T, T, C, M, 990 + B, dev, 64, n_cond=1)
        for name, args in a.items():
            kern, plain = getattr(wp, name), getattr(wp, name + "_plain")

            def first(name=name, args=args):
                return wp.first_design(name, *args)

            turns = [time_ms(f, iters=10 if f is first else 50)
                     for f in (first, lambda: kern(*args),
                               lambda: kern(*args), first)]
            outs = kern(*args)
            tensors = [t for t in (*args, *outs) if torch.is_tensor(t)]
            bound, by = bound_ms(padded_work(name, B, T, C, M, 8), tensors)
            ms, prev = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
            plain_ms = time_ms(lambda: plain(*args), warmup=1, iters=3)
            sfx = "" if B == 1 else "_b3"
            rec[name].update({"ms" + sfx: ms, "prev_ms" + sfx: prev,
                              "plain_ms" + sfx: plain_ms,
                              "bound_ms" + sfx: bound})
            if B == 1:
                rec[name]["bound_by"] = by
            role, code = PADDED_TILES_ROLES[name]
            plan = wp.padded_tiles_plan(C, T, B, 64, role)
            print(f"[kernels] {name} ({code}) B={B} T={T} d=64: sm90 "
                  f"{turns[1]:.4f} / {turns[2]:.4f} ms, first design "
                  f"{turns[0]:.4f} / {turns[3]:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound:.4f} ms (by {by}; "
                  f"{100 * bound / ms:.2f}% of it, first design "
                  f"{100 * bound / prev:.2f}%), {plan['tiles']} tiles of "
                  f"{plan['bm']} rows, {plan['nst']} stages")
    torch.cuda.synchronize()
    return {"rows 12-13 cases": t1 - t0,
            "rows 12-13 times": time.perf_counter() - t1}


def check_stream_sm90(rec: dict, C: int = 512, M: int = 640,
                      E: int = 8) -> dict:
    """Rows 14 and 15 (``csrc/wn_block_padded_sm90.cu`` STREAM and
    STREAM_FINAL) against their plain versions on the same inputs: d = 0,
    1, 63, 64, 128 at n_valid = T - 301, T, 1 and 0 (B=1, T=6400), batch 3
    at d = 1, 64, 128, a width with C % 128 == 64 (C=192, M=96, T=1024, B 1
    and 3) and one that leaves room for one window slot only (C=1024, M=64,
    d 127 and 128); rs_out 2C and C and E 8 and 1 alternate.  The first
    case of each batch, width and dilation is also held against the first
    design (``wn_block_padded.first_design``).  Pad tiles exactly zero; the
    stream layer's skip sum is updated in place in a buffer with guard rows
    on both sides, which stay as they were; the final layer leaves its skip
    sum as it found it; the plan's shared memory is the kernel's own
    (``t2s_wn_padded_sm90_smem_bytes``).  Then the two times at B=1 and 3,
    d=64, beside the first design in turns (first, sm90, sm90, first), the
    plain version and the bound (``ms``, ``prev_ms``, ``plain_ms``,
    ``bound_ms`` and their ``_b3`` forms in ``rec``).  Returns the seconds
    of the cases and of the times."""
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    dev = torch.device("cuda")
    bt, T, bf = wp.BT_PAD, 6400, torch.bfloat16
    lib = wp.LIB_SM90.get()
    cases = [(1, T, C, M, d, nv) for d in (0, 1, 63, 64, 128)
             for nv in (T - 301, T, 1, 0)]
    cases += [(3, T, C, M, d, nv) for d in (1, 64, 128) for nv in (T - 301, T)]
    cases += [(1, 1024, 192, 96, 0, 1024), (3, 1024, 192, 96, 63, 723),
              (1, 1024, 192, 96, 128, 1), (3, 1024, 192, 96, 1, 0)]
    # C = 1024 at d = 127, 128: the plan's one window slot
    cases += [(1, 1024, 1024, 64, 128, 1000), (3, 512, 1024, 64, 127, 512)]
    guard = 64                     # bf16 values of guard on each side
    seen = set()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (B, Tc, Cc, Mc, d, nv) in enumerate(cases):
        rs_half, Ec = i % 2 == 1, 1 if i % 3 == 1 else E
        vs_first = (B, Tc, Cc, d) not in seen
        seen.add((B, Tc, Cc, d))
        for role, code in wp.PADDED_SM90_ROLES.items():
            plan = wp.padded_sm90_plan(Cc, Tc, B, d, role)
            smem = lib.t2s_wn_padded_sm90_smem_bytes(
                code, Cc, d, plan["nwin"], plan["nwst"])
            if smem != plan["smem"]:
                raise RuntimeError(f"{role} C={Cc} d={d} plan: "
                                   f"{plan['smem']} B of shared memory, the "
                                   f"kernel asks {smem}")
        a = stream_case_args(B, Tc, nv, Cc, Mc, Ec, 700 + i, dev, d, rs_half)
        tag = (f"B={B} T={Tc} C={Cc} M={Mc} d={d} n_valid={nv} rs_out="
               f"{Cc if rs_half else 2 * Cc}")
        args = a["wn_layer_stream"]
        acc = args[-2]
        buf = torch.full((acc.numel() + 2 * guard,), 7.0, dtype=bf,
                         device=dev)
        skip = buf[guard:guard + acc.numel()].view_as(acc)
        skip.copy_(acc)
        got = wp.wn_layer_stream(*args[:-2], skip, d, n_valid=nv)
        if got[1].data_ptr() != skip.data_ptr():
            raise RuntimeError(f"wn_layer_stream {tag}: skip not in place")
        if (buf[:guard] != 7).any() or (buf[-guard:] != 7).any():
            raise RuntimeError(f"wn_layer_stream {tag}: the in-place skip "
                               f"sum wrote outside its rows")
        want = wp.wn_layer_stream_plain(*args[:-2], acc, d, nv)
        first = (wp.first_design("wn_layer_stream", *args[:-2], acc.clone(),
                                 d, n_valid=nv) if vs_first else (None,) * 2)
        outs = [(f"wn_layer_stream[{j}]", g, w, f)
                for j, (g, w, f) in enumerate(zip(got, want, first))]
        args = a["wn_layer_stream_final"]
        keep = args[-4].clone()
        got = wp.wn_layer_stream_final(*args, n_valid=nv)
        if not torch.equal(args[-4], keep):
            raise RuntimeError(f"wn_layer_stream_final {tag}: skip_acc "
                               f"changed")
        outs.append((f"wn_layer_stream_final E={Ec}", got,
                     wp.wn_layer_stream_final_plain(*args, nv),
                     wp.first_design("wn_layer_stream_final", *args,
                                     n_valid=nv) if vs_first else None))
        for name, g, w, f in outs:
            if g[:, :bt].any() or g[:, -bt:].any():
                raise RuntimeError(f"{name} {tag}: pad tiles not zero")
            err = compare(f"{name} {tag}", g, w)
            if f is not None:
                compare(f"{name} {tag} vs first design", g, f)
            r = rec[name.split("[")[0].split()[0]]
            r["max_abs_err"] = max(r["max_abs_err"], err)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for B in (1, 3):
        a = stream_case_args(B, T, T, C, M, E, 790 + B, dev, 64)
        for name, args in a.items():
            kern, plain = getattr(wp, name), getattr(wp, name + "_plain")

            def first(name=name, args=args):
                return wp.first_design(name, *args)

            turns = [time_ms(f, iters=10 if f is first else 50)
                     for f in (first, lambda: kern(*args),
                               lambda: kern(*args), first)]
            outs = kern(*args)
            outs = outs if isinstance(outs, tuple) else (outs,)
            tensors = [t for t in (*args, *outs) if torch.is_tensor(t)]
            bound, by = bound_ms(padded_work(name, B, T, C, M, E), tensors)
            ms, prev = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
            plain_ms = time_ms(lambda: plain(*args), warmup=1, iters=3)
            sfx = "" if B == 1 else "_b3"
            rec[name].update({"ms" + sfx: ms, "prev_ms" + sfx: prev,
                              "plain_ms" + sfx: plain_ms,
                              "bound_ms" + sfx: bound})
            if B == 1:
                rec[name]["bound_by"] = by
            role = "stream_final" if name.endswith("final") else "stream"
            plan = wp.padded_sm90_plan(C, T, B, 64, role)
            print(f"[kernels] {name} ({PADDED_SM90_ROLES[name]}) B={B} T={T} "
                  f"d=64: sm90 {turns[1]:.4f} / {turns[2]:.4f} ms, first "
                  f"design {turns[0]:.4f} / {turns[3]:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound:.4f} ms (by {by}; "
                  f"{100 * bound / ms:.2f}% of it, first design "
                  f"{100 * bound / prev:.2f}%), {plan['tiles']} tiles of "
                  f"{plan['bm']} rows, {plan['nwin']} window / "
                  f"{plan['nwst']} weight slots")
    torch.cuda.synchronize()
    return {"rows 14-15 cases": t1 - t0,
            "rows 14-15 times": time.perf_counter() - t1}


def check_padded_kernels(C: int = 512, M: int = 640, E: int = 8) -> dict:
    """The four padded kernels against their plain versions at B=1,
    T=6400 (Tp = 6656), C=512, M=640, E=8 for d in {1, 64, 128} at full
    and short ``n_valid``; pad tiles exactly zero; then rows 12-13's own
    cases and times (``check_tiles_sm90``) and rows 14-15's
    (``check_stream_sm90``).  Prints the seconds of each part."""
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    dev = torch.device("cuda")
    bt = wp.BT_PAD
    rec = {n: {"max_abs_err": 0.0, "library_ms": None}
           for n in PADDED_KERNELS}
    B, T, seed = 1, 6400, 300
    torch.cuda.synchronize()
    t0 = time.perf_counter()
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
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    parts = {"rows 12-15 vs plain": t1 - t0,
             **check_tiles_sm90(rec, C, M),
             **check_stream_sm90(rec, C, M, E)}
    print("[time] phase 22 parts, seconds: "
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    return rec


def ladder_path(C: int = 512, M: int = 640, E: int = 8) -> dict:
    """The padded kernels' own path, the parity ladder across kernels on
    the card (``tests/test_pallas.py:81-250`` in the JAX package): kernel 2
    (the unpadded standard layer) against 14 and kernel 3 (the unpadded
    final layer, end projection folded) against 15 on the valid rows,
    kernel 9 (``dcond``) against 12 on the same stacked conditioning, and
    13 against 14 (two implementations: the three-tile ``wgmma`` kernel of
    ``csrc/wn_block_padded_tiles_sm90.cu`` and the one-window ``wgmma``
    kernel of ``csrc/wn_block_padded_sm90.cu``).  Returns the padded
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


GL_ITERS = 8
GL_MAX_STEPS = 200


def cli_griffin_lim(ckpt: str, d: str) -> None:
    """The inference CLI's vocoder-free path on the Tacotron checkpoint
    ``ckpt`` (a checkpoint directory alone): ``synthesize_griffin_lim`` in
    this process (no WN-layer kernel launched; the waveform finite, hop x
    (frames - 1) samples of its mel), then ``python -m
    text2speech_tpu_torch.inference --taco_checkpoint ckpt
    --griffin_lim_iters 8`` in a process of its own, its WAV read back.
    The checkpoint's stop gate, trained for a few steps, fires at the
    first frame, so both runs take ``--hparams`` with ``gate_threshold``
    1.0: the decode runs ``--max_steps`` frames."""
    from scipy.io import wavfile

    from text2speech_tpu_torch import inference
    from text2speech_tpu_torch.config import HParams, WaveGlowConfig

    hp_json = os.path.join(d, "gl_hparams.json")
    with open(hp_json, "w") as f:
        json.dump({"sample_rate": 22050, "gate_threshold": 1.0}, f)
    argv = ["--taco_checkpoint", ckpt, "--griffin_lim_iters", str(GL_ITERS),
            "--max_steps", str(GL_MAX_STEPS), "--hparams", hp_json]
    args = inference.build_parser().parse_args(
        argv + ["--out", os.path.join(d, "gl_in_process.wav")])
    hp = HParams.load(hp_json)                     # as the CLI builds it
    reset_counts()
    wav, frames = inference.synthesize_griffin_lim(args, hp,
                                                   WaveGlowConfig(), "cuda")
    torch.cuda.synchronize()
    print(f"[gl] synthesize_griffin_lim: {frames} mel frames -> "
          f"{wav.shape[0]} samples, peak {np.abs(wav).max():.4g}, launches "
          f"{all_counts()}")
    if (frames != GL_MAX_STEPS
            or wav.shape != (hp.hop_length * (frames - 1),)
            or not np.isfinite(wav).all() or any(all_counts().values())):
        raise RuntimeError("Griffin-Lim path: bad waveform or WN launches")
    out = os.path.join(d, "gl.wav")
    r = subprocess.run([sys.executable, "-m", "text2speech_tpu_torch.inference",
                        *argv, "--out", out], capture_output=True, text=True,
                       timeout=600)
    line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    print(f"[gl] python -m text2speech_tpu_torch.inference "
          f"{' '.join(argv[2:6])} -> rc {r.returncode}: {line}")
    m = re.search(r"Griffin-Lim on (\d+) mel frames", line)
    if r.returncode != 0 or not m:
        raise RuntimeError(f"Griffin-Lim CLI failed:\n{r.stderr[-3000:]}")
    sr, pcm = wavfile.read(out)
    n = hp.hop_length * (int(m.group(1)) - 1)
    if sr != hp.sample_rate or pcm.dtype != np.int16 or pcm.shape != (n,) \
            or not pcm.any():
        raise RuntimeError(f"Griffin-Lim CLI: WAV {sr} Hz {pcm.dtype} "
                           f"{pcm.shape}, want {hp.sample_rate} Hz int16 "
                           f"({n},)")


# ---------------------------------------------------------------------------
# corpus preprocessing: the CLI on a KSS-shaped synthetic corpus
# ---------------------------------------------------------------------------

# KSS ships 12,853 WAVs of 1-10+ s at 44,100 Hz; a synthetic corpus of this
# many, written from a numpy seed, stands in for it
PRE_WAVS = 200
PRE_SR = 44100


def write_kss_corpus(root: str) -> str:
    """PRE_WAVS synthetic utterances of 1-10 s at 44,100 Hz (a voiced tone
    with harmonics under a syllable-rate envelope, in noise), each with a
    silent lead-in and tail of 0.1-0.6 s, and ``transcript.txt`` in KSS's
    six columns (path, script, expanded script, decomposed script,
    duration, translation); every tenth row's expanded script has another
    word count, which gives two items of one WAV."""
    import unicodedata

    from scipy.io import wavfile

    rng = np.random.RandomState(13)
    lines = []
    for i in range(PRE_WAVS):
        sub = f"{1 + i % 4}"
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        n = int(PRE_SR * rng.uniform(1.0, 10.0))
        t = np.arange(n) / PRE_SR
        f0 = rng.uniform(90, 260)
        voice = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in (1, 2, 3))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 6) * t)
        sig = 0.25 * voice * env + 0.01 * rng.randn(n)
        lead, tail = (np.zeros(int(PRE_SR * rng.uniform(0.1, 0.6)))
                      for _ in range(2))
        sig = np.concatenate([lead, sig, tail])
        name = f"{sub}/{sub}_{i:04d}.wav"
        wavfile.write(os.path.join(root, name), PRE_SR,
                      (np.clip(sig, -1, 1) * 32767).astype(np.int16))
        text = TACO_TEXTS[i % len(TACO_TEXTS)]
        expanded = text if i % 10 else text.replace(" ", "")
        lines.append(f"{name}|{text}|{expanded}|"
                     f"{unicodedata.normalize('NFD', text)}|"
                     f"{len(sig) / PRE_SR:.1f}|synthetic")
    with open(os.path.join(root, "transcript.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return root


def preprocess_path(info: str) -> None:
    """Phase 26: ``python -m text2speech_tpu_torch.preprocess`` on the card,
    each in a process of its own, with ``--trim_impl device`` and then
    ``--trim_impl host`` on a KSS-shaped corpus (:func:`write_kss_corpus`,
    the reference hparams: 44,800 Hz, so every WAV is resampled): the two
    outputs' npz arrays and ``train.txt`` equal, the native WAV decoder
    built and used for every file, the port's npz feeder (the Tacotron
    trainer's reader of preprocess output) batching the output on the
    card; mel frames per second of each placement."""
    from text2speech_tpu_torch.config import HParams
    from text2speech_tpu_torch.data.npz_dataset import NpzDataFeeder
    from text2speech_tpu_torch.data.preprocess import parse_transcript

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        corpus = write_kss_corpus(os.path.join(d, "kss"))
        # a row with two scripts loads its WAV once for each
        n_rows = len(parse_transcript(corpus))
        print(f"[preprocess] corpus: {PRE_WAVS} WAVs at {PRE_SR} Hz, "
              f"{n_rows} transcript items, written in "
              f"{time.perf_counter() - t0:.2f} s")
        outs, rates = {}, {}
        for impl in ("device", "host"):
            out = os.path.join(d, f"out_{impl}")
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "text2speech_tpu_torch.preprocess",
                 "--in_dir", corpus, "--out_dir", out, "--trim_impl", impl,
                 "--num_workers", "8"],
                capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            rate = re.search(r"\((\d+) mel frames/sec\)", r.stdout)
            nat = re.search(r"native WAV decoder built: (\d+) files", r.stdout)
            wrote = re.search(r"Wrote (\d+) utterances, (\d+) mel frames",
                              r.stdout)
            if r.returncode != 0 or not (rate and nat and wrote):
                raise RuntimeError(f"preprocess CLI --trim_impl {impl} failed "
                                   f"(rc {r.returncode}):\n{r.stdout[-2000:]}"
                                   f"\n{r.stderr[-3000:]}")
            if int(nat.group(1)) != n_rows:
                raise RuntimeError(f"preprocess --trim_impl {impl}: "
                                   f"{nat.group(1)} of {n_rows} WAV loads "
                                   f"decoded natively")
            rates[impl] = int(rate.group(1))
            outs[impl] = out
            print(f"[preprocess] --trim_impl {impl}: {wrote.group(1)} "
                  f"utterances, {wrote.group(2)} mel frames, "
                  f"{rates[impl]} mel frames/s ({wall:.2f} s with the "
                  f"process start), {nat.group(1)} WAV loads decoded "
                  f"natively; "
                  f"{info}")
        rows = {impl: open(os.path.join(o, "train.txt"),
                           encoding="utf-8").read().splitlines()
                for impl, o in outs.items()}
        if rows["device"] != rows["host"] or not rows["device"]:
            raise RuntimeError("preprocess: train.txt differs between the "
                               "trim placements")
        for row in rows["device"]:
            npz = row.split("|")[6]
            with np.load(os.path.join(outs["device"], npz)) as a, \
                    np.load(os.path.join(outs["host"], npz)) as b:
                if sorted(a.files) != sorted(b.files) or not all(
                        np.array_equal(a[k], b[k]) for k in a.files):
                    raise RuntimeError(f"preprocess: {npz} differs between "
                                       f"the trim placements")
        dups = sum("-2.npz" in r for r in rows["device"])
        feeder = NpzDataFeeder([outs["device"]], HParams(), device="cuda")
        batch = feeder.sample_batch()
        if batch.mel.device.type != "cuda" or batch.mel.shape[1] != 80 \
                or not torch.isfinite(batch.mel).all():
            raise RuntimeError(f"npz feeder: mel {batch.mel.shape} on "
                               f"{batch.mel.device}")
        print(f"[preprocess] device and host trim: {len(rows['device'])} "
              f"rows ({dups} second items of one WAV) and their npz arrays "
              f"equal; NpzDataFeeder: {len(feeder.corpus_files[0])} files, "
              f"batch mel {tuple(batch.mel.shape)} on the card")


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
    fused vocoder, and through the CLI's Griffin-Lim path.  Prints the
    seconds of each part."""
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
        part("Griffin-Lim CLI", lambda: cli_griffin_lim(ckpt, d))
    print(f"[time] phase 24 parts, seconds: "
          f"{ {k: round(v, 2) for k, v in secs.items()} }; in all "
          f"{sum(secs.values()):.2f}")


# ---------------------------------------------------------------------------
# phase 27: data parallelism over torch.distributed groups
# ---------------------------------------------------------------------------

# Two ranks against one process on the same global batch, both on this card
# in f32 with TF32 off: the ranks sum the same products in another order
# (each its rows, then one all-reduce).  WaveGlow: the loss, a mean of terms
# of about 0.1, to 1e-6 absolute and the gradient norm to 1e-4 relative (the
# bounds of phase 9); one Adam step moves a parameter by lr g / (|g| + eps),
# which a difference in the last bits of g moves only where |g| is near eps:
# 0.1 lr.  Tacotron: the JAX package's DP bounds
# (tests/test_train_infra.py:80-85, 430): loss 1e-5 relative, parameters and
# the BatchNorm running statistics 1e-5 absolute; the gradient norm 1e-4
# relative.  Vocoding: a rank's window rows go through the same kernels at
# another batch size, where a library call may sum in another order; the
# audio is held to the main path's kernel-against-plain bounds.
DP_LOSS_ATOL = 1e-6
DP_GNORM_RTOL = 1e-4
DP_PARAM_LR = 0.1
DP_TACO_LOSS_RTOL = 1e-5
DP_TACO_ATOL = 1e-5
DP_TACO_B, DP_TACO_T_IN, DP_TACO_T_OUT = 4, 40, 96
DP_LONG_FRAMES, DP_GRID_FRAMES = 600, 64

DP_WORKER = r'''
import json
import sys
import time

import torch
import torch.distributed as dist

from text2speech_tpu_torch.parallel import mesh as pm

role, port, world, rank, inp, out = (sys.argv[1], int(sys.argv[2]),
                                     int(sys.argv[3]), int(sys.argv[4]),
                                     sys.argv[5], sys.argv[6])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
assert pm.initialize_distributed(f"tcp://localhost:{port}", world, rank,
                                 device="cuda")


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def audio_err(got, want):
    want = want.to(got.device)
    return {"max_abs": (got - want).abs().max().item(),
            "rel_l2": ((got - want).norm() / want.norm()).item(),
            "peak": want.abs().max().item(), "shape": list(got.shape),
            "finite": bool(torch.isfinite(got).all())}


def checksum(tensors):
    return float(sum(t.detach().double().sum().item() for t in tensors))


def dp2(d):
    from text2speech_tpu_torch.data.dataset import Batch
    from text2speech_tpu_torch.data.mel2samp import VocoderBatch
    from text2speech_tpu_torch.models import chunked
    from text2speech_tpu_torch.models.tacotron2 import Tacotron2
    from text2speech_tpu_torch.models.waveglow import (TrainableWaveGlow,
                                                       WaveGlow)
    from text2speech_tpu_torch.models.waveglow_fused import (
        prepare_fused, prepare_fused_int8)
    from text2speech_tpu_torch.ops import gated
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_int8 as wq
    from text2speech_tpu_torch.text import N_SYMBOLS
    from text2speech_tpu_torch.train.state import (create_tacotron_state,
                                                   create_train_state)
    from text2speech_tpu_torch.train.tacotron import make_train_step
    from text2speech_tpu_torch.train.waveglow import make_wg_train_step

    mesh = pm.make_mesh()
    res = {"mesh": [list(mesh.shape), mesh.rank()]}
    cfg = d["wg_cfg"]
    model = TrainableWaveGlow(cfg, device="cuda")
    with torch.no_grad():
        for n, p in model.params.items():
            p.copy_(d["wg_params"][n])
    state = create_train_state(model.params, cfg.learning_rate)
    batch = VocoderBatch(*(t.cuda() for t in d["wg_batch"]))
    step = make_wg_train_step(model, cfg.sigma, mesh=mesh)
    gated.reset_launch_counts()
    (_, m), wall = timed(lambda: step(state, batch))
    ref = d["wg_ref"]
    res["wg"] = {
        "loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
        "param_err": max((p.detach().cpu() - ref["params"][n]).abs().max()
                         .item() for n, p in model.params.items()),
        "checksum": checksum(model.params.values()),
        "launches": gated.launch_counts(), "wall": wall}
    del model, state, step
    torch.cuda.empty_cache()

    hp = d["taco_hp"]
    for ga in (1, 2):
        model = Tacotron2(hp, N_SYMBOLS, device="cuda")
        model.load_state_dict(d["taco_sd"])
        state = create_tacotron_state(model, hp)
        batch = Batch(*(t.cuda() for t in d["taco_batch"]))
        step = make_train_step(model, hp, ga, mesh)
        (_, m), wall = timed(lambda: step(
            state, batch, torch.Generator(device="cuda").manual_seed(5)))
        ref = d["taco_ref"][ga]
        sd = model.state_dict()
        stats = [n for n in sd if n.endswith(("running_mean",
                                              "running_var"))]
        res[f"taco{ga}"] = {
            "loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
            "stats_err": max((sd[n].cpu() - ref["sd"][n]).abs().max().item()
                             for n in stats),
            "param_err": max((sd[n].cpu() - ref["sd"][n]).abs().max().item()
                             for n in sd if n not in stats),
            "checksum": checksum(sd.values()), "wall": wall}
        del model, state, step
    torch.cuda.empty_cache()

    wg = WaveGlow(d["voc_cfg"], device="cuda")
    wg.load_state_dict(d["voc_sd"])
    wg.eval()
    mel = d["long_mel"].cuda()
    noise = tuple(z.cuda() for z in d["long_noise"])
    for tag, prep in (("bf16", prepare_fused), ("int8", prepare_fused_int8)):
        fw = prep(wg)
        wb.reset_launch_counts()
        wq.reset_launch_counts()
        with torch.inference_mode():
            audio, wall = timed(lambda: chunked.infer_long(
                fw, mel, d["sigma"], chunk_frames=256, noise=noise,
                mesh=mesh))
        res[f"long_{tag}"] = {**audio_err(audio, d["long_ref"][tag]),
                              "launches": {**wb.launch_counts(),
                                           **wq.launch_counts()},
                              "wall": wall}
        del fw
    return res


def grid(d):
    from text2speech_tpu_torch.models.waveglow import WaveGlow
    from text2speech_tpu_torch.parallel import tp

    mesh = pm.make_mesh((2, 2), (pm.DATA_AXIS, pm.MODEL_AXIS))
    res = {"coords": list(mesh.coords)}
    wg = WaveGlow(d["voc_cfg"], device="cuda")
    wg.load_state_dict(d["voc_sd"])
    wg.eval()
    mel = d["grid_mel"].cuda()
    noise = tuple(z.cuda() for z in d["grid_noise"])
    for tag, int8 in (("bf16", False), ("int8", True)):
        server = tp.TPWaveGlowServer(wg, mesh=mesh, int8=int8)
        tp.reset_launch_counts()
        audio, wall = timed(lambda: server(mel, d["sigma"], noise=noise))
        res[tag] = {"vs_tp": audio_err(audio, d["grid_ref"][tag]),
                    "vs_fused": audio_err(audio, d["grid_fused"][tag]),
                    "launches": tp.launch_counts(), "wall": wall,
                    "ranks": server.ranks, "n_model": server.n_model}
        del server
    return res


def tp2(d):
    """Phase 28: this rank's shard of the tensor-parallel decode and of
    ``make_server_tp`` over a gloo group of two, each against the
    one-process two-shard run (bit for bit)."""
    import numpy as np

    from text2speech_tpu_torch.models.tacotron2 import Tacotron2
    from text2speech_tpu_torch.models.waveglow import WaveGlow
    from text2speech_tpu_torch.parallel import tp
    from text2speech_tpu_torch.parallel.serve import TPSynthesizer
    from text2speech_tpu_torch.parallel.tp_tacotron import TPTacotronDecoder
    from text2speech_tpu_torch.server import make_server_tp
    from text2speech_tpu_torch.text import N_SYMBOLS

    hp, cfg, me = d["hp"], d["wg_cfg"], dist.get_rank()
    taco = Tacotron2(hp, N_SYMBOLS, device="cuda")
    taco.load_state_dict(d["taco_sd"])
    taco.eval()
    wg = WaveGlow(cfg, device="cuda")
    wg.load_state_dict(d["wg_sd"])
    wg.eval()
    mem, pmem, masks, lengths = (t.cuda() for t in d["decode_in"])
    res = {"rank": me}
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        dec = TPTacotronDecoder(taco, hp, group=dist.group.WORLD, dtype=dt)
        with torch.inference_mode():
            out, wall = timed(lambda: dec(mem, pmem, *dec.initial_carry(mem),
                                          masks, lengths))
        (st, fr, fin), *outs = out
        (st_w, fr_w, fin_w), *outs_w = d["decode_ref"][tag]
        same = [torch.equal(a.cpu(), b) for a, b in zip(outs, outs_w)]
        same += [torch.equal(fr.cpu(), fr_w), torch.equal(fin.cpu(), fin_w)]
        for field, a, b in zip(st._fields, st, st_w):
            if field.endswith("_c"):          # this rank's columns
                k = b.shape[-1] // 2
                b = b[:, me * k:(me + 1) * k]
            same.append(torch.equal(a.cpu(), b))
        res[f"decode_{tag}"] = {"equal": all(same), "wall": wall,
                                "ranks": dec.ranks}
    tps = TPSynthesizer(hp, taco, cfg, wg, group=dist.group.WORLD,
                        chunk_steps=d["chunk"])
    srv = make_server_tp(tps, slots=2, chunk_steps=d["chunk"],
                         max_steps=d["steps"])
    srv.warm_window_widths()
    tp.reset_launch_counts()
    wavs, wall = timed(lambda: srv.run(d["texts"], seeds=d["seeds"]))
    res["server"] = {
        "equal": sorted(wavs) == sorted(d["server_ref"]) and all(
            np.array_equal(wavs[k], d["server_ref"][k]) for k in wavs),
        "wall": wall, "rounds": srv.stats["rounds"],
        "launches": tp.launch_counts()}
    return res


res = {"backend": dist.get_backend(), "device": str(pm.rank_device())}
try:
    d = torch.load(inp, weights_only=False, mmap=True)
    res.update({"dp2": dp2, "grid": grid, "tp2": tp2}[role](d))
    with open(out, "w") as f:
        json.dump(res, f)
finally:
    pm.destroy_distributed()
'''


def run_ranks(role: str, world: int, inputs: str, d: str,
              timeout: int = 300) -> list:
    """``world`` processes of ``DP_WORKER`` on this card over one gloo group
    (the ranks share the card); each writes its results as JSON.  Every
    process is killed by ``timeout``."""
    script = os.path.join(d, "dp_worker.py")
    with open(script, "w", encoding="utf-8") as f:
        f.write(DP_WORKER)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    outs = [os.path.join(d, f"{role}{r}.json") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, script, role, str(port), str(world), str(r),
         inputs, outs[r]], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        deadline = time.time() + timeout
        for pr in procs:
            out, _ = pr.communicate(timeout=max(1, deadline - time.time()))
            logs.append(out)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait(timeout=30)
    if any(pr.returncode != 0 for pr in procs):
        raise RuntimeError(f"{role} ranks failed: rc "
                           f"{[pr.returncode for pr in procs]}\n"
                           + "\n".join(log[-3000:] for log in logs))
    results = []
    for path in outs:
        with open(path, encoding="utf-8") as f:
            results.append(json.load(f))
    return results


def dp_taco_setup(hp):
    """Seeded full-width Tacotron weights and a batch of 4 rows of unequal
    lengths, on the CPU."""
    from text2speech_tpu_torch.data.dataset import Batch
    from text2speech_tpu_torch.models.tacotron2 import (Tacotron2,
                                                        init_weights_)
    from text2speech_tpu_torch.text import N_SYMBOLS

    model = init_weights_(Tacotron2(hp, N_SYMBOLS),
                          torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(6)
    B, T_in, T_out = DP_TACO_B, DP_TACO_T_IN, DP_TACO_T_OUT
    in_len = torch.tensor([40, 33, 27, 18], dtype=torch.int32)
    out_len = torch.tensor([96, 80, 71, 50], dtype=torch.int32)
    text = torch.randint(2, 70, (B, T_in), generator=g, dtype=torch.int32)
    text = torch.where(torch.arange(T_in)[None] < in_len[:, None], text, 0)
    valid = (torch.arange(T_out)[None] < out_len[:, None]).float()
    mel = torch.randn(B, hp.n_mel_channels, T_out, generator=g) \
        * valid[:, None]
    gate = (torch.arange(T_out)[None] >= out_len[:, None] - 1).float()
    batch = Batch(text, in_len, mel, gate, torch.zeros(B, dtype=torch.int32),
                  out_len)
    return model.state_dict(), batch


def dp_wg_setup(cfg, files: str):
    """Seeded full-width WaveGlow parameters (the ``end`` convs perturbed,
    as phase 9) and a global batch of 4 x 16,000 samples from the corpus,
    on the CPU."""
    from text2speech_tpu_torch.data.mel2samp import (Mel2Samp, VocoderBatch,
                                                     files_to_list)
    from text2speech_tpu_torch.models.waveglow import TrainableWaveGlow

    model = TrainableWaveGlow(
        cfg, generator=torch.Generator().manual_seed(cfg.seed))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in sorted(model.params.items()):
            if "/end/" in name:
                p.add_(0.01 * torch.randn(p.shape, generator=g))
    paths = files_to_list(files)
    data = Mel2Samp(paths, cfg, device="cuda")
    batch = data.make_batch(paths[:4], list(range(4)))
    return ({n: p.detach().clone() for n, p in model.params.items()},
            VocoderBatch(batch.mel.cpu(), batch.audio.cpu()))


def dp_wg_step(cfg, params: dict, batch, grad_accum: int = 1, mesh=None):
    """One step of a fresh trainable model from ``params`` on the card ->
    (metrics, updated parameters on the CPU)."""
    from text2speech_tpu_torch.data.mel2samp import VocoderBatch
    from text2speech_tpu_torch.models.waveglow import TrainableWaveGlow
    from text2speech_tpu_torch.train.state import create_train_state
    from text2speech_tpu_torch.train.waveglow import make_wg_train_step

    model = TrainableWaveGlow(cfg, device="cuda")
    with torch.no_grad():
        for n, p in model.params.items():
            p.copy_(params[n])
    state = create_train_state(model.params, cfg.learning_rate)
    _, m = make_wg_train_step(model, cfg.sigma, grad_accum, mesh)(
        state, VocoderBatch(*(t.cuda() for t in batch)))
    return m, {n: p.detach().cpu() for n, p in model.params.items()}


def dp_taco_step(hp, sd: dict, batch, grad_accum: int = 1, mesh=None):
    """One step of a fresh full-width Tacotron from ``sd`` on the card,
    masks from a generator seeded 5 -> (metrics, state dict on the CPU)."""
    from text2speech_tpu_torch.data.dataset import Batch
    from text2speech_tpu_torch.models.tacotron2 import Tacotron2
    from text2speech_tpu_torch.text import N_SYMBOLS
    from text2speech_tpu_torch.train.state import create_tacotron_state
    from text2speech_tpu_torch.train.tacotron import make_train_step

    model = Tacotron2(hp, N_SYMBOLS, device="cuda")
    model.load_state_dict(sd)
    state = create_tacotron_state(model, hp)
    _, m = make_train_step(model, hp, grad_accum, mesh)(
        state, Batch(*(t.cuda() for t in batch)),
        torch.Generator(device="cuda").manual_seed(5))
    return m, {n: t.cpu() for n, t in model.state_dict().items()}


def dp_one_rank_nccl(cfg, wg_params, wg_batch, hp, taco_sd, taco_batch,
                     synth, mel, noise) -> None:
    """The distributed forms on an NCCL group of this one rank: the
    WaveGlow and the Tacotron step (deterministic kernels) and
    ``infer_long`` through both fused vocoders bit for bit those of
    ``mesh=None``."""
    from text2speech_tpu_torch.models import chunked
    from text2speech_tpu_torch.models.waveglow_fused import prepare_fused_int8
    from text2speech_tpu_torch.parallel import mesh as pm

    assert pm.initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0,
                                     device="cuda")
    prev = (torch.backends.cudnn.deterministic,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    try:
        import torch.distributed as dist

        mesh = pm.make_mesh()
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        same = {}
        for ga in (1, 2):
            (m0, p0), (m1, p1) = (dp_wg_step(cfg, wg_params, wg_batch, ga,
                                             mk) for mk in (None, mesh))
            same[f"waveglow grad_accum {ga}"] = (
                all(torch.equal(m0[k], m1[k]) for k in m0)
                and all(torch.equal(p0[n], p1[n]) for n in p0))
        for ga in (1, 2):
            (m0, s0), (m1, s1) = (dp_taco_step(hp, taco_sd, taco_batch, ga,
                                               mk) for mk in (None, mesh))
            same[f"tacotron grad_accum {ga}"] = (
                all(torch.equal(m0[k], m1[k]) for k in m0)
                and all(torch.equal(s0[n], s1[n]) for n in s0))
        torch.backends.cudnn.deterministic = prev[0]
        torch.use_deterministic_algorithms(prev[1], warn_only=prev[2])
        with torch.inference_mode():
            for tag, fw in (("bf16", synth.fused),
                            ("int8", prepare_fused_int8(synth.waveglow))):
                a = chunked.infer_long(fw, mel, SIGMA, chunk_frames=256,
                                       noise=noise)
                b = chunked.infer_long(fw, mel, SIGMA, chunk_frames=256,
                                       noise=noise, mesh=mesh)
                same[f"infer_long {tag}"] = torch.equal(a, b)
        print(f"[dp] NCCL group of one rank ({dist.get_backend()}, "
              f"{pm.rank_device()}), bit-equal to mesh=None: {same}")
        if not all(same.values()):
            raise RuntimeError(f"the one-rank distributed form differs from "
                               f"mesh=None: {same}")
    finally:
        torch.backends.cudnn.deterministic = prev[0]
        torch.use_deterministic_algorithms(prev[1], warn_only=prev[2])
        pm.destroy_distributed()


def dp_check_two_ranks(res: list, ref_wg, cfg, ref_taco, wg_cfg,
                       info: str) -> None:
    """Phase 27's two ranks against the one-process numbers."""
    n = cfg.n_flows * cfg.wn_n_layers
    for r, out in enumerate(res):
        if out["backend"] != "gloo" or out["mesh"] != [[2], r]:
            raise RuntimeError(f"rank {r}: {out['backend']} {out['mesh']}")
        w = out["wg"]
        print(f"[dp] rank {r} WaveGlow step (global batch 4 x 16,000, 2 "
              f"rows here): loss {w['loss']:.8g} vs one process "
              f"{ref_wg[0]:.8g} (bound {DP_LOSS_ATOL}), grad norm "
              f"{w['grad_norm']:.8g} vs {ref_wg[1]:.8g} (bound "
              f"{DP_GNORM_RTOL} relative), updated parameters max-abs "
              f"{w['param_err']:.3g} (bound {DP_PARAM_LR * cfg.learning_rate:.3g}"
              f"); gated launches {w['launches']}; wall {w['wall']:.3f} s "
              f"({info})")
        if w["launches"] != {"gated_fwd": n, "gated_bwd": n} or \
                abs(w["loss"] - ref_wg[0]) > DP_LOSS_ATOL or \
                abs(w["grad_norm"] - ref_wg[1]) > DP_GNORM_RTOL * ref_wg[1] \
                or w["param_err"] > DP_PARAM_LR * cfg.learning_rate:
            raise RuntimeError(f"rank {r}: the data-parallel WaveGlow step "
                               f"differs from the one-process step")
        for ga in (1, 2):
            t = out[f"taco{ga}"]
            rl, rn = ref_taco[ga]
            print(f"[dp] rank {r} Tacotron step grad_accum {ga} (global "
                  f"batch {DP_TACO_B} x {DP_TACO_T_OUT} frames): loss "
                  f"{t['loss']:.8g} vs {rl:.8g} (bound {DP_TACO_LOSS_RTOL} "
                  f"relative), grad norm {t['grad_norm']:.8g} vs {rn:.8g} "
                  f"(bound {DP_GNORM_RTOL} relative), BatchNorm statistics "
                  f"max-abs {t['stats_err']:.3g}, parameters "
                  f"{t['param_err']:.3g} (bound {DP_TACO_ATOL}); wall "
                  f"{t['wall']:.3f} s ({info})")
            if abs(t["loss"] - rl) > DP_TACO_LOSS_RTOL * abs(rl) or \
                    abs(t["grad_norm"] - rn) > DP_GNORM_RTOL * rn or \
                    max(t["stats_err"], t["param_err"]) > DP_TACO_ATOL:
                raise RuntimeError(f"rank {r}: the data-parallel Tacotron "
                                   f"step differs from the one-process step")
        for tag, int8 in (("bf16", False), ("int8", True)):
            a = out[f"long_{tag}"]
            steps, rel = ((E2E_INT8_MAX_ABS_STEPS, E2E_INT8_REL_L2) if int8
                          else (E2E_MAX_ABS_STEPS, E2E_REL_L2))
            per_vocode = want_counts(wg_cfg, int8)
            want = {k: per_vocode.get(k, 0) for k in a["launches"]}
            print(f"[dp] rank {r} infer_long {tag}, {DP_LONG_FRAMES} frames "
                  f"(3 windows padded to 4, 2 here) vs one process: max_abs "
                  f"{a['max_abs']:.6g} (bound {steps * a['peak']:.4g}), "
                  f"rel_l2 {a['rel_l2']:.4g} (bound {rel}); WN launches "
                  f"{ {k: v for k, v in a['launches'].items() if v} }; wall "
                  f"{a['wall'] * 1e3:.1f} ms ({info})")
            if not a["finite"] or a["shape"] != [1, DP_LONG_FRAMES * wg_cfg.
                                                  upsample_stride] or \
                    a["max_abs"] > steps * a["peak"] or a["rel_l2"] > rel \
                    or a["launches"] != want:
                raise RuntimeError(f"rank {r}: infer_long(mesh=) {tag} out "
                                   f"of bounds")
    for key in ("wg", "taco1", "taco2"):
        if res[0][key]["checksum"] != res[1][key]["checksum"]:
            raise RuntimeError(f"the two ranks' {key} states differ")


def dp_check_grid(res: list, wg_cfg, info: str) -> None:
    """The 2 x 2 grid's four ranks against the one-process TP server and
    the single-device fused vocoder."""
    F, L = wg_cfg.n_flows, wg_cfg.wn_n_layers
    for r, out in enumerate(res):
        if out["backend"] != "gloo" or out["coords"] != [r // 2, r % 2]:
            raise RuntimeError(f"rank {r}: {out['backend']} "
                               f"{out['coords']}")
        for tag, int8 in (("bf16", False), ("int8", True)):
            g = out[tag]
            steps, rel = ((E2E_INT8_MAX_ABS_STEPS, E2E_INT8_REL_L2) if int8
                          else (E2E_MAX_ABS_STEPS, E2E_REL_L2))
            want = ({"wn_layer_partial": F,
                     "wn_layer_partial_int8": F * (L - 1)} if int8 else
                    {"wn_layer_partial": F * L, "wn_layer_partial_int8": 0})
            bad = []
            for ref in ("vs_tp", "vs_fused"):
                e = g[ref]
                print(f"[dp] grid rank {r} (data {r // 2}, model {r % 2}) "
                      f"{tag} {ref}: max_abs {e['max_abs']:.6g} (bound "
                      f"{steps * e['peak']:.4g}), rel_l2 {e['rel_l2']:.4g} "
                      f"(bound {rel})")
                if not e["finite"] or e["max_abs"] > steps * e["peak"] or \
                        e["rel_l2"] > rel:
                    bad.append(ref)
            print(f"[dp] grid rank {r} {tag}: shard {g['ranks']} of "
                  f"{g['n_model']}, launches {g['launches']} (want {want}), "
                  f"wall {g['wall'] * 1e3:.1f} ms ({info})")
            if bad or g["launches"] != want or \
                    g["ranks"] != [r % 2] or g["n_model"] != 2:
                raise RuntimeError(f"grid rank {r} {tag}: {bad or 'counts'}")


def timed_lines(cmd: list, timeout: int) -> tuple:
    """Run ``cmd`` from the repository's root -> (exit code, [(seconds
    since the start, line)] of its merged output, wall seconds); killed
    after ``timeout``."""
    t0 = time.perf_counter()
    pr = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    killer = threading.Timer(timeout, pr.kill)
    killer.start()
    try:
        lines = [(time.perf_counter() - t0, line.rstrip())
                 for line in pr.stdout]
        pr.wait()
    finally:
        killer.cancel()
        if pr.poll() is None:
            pr.kill()
            pr.wait(timeout=30)
    return pr.returncode, lines, time.perf_counter() - t0


def dp_torchrun(files: str, d: str, info: str) -> None:
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    text2speech_tpu_torch.waveglow_train`` for 2 steps at full width (C
    = 512, M = 640; 2 flows of 4 layers, global batch 4), then a resume to
    3: exactly one checkpoint after the first, the second picks it up."""
    cfg_path = os.path.join(d, "dp_wg.json")
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump({"train_config": {"batch_size": 4,
                                    "iters_per_checkpoint": 1000},
                   "waveglow_config": {"n_flows": 2,
                                       "WN_config": {"n_layers": 4}}}, f)
    out = os.path.join(d, "dp_ckpt")
    runs = []
    for steps in (2, 3):
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", "2", "--master_port", str(free_port()),
               "-m", "text2speech_tpu_torch.waveglow_train", "-c", cfg_path,
               "--training_files", files, "--output_directory", out,
               "--num_steps", str(steps)]
        rc, lines, wall = timed_lines(cmd, 300)
        ckpts = sorted(f for f in os.listdir(out) if f.endswith(".pt")) \
            if os.path.isdir(out) else []
        text = "\n".join(line for _, line in lines)
        marks = [f"{t:.1f} s {line[:90]}" for t, line in lines
                 if "distributed: process" in line or "Resumed" in line]
        print(f"[dp] torchrun --nproc_per_node 2 waveglow_train --num_steps "
              f"{steps}: rc {rc}, checkpoints {ckpts}, wall {wall:.2f} s "
              f"({info}); {marks}; last line at "
              f"{lines[-1][0] if lines else 0:.1f} s")
        if rc != 0:
            raise RuntimeError(f"torchrun waveglow_train failed:\n"
                               f"{text[-4000:]}")
        runs.append((ckpts, text))
    (first, t1), (second, t2) = runs
    if first != ["ckpt_00000002.pt"] or \
            second != ["ckpt_00000002.pt", "ckpt_00000003.pt"] or \
            "distributed: process 1/2 (gloo, cuda:0)" not in t1 or \
            "Resumed WaveGlow from step 2" not in t2:
        raise RuntimeError("torchrun waveglow_train: wrong checkpoints or no "
                           "resume")


def dp_path(synth, info: str) -> None:
    """Phase 27: data parallelism on this card.  An NCCL group of one rank
    (bit-equal to ``mesh=None``); two processes over gloo (a WaveGlow and
    a Tacotron step, ``infer_long`` with both fused vocoders) against one
    process; ``torchrun`` of the WaveGlow trainer; a 2 x 2 TP grid.  Gloo
    on one card copies through the host: the walls measure correctness
    only, no rate."""
    from text2speech_tpu_torch.config import HParams, WaveGlowConfig
    from text2speech_tpu_torch.models import chunked
    from text2speech_tpu_torch.models.waveglow_fused import prepare_fused_int8
    from text2speech_tpu_torch.parallel import tp

    cfg, hp, wg_cfg = WaveGlowConfig(), HParams(), synth.wg_cfg
    secs = {}

    def part(tag, fn):
        out, secs[tag] = sync_time(fn)
        return out

    gen = torch.Generator(device="cuda").manual_seed(27)
    mel = torch.randn(1, wg_cfg.n_mel_channels, DP_LONG_FRAMES,
                      generator=gen, device="cuda")
    gpf = wg_cfg.upsample_stride // wg_cfg.n_group
    noise = chunked.draw_noise(wg_cfg, gen, 1, DP_LONG_FRAMES * gpf)
    with tempfile.TemporaryDirectory() as d:
        files = write_corpus(d, cfg)
        wg_params, wg_batch = part("setup", lambda: dp_wg_setup(cfg, files))
        taco_sd, taco_batch = dp_taco_setup(hp)
        part("one-rank NCCL", lambda: dp_one_rank_nccl(
            cfg, wg_params, wg_batch, hp, taco_sd, taco_batch, synth, mel,
            noise))

        def references():
            m, p = dp_wg_step(cfg, wg_params, wg_batch)
            taco = {}
            for ga in (1, 2):
                tm, sd = dp_taco_step(hp, taco_sd, taco_batch, ga)
                taco[ga] = (tm, sd)
            with torch.inference_mode():
                long_ref = {
                    tag: chunked.infer_long(fw, mel, SIGMA, chunk_frames=256,
                                            noise=noise).cpu()
                    for tag, fw in (("bf16", synth.fused),
                                    ("int8", prepare_fused_int8(
                                        synth.waveglow)))}
            return m, p, taco, long_ref

        m, p, taco, long_ref = part("one-process references", references)
        inputs = os.path.join(d, "dp_inputs.pt")
        torch.save({
            "wg_cfg": cfg, "wg_params": wg_params, "wg_batch": wg_batch,
            "wg_ref": {"params": p}, "taco_hp": hp, "taco_sd": taco_sd,
            "taco_batch": taco_batch,
            "taco_ref": {ga: {"sd": sd} for ga, (_, sd) in taco.items()},
            "voc_cfg": wg_cfg, "voc_sd": {k: v.cpu() for k, v in
                                          synth.waveglow.state_dict().items()},
            "long_mel": mel.cpu(), "long_noise": tuple(z.cpu() for z in noise),
            "long_ref": long_ref, "sigma": SIGMA}, inputs)
        res = part("two ranks", lambda: run_ranks("dp2", 2, inputs, d))
        dp_check_two_ranks(
            res, (m["loss"].item(), m["grad_norm"].item()), cfg,
            {ga: (tm["loss"].item(), tm["grad_norm"].item())
             for ga, (tm, _) in taco.items()}, wg_cfg, info)
        part("torchrun", lambda: dp_torchrun(files, d, info))

        g = torch.Generator(device="cuda").manual_seed(28)
        gmel = torch.randn(2, wg_cfg.n_mel_channels, DP_GRID_FRAMES,
                           generator=g, device="cuda")
        gnoise = chunked.draw_noise(wg_cfg, g, 2, DP_GRID_FRAMES * gpf)
        int8_fused = prepare_fused_int8(synth.waveglow)
        with torch.inference_mode():
            grid_ref = {tag: tp.TPWaveGlowServer(synth.waveglow, 2,
                                                 int8=int8)(
                gmel, SIGMA, noise=gnoise).cpu()
                for tag, int8 in (("bf16", False), ("int8", True))}
            grid_fused = {
                "bf16": synth.fused.infer(gmel, SIGMA, noise=gnoise).cpu(),
                "int8": int8_fused.infer(gmel, SIGMA, noise=gnoise).cpu()}
        del int8_fused
        torch.save({"voc_cfg": wg_cfg,
                    "voc_sd": {k: v.cpu() for k, v in
                               synth.waveglow.state_dict().items()},
                    "grid_mel": gmel.cpu(),
                    "grid_noise": tuple(z.cpu() for z in gnoise),
                    "grid_ref": grid_ref, "grid_fused": grid_fused,
                    "sigma": SIGMA}, inputs)
        res = part("2 x 2 grid", lambda: run_ranks("grid", 4, inputs, d))
        dp_check_grid(res, wg_cfg, info)
    torch.cuda.empty_cache()
    print(f"[time] phase 27 parts, seconds: "
          f"{ {k: round(v, 2) for k, v in secs.items()} }; in all "
          f"{sum(secs.values()):.2f} ({info})")


# ---------------------------------------------------------------------------
# phase 28: tensor-parallel decode and full-chain tensor-parallel serving
# ---------------------------------------------------------------------------

TP_DECODE_STEPS = 64
# The f32 tensor-parallel decode against decode_chunk_serve on the same
# masks: each hidden unit's gates are the same contraction, cut into the
# rank's rows of the kernel, so only the library's blocking of the smaller
# products differs; 64 steps of the recurrence carry that on.  The JAX
# package holds its pair to 1e-5 on the CPU (tests/test_tp_tacotron.py);
# on the card: 1e-4 on the mel.
TP_DECODE_F32_ATOL = 1e-4
TP_SERVE_TEXTS = [TEXTS[i % len(TEXTS)] for i in range(6)]
# the two gloo ranks' server run: two chunks a session (each layer's sum
# over the ranks copies through the host, so the run is kept short)
TP_RANKS_STEPS = 2 * STREAM_CHUNK


def kernel_trace(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its GPU kernels (from
    the chrome trace, read as ``profile_torch.py`` reads it), the
    device-busy time (their union) and the wall."""
    from torch.profiler import ProfilerActivity, profile

    from profile_torch import busy_us, kernel_events

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        ks = kernel_events(f"{d}/trace.json")
    return {"kernels": len(ks), "busy_ms": busy_us(ks) / 1e3,
            "wall_ms": wall}


def tp_decode_checks(synth, info: str) -> dict:
    """Phase 28, the decoder: the tensor-parallel decode (p = 2, 4, all
    shards on this card) against ``decode_chunk_serve`` on the same masks,
    the int8 slices' scales against the whole kernels', steps per second
    and kernels per step.  Returns the decode's inputs and the one-process
    p = 2 outputs for the two-process check."""
    from text2speech_tpu_torch.models import tacotron_serve as ts
    from text2speech_tpu_torch.parallel import tp_tacotron as ttp
    from text2speech_tpu_torch.text import encode_batch

    taco, hp = synth.taco, synth.hp
    dp = ts.extract_decoder_params(taco)
    B, steps = len(TEXTS), TP_DECODE_STEPS
    ids, lengths = encode_batch(TEXTS)
    lengths = torch.from_numpy(lengths).cuda()
    with torch.inference_mode():
        memory = taco.encode(torch.from_numpy(ids).long().cuda(),
                             text_lengths=lengths)
        pmem = taco.process_memory(memory)
    masks = taco.decoder.draw_keep_masks(
        steps, B, torch.Generator(device="cuda").manual_seed(28), "cuda")

    whole = {wk: ts.quantize_kernel_int8(dp[wk]) for wk, _, _ in
             ttp._LSTM_KEYS}
    for p in (2, 4):
        q = ttp.shard_decoder_params(dp, hp, p, int8=True)
        same = all(
            torch.equal(q[wk]["s"][i], whole[wk]["s"][rows])
            and torch.equal(q[wk]["q"][i], whole[wk]["q"][rows])
            for wk, _, dim in ttp._LSTM_KEYS for i in range(p)
            for rows in [torch.from_numpy(ttp._gate_cols(
                getattr(hp, dim), p, i)).cuda()])
        print(f"[tpdec] p={p}: int8 slices' payloads and scales equal to the "
              f"rows of the whole kernels' (torch.equal): {same}")
        if not same:
            raise RuntimeError("int8 slices differ from the whole kernels'")
    del whole

    types = {"f32": torch.float32, "bf16": torch.bfloat16}

    def run(dec, dt):
        def call():
            with torch.inference_mode():
                if dec is None:
                    return ts.decode_chunk_serve(
                        dp, hp, memory, pmem,
                        *taco.decoder.initial_carry(memory), masks, lengths,
                        dtype=dt)
                return dec(memory, pmem, *dec.initial_carry(memory), masks,
                           lengths)
        return call

    runs = {}
    for name, dt in types.items():
        runs[f"serve {name}"] = run(None, dt)
        for p in (2, 4):
            runs[f"p={p} {name}"] = run(
                ttp.TPTacotronDecoder(taco, hp, n_model=p, dtype=dt), dt)
    out = {k: fn() for k, fn in runs.items()}         # also the warm-up
    (st_r, _, fin_r), mel_r, gate_r, align_r, act_r = out["serve f32"]
    for p in (2, 4):
        for name in types:
            (st, _, fin), mel, gate, align, act = out[f"p={p} {name}"]
            errs = {"mel": (mel - mel_r).abs().max().item(),
                    "gate": (gate - gate_r).abs().max().item(),
                    "align": (align - align_r).abs().max().item(),
                    "carry": max((a.float() - b).abs().max().item()
                                 for a, b in zip(st, st_r))}
            same_flags = torch.equal(act, act_r) and torch.equal(fin, fin_r)
            line = (f"[tpdec] p={p} {name}, batch {B} x {steps} steps, "
                    f"against decode_chunk_serve f32: max |diff| "
                    f"{ {k: float(f'{v:.4g}') for k, v in errs.items()} }, "
                    f"mel rel_l2 {rel_l2(mel, mel_r):.4g}; active and "
                    f"finished equal: {same_flags}")
            if name == "bf16":
                mel_b = out["serve bf16"][1]
                line += (f"; against decode_chunk_serve bf16: mel max |diff| "
                         f"{(mel - mel_b).abs().max().item():.4g}, rel_l2 "
                         f"{rel_l2(mel, mel_b):.4g}")
            print(line)
            if name == "f32" and (errs["mel"] > TP_DECODE_F32_ATOL
                                  or not same_flags):
                raise RuntimeError(f"f32 TP decode p={p} differs from "
                                   f"decode_chunk_serve (bound "
                                   f"{TP_DECODE_F32_ATOL} on the mel)")
            if not torch.isfinite(mel).all():
                raise RuntimeError(f"TP decode p={p} {name}: non-finite mel")

    times = {k: [] for k in runs}
    for _ in range(2):
        for k, fn in runs.items():
            times[k].append(steps / sync_time(fn)[1])
    traces = {k: kernel_trace(fn) for k, fn in runs.items()}
    rates = {k: round(max(v), 1) for k, v in times.items()}
    per_step = {k: round(t["kernels"] / steps, 2) for k, t in traces.items()}
    idle = {k: round(1 - t["busy_ms"] / t["wall_ms"], 3)
            for k, t in traces.items()}
    print(f"[tpdec] batch {B}, {steps} steps, all shards on one card: "
          f"steps/s (best of two) {rates}; kernels per step {per_step}; "
          f"device idle share under the profiler {idle} ({info})")
    ref2 = {name: out[f"p=2 {name}"] for name in types}
    return {"decode_in": (memory, pmem, masks, lengths), "decode_ref": ref2}


def tp_serve_path(info: str) -> dict:
    """Phase 28: tensor-parallel decode and full-chain tensor-parallel
    serving at full width on seeded random weights (the gate biased shut):
    the decoder's checks, ``TPSynthesizer(n_model=2)`` in bf16 and int8
    against the fused ``Synthesizer`` on the same masks and noise, the
    streaming path with the denoiser, the partial kernels' launches per
    vocode, ``make_server_tp`` against ``make_server``, and two processes
    on this card over gloo against the one-process objects."""
    from text2speech_tpu_torch.config import HParams, WaveGlowConfig
    from text2speech_tpu_torch.infer import Synthesizer, random_synthesizer
    from text2speech_tpu_torch.models.denoiser import make_denoiser
    from text2speech_tpu_torch.parallel import tp
    from text2speech_tpu_torch.parallel.serve import TPSynthesizer
    from text2speech_tpu_torch.server import make_server, make_server_tp

    secs = {}

    def part(tag, fn):
        out, secs[tag] = sync_time(fn)
        return out

    synth = random_synthesizer(HParams(), WaveGlowConfig(), seed=28,
                               device="cuda", use_fused_vocoder=True)
    hp, cfg = synth.hp, synth.wg_cfg
    F, L = cfg.n_flows, cfg.wn_n_layers
    gpf = cfg.upsample_stride // cfg.n_group
    dec = part("decoder", lambda: tp_decode_checks(synth, info))
    int8_synth = Synthesizer(hp, synth.taco, cfg, synth.waveglow,
                             int8_vocoder=True)
    tps = {"bf16": TPSynthesizer(hp, synth.taco, cfg, synth.waveglow,
                                 n_model=2, chunk_steps=STREAM_CHUNK),
           "int8": TPSynthesizer(hp, synth.taco, cfg, synth.waveglow,
                                 n_model=2, chunk_steps=STREAM_CHUNK,
                                 int8=True)}
    if tps["bf16"].compute_dtype != torch.bfloat16:
        raise RuntimeError("TPSynthesizer's default type on the card is not "
                           "bf16")
    singles = {"bf16": synth, "int8": int8_synth}
    B = len(TEXTS)
    limit = -(-MAX_STEPS // STREAM_CHUNK) * STREAM_CHUNK
    g = torch.Generator(device="cuda").manual_seed(5)
    masks = synth.taco.decoder.draw_keep_masks(limit, B, g, "cuda")
    noise = tuple(torch.randn(sh, generator=g, device="cuda")
                  for sh in synth.fused.noise_shapes(B, MAX_STEPS * gpf))

    def offline(tag):
        t, s1 = tps[tag], singles[tag]
        mel_t, len_t = t.text_to_mel(TEXTS, seed=5, max_steps=MAX_STEPS,
                                     keep_masks=masks)
        mel_s, len_s = s1.text_to_mel(TEXTS, seed=5, max_steps=MAX_STEPS,
                                      keep_masks=masks[:MAX_STEPS])
        wav_t, t_tp = sync_time(lambda: t.synthesize(
            TEXTS, SIGMA, seed=5, max_steps=MAX_STEPS, keep_masks=masks,
            noise=noise))
        wav_s, t_single = sync_time(lambda: s1.synthesize(
            TEXTS, SIGMA, seed=5, max_steps=MAX_STEPS,
            keep_masks=masks[:MAX_STEPS], noise=noise))
        a, b = (torch.from_numpy(np.concatenate(w)) for w in (wav_t, wav_s))
        # the TP vocoder alone on the single path's mel: phase 18's pair
        mel_cut = mel_s[:, :, :MAX_STEPS].contiguous()
        voc = t.mel_to_audio(mel_cut, SIGMA, noise=noise)
        with torch.inference_mode():
            voc_s = s1.mel_to_audio(mel_cut, SIGMA, noise=noise)
        tp.reset_launch_counts()
        reset_counts()
        t.mel_to_audio(mel_cut, SIGMA, noise=noise)
        counts, other = tp.launch_counts(), all_counts()
        want = ({"wn_layer_partial": F * 2,
                 "wn_layer_partial_int8": F * (L - 1) * 2}
                if tag == "int8" else
                {"wn_layer_partial": F * L * 2, "wn_layer_partial_int8": 0})
        r_voc, r_all = rel_l2(voc, voc_s), rel_l2(a, b)
        print(f"[tpserve] {tag}: TPSynthesizer(n_model=2).synthesize of "
              f"{B} texts x {MAX_STEPS} frames in {t_tp:.3f} s (fused "
              f"Synthesizer {t_single:.3f} s); lengths {len_t.tolist()} vs "
              f"{len_s.tolist()}; mel (bf16 TP decode vs f32 decode) max "
              f"|diff| {(mel_t - mel_s).abs().max().item():.4g} rel_l2 "
              f"{rel_l2(mel_t, mel_s):.4g}; audio rel_l2 vs the fused "
              f"Synthesizer {r_all:.4g}; the TP vocoder alone on the same "
              f"mel rel_l2 {r_voc:.4g} (phase 18's TP-vs-fused pair, bound "
              f"{E2E_INT8_REL_L2 if tag == 'int8' else E2E_REL_L2}); "
              f"launches per vocode {counts}, other wrappers "
              f"{sum(other.values())} ({info})")
        if counts != want or any(other.values()):
            raise RuntimeError(f"TP serving {tag}: launches {counts} (+ "
                               f"{other}), want {want}")
        if not torch.equal(len_t.cpu(), len_s.cpu()) or not all(
                np.isfinite(w).all() for w in wav_t):
            raise RuntimeError(f"TP serving {tag}: lengths or audio wrong")
        if r_voc > (E2E_INT8_REL_L2 if tag == "int8" else E2E_REL_L2):
            raise RuntimeError(f"TP serving {tag}: vocoder off the fused "
                               f"path")
        # the whole chain: the bf16 decode moves the mel by a few 1e-3
        # relative L2 (the f32 TP decode is checked above), which the
        # vocoder path's own bounds take in
        for i, (wt, ws) in enumerate(zip(wav_t, wav_s)):
            check_stream_audio(f"tp {tag} synthesize row {i} vs the fused "
                               f"Synthesizer", wt, torch.from_numpy(ws),
                               tag == "int8")
        return counts

    launches = {}
    for tag in ("bf16", "int8"):
        launches[tag] = part(f"synthesize {tag}", lambda: offline(tag))

    def incremental(tag):
        t = tps[tag]
        kw = dict(sigma=SIGMA, seed=7, max_steps=MAX_STEPS)
        raw, t_raw = sync_time(lambda: np.concatenate(list(
            t.synthesize_incremental(TEXTS[0], **kw))))
        den = np.concatenate(list(t.synthesize_incremental(
            TEXTS[0], denoiser_strength=DENOISER_STRENGTH, **kw)))
        _, denoise = make_denoiser(synth.waveglow)
        with torch.inference_mode():
            ref = denoise(torch.from_numpy(raw[None]).cuda(),
                          DENOISER_STRENGTH)[0]
        print(f"[tpserve] {tag}: synthesize_incremental of {MAX_STEPS} "
              f"frames in {t_raw:.3f} s; the denoised stream against the "
              f"offline denoiser over the raw stream:")
        check_stream_audio(f"tp {tag} denoised stream", den, ref,
                           tag == "int8")

    for tag in ("bf16", "int8"):
        part(f"stream {tag}", lambda: incremental(tag))

    def serve():
        requests = [dict(request=t, seed=10 + i, sigma=SERVE_SIGMAS[i])
                    for i, t in enumerate(TP_SERVE_TEXTS)]
        kw = dict(slots=SERVE_SLOTS, chunk_steps=STREAM_CHUNK,
                  max_steps=SERVE_STEPS, retain_sessions=True)
        res = {}
        for name, srv in (("make_server", make_server(synth, **kw)),
                          ("make_server_tp", make_server_tp(tps["bf16"],
                                                            **kw))):
            srv.warm_window_widths()
            tp.reset_launch_counts()
            wavs, first, wall = drive(srv, [(0, requests)])
            seconds = sum(len(w) for w in wavs.values()) / cfg.sampling_rate
            res[name] = wavs
            print(f"[tpserve] {name}: {len(requests)} sessions x "
                  f"{SERVE_STEPS} steps through {SERVE_SLOTS} slots in "
                  f"{srv.stats['rounds']} rounds, {wall:.3f} s: "
                  f"{seconds / wall:.3f} audio seconds per wall second; "
                  f"first audio after "
                  f"{ {k: round(v, 3) for k, v in sorted(first.items())} } "
                  f"s; partial launches {tp.launch_counts()} ({info})")
        if sorted(res["make_server_tp"]) != sorted(res["make_server"]):
            raise RuntimeError("make_server_tp completed other sessions")
        for sid, w in res["make_server"].items():
            check_stream_audio(f"tp make_server_tp session {sid} vs "
                               f"make_server", res["make_server_tp"][sid],
                               torch.from_numpy(w), False)

    part("server", serve)

    def two_ranks():
        texts, seeds = TEXTS, [21, 22, 23]
        one = TPSynthesizer(hp, synth.taco, cfg, synth.waveglow, n_model=2,
                            chunk_steps=STREAM_CHUNK)
        srv = make_server_tp(one, slots=2, chunk_steps=STREAM_CHUNK,
                             max_steps=TP_RANKS_STEPS)
        ref = srv.run(texts, seeds=seeds)
        with tempfile.TemporaryDirectory() as d:
            inputs = os.path.join(d, "tp_inputs.pt")
            torch.save({
                "hp": hp, "wg_cfg": cfg,
                "taco_sd": {k: v.cpu() for k, v in
                            synth.taco.state_dict().items()},
                "wg_sd": {k: v.cpu() for k, v in
                          synth.waveglow.state_dict().items()},
                "decode_in": tuple(t.cpu() for t in dec["decode_in"]),
                "decode_ref": {k: ((tuple(t.cpu() for t in st), fr.cpu(),
                                    fin.cpu()), *(t.cpu() for t in rest))
                               for k, ((st, fr, fin), *rest)
                               in dec["decode_ref"].items()},
                "chunk": STREAM_CHUNK, "steps": TP_RANKS_STEPS,
                "texts": texts,
                "seeds": seeds, "server_ref": ref}, inputs)
            res = run_ranks("tp2", 2, inputs, d)
        for r in res:
            print(f"[tpserve] gloo rank {r['rank']} of 2 ({r['backend']}, "
                  f"{r['device']}): decode f32 bit-equal "
                  f"{r['decode_f32']['equal']} ({r['decode_f32']['wall']:.3f}"
                  f" s), bf16 bit-equal {r['decode_bf16']['equal']}; "
                  f"make_server_tp of {len(texts)} texts bit-equal "
                  f"{r['server']['equal']} in {r['server']['rounds']} rounds,"
                  f" {r['server']['wall']:.3f} s, launches "
                  f"{r['server']['launches']}")
            if not (r["decode_f32"]["equal"] and r["decode_bf16"]["equal"]
                    and r["server"]["equal"]):
                raise RuntimeError("two gloo ranks differ from the "
                                   "one-process two-shard run")

    part("two ranks", two_ranks)
    del tps, int8_synth, synth
    torch.cuda.empty_cache()
    print(f"[time] phase 28 parts, seconds: "
          f"{ {k: round(v, 2) for k, v in secs.items()} }; in all "
          f"{sum(secs.values()):.2f} ({info})")
    return launches


# ---------------------------------------------------------------------------
# phase 29: reference checkpoints into the port, the profiling tools, the
# worked example
# ---------------------------------------------------------------------------

CONVERT_SEED = 29
# the demo's own run of two training steps a model, in a process of its own
DEMO_STEPS = 2


def run_cli_module(module: str, args: list, timeout: int = 600) -> tuple:
    """``python -m <module> args`` in a process of its own -> (stdout,
    seconds); raises on a nonzero exit."""
    cmd = [sys.executable, "-m", module, *map(str, args)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    print(f"[convert] python -m {module} {' '.join(map(str, args))} -> rc "
          f"{r.returncode} in {secs:.2f} s:")
    print("    " + r.stdout.strip().replace("\n", "\n    "))
    if r.returncode != 0:
        raise RuntimeError(f"{module} failed:\n{r.stderr[-4000:]}")
    return r.stdout, secs


# the demo's tensor-parallel vocoder (examples/demo.py): C = 128 channels
# cut into p = 2 shares of 64 columns, n_half 4 in both flows, M = 80 mels
# x 8 groups, L = 2 (layer 0 the first form at d 1; layer 1 the last, its
# res/skip product C wide, at d 2), every row valid; 32 groups a mel frame,
# from one frame to the demo decoder's 40, and a batch of two
DEMO_C, DEMO_M, DEMO_P, DEMO_N_HALF = 128, 640, 2, 4
DEMO_SHAPES = ((1, 32), (1, 1280), (2, 416))


def check_demo_partials() -> float:
    """Row 4 at the demo's widths, which no other phase reaches (phase 17
    runs C = 512): every rank's ``PART_FIRST`` (layer 0) and ``PART``
    (layer 1) launch against its plain version on the same inputs, within
    phase 17's bound, and the ranks' sum + bias against the whole layer's
    plain res/skip term.  Returns the largest error against a plain
    version."""
    from text2speech_tpu_torch.ops import wn_block as wb

    dev = torch.device("cuda")
    C, M, p = DEMO_C, DEMO_M, DEMO_P
    worst, seed = 0.0, 2900
    for B, T in DEMO_SHAPES:
        for li in (0, 1):
            seed += 1
            if li == 0:
                k = layer_inputs(B, T, T, C, M, seed, dev, n_half=DEMO_N_HALF)
            else:                         # the last layer: rs_out = C
                k = layer_inputs(B, T, T, C, M, seed, dev)
                k["w_rs"] = k["w_rs"][:, :C].contiguous()
                k["b_rs"] = k["b_rs"][:C].contiguous()
            tag = f"demo widths C={C} p={p} layer {li} B={B} T={T}"
            total = None
            for i in range(p):
                w_in, b_in, w_c, b_c, w_rs = rank_share(k, p, i, False)
                if li == 0:
                    wp, b_all, b_edge = wb.fold_first_taps(
                        k["start_k"], k["start_b"], w_in, b_in)
                    args = (k["x0"], k["spect"], wp, b_all, w_c, b_c, w_rs, 1)
                    kw = {"b_edge": b_edge}
                else:
                    args = (k["x"], k["spect"], w_in, b_in, w_c, b_c, w_rs, 2)
                    kw = {}
                n0 = wb.wn_layer_partial.launches
                got = wb.wn_layer_partial(*args, n_valid=T, **kw)
                if wb.wn_layer_partial.launches != n0 + 1:
                    raise RuntimeError(f"{tag} rank {i}: "
                                       f"{wb.wn_layer_partial.launches - n0}"
                                       f" launches counted, want 1")
                want = wb.wn_layer_partial_plain(*args, n_valid=T, **kw)
                worst = max(worst, compare(f"wn_layer_partial {tag} rank {i}",
                                           got, want))
                total = got if total is None else total + got
            if li == 0:
                wp, b_all, b_edge = wb.fold_first_taps(
                    k["start_k"], k["start_b"], k["w_in"], k["b_in"])
                in_act = wb._edge_bias_suppress(
                    wb._taps(k["x0"], wp, 1, T) + b_all
                    + wb._cond(k["spect"], k["w_cond"], k["b_cond"]),
                    b_edge, 1, T)
            else:
                in_act = (wb._taps(k["x"], k["w_in"], 2, T) + k["b_in"]
                          + wb._cond(k["spect"], k["w_cond"], k["b_cond"]))
            rs = (wb._gate(in_act, torch.bfloat16).float() @ k["w_rs"].float()
                  + k["b_rs"])
            compare(f"sum of {p} partials + bias vs the whole layer {tag}",
                    total + k["b_rs"], rs)
    return worst


def convert_path(info: str) -> dict:
    """Phase 29: a user's route from reference checkpoints to a WAV, at full
    width on seeded weights.  Reference-format state dicts (a Tacotron at
    ``HParams()`` in the ``train.py:72`` format, a WaveGlow at
    ``WaveGlowConfig()`` with its early outputs as a bare state dict, and
    the same WaveGlow in the pre-fusion layout) go through ``python -m
    text2speech_tpu_torch.convert_checkpoint`` (processes of their own;
    the two WaveGlow conversions equal bit for bit; the printed counts
    equal the state dicts'), then ``python -m
    text2speech_tpu_torch.inference --fused_vocoder`` writes a WAV of
    frames x hop samples.  In this process ``load_torch_checkpoint`` and
    the module conveniences build a fused ``Synthesizer``, whose one
    vocode launches rows 1-3 12 / 72 / 12 times and no other WN-layer
    kernel, held to the f32 ``WaveGlow.infer`` on the same mel and noise
    (phase 4's bound) and its mel bit for bit to a ``Synthesizer`` of the
    converted checkpoint directories; that vocode again under
    ``trace_capture`` / ``annotate`` / ``StepTimer``; then the demo
    (``python -m text2speech_tpu_torch.examples.demo``) in a process of
    its own, after row 4 is held to its plain version at the demo's widths
    (:func:`check_demo_partials`).  Returns the launches of each kernel on
    the convert path and in the demo, and the largest error of row 4
    against its plain version at the demo's widths."""
    from scipy.io import wavfile

    from text2speech_tpu_torch.config import HParams, WaveGlowConfig
    from text2speech_tpu_torch.convert import (load_torch_checkpoint,
                                               tacotron_module_from_torch,
                                               waveglow_module_from_torch)
    from text2speech_tpu_torch.examples.reference_checkpoints import (
        pre_fusion_layout, reference_tacotron_state_dict,
        reference_waveglow_state_dict)
    from text2speech_tpu_torch.infer import Synthesizer, load_synthesizer
    from text2speech_tpu_torch.ops import wn_block_padded as wp
    from text2speech_tpu_torch.parallel import tp
    from text2speech_tpu_torch.utils.profiling import (StepTimer, annotate,
                                                       trace_capture)

    hp, cfg = HParams(), WaveGlowConfig()
    hop = cfg.upsample_stride
    secs = {}

    def part(tag, fn):
        out, secs[tag] = sync_time(fn)
        return out

    def counts():
        return {**all_counts(), **tp.launch_counts(), **wp.launch_counts()}

    def reset():          # every count counts() reads (the ladder's too)
        reset_counts()
        wp.reset_launch_counts()

    with tempfile.TemporaryDirectory() as d:
        def write_state_dicts():
            taco_sd = reference_tacotron_state_dict(hp, CONVERT_SEED)
            torch.save({"iteration": 0, "state_dict": taco_sd,
                        "learning_rate": hp.learning_rate}, f"{d}/taco.pt")
            wg_sd = reference_waveglow_state_dict(cfg, CONVERT_SEED)
            torch.save(wg_sd, f"{d}/wg.pt")
            torch.save(pre_fusion_layout(wg_sd, cfg), f"{d}/wg_old.pt")
            stats = ("running_mean", "running_var", "num_batches_tracked")
            return ({"taco": sum(t.numel() for k, t in taco_sd.items()
                                 if not k.endswith(stats)),
                     "wg": sum(t.numel() for t in wg_sd.values())})

        want_n = part("state dicts", write_state_dicts)
        print(f"[convert] reference state dicts at full width "
              f"(Tacotron at HParams(), WaveGlow at C={cfg.wn_n_channels}, "
              f"L={cfg.wn_n_layers}, {cfg.n_flows} flows with early "
              f"outputs, fused and pre-fusion): parameters {want_n}")

        def convert_all():
            """The three conversions, one process each, side by side."""
            jobs = (("tacotron", "taco.pt", "taco_ckpt"),
                    ("waveglow", "wg.pt", "wg_ckpt"),
                    ("waveglow", "wg_old.pt", "wg_old_ckpt"))
            with ThreadPoolExecutor(len(jobs)) as pool:
                runs = [pool.submit(
                    run_cli_module, "text2speech_tpu_torch.convert_checkpoint",
                    ["--kind", kind, "--torch_ckpt", f"{d}/{src}",
                     "--out_dir", f"{d}/{out}"]) for kind, src, out in jobs]
                results = [r.result() for r in runs]
            walls = {}
            for (kind, src, _), (stdout, walls[src]) in zip(jobs, results):
                n = int(re.search(r"\(([\d,]+) params\)", stdout)[1]
                        .replace(",", ""))
                want = want_n["taco" if kind == "tacotron" else "wg"]
                if n != want:
                    raise RuntimeError(f"convert_checkpoint counted {n} "
                                       f"parameters of {src}, the state "
                                       f"dict holds {want}")
            return walls

        walls = part("convert CLI", convert_all)
        fused = torch.load(f"{d}/wg_ckpt/ckpt_00000000.pt",
                           map_location="cpu", weights_only=True)["params"]
        old = torch.load(f"{d}/wg_old_ckpt/ckpt_00000000.pt",
                         map_location="cpu", weights_only=True)["params"]
        if set(fused) != set(old) or not all(
                torch.equal(fused[k], old[k]) for k in fused):
            raise RuntimeError("the pre-fusion WaveGlow converts to other "
                               "tensors than the fused one")
        print(f"[convert] convert_checkpoint walls, side by side (s, {info}): "
              f"{ {k: round(v, 2) for k, v in walls.items()} }; the fused "
              f"and pre-fusion WaveGlow give the same {len(fused)} tensors, "
              f"bit for bit")
        del fused, old

        def cli_inference():
            out = f"{d}/converted.wav"
            run_cli_module("text2speech_tpu_torch.inference", [
                "--taco_checkpoint", f"{d}/taco_ckpt",
                "--waveglow_checkpoint", f"{d}/wg_ckpt", "--fused_vocoder",
                "--max_steps", MAX_STEPS, "--text", TEXTS[0], "--out", out])
            sr, data = wavfile.read(out)
            if data.dtype != np.int16 or sr != cfg.sampling_rate or \
                    data.shape != (MAX_STEPS * hop,):
                raise RuntimeError(f"inference wrote {data.shape} {data.dtype}"
                                   f" at {sr} Hz, want {MAX_STEPS * hop} "
                                   f"PCM16 samples at {cfg.sampling_rate}")

        part("inference CLI", cli_inference)

        def in_process():
            taco_sd = load_torch_checkpoint(f"{d}/taco.pt")
            wg_sd = load_torch_checkpoint(f"{d}/wg.pt")
            synth = Synthesizer(
                hp, tacotron_module_from_torch(taco_sd, hp, device="cuda"),
                cfg, waveglow_module_from_torch(wg_sd, cfg, device="cuda"),
                use_denoiser=False, use_fused_vocoder=True)
            mel, lens = synth.text_to_mel(TEXTS, seed=0, max_steps=MAX_STEPS)
            from_dirs = load_synthesizer(
                hp, None, cfg, use_denoiser=False,
                device="cuda", taco_ckpt_dir=f"{d}/taco_ckpt",
                wg_ckpt_dir=f"{d}/wg_ckpt")
            mel2, lens2 = from_dirs.text_to_mel(TEXTS, seed=0,
                                                max_steps=MAX_STEPS)
            if not (torch.equal(mel, mel2) and torch.equal(lens, lens2)):
                raise RuntimeError("the converted modules' mel differs from "
                                   "the converted checkpoints'")
            del from_dirs
            gen = torch.Generator(device="cuda").manual_seed(CONVERT_SEED)
            Tg = mel.shape[-1] * hop // cfg.n_group
            noise = tuple(torch.randn(s, generator=gen, device="cuda")
                          for s in synth.fused.noise_shapes(len(TEXTS), Tg))
            reset()
            with torch.inference_mode():
                got = synth.fused.infer(mel, SIGMA, noise=noise)
            launches = counts()
            with torch.inference_mode():
                exact = synth.waveglow.infer(mel, SIGMA, noise=noise)
            want = {n: 0 for n in launches}
            want.update(wn_layer_first=cfg.n_flows,
                        wn_layer=cfg.n_flows * (cfg.wn_n_layers - 2),
                        wn_layer_final=cfg.n_flows)
            print(f"[convert] one fused vocode of the converted WaveGlow "
                  f"(batch {len(TEXTS)} x {mel.shape[-1]} frames): launches "
                  f"{ {n: c for n, c in launches.items() if c} }")
            if launches != want:
                raise RuntimeError(f"launches {launches}, want {want}")
            err = (got - exact).abs().max().item()
            peak = exact.abs().max().item()
            rel = ((got - exact).norm() / exact.norm()).item()
            print(f"[convert] fused vs f32 WaveGlow.infer on the same mel "
                  f"and noise: max_abs_err={err:.6g} (bound "
                  f"{E2E_MAX_ABS_STEPS * peak:.4g}) rel_l2={rel:.4g} (bound "
                  f"{E2E_REL_L2}); mel bit-equal to the checkpoint "
                  f"directories' Synthesizer, lengths {lens.tolist()}")
            if not torch.isfinite(got).all() or \
                    err > E2E_MAX_ABS_STEPS * peak or rel > E2E_REL_L2:
                raise RuntimeError("the converted weights' fused vocode "
                                   "disagrees with the f32 module's")
            return synth, mel, noise, launches

        synth, mel, noise, launches = part("in process", in_process)

        def traced():
            timer = StepTimer()
            with trace_capture(f"{d}/trace") as path:
                with timer.step() as t, annotate("vocode"), \
                        torch.inference_mode():
                    t.block_on(synth.fused.infer(mel, SIGMA, noise=noise))
            with open(path) as f:
                text = f.read()
            n_kernel = text.count("wn_sm90_kernel")
            n_region = text.count('"vocode"')
            print(f"[convert] trace_capture: {os.path.basename(path)} "
                  f"({len(text)} bytes) names wn_sm90_kernel {n_kernel} "
                  f"times and the vocode region {n_region} times; "
                  f"StepTimer host {timer.last_host * 1e3:.3f} ms, device "
                  f"{timer.last_device * 1e3:.3f} ms")
            if not n_kernel or not n_region:
                raise RuntimeError("the trace names no wn_sm90_kernel launch "
                                   "or no vocode region")
            if not timer.last_device >= timer.last_host > 0:
                raise RuntimeError("StepTimer: device time below host time")

        part("trace", traced)

        def traced_synthesis():
            with trace_capture(f"{d}/trace") as path:
                synth.synthesize(TEXTS, seed=0, max_steps=MAX_STEPS)
            with open(path) as f:
                text = f.read()
            found = {n: text.count(f'"{n}"')
                     for n in ("taco.decoder", "wg.flows")}
            print(f"[convert] trace_capture of one synthesize: "
                  f"{os.path.basename(path)} names the program's spans "
                  f"{found}")
            if not all(found.values()):
                raise RuntimeError(f"the synthesize trace lacks a program "
                                   f"span: {found}")

        part("trace of synthesize", traced_synthesis)
        del synth, mel, noise
        torch.cuda.empty_cache()
        partial_err = part("demo-width partials", check_demo_partials)

        def demo():
            stdout, wall = run_cli_module(
                "text2speech_tpu_torch.examples.demo",
                ["--workdir", f"{d}/demo", "--steps", DEMO_STEPS])
            for name in ("out.wav", "out_tp.wav"):
                sr, data = wavfile.read(f"{d}/demo/{name}")
                if data.dtype != np.int16 or data.size == 0:
                    raise RuntimeError(f"the demo's {name} is not PCM16 audio")
            demo_launches = json.loads(stdout.strip().splitlines()[-1]
                                       .removeprefix("launches "))
            print(f"[demo] {DEMO_STEPS} training steps a model, wall "
                  f"{wall:.2f} s ({info}); launches "
                  f"{ {n: c for n, c in demo_launches.items() if c} }")
            return demo_launches

        demo_launches = part("demo", demo)
    print(f"[time] phase 29 parts, seconds: "
          f"{ {k: round(v, 2) for k, v in secs.items()} }; in all "
          f"{sum(secs.values()):.2f} ({info})")
    return {"convert": launches, "demo": demo_launches}, partial_err


# ---------------------------------------------------------------------------
# phase 30: what the program's spans cost when a recorder listens
# ---------------------------------------------------------------------------

COST_BATCH, COST_STEPS, COST_SETS, COST_BATCHES = 32, 320, 2, 6
COST_SPANS = 100_000
COST_SEED = 30


def recorder_cost(info: str) -> dict:
    """Phase 30: ``Synthesizer.synthesize`` at the offline benchmark's
    shapes with and without ``recording()``: ``COST_SETS`` sets of
    ``COST_BATCHES`` batches with the same seeds, each batch run both
    ways in turns (the order swapped every batch); the audio of the two
    runs of a batch is bit for bit the same.  The batches' walls spread
    more than a few spans cost, so one span's cost is also timed alone
    (``COST_SPANS`` empty spans).  Returns each set's median walls and
    their ratio."""
    from text2speech_tpu_torch.config import HParams, WaveGlowConfig
    from text2speech_tpu_torch.infer import random_synthesizer
    from text2speech_tpu_torch.utils.profiling import annotate, recording

    synth = random_synthesizer(HParams(), WaveGlowConfig(), seed=COST_SEED,
                               device="cuda")
    texts = [TEXTS[i % len(TEXTS)] for i in range(COST_BATCH)]

    def run(seed, on):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if on:
            with recording() as rec:
                out = synth.synthesize(texts, seed=seed,
                                       denoiser_strength=DENOISER_STRENGTH,
                                       max_steps=COST_STEPS)
        else:
            rec = None
            out = synth.synthesize(texts, seed=seed,
                                   denoiser_strength=DENOISER_STRENGTH,
                                   max_steps=COST_STEPS)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, rec

    run(COST_SEED, False)                       # builds and warms
    sets = []
    for k in range(COST_SETS):
        walls = {"off": [], "on": []}
        for i in range(COST_BATCHES):
            seed = COST_SEED + 1 + i
            outs = {}
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                outs[on], wall, rec = run(seed, on)
                walls["on" if on else "off"].append(wall)
                if rec is not None:
                    n_spans = len(rec.spans)
                    n_counts = sum(len(v) for v in rec.counters.values())
            if not all(np.array_equal(a, b)
                       for a, b in zip(outs[False], outs[True])):
                raise RuntimeError(f"batch {i}: the audio differs with a "
                                   f"recorder installed")
        med = {w: float(np.median(v)) for w, v in walls.items()}
        sets.append({**med, "ratio": med["on"] / med["off"],
                     "walls": walls})
        print(f"[trace] recorder cost, set {k} ({COST_BATCHES} batches of "
              f"{COST_BATCH} x {COST_STEPS} frames, seeds "
              f"{COST_SEED + 1}-{COST_SEED + COST_BATCHES}; {info}): walls "
              f"off {[round(w * 1e3, 2) for w in walls['off']]} ms, on "
              f"{[round(w * 1e3, 2) for w in walls['on']]} ms; medians off "
              f"{med['off'] * 1e3:.2f} ms, on {med['on'] * 1e3:.2f} ms, "
              f"on / off {med['on'] / med['off']:.4f}; a batch records "
              f"{n_spans} spans and {n_counts} counter values")
    del synth
    torch.cuda.empty_cache()

    def per_span() -> float:
        t0 = time.perf_counter()
        for _ in range(COST_SPANS):
            with annotate("synth.text"):
                pass
        return (time.perf_counter() - t0) / COST_SPANS

    off_s = per_span()
    with recording():
        on_s = per_span()
    wall = min(st["on"] for st in sets)
    print(f"[trace] one span: {off_s * 1e6:.3f} us without a recorder, "
          f"{on_s * 1e6:.3f} us with one; {n_spans} spans and {n_counts} "
          f"counter values a batch cost {n_spans * on_s * 1e6:.1f} us, "
          f"{100 * n_spans * on_s / wall:.5f}% of the batch's "
          f"{wall * 1e3:.1f} ms")
    return sets


# ---------------------------------------------------------------------------
# phase 31: the text-to-mel layer's loops replayed from CUDA graphs
# ---------------------------------------------------------------------------

GRAPH_BATCHES, GRAPH_SEED = 6, 31
GRAPH_SERVE_SEED, GRAPH_SERVE_S = 7400000004, 50.0


@contextlib.contextmanager
def graphs_off():
    """The eager loops, for comparison: ``cuda_graphs.usable`` says no."""
    from text2speech_tpu_torch.utils import cuda_graphs

    usable = cuda_graphs.usable
    cuda_graphs.usable = lambda *tensors: False
    try:
        yield
    finally:
        cuda_graphs.usable = usable


def graph_counts(rec) -> dict:
    return {name: sum(v for _, v in rec.counters.get(name, []))
            for name in ("taco.graph_captures", "taco.graph_replays")}


def graph_replay(info: str) -> dict:
    """Phase 31 (module docstring).  Returns the medians and the serve
    runs' records."""
    from perfbench import inputs
    from perfbench.traffic import serve_open
    from perfbench.trace import Observation
    from text2speech_tpu_torch.config import HParams, WaveGlowConfig
    from text2speech_tpu_torch.infer import random_synthesizer
    from text2speech_tpu_torch.models.tacotron2 import MASK_BLOCK
    from text2speech_tpu_torch.server import make_server
    from text2speech_tpu_torch.text import encode_batch
    from text2speech_tpu_torch.utils.profiling import recording

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "perfbench", "workloads",
                           "wg512-offline-b32.json")) as f:
        offline = json.load(f)["params"]
    with open(os.path.join(root, "perfbench", "workloads",
                           "wg512-serve-poisson.json")) as f:
        serve = json.load(f)["params"]
    synth = random_synthesizer(HParams(), WaveGlowConfig(), seed=GRAPH_SEED,
                               device="cuda")
    B, steps = offline["batch"], offline["max_steps"]

    widths = set()

    def run(i):
        texts = inputs.texts(GRAPH_SEED, i, B, offline["syllables"])
        widths.add(encode_batch(texts)[0].shape[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recording() as rec:
            mel, lens = synth.text_to_mel(texts, seed=GRAPH_SEED + i,
                                          max_steps=steps)
        torch.cuda.synchronize()
        return (mel, lens), time.perf_counter() - t0, graph_counts(rec)

    with graphs_off():
        _, eager_first, _ = run(0)              # cuBLAS, cuDNN, allocator
    _, graph_first, first = run(0)
    walls = {"eager": [], "graph": []}
    counts = []
    for i in range(1, GRAPH_BATCHES + 1):
        outs = {}
        for graphed in ((False, True) if i % 2 else (True, False)):
            if graphed:
                outs[graphed], wall, c = run(i)
                counts.append(c)
            else:
                with graphs_off():
                    outs[graphed], wall, _ = run(i)
            walls["graph" if graphed else "eager"].append(wall)
        if not all(torch.equal(a, b) for a, b in zip(outs[False],
                                                     outs[True])):
            raise RuntimeError(f"batch {i}: the graphed text_to_mel differs "
                               f"from the eager loops")
    med = {k: float(np.median(v)) for k, v in walls.items()}
    print(f"[graphs] text_to_mel at {B} x {outs[True][0].shape[-1]} frames, "
          f"texts padded to {sorted(widths)} symbols ({info}): "
          f"first call eager {eager_first * 1e3:.1f} ms, graphed (with its "
          f"captures) {graph_first * 1e3:.1f} ms, counters {first}; walls "
          f"eager {[round(w * 1e3, 2) for w in walls['eager']]} ms, graphed "
          f"{[round(w * 1e3, 2) for w in walls['graph']]} ms; medians eager "
          f"{med['eager'] * 1e3:.2f} ms, graphed {med['graph'] * 1e3:.2f} "
          f"ms, eager / graphed {med['eager'] / med['graph']:.3f}; graphed "
          f"counters a batch {counts}; mels and lengths bit for bit equal")
    # the encoder's graph, then a graph a block length (64, a shorter tail)
    blocks = [MASK_BLOCK] * (steps // MASK_BLOCK) + (
        [steps % MASK_BLOCK] if steps % MASK_BLOCK else [])
    want = {"taco.graph_captures": 1 + len(set(blocks)),
            "taco.graph_replays": 1 + len(blocks)}
    if first != want or any(c != {**want, "taco.graph_captures": 0}
                            for c in counts):
        raise RuntimeError(f"graph counters {first}, {counts}: want {want} "
                           f"in the first call, then no capture")

    sched = serve_open.schedule(GRAPH_SERVE_SEED, serve, GRAPH_SERVE_S)
    runs = {}
    for mode in ("eager", "graph"):
        ctx = graphs_off() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            srv = make_server(synth, slots=serve["slots"],
                              chunk_steps=serve["chunk_steps"],
                              max_text_len=serve["max_text_len"],
                              max_steps=serve["max_steps"],
                              sigma=serve["sigma"])
            srv.warm_window_widths()
            for j, text in enumerate(inputs.texts(
                    GRAPH_SERVE_SEED, 2 ** 20, serve["slots"],
                    serve["syllables"])):
                srv.submit(text, seed=j,
                           denoiser_strength=serve["denoiser_strength"]
                           * (j % 2))
            while not srv.idle:
                srv.step()
            srv.sessions.clear()
            with recording() as rec:
                out = serve_open.drive(srv, sched, GRAPH_SERVE_S,
                                       serve["drain_s"], Observation())
        spans = {n: [1e3 * (b - a) for m, a, b, *_ in rec.spans if m == n]
                 for n in ("serve.admit", "serve.decode")}
        done = sum(r["done"] for r in out["recs"].values())
        runs[mode] = {"rounds": out["rounds"], "done": done,
                      "requests": len(sched), "end_s": out["end"],
                      **{f"{n}_p50_ms": float(np.median(v))
                         for n, v in spans.items()},
                      **{f"{n}_mean_ms": float(np.mean(v))
                         for n, v in spans.items()},
                      **graph_counts(rec)}
        print(f"[graphs] serve {mode} ({info}): {len(sched)} requests at "
              f"{serve['rate_per_s']} req/s over {GRAPH_SERVE_S:.0f} s, seed "
              f"{GRAPH_SERVE_SEED}: {out['rounds']} rounds, {done} done, "
              f"drained at {out['end']:.1f} s; over "
              f"{len(spans['serve.admit'])} rounds serve.admit median "
              f"{runs[mode]['serve.admit_p50_ms']:.2f} ms, mean "
              f"{runs[mode]['serve.admit_mean_ms']:.2f} ms, serve.decode "
              f"median {runs[mode]['serve.decode_p50_ms']:.2f} ms, mean "
              f"{runs[mode]['serve.decode_mean_ms']:.2f} ms; counters "
              f"{graph_counts(rec)}")
        del srv
    del synth
    torch.cuda.empty_cache()
    return {"medians": med, "serve": runs}


# ---------------------------------------------------------------------------
# phase 32: VITS's flows on the gated activation kernel
# ---------------------------------------------------------------------------

VITS_CELL = "vits-offline-b32"
VITS_SEED = 3_000_000_023


# the generator's convolutions by role (PERF.md's rows V1-V6) -> the
# phase-33 cases of the role (their names' prefixes)
VITS_KERNELS = {"vits_conv.pre": ("pre",), "vits_conv.up": ("up",),
                "vits_conv.first": ("first",),
                "vits_conv.second": ("second",),
                "vits_conv.sum": ("mean",), "vits_conv.post": ("post",)}


def vits_role_counts(vc) -> dict:
    """The launches a generator pass at ``vc``'s shapes makes of each
    role: conv_pre, the transposed convolutions, a pair's first conv, its
    second (the residual alone) and the second with the running sum (the
    last of resblocks 2..n)."""
    n_up, dils = len(vc.upsample_rates), vc.resblock_dilation_sizes
    pairs = sum(len(d) for d in dils)
    return {"vits_conv.pre": 1, "vits_conv.up": n_up,
            "vits_conv.first": n_up * pairs,
            "vits_conv.second": n_up * (pairs - len(dils) + 1),
            "vits_conv.sum": n_up * (len(dils) - 1), "vits_conv.post": 1}


def vits_path() -> tuple:
    """Phase 32 (module docstring).  Returns the gated forward's largest
    error against its plain version at the cell's shapes, and the
    generator's launches by role in the ``synthesize`` run."""
    from perfbench import harness, inputs, weights_vits
    from text2speech_tpu_torch import convert
    from text2speech_tpu_torch.config import VitsConfig
    from text2speech_tpu_torch.infer import VitsSynthesizer
    from text2speech_tpu_torch.models import vits as vits_model
    from text2speech_tpu_torch.ops import gated, vits_conv

    cell, cfg = harness.load_cell(VITS_CELL)
    p, v = cell["params"], cfg["vits"]
    B, H2 = p["batch"], 2 * v["hidden_channels"]
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(VITS_SEED)
    worst = 0.0
    for T in (1088, 1061):
        a = torch.randn(B, T, H2, generator=g).to(dev)
        zero = torch.zeros_like(a)        # CouplingLayer.wn's conditioning
        reset_counts()
        got = gated.gated_fwd(a, zero)
        n = gated.launch_counts()["gated_fwd"]
        err = (got - gated.gated_plain(a, zero)).abs().max().item()
        print(f"[vits] gated_fwd f32 {(B, T, H2)} b dense zero: "
              f"max_abs_err={err:.4g} (bound {GATED_F32_ATOL['fwd']:.4g}), "
              f"{n} launch")
        if n != 1 or not torch.isfinite(got).all() or \
                err > GATED_F32_ATOL["fwd"]:
            raise RuntimeError(f"gated_fwd at VITS's shape {(B, T, H2)}: "
                               f"{n} launches, max_abs_err {err}")
        worst = max(worst, err)
    del a, zero, got

    vc = VitsConfig.from_dict(v)
    sd = weights_vits.make_weights(cfg, VITS_SEED, dev)
    synth = VitsSynthesizer(vc, convert.vits_module_from_torch(sd, vc, dev))
    texts = inputs.texts(VITS_SEED, 0, B, p["syllables"])
    roles = dict.fromkeys(VITS_KERNELS, 0)

    class ByRole:
        """``ops/vits_conv.py`` as the generator sees it, its ``conv``
        calls counted by role on the way through."""

        def __getattr__(self, name):
            return getattr(vits_conv, name)

        def conv(self, x, w, b, d=1, **kw):
            roles["vits_conv." + (
                "sum" if kw.get("acc") is not None else
                "second" if kw.get("res") is not None else
                "first" if kw.get("pre") else "pre")] += 1
            return vits_conv.conv(x, w, b, d, **kw)

    reset_counts()
    vits_model.vits_conv = ByRole()
    try:
        t0 = time.perf_counter()
        wavs = synth.synthesize(texts, noise_scale=p["noise_scale"],
                                noise_scale_w=p["noise_scale_w"],
                                length_scale=p["length_scale"],
                                seed=VITS_SEED)
        wall = time.perf_counter() - t0
    finally:
        vits_model.vits_conv = vits_conv
    launches = all_counts()
    per_role = vits_role_counts(vc)
    want = {**{k: 0 for k in launches},
            "gated_fwd": vc.flow_n_flows * vc.flow_n_layers,
            "vits_conv.conv": sum(n for r, n in per_role.items()
                                  if r not in ("vits_conv.up",
                                               "vits_conv.post")),
            "vits_conv.up": per_role["vits_conv.up"],
            "vits_conv.post": per_role["vits_conv.post"]}
    roles.update({r: launches[r] for r in ("vits_conv.up",
                                           "vits_conv.post")})
    frames = [w.size // vc.hop for w in wavs]
    print(f"[vits] synthesize, {B} of the cell's texts ({min(frames)}-"
          f"{max(frames)} frames) on seeded weights in {wall:.3f} s (first "
          f"call); launches {launches}; the generator's by role {roles}")
    if launches != want or roles != per_role:
        raise RuntimeError(f"VITS launch counts {launches}, by role "
                           f"{roles}; want {want}, {per_role}")
    if len(wavs) != B or any(w.size % vc.hop or not np.isfinite(w).all()
                             for w in wavs):
        raise RuntimeError("VITS waveforms: wrong count, partial frames or "
                           "not finite")
    del synth, sd
    torch.cuda.empty_cache()
    return worst, roles


# ---------------------------------------------------------------------------
# phase 33: VITS's generator on the fused channels-last convolution kernels
# ---------------------------------------------------------------------------

VITS_FRAMES = 1216


def vits_roles(v: dict, B: int, T: int) -> list:
    """(name, C_in, C_out, k, d, u, t_in, kwargs) of each role timed at the
    cell's shapes; ``u`` > 0 marks a transposed convolution."""
    c0 = v["upsample_initial_channel"]
    out = [("pre", v["inter_channels"], c0, 7, 1, 0, T, {})]
    t = T
    for i, u in enumerate(v["upsample_rates"]):
        cin, c = c0 >> i, c0 >> (i + 1)
        out.append((f"up{i}", cin, c, 2 * u, 1, u, t, {}))
        t *= u
        for k, d in ((3, 1), (7, 3), (11, 5)):
            out.append((f"first{c}_k{k}d{d}", c, c, k, d, 0, t,
                        {"pre": True, "post": True}))
        out.append((f"second{c}_k11", c, c, 11, 1, 0, t, {"res": True}))
        out.append((f"mean{c}_k11", c, c, 11, 1, 0, t,
                    {"res": True, "acc": True, "scale": 1 / 3}))
    return out


def vits_role_case(vc, dev, g, cin, cout, k, d, u, t_in, kw, B: int):
    """Inputs of a role on the card, and (kernel, plain, library) calls."""
    import torch.nn.functional as F

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    x = rn(B, t_in, cin)
    if u:
        w, b = rn(cin, cout, k, scale=(cin * 2) ** -0.5), rn(cout, scale=0.1)
        pk = vc.pack(w, u)
        xcf = x.transpose(1, 2).contiguous()
        return (lambda: vc.up(x, w, b, u, packed=pk),
                lambda: vc.up_plain(x, w, b, u),
                lambda: F.conv_transpose1d(xcf, w, b, stride=u,
                                           padding=u // 2))
    w, b = rn(cout, cin, k, scale=(cin * k) ** -0.5), rn(cout, scale=0.1)
    res = rn(B, t_in, cout) if kw.get("res") else None
    acc = rn(B, t_in, cout) if kw.get("acc") else None
    args = {"pre": kw.get("pre", False), "post": kw.get("post", False),
            "res": res, "acc": acc, "scale": kw.get("scale", 1.0)}
    pk = vc.pack(w)
    xcf = x.transpose(1, 2).contiguous()
    return (lambda: vc.conv(x, w, b, d, packed=pk, **args),
            lambda: vc.conv_plain(x, w, b, d, **args),
            lambda: F.conv1d(xcf, w, b, padding=(k - 1) * d // 2,
                             dilation=d))


def vits_conv_frames(lib) -> None:
    """Raise when a tile of ``csrc/vits_conv_sm90.cu`` (``vits_conv_kernel<N,
    MT>``) has a stack frame as large as one 64-row accumulator tile (N / 2
    floats a thread): an accumulator array in local memory.  Smaller frames
    are a few registers spilled where the tile's register cap (168 a
    thread with one block an SM, 96 with two) is reached; they are
    printed.  This is looser than :func:`require_no_local_memory`, which
    the port's other Hopper kernels meet: four of these five tiles spill
    8-40 bytes, and one block an SM, which clears the 96-register tiles'
    spills, costs 10-40% at 64 and 32 channels (PERF.md)."""
    name, seen = None, {}
    for line in lib.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame", line)
        r = re.search(r"vits_conv_kernelILi(\d+)ELi(\d+)E", name or "")
        if m and r:
            seen[(int(r.group(1)), int(r.group(2)))] = int(m.group(1))
    print(f"[vits-gen] stack frames (bytes) by (N, MT): {seen}")
    if not seen:
        raise RuntimeError(f"{lib.source.name}: no -Xptxas -v report")
    for (n, mt), frame in seen.items():
        if frame >= n // 2 * 4:
            raise RuntimeError(f"{lib.source.name}: the N={n}, MT={mt} tile "
                               f"has a {frame} B stack frame")


def vits_generator_path(info: str) -> dict:
    """Phase 33 (module docstring).  Returns {role: record}."""
    from perfbench import harness, roofline_vits, weights_vits
    from perfbench.reference import vits as ref_vits
    from perfbench.roofline import bound_s
    from text2speech_tpu_torch import convert
    from text2speech_tpu_torch.config import VitsConfig
    from text2speech_tpu_torch.ops import vits_conv as vc
    from text2speech_tpu_torch.utils.profiling import recording

    cell, cfg = harness.load_cell(VITS_CELL)
    v, B, T = cfg["vits"], cell["params"]["batch"], VITS_FRAMES
    dev = torch.device("cuda")
    if not vc.LIB.build_log:      # run alone: phase 2 has not built it
        vc.LIB.build()
    vc.LIB.get()
    print(f"[vits-gen] {info}; {vc.LIB.source.name} nvcc "
          f"{vc.LIB.build_seconds:.2f} s; SASS {hgmma_counts(vc.LIB.path)}")
    print(f"[vits-gen] registers (-Xptxas -v): "
          f"{ptxas_registers(vc.LIB.build_log)}")
    vits_conv_frames(vc.LIB)
    g = torch.Generator(device=dev).manual_seed(VITS_SEED)
    rec = {}
    for name, cin, cout, k, d, u, t_in, kw in vits_roles(v, B, T):
        kernel, plain, library = vits_role_case(vc, dev, g, cin, cout, k, d,
                                                u, t_in, kw, B)
        err = compare(f"vits_conv {name}", kernel(), plain())
        t_out = t_in * (u or 1)
        ops, bytes_ = roofline_vits._conv(B, cin, cout, k, t_in, t_out, t_in)
        bound = bound_s(ops, bytes_) * 1e3
        ms = time_ms(kernel, iters=10)
        r = {"ms": ms, "plain_ms": time_ms(plain, warmup=1, iters=3),
             "library_ms": time_ms(library, iters=10), "bound_ms": bound,
             "bound_by": ("operations" if ops / 989e12 >= bytes_ / 3.35e12
                          else "bytes"),
             "share": bound / ms, "max_abs_err": err,
             "shape": [B, t_in, cin, cout, k, d, u]}
        rec[name] = r
        print(f"[vits-gen] {name}: {B}x{t_in}x{cin} -> {cout}, k {k} d {d}"
              f"{f' u {u}' if u else ''}: kernel {ms:.4f} ms, bound "
              f"{bound:.4f} ({r['bound_by']}, {100 * r['share']:.1f}%), "
              f"plain {r['plain_ms']:.4f}, cuDNN {r['library_ms']:.4f}, "
              f"max_abs_err {err:.4g}", flush=True)
        del kernel, plain, library
        torch.cuda.empty_cache()
    x = (torch.randn(B, T, 32, generator=g, device=dev)).to(torch.bfloat16)
    w = torch.randn(1, 32, 7, generator=g, device=dev) * 0.05
    w = w.to(torch.bfloat16)
    pk = vc.pack_post(w)
    err = compare("vits_conv post", vc.post(x, w, packed=pk),
                  vc.post_plain(x, w))
    x = torch.randn(B, T * roofline_vits.hop(v), 32, generator=g,
                    device=dev).to(torch.bfloat16)
    ms = time_ms(lambda: vc.post(x, w, packed=pk), iters=10)
    ops, bytes_ = roofline_vits._conv(B, 32, 1, 7, x.shape[1], x.shape[1],
                                      x.shape[1])
    rec["post"] = {"ms": ms, "bound_ms": bound_s(ops, bytes_) * 1e3,
                   "plain_ms": time_ms(lambda: vc.post_plain(x, w),
                                       warmup=1, iters=3),
                   "max_abs_err": err}
    print(f"[vits-gen] post: {B}x{x.shape[1]}x32 -> 1: kernel {ms:.4f} ms, "
          f"bound {rec['post']['bound_ms']:.4f} (bytes), plain "
          f"{rec['post']['plain_ms']:.4f}, max_abs_err {err:.4g}")
    del x
    torch.cuda.empty_cache()

    vcfg = VitsConfig.from_dict(v)
    sd = weights_vits.make_weights(cfg, VITS_SEED, dev)
    gen = convert.vits_module_from_torch(sd, vcfg, dev).dec
    z = torch.randn(B, vcfg.inter_channels, T, generator=g, device=dev)
    with torch.inference_mode():
        vc.reset_launch_counts()
        with recording() as r:
            got = gen(z)
        torch.cuda.synchronize()
        n = vc.total_launches()
        seen = [c for _, c in r.counters.get("vits.gen_launches", [])]
        if n != 78 or seen != [78]:
            raise RuntimeError(f"generator pass: {n} kernel launches, counter "
                               f"{seen}; want 78")
        first = gen.first_design(z)
        want = ref_vits.generator(sd, v, z)[:, 0]
        nsr = rel_l2(got, want) ** 2
        nsr_first = rel_l2(first, want) ** 2
        print(f"[vits-gen] pass at B {B} x {T} frames: 78 launches, counter "
              f"{seen}; audio noise against the f32 reference generator "
              f"(perfbench/reference/vits.py): kernels {nsr:.3e}, first "
              f"design {nsr_first:.3e}")
        if not torch.isfinite(got).all() or nsr > 1.2e-3:
            raise RuntimeError(f"generator pass: audio noise {nsr}")
        del got, first, want
        turns = []
        for name, fn in (("first_design", gen.first_design), ("kernels", gen),
                         ("kernels", gen),
                         ("first_design", gen.first_design)):
            turns.append((name, time_ms(lambda: fn(z), warmup=1, iters=3)))
        print(f"[vits-gen] pass in turns (ms): {turns}")
    rec["pass"] = {"turns": turns, "nsr": nsr, "nsr_first": nsr_first}
    print(json.dumps({"vits_generator": rec}))
    del gen, z, sd
    torch.cuda.empty_cache()
    return rec


def vits_kernel_rows(launches: dict, rec: dict) -> list:
    """The ``kernels`` line's rows V1-V6: each role's launches in phase
    32's ``synthesize`` and, per phase-33 case of the role, its ms, bound,
    plain chain's and cuDNN's ms and error.  No TPU kernel is replaced."""
    rows = []
    for n, prefixes in VITS_KERNELS.items():
        cases = {c: r for c, r in rec.items() if c.startswith(prefixes)}
        if not cases:
            raise RuntimeError(f"phase 33 timed no case of {n}")
        rows.append({
            "name": n, "route": "cuda", "source": CSRC + "vits_conv_sm90.cu",
            "replaces": None, "launches": launches[n],
            "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
            **{k: {c: r.get(k) for c, r in cases.items()}
               for k in ("ms", "bound_ms", "bound_by", "plain_ms",
                         "library_ms", "shape")}})
    return rows


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

    from text2speech_tpu_torch.ops import gated, vits_conv, wn_backward
    from text2speech_tpu_torch.ops import wn_block as wb
    from text2speech_tpu_torch.ops import wn_block_int8 as wq
    from text2speech_tpu_torch.ops import wn_block_padded as wp

    t0 = time.perf_counter()
    libs = (wb.LIB, wb.LIB_SM90, wq.LIB, wq.LIB_SM90, gated.LIB,
            wn_backward.LIB, wn_backward.LIB_SM90, wp.LIB, wp.LIB_SM90,
            wp.LIB_TILES, vits_conv.LIB)
    with ThreadPoolExecutor(len(libs)) as pool:   # one nvcc per source
        for f in [pool.submit(lib.build) for lib in libs]:
            f.result()
    for lib in libs:
        lib.get()
        print(f"[build] {lib.source.name}: nvcc {lib.build_seconds:.2f} s")
        print(lib.build_log.strip())
    print(f"[build] {len(libs)} libraries built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in (wb.LIB_SM90, wq.LIB_SM90, wn_backward.LIB_SM90,
                wp.LIB_SM90, wp.LIB_TILES):
        print(f"[build] {lib.source.name} SASS: {hgmma_counts(lib.path)}")
        print(f"[build] {lib.source.name} registers (-Xptxas -v): "
              f"{ptxas_registers(lib.build_log)}")
    # the bf16 first layers' roles (the first layer's and the partial
    # layer's layer-0 form) and the s8 final and first layers keep no array
    # in local memory
    require_no_local_memory(wb.LIB_SM90, {
        wb.SM90_ROLES[role]: role for role in wb.SM90_TAP_ROLES})
    require_no_local_memory(wq.LIB_SM90, {
        code: role for role, code in wq.INT8_SM90_ROLES.items()
        if role in ("final", "first")})
    # rows 14-15's kernel and rows 12-13's, both roles of each
    require_no_local_memory(wp.LIB_SM90, {
        code: role for role, code in wp.PADDED_SM90_ROLES.items()})
    require_no_local_memory(wp.LIB_TILES, {
        code: role for role, code in wp.PADDED_TILES_ROLES.items()})

    print("[kernels] kernel vs plain at C=512, M=640")
    rec = check_kernels()
    bf16 = main_path("bf16", int8=False)
    int8 = main_path("int8", int8=True, rel32_bf16=bf16["rel32"])
    bf16_launches = bf16["launches"]
    print(f"[e2e] vocode+denoise, batch {len(TEXTS)} x {MAX_STEPS} frames: "
          f"bf16 {bf16['vocode_ms']:.3f} ms, int8 {int8['vocode_ms']:.3f} ms")
    int8_launches = int8["launches"]
    long_form(int8["synth"], int8["mel"], "int8", int8=True)
    long_form(bf16["synth"], bf16["mel"], "bf16", int8=False)
    cli_run("--fused_vocoder")
    cli_run("--int8_vocoder")
    print(f"[time] phase 25: {sync_time(cli_vocoder)[1]:.2f} s")

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
    tile_alternatives()
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
    print(f"[time] phase 26: {sync_time(lambda: preprocess_path(info))[1]:.2f}"
          f" s")
    print(f"[time] phase 27: "
          f"{sync_time(lambda: dp_path(bf16['synth'], info))[1]:.2f} s")
    del bf16
    torch.cuda.empty_cache()
    print(f"[time] phase 28: {sync_time(lambda: tp_serve_path(info))[1]:.2f}"
          f" s")
    (paths, demo_partial_err), t = sync_time(lambda: convert_path(info))
    print(f"[time] phase 29: {t:.2f} s")
    print(f"[time] phase 30: "
          f"{sync_time(lambda: recorder_cost(info))[1]:.2f} s")
    print(f"[time] phase 31: "
          f"{sync_time(lambda: graph_replay(info))[1]:.2f} s")
    (vits_err, vits_launches), t = sync_time(vits_path)
    print(f"[time] phase 32: {t:.2f} s")
    vits_rec, t = sync_time(lambda: vits_generator_path(info))
    print(f"[time] phase 33: {t:.2f} s")
    rec["wn_layer_partial"]["max_abs_err"] = max(
        rec["wn_layer_partial"]["max_abs_err"], demo_partial_err)
    rec["gated_fwd"]["max_abs_err"] = max(rec["gated_fwd"]["max_abs_err"],
                                          vits_err)

    launches = {**{n: bf16_launches[n] for n in list(KERNELS)[:3]},
                **{n: int8_launches[n] for n in list(KERNELS)[3:]},
                **{n: dcond_launches[n] for n in DCOND_KERNELS},
                **tp_launches, **trained, "conv_k3_bwd": chain_launches,
                **ladder_launches, **vits_launches}
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
        # 3 (the WN layers; the main paths' other WN layers too, with the
        # bound there) and the conv backward's f32 form
        **{k: rec[n][k] for k in ("prev_ms", "ms_b3", "prev_ms_b3",
                                  "bound_ms_b3", "plain_ms_b3", "f32")
           if k in rec[n]},
        **({"role": PADDED_SM90_ROLES[n]} if n in PADDED_SM90_ROLES else {}),
        **({"role": PADDED_TILES_ROLES[n][1]} if n in PADDED_TILES_ROLES
           else {}),
        # launches on phase 29's paths: one vocode of converted reference
        # weights, and the demo's whole run (its own process)
        "paths": {path: paths[path].get(n, 0) for path in paths},
    } for n, (src, repl) in {**KERNELS, **DCOND_KERNELS, **PARTIAL_KERNELS,
                             **TRAIN_KERNELS, **PADDED_KERNELS}.items()]
    kernels += vits_kernel_rows(vits_launches, vits_rec)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
