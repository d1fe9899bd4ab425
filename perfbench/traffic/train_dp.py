"""Data-parallel WaveGlow training: one process a card, the port's
``train/waveglow.py::make_wg_train_step(..., mesh=)`` over a
``parallel/mesh.py`` data mesh (NCCL on the cards; gloo where a test runs
it on the CPU).

Every step takes a new global batch of ``rows_per_rank x ranks`` rows of
``segment_length`` samples: seeded audio (a few sinusoids and noise, made
on the card from (seed, step)) and its mel through the port's
``dsp/mel.py``, as its data loader computes it.  Set-up builds the
training step once, drives it through the three checked steps and two
timed ones, and hands that same object to the window.  The number of
window steps is fixed before the window from those two timed steps (the
ranks must agree on it): about ``--seconds`` of work; the window's
batches are made in set-up, so the window times the training step alone.

The check (rank 0, after the window, the program freed): the three
steps' losses, the first step's gradient by leaf as the optimizer got it
(Adam's first moment after one step over 1 - beta1), and each leaf's
change after the three steps, against the reference's plain f32 training
in blocks of rows."""

from __future__ import annotations

import math
import os
import socket
import time
from datetime import timedelta

from .. import inputs, roofline, weights
from ..harness import Outcome
from ..reference import compare
from ..reference.pipeline import train_steps
from ..trace import Observation, device_trace
from . import common

CHECKED_STEPS = 3


def audio_batch(seed: int, step: int, rows: int, samples: int, sr: int,
                device):
    """[rows, samples] in [-1, 1]: per row three sinusoids of random pitch
    and level over a little noise."""
    import torch

    g = torch.Generator(device=device).manual_seed(
        inputs.derived_seed(seed, 11, step))
    t = torch.arange(samples, device=device, dtype=torch.float32) / sr
    f = 80.0 + 900.0 * torch.rand((rows, 3, 1), generator=g, device=device)
    a = 0.05 + 0.25 * torch.rand((rows, 3, 1), generator=g, device=device)
    ph = 6.2832 * torch.rand((rows, 3, 1), generator=g, device=device)
    x = (a * torch.sin(6.2832 * f * t + ph)).sum(1)
    x = x + 0.01 * torch.randn((rows, samples), generator=g, device=device)
    return x.clamp(-1.0, 1.0)


def leaf_groups(wg: dict) -> dict:
    """The port's trainable leaf -> the reference leaves it holds (the
    port keeps one conditioning conv per flow, the reference one per
    layer)."""
    out = {"upsample/kernel": ["upsample.weight"],
           "upsample/bias": ["upsample.bias"]}
    L = wg["wn_n_layers"]
    for k in range(wg["n_flows"]):
        out[f"convinv{k}/W"] = [f"convinv.{k}.conv.weight"]
        w, r = f"wn{k}", f"WN.{k}"
        for leaf, suffix in (("v", "weight_v"), ("g", "weight_g"),
                             ("bias", "bias")):
            out[f"{w}/start/{leaf}"] = [f"{r}.start.{suffix}"]
            out[f"{w}/cond/{leaf}"] = [f"{r}.cond_layers.{i}.{suffix}"
                                       for i in range(L)]
            for i in range(L):
                out[f"{w}/in{i}/{leaf}"] = [f"{r}.in_layers.{i}.{suffix}"]
                out[f"{w}/res_skip{i}/{leaf}"] = [
                    f"{r}.res_skip_layers.{i}.{suffix}"]
        out[f"{w}/end/kernel"] = [f"{r}.end.weight"]
        out[f"{w}/end/bias"] = [f"{r}.end.bias"]
    return out


def _leaf(name: str) -> str:
    """The trainable module's parameter name without its ``params.``
    prefix: the flax path."""
    return name.removeprefix("params.")


def _norm(t) -> float:
    return 0.0 if t is None else float(t.double().norm())


def _norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def _grouped(norms: dict, groups: dict) -> dict:
    return {k: math.sqrt(sum(norms[r] ** 2 for r in refs))
            for k, refs in groups.items()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(ctx) -> Outcome:
    import multiprocessing as mp

    world = ctx.cell["chips"]
    port = _free_port()
    spawn = mp.get_context("spawn")
    args = (ctx.cell_name, ctx.cell, ctx.cfg, ctx.seed, ctx.seconds,
            ctx.trace, ctx.device, ctx.control, ctx.fault, world, port)
    procs = [spawn.Process(target=_worker, args=(r, *args), daemon=True)
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        return _rank(0, ctx, world, port)
    except BaseException:
        for p in procs:
            p.terminate()
        raise
    finally:
        for p in procs:
            p.join(timeout=600)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)


def _worker(rank, name, cell, cfg, seed, seconds, trace, device, control,
            fault, world, port) -> None:
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from perfbench.harness import THREADS, Context, set_cache_dirs

    set_cache_dirs()
    import torch

    torch.set_num_threads(THREADS)
    ctx = Context(name, cell, cfg, seed, seconds, trace, time.perf_counter(),
                  device=device, control=control, fault=fault)
    _rank(rank, ctx, world, port)


def _rank(rank: int, ctx, world: int, port: int):
    import torch
    import torch.distributed as dist
    from text2speech_tpu_torch import convert
    from text2speech_tpu_torch.config import WaveGlowConfig
    from text2speech_tpu_torch.data.mel2samp import VocoderBatch
    from text2speech_tpu_torch.dsp.mel import MelFrontend
    from text2speech_tpu_torch.parallel import mesh as pmesh
    from text2speech_tpu_torch.train.state import create_train_state
    from text2speech_tpu_torch.train.waveglow import make_wg_train_step

    p = ctx.cell["params"]
    wg = ctx.cfg["waveglow"]
    common.set_precision(torch, ctx.control)
    pmesh.initialize_distributed(
        init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
        device=ctx.device, timeout=timedelta(seconds=600))
    dev = pmesh.rank_device()
    rows = p["rows_per_rank"] * world
    mesh = pmesh.make_data_mesh(rows)
    wgc = WaveGlowConfig(**wg)
    _, wg_sd = weights.make_weights(ctx.cfg, ctx.seed, dev)
    model = convert.trainable_waveglow_from_variables(
        {"params": convert.waveglow_from_torch(wg_sd, wgc)}, wgc, device=dev)
    state = create_train_state(model, wg["learning_rate"])
    pmesh.replicate(state, mesh)
    step_fn = make_wg_train_step(model, wg["sigma"], mesh=mesh)
    undo = None
    if ctx.fault:
        from . import faults

        undo = faults.plant(ctx.fault, train={"state": state, "model": model})
    frontend = MelFrontend(
        filter_length=wg["filter_length"], hop_length=wg["hop_length"],
        win_length=wg["win_length"], n_mel_channels=wg["n_mel_channels"],
        sampling_rate=wg["sampling_rate"], mel_fmin=wg["mel_fmin"],
        mel_fmax=wg["mel_fmax"])

    def batch(s):
        audio = audio_batch(ctx.seed, s, rows, wg["segment_length"],
                            wg["sampling_rate"], dev)
        with torch.no_grad():
            return VocoderBatch(frontend.mel_spectrogram(audio), audio)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    init = ({k: v.detach().clone() for k, v in state.params.items()}
            if rank == 0 else None)
    losses, grad_norms = [], None
    for s in range(CHECKED_STEPS):
        _, m = step_fn(state, batch(s))
        losses.append(float(m["loss"]))
        if s == 0 and rank == 0:
            # the gradient as Adam got it: its first moment over 1 - b1 (a
            # leaf the optimizer never saw has none: norm 0)
            grad_norms = {_leaf(k): _norm(state.opt.state.get(v, {})
                                          .get("exp_avg")) / 0.1
                          for k, v in state.params.items()}
    change = ({_leaf(k): float((state.params[k].detach() - v).double()
                               .norm())
               for k, v in init.items()} if rank == 0 else None)
    del init
    times = []
    for s in range(CHECKED_STEPS, CHECKED_STEPS + 2):
        b = batch(s)
        sync()
        t = time.perf_counter()
        step_fn(state, b)
        sync()
        times.append(time.perf_counter() - t)
    n = torch.tensor([max(3, round(ctx.seconds / min(times)))],
                     device=dev)
    dist.broadcast(n, 0)
    n_steps = p["trace_steps"] if ctx.trace else int(n.item())
    first = CHECKED_STEPS + 2
    window = [batch(s) for s in range(first, first + n_steps)]
    obs = Observation()
    dist.barrier()
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    if ctx.trace and rank == 0 and dev.type == "cuda":
        with device_trace(obs, torch):
            for b in window:
                with obs.span("step", sync):
                    step_fn(state, b)
    else:
        for b in window:
            if ctx.trace:
                with obs.span("step", sync):
                    step_fn(state, b)
            else:
                step_fn(state, b)
        sync()
    wall = time.perf_counter() - t0
    if undo is not None:
        undo()
    peak = torch.tensor([common.memory_peak(torch, dev.type)],
                        dtype=torch.float64, device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    tf32 = (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32)
    obs.info.update(
        step_flops=roofline.train_flops_per_row(wg, wg["segment_length"])
        * p["rows_per_rank"], peak_kind="tf32" if tf32 else "f32",
        steps=n_steps)
    del state, model, step_fn, window
    common.free(torch, dev.type)
    dist.barrier()
    pmesh.destroy_distributed()
    if rank != 0:
        return None
    checks = _check(ctx, wg, wg_sd, rows, losses, grad_norms, change, dev)
    samples = n_steps * rows * wg["segment_length"]
    return Outcome(
        attempted=n_steps, failed=0,
        e2e={"train_audio_s_per_s": samples / wg["sampling_rate"] / wall,
             "setup_s": setup_s},
        checks=checks, memory_peak_bytes=int(peak.item()), obs=obs,
        notes={"steps": n_steps, "window_s": wall, "ranks": world,
               "peak_of": obs.info["peak_kind"],
               "losses": losses})


def _check(ctx, wg, wg_sd, rows, losses, grad_norms, change, dev) -> dict:
    p = ctx.cell["params"]
    batches = [audio_batch(ctx.seed, s, rows, wg["segment_length"],
                           wg["sampling_rate"], dev)
               for s in range(CHECKED_STEPS)]
    ref_losses, ref_grad, ref_params = train_steps(
        wg_sd, wg, batches, wg["sigma"], wg["learning_rate"],
        p["rows_per_rank"])
    groups = leaf_groups(wg)
    ref_gn = _grouped(_norms(ref_grad), groups)
    ref_change = _grouped(
        _norms({k: ref_params[k] - wg_sd[k] for k in wg_sd}), groups)
    # leaves whose reference gradient is nought to rounding move under
    # Adam by round-off alone: left out of the change by this rule
    med = sorted(ref_gn.values())[len(ref_gn) // 2]
    moved = [k for k, v in ref_gn.items() if v >= 1e-3 * med]
    lim = p["limits"]
    return {
        "loss_gap": (compare.loss_gap(losses, ref_losses), lim["loss_gap"]),
        "grad_gap": (compare.worst_leaf_gap(grad_norms, ref_gn),
                     lim["grad_gap"]),
        "change_gap": (compare.worst_leaf_gap(
            {k: change[k] for k in moved}, {k: ref_change[k] for k in moved}),
            lim["change_gap"])}
