"""Open-loop streaming: Poisson-like arrivals at a fixed rate into the
port's continuous-batching server (``server.make_server``), driven by one
thread that submits every request due before each ``step()``.

The schedule is a function of ``--seed`` alone, and every seed gets the
same work in another order: N = rate x seconds requests; the gaps between
arrivals are the exponential distribution's quantiles at (i + 1/2) / N
(mean 1 / rate), in one order that no seed changes (a seed that reorders
the gaps changes how arrivals bunch, and with it the tails, far more than
two runs of one seed differ); the texts' syllable counts are the cell's
quantile sizes, permuted; exactly half of the requests, chosen by the
seed, ask for the denoiser.  Each request's prenet keep-masks and flow
noise come from the benchmark's ``key_fn`` / ``noise_fn``, functions of
the request's own seed, which the reference calls again.

A request is timed from its due time on the schedule (not from when it
was submitted), so a stall delays every later request's first audio."""

from __future__ import annotations

import math
import time
from contextlib import ExitStack

from .. import inputs, roofline, weights
from ..harness import Outcome
from ..reference import compare
from ..reference.pipeline import Synthesis
from ..reference.text import symbol_ids
from ..trace import Observation, device_trace, finish
from . import common

WARM_STREAM = 2 ** 20
ARRIVAL_ORDER = 0      # the generator of the gaps' one order, for every seed


def schedule(seed: int, p: dict, seconds: float) -> list:
    """[(due s, text, request seed, denoiser strength)] in due order."""
    n = max(1, round(p["rate_per_s"] * seconds))
    r = inputs.rng(seed, 3)
    gaps = [-math.log(1.0 - (i + 0.5) / n) / p["rate_per_s"]
            for i in range(n)]
    gaps = [gaps[i] for i in inputs.rng(ARRIVAL_ORDER, 3).permutation(n)]
    scale = seconds / sum(gaps)
    texts = inputs.texts(seed, 4, n, p["syllables"])
    denoised = set(int(i) for i in r.permutation(n)[: round(
        n * p["denoise_share"])])
    out, t = [], 0.0
    for i in range(n):
        out.append((t, texts[i], inputs.derived_seed(seed, 5, i),
                    p["denoiser_strength"] if i in denoised else 0.0))
        t += gaps[i] * scale
    return out


def draws(ctx, hp: dict, wg: dict, p: dict):
    """The benchmark's ``key_fn`` and ``noise_fn`` (``server.py``'s
    contract): keep-masks bool [limit, 2, prenet_dim] and noise blocks
    ``draw(j)``, each a function of the request's seed alone."""
    import torch

    cs = p["chunk_steps"]
    limit = -(-p["max_steps"] // cs) * cs
    gpf = wg["upsample_stride"] // wg["n_group"]
    widths = inputs.noise_widths(wg)
    dev = ctx.device

    def key_fn(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.rand((limit, 2, hp["prenet_dim"]), generator=g,
                          device=dev) < 0.5

    def noise_fn(seed):
        def draw(j):
            g = torch.Generator(device=dev).manual_seed(
                inputs.derived_seed(seed, j))
            return tuple(torch.randn((cs * gpf, w), generator=g, device=dev)
                         for w in widths)
        return draw

    return key_fn, noise_fn


def build(ctx):
    """(weights, synthesizer, server), the server warmed on a full set of
    slots (admission, decode, postnet and denoise windows, both vocoder
    window widths)."""
    import torch
    from text2speech_tpu_torch.server import make_server

    p = ctx.cell["params"]
    hp, wg = ctx.cfg["tacotron"], ctx.cfg["waveglow"]
    common.set_precision(torch, ctx.control)
    taco_sd, wg_sd = weights.make_weights(ctx.cfg, ctx.seed, ctx.device)
    synth = common.build_synthesizer(ctx, taco_sd, wg_sd)
    key_fn, noise_fn = draws(ctx, hp, wg, p)
    srv = make_server(synth, slots=p["slots"], chunk_steps=p["chunk_steps"],
                      max_text_len=p["max_text_len"],
                      max_steps=p["max_steps"], sigma=p["sigma"],
                      key_fn=key_fn, noise_fn=noise_fn,
                      retain_sessions=True)
    if ctx.fault:
        from . import faults

        faults.plant(ctx.fault, synth=synth)
    srv.warm_window_widths()
    for i, text in enumerate(inputs.texts(ctx.seed, WARM_STREAM,
                                          p["slots"], p["syllables"])):
        srv.submit(text, seed=inputs.derived_seed(ctx.seed, WARM_STREAM, i),
                   denoiser_strength=p["denoiser_strength"] * (i % 2))
    while not srv.idle:
        srv.step()
    srv.sessions.clear()
    common.free(torch, ctx.device)
    return taco_sd, wg_sd, synth, srv


def sample(seed: int, n: int, k: int) -> list:
    """The requests whose answers the check compares, drawn before the
    window: the server keeps their sessions, and drops the others'."""
    r = inputs.rng(seed, 9)
    return sorted(int(i) for i in r.choice(n, min(k, n), replace=False))


def drive(srv, sched: list, seconds: float, drain_s: float, obs,
          trace_rounds=None, torch=None, keep=()) -> dict:
    """Run the schedule open-loop; returns per-request records
    {index: {"due", "sid", "events": [(t, samples)], "audio": [chunks],
    "done"}} and the driver's lateness.  Times are seconds from the
    window's start.  ``trace_rounds``: (first, count) of the rounds to
    trace on the device.  The requests in ``keep`` also get the served
    mel of their session ("mel"); the server (built retaining sessions)
    drops every other session once it completes."""
    recs = {i: {"due": due, "events": [], "audio": [], "done": False}
            for i, (due, *_rest) in enumerate(sched)}
    by_sid, late = {}, []
    nxt, rounds = 0, 0
    stack = ExitStack()
    t0 = time.perf_counter()
    obs.info["t0"] = t0
    while True:
        t = time.perf_counter() - t0
        while nxt < len(sched) and sched[nxt][0] <= t:
            due, text, seed, strength = sched[nxt]
            sid = srv.submit(text, seed=seed, denoiser_strength=strength)
            by_sid[sid] = nxt
            recs[nxt]["sid"] = sid
            late.append(t - due)
            nxt += 1
        if nxt == len(sched) and srv.idle:
            break
        if t > seconds + drain_s:
            break
        if srv.idle:
            time.sleep(max(0.0, min(sched[nxt][0] - t, 0.05)))
            continue
        if trace_rounds and rounds == trace_rounds[0]:
            stack.enter_context(device_trace(obs, torch))
        obs.count("queued", srv.queued_count)
        with obs.span("step"):
            events = srv.step()
        t_ev = time.perf_counter() - t0
        rounds += 1
        if trace_rounds and rounds == trace_rounds[0] + trace_rounds[1]:
            stack.close()
        for ev in events:
            rec = recs[by_sid[ev.sid]]
            if ev.audio is not None:
                rec["events"].append((t_ev, ev.audio.size))
                rec["audio"].append(ev.audio)
            if ev.final:
                rec["done"] = True
                sess = srv.sessions.pop(ev.sid, None)
                if by_sid[ev.sid] in keep and sess is not None:
                    rec["mel"] = sess.post_cat()
    stack.close()
    return {"recs": recs, "late": late, "end": time.perf_counter() - t0,
            "rounds": rounds}


def latencies(run: dict) -> tuple:
    """(first-audio latency per request, every gap between consecutive
    audio events of a session, failed count), in seconds.  A request
    without audio when the drain ended counts the whole wait."""
    first, gaps, failed = [], [], 0
    for rec in run["recs"].values():
        times = [t for t, _ in rec["events"]]
        if not rec["done"]:
            failed += 1
        first.append((times[0] if times else run["end"]) - rec["due"])
        gaps += [b - a for a, b in zip(times, times[1:])]
    return first, gaps, failed


def run(ctx) -> Outcome:
    import torch

    p = ctx.cell["params"]
    hp, wg = ctx.cfg["tacotron"], ctx.cfg["waveglow"]
    taco_sd, wg_sd, synth, srv = build(ctx)
    sched = schedule(ctx.seed, p, ctx.seconds)
    obs = Observation()
    setup_s = time.perf_counter() - ctx.t_start
    keep = sample(ctx.seed, len(sched), p["check_sessions"])
    out = drive(srv, sched, ctx.seconds, p["drain_s"], obs,
                tuple(p["trace_rounds"]) if ctx.trace else None, torch,
                set(keep))
    peak = common.memory_peak(torch, ctx.device)
    first, gaps, failed = latencies(out)
    if ctx.trace:
        finish(obs)
        lo, hi = (obs.slice_s[0] - obs.info["t0"],
                  obs.slice_s[1] - obs.info["t0"])
        samples = sum(n for rec in out["recs"].values()
                      for t, n in rec["events"] if lo <= t <= hi)
        mean_syms = (sum(len(symbol_ids(s[1])) for s in sched) / len(sched))
        per_frame = (roofline.vocoder_flops_per_frame(wg)
                     + roofline.decoder_flops_per_frame(hp, mean_syms)
                     + roofline.postnet_flops_per_frame(hp)
                     + roofline.encoder_flops_per_symbol(hp) * mean_syms
                     / p["max_steps"])
        obs.info.update(slice_samples=samples, flops_per_frame=per_frame,
                        hop=wg["upsample_stride"],
                        sampling_rate=wg["sampling_rate"])
    late = sorted(out["late"])
    notes = {"requests": len(sched), "rounds": out["rounds"],
             "drain_end_s": out["end"],
             "late_p95_ms": 1e3 * common.pct(late, 95),
             "late_max_ms": 1e3 * late[-1],
             "first_audio_p50_ms": 1e3 * common.pct(first, 50)}
    del synth, srv
    common.free(torch, ctx.device)
    checks = _check(ctx, sched, out, keep, taco_sd, wg_sd)
    return Outcome(
        attempted=len(sched), failed=failed,
        e2e={"first_audio_p95_ms": 1e3 * common.pct(first, 95),
             "chunk_gap_p95_ms": 1e3 * common.pct(gaps, 95),
             "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak, obs=obs, notes=notes)


def _check(ctx, sched: list, out: dict, keep: list, taco_sd,
           wg_sd) -> dict:
    """The sampled sessions against the reference's single pass over each
    (its text padded to the server's width, its masks and noise from
    ``key_fn`` / ``noise_fn``): the served mel as a relative L2 gap and
    the streamed audio, concatenated, as a noise-to-signal power ratio,
    worst over the sample.  A sampled request that never finished fails
    both."""
    import numpy as np
    import torch

    p = ctx.cell["params"]
    hp, wg = ctx.cfg["tacotron"], ctx.cfg["waveglow"]
    lim = p["limits"]
    if not all(out["recs"][i]["done"] for i in keep):
        return {"mel_gap": (float("inf"), lim["mel_gap"]),
                "audio_nsr": (float("inf"), lim["audio_nsr"])}
    key_fn, noise_fn = draws(ctx, hp, wg, p)
    gpf = wg["upsample_stride"] // wg["n_group"]
    cs = p["chunk_steps"]
    frames = p["max_steps"]
    ref = Synthesis(taco_sd, wg_sd, hp, wg)
    mel_gaps, audio_gaps = [], []
    for g0 in range(0, len(keep), p["check_block"]):
        block = keep[g0: g0 + p["check_block"]]
        masks = torch.stack([key_fn(sched[i][2])[:frames] for i in block],
                            dim=2)
        mel, lens = ref.mel([sched[i][1] for i in block], masks,
                            [p["max_text_len"]] * len(block))
        comps = []
        for i in block:
            draw = noise_fn(sched[i][2])
            blocks = [draw(j) for j in range(-(-frames // cs))]
            comps.append([torch.cat([b[c] for b in blocks])[: frames * gpf]
                          for c in range(len(blocks[0]))])
        noise = tuple(torch.stack([c[k] for c in comps])
                      for k in range(len(comps[0])))
        audio = ref.audio(mel, noise, p["sigma"],
                          [sched[i][3] for i in block])
        for j, i in enumerate(block):
            n = int(lens[j])
            mel_gaps.append(compare.rel_l2(out["recs"][i]["mel"][:, :n],
                                           mel[j, :, :n]))
            got = torch.from_numpy(np.concatenate(out["recs"][i]["audio"]))
            audio_gaps.append(compare.noise_power_ratio(
                got, audio[j, : n * wg["upsample_stride"]].cpu()))
    return {"mel_gap": (max(mel_gaps), lim["mel_gap"]),
            "audio_nsr": (max(audio_gaps), lim["audio_nsr"])}
