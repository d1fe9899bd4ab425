"""Offline VITS synthesis: a closed loop of batches, back to back, through
``VitsSynthesizer.synthesize`` (text, encoder, stochastic duration
predictor, one host read of the frame counts, flows, generator).

Batch i holds ``batch`` texts whose syllable counts are the cell's
quantile sizes, permuted by (seed, i); its duration noise [B, 2,
max_tokens] and latent noise [B, C, max_frames] are drawn from (seed, i)
on the card and handed to the program (``noise_w=``, ``noise_z=``, which it
slices) and, after the window, to the reference for the sampled rows.

A traced run wraps ``text_to_latent`` and ``latent_to_audio`` in the
benchmark's synchronised spans and merges the program's own spans and
counters (``perfbench/spans.py``)."""

from __future__ import annotations

import time
from contextlib import ExitStack

from .. import inputs, roofline_vits, spans, weights_vits
from ..harness import Outcome
from ..reference import compare
from ..reference import vits as ref_vits
from ..reference.text import symbol_ids
from ..trace import Observation, device_trace
from . import common

WARM_STREAM = 2 ** 20


def _ids(text: str) -> list:
    return ref_vits.intersperse(symbol_ids(text))


def _batch(ctx, i: int):
    import torch

    p, v = ctx.cell["params"], ctx.cfg["vits"]
    B = p["batch"]
    texts = inputs.texts(ctx.seed, i, B, p["syllables"])
    g = torch.Generator(device=ctx.device).manual_seed(
        inputs.derived_seed(ctx.seed, i, 3))
    noise_w = torch.randn((B, 2, p["max_tokens"]), generator=g,
                          device=ctx.device)
    noise_z = torch.randn((B, v["inter_channels"], p["max_frames"]),
                          generator=g, device=ctx.device)
    return texts, noise_w, noise_z


def _synthesizer(ctx, sd):
    from text2speech_tpu_torch import convert
    from text2speech_tpu_torch.config import VitsConfig
    from text2speech_tpu_torch.infer import VitsSynthesizer

    cfg = VitsConfig.from_dict(ctx.cfg["vits"])
    model = convert.vits_module_from_torch(sd, cfg, device=ctx.device)
    return VitsSynthesizer(cfg, model)


def run(ctx) -> Outcome:
    import torch

    p, v = ctx.cell["params"], ctx.cfg["vits"]
    common.set_precision(torch, ctx.control)
    obs = Observation()
    stack = ExitStack()
    rec = stack.enter_context(spans.recorder(ctx.trace))
    sync = common.sync(torch, ctx.device)
    sd = weights_vits.make_weights(ctx.cfg, ctx.seed, ctx.device)
    synth = _synthesizer(ctx, sd)

    def call(batch):
        texts, noise_w, noise_z = batch
        return synth.synthesize(
            texts, noise_scale=p["noise_scale"],
            noise_scale_w=p["noise_scale_w"],
            length_scale=p["length_scale"], noise_w=noise_w,
            noise_z=noise_z)

    call(_batch(ctx, WARM_STREAM))                 # builds and warms
    lo, hi = p["warm_frames"]
    for T in range(lo, hi + 1, synth.FRAME_BUCKET):
        synth.latent_to_audio(torch.zeros(
            (p["batch"], v["inter_channels"], T), device=ctx.device))
    if sync:
        sync()
    # one row a batch, drawn before the window: its logw, durations and
    # latent are kept on the device for the check
    kept: dict = {}
    text_to_latent = synth.text_to_latent

    def keeping(texts, *a, **kw):
        z, y_len, logw, w_ceil = text_to_latent(texts, *a,
                                                with_durations=True, **kw)
        i = len(kept)
        row = int(inputs.rng(ctx.seed, 7, i).integers(len(texts)))
        kept[i] = (row, logw[row].clone(), w_ceil[row].clone(),
                   z[row].clone(), int(z.shape[-1]), y_len)
        return z, y_len

    synth.text_to_latent = keeping
    outputs: dict = {}
    samples = 0
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    if ctx.trace:
        for name in ("text_to_latent", "latent_to_audio"):
            inner = getattr(synth, name)
            setattr(synth, name, _spanned(obs, name, inner, sync))
        with device_trace(obs, torch):
            for i in range(p["trace_batches"]):
                batch = _batch(ctx, i)
                with obs.span("batch", sync):
                    outputs[i] = (batch[0], call(batch))
        i = p["trace_batches"]
    else:
        i = 0
        while time.perf_counter() - t0 < ctx.seconds:
            batch = _batch(ctx, i)
            outputs[i] = (batch[0], call(batch))
            samples += sum(a.size for a in outputs[i][1])
            i += 1
    wall = time.perf_counter() - t0
    stack.close()
    n_batches = i
    peak = common.memory_peak(torch, ctx.device)
    spans.merge(
        obs, rec, batches=n_batches,
        batch_flops=[sum(roofline_vits.utterance_flops(
            v, len(_ids(t)), int(n)) for t, n in zip(outputs[b][0],
                                                     kept[b][5]))
            for b in range(n_batches)],
        generator_bound_s=[roofline_vits.generator_bound_s(
            v, p["batch"], kept[b][4]) for b in range(n_batches)])
    del synth
    common.free(torch, ctx.device)

    checks = _check(ctx, outputs, kept, sd)
    return Outcome(
        attempted=n_batches * p["batch"], failed=0,
        e2e={"audio_s_per_s": samples / v["sampling_rate"] / wall,
             "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak, obs=obs,
        notes={"batches": n_batches, "window_s": wall})


def _spanned(obs, name, fn, sync):
    def wrapped(*a, **kw):
        with obs.span(name, sync):
            return fn(*a, **kw)
    return wrapped


def _check(ctx, outputs: dict, kept: dict, sd: dict) -> dict:
    """Sampled rows against the reference's single pass, each given the
    row's draws, the program's integer durations and its padded frame
    count: ``logw_gap`` (rel. L2 of logw over the row's symbols),
    ``latent_gap`` (rel. L2 of z over the row's frames), ``audio_nsr``
    (noise-to-signal power of the returned audio), worst over the sample.
    The rows: ``check_rows`` batches drawn from the seed among those the
    window completed, each with the row drawn for it before the window."""
    import torch

    p, v = ctx.cell["params"], ctx.cfg["vits"]
    r = inputs.rng(ctx.seed, 8)
    picked = sorted(int(b) for b in r.choice(
        sorted(outputs), min(p["check_rows"], len(outputs)), replace=False))
    hop = roofline_vits.hop(v)
    gaps: dict = {"logw_gap": [], "latent_gap": [], "audio_nsr": []}
    for b in picked:
        row, logw, w_ceil, z, T_y, y_lengths = kept[b]
        texts, noise_w, noise_z = _batch(ctx, b)
        ids = _ids(texts[row])
        n, y_len = len(ids), int(y_lengths[row])
        want = ref_vits.infer(
            sd, v, ids, noise_w[row], noise_z[row],
            noise_scale=p["noise_scale"], noise_scale_w=p["noise_scale_w"],
            length_scale=p["length_scale"], w_ceil=w_ceil[:n], T_y=T_y)
        gaps["logw_gap"].append(compare.rel_l2(logw[:n], want["logw"]))
        gaps["latent_gap"].append(compare.rel_l2(z[:, :y_len],
                                                 want["z"][:, :y_len]))
        got = torch.from_numpy(outputs[b][1][row])
        gaps["audio_nsr"].append(compare.noise_power_ratio(
            got, want["audio"][: y_len * hop].cpu()))
        del want
    lim = p["limits"]
    return {k: (max(g), lim[k]) for k, g in gaps.items()}
