"""Offline synthesis: a closed loop of batches, back to back, through
``Synthesizer.synthesize`` (text, encoder, autoregressive decoder,
postnet, fused vocoder, denoiser).

Batch i holds ``batch`` texts whose syllable counts are the cell's
quantile sizes, permuted by (seed, i); its prenet keep-masks and flow
noise are drawn from (seed, i) on the card and handed to the program
(``keep_masks=``, ``noise=``) and, after the window, to the reference
for the sampled rows."""

from __future__ import annotations

import time

from .. import inputs, roofline, weights
from ..harness import Outcome
from ..reference import compare
from ..reference.pipeline import Synthesis
from ..reference.text import symbol_ids
from ..trace import Observation, device_trace
from . import common

WARM_STREAM = 2 ** 20


def _batch(ctx, i: int, hp: dict, wg: dict):
    p = ctx.cell["params"]
    B, steps = p["batch"], p["max_steps"]
    gpf = wg["upsample_stride"] // wg["n_group"]
    texts = inputs.texts(ctx.seed, i, B, p["syllables"])
    masks = inputs.keep_masks(ctx.seed, i, steps, B, hp["prenet_dim"],
                              ctx.device)
    noise = inputs.noise(ctx.seed, i, B, steps * gpf, wg, ctx.device)
    return texts, masks, noise


def _pad_width(texts: list) -> int:
    """The program's encoder width for a batch: the longest text rounded
    up to a multiple of 32 symbols (``text.encode_batch``)."""
    n = max(len(symbol_ids(t)) for t in texts)
    return -(-n // 32) * 32


def run(ctx) -> Outcome:
    import torch

    p = ctx.cell["params"]
    hp, wg = ctx.cfg["tacotron"], ctx.cfg["waveglow"]
    common.set_precision(torch, ctx.control)
    obs = Observation()
    sync = common.sync(torch, ctx.device)
    taco_sd, wg_sd = weights.make_weights(ctx.cfg, ctx.seed, ctx.device)
    synth = common.build_synthesizer(ctx, taco_sd, wg_sd)
    if ctx.fault:
        from . import faults

        faults.plant(ctx.fault, synth=synth)

    def call(batch):
        texts, masks, noise = batch
        return synth.synthesize(
            texts, sigma=p["sigma"], denoiser_strength=p["denoiser_strength"],
            max_steps=p["max_steps"], keep_masks=masks, noise=noise)

    call(_batch(ctx, WARM_STREAM, hp, wg))         # builds and warms
    if sync:
        sync()
    # the mel of one row a batch, drawn before the window, is kept on the
    # device for the check
    mels: dict = {}
    text_to_mel = synth.text_to_mel

    def kept(texts, *a, **kw):
        mel, lens = text_to_mel(texts, *a, **kw)
        i = len(mels)
        row = int(inputs.rng(ctx.seed, 7, i).integers(len(texts)))
        mels[i] = (row, mel[row].clone())
        return mel, lens

    synth.text_to_mel = kept
    outputs: dict = {}
    samples = 0
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    if ctx.trace:
        for name in ("text_to_mel", "mel_to_audio"):
            inner = getattr(synth, name)
            setattr(synth, name, _spanned(obs, name, inner, sync))
        with device_trace(obs, torch):
            for i in range(p["trace_batches"]):
                batch = _batch(ctx, i, hp, wg)
                with obs.span("batch", sync):
                    outputs[i] = (batch[0], call(batch))
        i = p["trace_batches"]
    else:
        i = 0
        while time.perf_counter() - t0 < ctx.seconds:
            batch = _batch(ctx, i, hp, wg)
            outputs[i] = (batch[0], call(batch))
            samples += sum(a.size for a in outputs[i][1])
            i += 1
    wall = time.perf_counter() - t0
    n_batches = i
    peak = common.memory_peak(torch, ctx.device)
    frames = p["max_steps"]
    obs.info.update(
        batches=n_batches,
        batch_flops=[sum(roofline.utterance_flops(
            hp, wg, len(symbol_ids(t)), frames) for t in outputs[b][0])
            for b in range(n_batches)],
        wn_bound_s_per_batch=roofline.vocode_wn_bound_s(wg, p["batch"],
                                                        frames))
    del synth
    common.free(torch, ctx.device)

    checks = _check(ctx, outputs, mels, taco_sd, wg_sd)
    rows = n_batches * p["batch"]
    return Outcome(
        attempted=rows, failed=0,
        e2e={"audio_s_per_s": samples / wg["sampling_rate"] / wall,
             "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak, obs=obs,
        notes={"batches": n_batches, "window_s": wall})


def _spanned(obs, name, fn, sync):
    def wrapped(*a, **kw):
        with obs.span(name, sync):
            return fn(*a, **kw)
    return wrapped


def _check(ctx, outputs: dict, mels: dict, taco_sd, wg_sd) -> dict:
    """Sampled rows against the reference's single pass: each row's mel
    (after the postnet) as a relative L2 gap and its audio as a
    noise-to-signal power ratio, worst over the sample.  The rows:
    ``check_rows`` batches drawn from the seed among those the window
    completed, each with the row drawn for it before the window."""
    import torch

    p = ctx.cell["params"]
    hp, wg = ctx.cfg["tacotron"], ctx.cfg["waveglow"]
    r = inputs.rng(ctx.seed, 8)
    picked = sorted(int(b) for b in r.choice(
        sorted(outputs), min(p["check_rows"], len(outputs)), replace=False))
    ref = Synthesis(taco_sd, wg_sd, hp, wg)
    mel_gaps, audio_gaps = [], []
    hop = wg["upsample_stride"]
    for b0 in range(0, len(picked), p["check_block"]):
        block = picked[b0: b0 + p["check_block"]]
        texts, masks, noise, widths, rows = [], [], [], [], []
        for b in block:
            row = mels[b][0]
            t, m, z = _batch(ctx, b, hp, wg)
            texts.append(t[row])
            widths.append(_pad_width(t))
            masks.append(m[:, :, row])
            noise.append([c[row] for c in z])
            rows.append(row)
        mel, lens = ref.mel(texts, torch.stack(masks, dim=2), widths)
        audio = ref.audio(mel, tuple(torch.stack(c) for c in zip(*noise)),
                          p["sigma"], [p["denoiser_strength"]] * len(block))
        for j, b in enumerate(block):
            n = int(lens[j])
            mel_gaps.append(compare.rel_l2(mels[b][1][:, :n], mel[j, :, :n]))
            got = torch.from_numpy(outputs[b][1][rows[j]])
            audio_gaps.append(compare.noise_power_ratio(
                got, audio[j, : n * hop].cpu()))
    lim = p["limits"]
    return {"mel_gap": (max(mel_gaps), lim["mel_gap"]),
            "audio_nsr": (max(audio_gaps), lim["audio_nsr"])}
