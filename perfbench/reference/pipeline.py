"""The reference's whole chains, in blocks of rows so that they fit beside
nothing else on the card: text to audio (ids, encoder, decoder with
attention, postnet, upsampler, the WN flows, coupling, the inverse 1x1
convs, the denoiser) and WaveGlow's training steps with plain Adam."""

from __future__ import annotations

import torch

from . import denoiser as ref_den
from . import tacotron as ref_taco
from . import waveglow as ref_wg
from .text import symbol_ids


class Synthesis:
    """The reference's text-to-audio chain over the benchmark's weights
    (both state dicts in the reference layout, f32 on one device)."""

    def __init__(self, taco_sd: dict, wg_sd: dict, hp: dict, wg: dict):
        self.taco_sd, self.wg_sd, self.hp, self.wg = taco_sd, wg_sd, hp, wg
        self.folded = ref_wg.fold_all(wg_sd, wg)
        self.bias_spec = ref_den.bias_spectrum(wg_sd, wg, self.folded)

    @torch.no_grad()
    def mel(self, texts: list, keep_masks: torch.Tensor, pad_to: list):
        """texts, keep-masks [steps, 2, B, prenet_dim], each row's padded
        width -> (mel_post [B, n_mel, steps], out_lengths [B]).

        The width matters: the encoder's convolutions read the pad
        symbol's embedding past a text's end, as the reference model's do
        in a zero-padded batch; rows are run in groups of one width."""
        dev = self.taco_sd["embedding.weight"].device
        outs = [None] * len(texts)
        for width in sorted(set(pad_to)):
            rows = [i for i, w in enumerate(pad_to) if w == width]
            mel, lens = self._mel([texts[i] for i in rows],
                                  keep_masks[:, :, rows], width)
            for j, i in enumerate(rows):
                outs[i] = (mel[j], lens[j])
        return (torch.stack([m for m, _ in outs]),
                torch.stack([n for _, n in outs]))

    def _mel(self, texts, keep_masks, width):
        dev = self.taco_sd["embedding.weight"].device
        seqs = [symbol_ids(t) for t in texts]
        lengths = torch.tensor([len(s) for s in seqs], device=dev)
        ids = torch.zeros((len(seqs), width), dtype=torch.long, device=dev)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = torch.tensor(s, device=dev)
        return ref_taco.infer(self.taco_sd, self.hp, ids, lengths,
                              keep_masks.to(dev))

    @torch.no_grad()
    def audio(self, mel: torch.Tensor, noise: tuple, sigma: float,
              strengths) -> torch.Tensor:
        """mel [B, n_mel, F], the draws, per-row denoiser strengths (0:
        off) -> audio [B, F * hop]."""
        audio = ref_wg.infer(self.wg_sd, self.wg, mel, noise, sigma,
                             self.folded)
        out = audio.clone()
        for r, s in enumerate(strengths):
            if s > 0:
                den = ref_den.denoise(audio[r: r + 1], self.bias_spec, s)
                out[r, : den.shape[1]] = den[0]
                out[r, den.shape[1]:] = 0.0
        return out


def train_steps(wg_sd: dict, wg: dict, batches: list, sigma: float,
                lr: float, block_rows: int):
    """Plain Adam (b1 0.9, b2 0.999, eps 1e-8) over every leaf of
    ``wg_sd`` for ``len(batches)`` steps, each on one global batch of
    audio [B, T] with its mel computed here.  Each step's gradient is the
    mean of the blocks' gradients (equal blocks of ``block_rows`` rows;
    the loss is a per-element mean).  Returns (losses, the first step's
    gradient by leaf, the final parameters by leaf)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in wg_sd.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grad = [], None
    for step, audio in enumerate(batches, start=1):
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        total = 0.0
        n_blocks = audio.shape[0] // block_rows
        for b in range(n_blocks):
            rows = audio[b * block_rows: (b + 1) * block_rows]
            with torch.no_grad():
                mel = ref_wg.mel_spectrogram(wg, rows)
            loss = ref_wg.loss(*ref_wg.forward(params, wg, mel, rows), sigma)
            for k, g in zip(params, torch.autograd.grad(
                    loss, list(params.values()))):
                grads[k] += g / n_blocks
            total += loss.item() / n_blocks
        losses.append(total)
        if first_grad is None:
            first_grad = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                m[k].mul_(0.9).add_(0.1 * g)
                v2[k].mul_(0.999).add_(0.001 * g * g)
                m_hat = m[k] / (1 - 0.9 ** step)
                v_hat = v2[k] / (1 - 0.999 ** step)
                p -= lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
    return losses, first_grad, {k: p.detach() for k, p in params.items()}
