"""Training losses (counterpart of ``text2speech_tpu/models/losses.py``).

``tacotron2_loss``: MSE on the decoder mels plus MSE on the postnet mels
plus binary cross-entropy on the stop-gate logits.  Padding is handled the
reference's way: the model's outputs are masked (mels to 0 against
zero-padded targets, gate logits to 1e3 against gate target 1), so padded
frames add next to nothing.  ``waveglow_loss``: the flow's negative
log-likelihood per element."""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits, in the numerically
    stable form ``max(x, 0) - x y + log1p(exp(-|x|))``."""
    return (torch.clamp_min(logits, 0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def tacotron2_loss(mel_out: torch.Tensor, mel_post: torch.Tensor,
                   gate_out: torch.Tensor, mel_target: torch.Tensor,
                   gate_target: torch.Tensor):
    """(total, {"mel_loss", "gate_loss", "loss"}) of mels [B, n_mel, T] and
    gate logits [B, T].  Accumulated in f32 (under bf16 training the
    outputs arrive bf16); the targets carry no gradient."""
    mel_target = mel_target.detach().float()
    gate_target = gate_target.detach().float()
    mel_out, mel_post = mel_out.float(), mel_post.float()
    mel_loss = (torch.mean((mel_out - mel_target) ** 2)
                + torch.mean((mel_post - mel_target) ** 2))
    gate_loss = torch.mean(bce_with_logits(gate_out.float(), gate_target))
    total = mel_loss + gate_loss
    return total, {"mel_loss": mel_loss, "gate_loss": gate_loss,
                   "loss": total}


def waveglow_loss(z: torch.Tensor, log_s_total: torch.Tensor,
                  log_det_w_total: torch.Tensor,
                  sigma: float = 1.0) -> torch.Tensor:
    """Flow negative log-likelihood, ``sum(z^2) / (2 sigma^2) - sum(log_s)
    - sum(log_det_W)``, over z's element count.  Accumulated in f32: under
    bf16 training a bf16 reduce over z would lose the loss's low bits."""
    z = z.to(torch.float32)
    loss = (torch.sum(z * z) / (2 * sigma * sigma) - log_s_total
            - log_det_w_total)
    return loss / z.numel()
