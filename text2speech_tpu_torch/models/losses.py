"""Training losses (counterpart of ``text2speech_tpu/models/losses.py``).
``tacotron2_loss`` waits for Tacotron training."""

from __future__ import annotations

import torch


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
