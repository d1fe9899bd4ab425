"""Training metrics writer (counterpart of ``text2speech_tpu/utils/
logger.py``): TensorBoard through ``tensorboardX`` where that is
installed, else the same scalars as JSON lines in
``<logdir>/scalars.jsonl``.  Validation writes its loss and, to
TensorBoard, a histogram of every parameter and the alignment, target
mel, predicted mel and gate images (``utils/plotting.py`` renders them).
Without ``tensorboardX`` nothing imports matplotlib: validation writes its
loss alone, on any machine."""

from __future__ import annotations

import json
import os

import torch


class MetricsLogger:
    def __init__(self, logdir: str):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            SummaryWriter = None
        os.makedirs(logdir, exist_ok=True)
        self.writer = SummaryWriter(logdir) if SummaryWriter else None
        self.path = None if self.writer else os.path.join(logdir,
                                                          "scalars.jsonl")

    def log_training(self, loss, grad_norm, learning_rate, duration,
                     iteration) -> None:
        self._write({"training.loss": float(loss),
                     "grad.norm": float(grad_norm),
                     "learning.rate": float(learning_rate),
                     "duration": float(duration)}, iteration)

    def log_validation(self, val_loss, params, targets, predictions,
                       iteration) -> None:
        """``params``: the parameters by name (or None); ``targets`` =
        (mel_target, gate_target); ``predictions`` = (mel_out, mel_post,
        gate_out, alignments), as ``log_validation``
        (``utils/logger.py:18-41``).  The images are of the first row."""
        self._write({"validation.loss": float(val_loss)}, iteration)
        if self.writer is None:
            return
        from ..convert import _np
        from .plotting import (plot_alignment, plot_gate_outputs,
                               plot_spectrogram)

        if params is not None:
            for name, value in params.items():
                self.writer.add_histogram(name, _np(value).ravel(),
                                          iteration)
        mel_target, gate_target = targets
        _, mel_post, gate_out, align = predictions
        images = {
            "alignment": plot_alignment(_np(align[0]).T),
            "mel_target": plot_spectrogram(_np(mel_target[0])),
            "mel_predicted": plot_spectrogram(_np(mel_post[0])),
            "gate": plot_gate_outputs(
                _np(gate_target[0]),
                _np(torch.sigmoid(torch.as_tensor(gate_out[0])))),
        }
        for tag, image in images.items():
            self.writer.add_image(tag, image, iteration, dataformats="HWC")

    def close(self) -> None:
        """Close the TensorBoard writer (once; later calls and the JSON-lines
        path do nothing)."""
        if self.writer is not None:
            self.writer.close()
            self.writer = None

    def _write(self, scalars: dict, iteration) -> None:
        if self.writer is not None:
            for name, value in scalars.items():
                self.writer.add_scalar(name, value, iteration)
            return
        if self.path is None:      # closed
            return
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps({"iteration": int(iteration), **scalars})
                    + "\n")
