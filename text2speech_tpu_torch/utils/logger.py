"""Training scalars writer (counterpart of ``text2speech_tpu/utils/
logger.py``'s ``log_training``): TensorBoard through ``tensorboardX`` where
that is installed, else the same scalars as JSON lines in
``<logdir>/scalars.jsonl``.  Validation images wait for Tacotron
training."""

from __future__ import annotations

import json
import os


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
        scalars = {"training.loss": float(loss),
                   "grad.norm": float(grad_norm),
                   "learning.rate": float(learning_rate),
                   "duration": float(duration)}
        if self.writer is not None:
            for name, value in scalars.items():
                self.writer.add_scalar(name, value, iteration)
            return
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps({"iteration": int(iteration), **scalars})
                    + "\n")
