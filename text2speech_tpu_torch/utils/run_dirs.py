"""Run directories (counterpart of ``text2speech_tpu/utils/run_dirs.py``):
timestamped run directories, hparams saved into them and reloaded on
resume, the ValueWindow rolling average and ``str2bool`` for CLIs."""

from __future__ import annotations

import os
from datetime import datetime

from ..config import HParams


class ValueWindow:
    """Rolling average over the last ``window_size`` values."""

    def __init__(self, window_size: int = 100):
        self._size = window_size
        self._values: list[float] = []

    def append(self, x: float) -> None:
        self._values = (self._values + [float(x)])[-self._size:]

    @property
    def sum(self) -> float:
        return sum(self._values)

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def average(self) -> float:
        return self.sum / max(1, self.count)

    def reset(self) -> None:
        self._values = []


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("yes", "true", "t", "1")


def make_run_dir(base_dir: str, name: str | None = None) -> str:
    """``<base>/<name>_<YYYY-MM-DD_HH-MM-SS>``, created."""
    stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    path = os.path.join(base_dir, f"{name}_{stamp}" if name else stamp)
    os.makedirs(path, exist_ok=True)
    return path


def save_hparams(run_dir: str, hp: HParams) -> None:
    """``params.json`` in the run directory."""
    hp.save(os.path.join(run_dir, "params.json"))


def load_hparams(run_dir: str) -> HParams:
    """A previous run's hparams, for a resume."""
    return HParams.load(os.path.join(run_dir, "params.json"))
