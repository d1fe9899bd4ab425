"""Checkpoints of a :class:`.state.TrainState` (counterpart of
``text2speech_tpu/train/checkpoint.py``, in a torch format).

One file per step, ``ckpt_<step>.pt``: ``{"step", "params": {name:
tensor}, "opt_state": optimizer.state_dict()}``, plus ``"batch_stats":
{name: tensor}`` when the state carries BatchNorm running statistics
(Tacotron), with every tensor on the CPU, written through a temporary file and ``os.replace`` so that a
checkpoint either exists whole or not at all.  The newest ``max_to_keep``
are kept.  Files are read with ``weights_only=True``: they hold tensors and
plain containers, no code.

Under data parallelism (``group=``, the data ranks) every rank holds the
same state: the group's first rank writes, the others wait at a barrier,
so no two processes write one file; every rank restores.
"""

from __future__ import annotations

import os
import re
import tempfile

import torch

from .state import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, group=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.group = group
        self.writer = True
        if group is not None:
            import torch.distributed as dist

            self.writer = dist.get_rank(group) == 0
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        """Write ``ckpt_<step>.pt`` (on the group's first rank; the others
        wait until it is written)."""
        if self.writer:
            self._write(step, state)
        if self.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.group)

    def _write(self, step: int, state: TrainState) -> None:
        tree = {"step": int(step), "params": _to_cpu(state.params),
                "opt_state": _to_cpu(state.opt.state_dict())}
        if state.batch_stats:
            tree["batch_stats"] = _to_cpu(state.batch_stats)
        fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=self.directory)
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(tree, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(step))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.unlink(self._path(old))

    def close(self) -> None:
        """The JAX manager's ``close`` waits for its asynchronous saves; this
        one's saves are synchronous (each has reached its file when
        :meth:`save` returns), so there is nothing to wait for.  Under
        ``group=`` it ends with the barrier :meth:`save` uses, so every
        rank leaves it together.  Safe to call more than once."""
        if self.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.group)

    def load_params(self, step: int | None = None) -> dict:
        """The parameters saved at ``step`` (default: the newest) by name,
        f32 tensors on the CPU, without a restore template: for serving a
        trained checkpoint.  Raises when the directory holds none."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint in {self.directory}")
        tree = torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
        return {name: t.to(torch.float32)
                for name, t in tree["params"].items()}

    def load_variables(self, step: int | None = None) -> dict:
        """The parameters and BatchNorm running statistics saved at
        ``step`` (default: the newest) as one ``{name: f32 tensor}`` dict
        on the CPU, the names a module's ``state_dict`` uses: for serving
        a trained Tacotron.  Raises when the directory holds none."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        tree = torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
        return {name: t.to(torch.float32) for name, t in
                {**tree["params"], **tree.get("batch_stats", {})}.items()}

    def restore(self, state: TrainState, step: int | None = None,
                params_only: bool = False) -> tuple[TrainState, int]:
        """Restore into ``state`` (in place); returns (state, step), or
        (state, 0) when the directory holds no checkpoint.  Restored
        leaves take the template's dtype and device.

        ``params_only=True`` restores the step, the parameters and the
        running statistics and keeps ``state``'s fresh optimizer state: the way out for a
        checkpoint whose optimizer layout no longer matches (moments
        restart from zero).  It still checks the parameter names and
        shapes against the model."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state, 0
        tree = torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
        where = f"checkpoint at step {step} in {self.directory}"
        saved = tree["params"]
        if set(saved) != set(state.params):
            raise ValueError(
                f"{where}: params tree does not match the model "
                "(params_only only skips the optimizer layout, not the "
                "model architecture).")
        for name, p in state.params.items():
            if tuple(saved[name].shape) != tuple(p.shape):
                raise ValueError(
                    f"{where}: leaf {name} has shape "
                    f"{tuple(saved[name].shape)}, the model's is "
                    f"{tuple(p.shape)} (params_only only skips the "
                    "optimizer layout, not the model architecture).")
        if not params_only:
            try:
                state.opt.load_state_dict(tree["opt_state"])
            except (ValueError, KeyError) as e:
                raise ValueError(
                    f"{where} does not match the restore template. If the "
                    "params themselves match, the usual cause is an "
                    "optimizer-layout change (the optimizer's state is "
                    "part of the format); restore(..., params_only=True) "
                    "recovers the weights and reinitializes the optimizer."
                ) from e
        stats = tree.get("batch_stats", {})
        if set(stats) != set(state.batch_stats):
            raise ValueError(f"{where}: batch statistics do not match the "
                             f"model's")
        with torch.no_grad():
            for name, p in state.params.items():
                p.copy_(saved[name])
            for name, b in state.batch_stats.items():
                b.copy_(stats[name])
        state.step = int(tree["step"])
        return state, state.step
